"""The port's spans and counters (tpuflow_torch.utils.trace) on the CPU:
when spans are kept, how they nest, their clock against the profiler's,
and the counts of host reads and K2 iterations against what a call's
stats imply."""

import collections
import inspect

import pytest
import torch

import tpuflow_torch
from tpuflow_torch.ops import sweeps
from tpuflow_torch.utils import trace

torch.set_num_threads(2)

PROFILERS = {
    "recording": trace.recording,
    "torch.profiler": lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]),
    "autograd.profiler": torch.autograd.profiler.profile,
}


def _delta(before):
    after = trace.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_span_off_keeps_nothing():
    trace.clear()
    with trace.span("a"):
        with trace.span("b"):
            trace.count("test.off")
    assert trace.spans() == []
    assert trace.span("a") is trace.span("b")   # one shared no-op
    assert trace.counters()["test.off"] >= 1    # counters are always on


@pytest.mark.parametrize("ctx", list(PROFILERS))
def test_spans_nest(ctx):
    trace.clear()
    with PROFILERS[ctx]():
        with trace.span("root"):
            trace.count("test.nest", 2)
            with trace.span("child"):
                trace.count("test.nest")
                with trace.span("leaf"):
                    pass
            with trace.span("child"):
                pass
        with trace.span("next"):
            pass
    with trace.span("after"):
        pass
    got = {s.name: s for s in trace.spans()}
    assert [s.name for s in trace.spans()] == [
        "leaf", "child", "child", "root", "next"]
    root, leaf = got["root"], got["leaf"]
    first, second = [s for s in trace.spans() if s.name == "child"]
    assert root.parent is None and root.call == root.id
    assert first.parent == second.parent == root.id
    assert leaf.parent == first.id and leaf.call == root.id
    assert got["next"].parent is None and got["next"].call == got["next"].id
    assert root.start <= first.start <= leaf.start <= leaf.end <= first.end
    assert first.end <= second.start <= second.end <= root.end
    assert root.counts == {"test.nest": 3}     # kept on the root alone
    assert first.counts is None and leaf.counts is None


def test_span_start_on_the_profilers_clock():
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with torch.profiler.record_function("test.inner"):
                torch.ones(8).sum()
    (outer,) = trace.spans()
    (inner,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "test.inner"]
    assert 0 <= inner.start_ns() - outer.start <= 1_000_000
    assert inner.start_ns() + inner.duration_ns() <= outer.end


def test_full_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(trace, "_kept", collections.deque(maxlen=2))
    before = trace.counters()
    with trace.recording():
        for name in "abc":
            with trace.span(name):
                pass
    assert [s.name for s in trace.spans()] == ["b", "c"]
    assert _delta(before) == {"spans.dropped": 1}


def _pairs(B=2, ny=32, nx=48):
    g = torch.Generator().manual_seed(3)
    I0 = 255 * torch.rand(B, ny, nx, generator=g)
    return I0, torch.roll(I0, (1, 2), dims=(-2, -1))


@pytest.mark.parametrize("engine", ["tvl1_batched", "hs_pyramidal_batched"])
def test_counts_match_the_stats(engine):
    """On the CPU a warp reads its per-sample counts once (the warp early
    exit) and the plain solve reads `active` before every iteration and
    once more to stop; K2's plain version counts its iterations."""
    trace.clear()
    before = trace.counters()
    with trace.recording():
        _, _, stats = getattr(tpuflow_torch, engine)(
            *_pairs(), device="cpu", with_stats=True)
    warps = [n for level in stats["iterations"].values() for n in level]
    solved = sum(max(n) for n in warps)
    want = {"host_reads": len(warps) + solved + len(warps)}
    if engine == "tvl1_batched":
        want["iters.k2"] = solved
    assert _delta(before) == want
    (root,) = [s for s in trace.spans() if s.parent is None]
    assert root.name == engine and root.counts == want
    names = collections.Counter(s.name for s in trace.spans())
    levels = len(stats["iterations"])
    assert names == {engine: 1, "prepare": 1, "upsample": levels - 1,
                     "warp": len(warps), "host_read": len(warps),
                     **{f"level_{s}": 1 for s in range(levels)}}


@pytest.mark.parametrize("stop_after,max_iter,chunks,reads", [
    (3, 300, [16, 16, 16], 3),      # stops after the third chunk
    (None, 40, [16, 16, 8], 2),     # runs to the cap: no read after it
    (None, 16, [16], 0),
])
def test_launch_until_stopped_reads_once_per_chunk(stop_after, max_iter,
                                                   chunks, reads):
    active = torch.ones(4, dtype=torch.int32)
    launched = []

    def launch(count):
        launched.append(count)
        if len(launched) == stop_after:
            active.zero_()

    trace.clear()
    before = trace.counters()
    with trace.recording():
        sweeps.launch_until_stopped(launch, active, max_iter)
    assert launched == chunks
    assert _delta(before) == ({"host_reads": reads} if reads else {})
    names = [s.name for s in trace.spans()]
    assert names == ["host_read"] * reads + ["solve"]


def test_traced_entry_keeps_its_name_and_signature():
    entry = tpuflow_torch.tvl1_batched
    assert entry.__name__ == "tvl1_batched"
    assert "warp_early_exit" in inspect.signature(entry).parameters
