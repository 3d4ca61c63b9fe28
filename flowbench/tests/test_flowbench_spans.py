"""The readers of the program's spans and counters: on a traced run of
the small cells on the CPU, and on spans and busy intervals laid out by
hand."""

import types

import pytest
import tpuflow_torch

from flowbench import layout
from flowbench.metrics import _spans
from flowbench.tests import _small
from tpuflow_torch.utils.trace import Span

SEED = 2**31 + 5
READERS = ("host_reads_per_call.batch", "k2_iters_launched_per_call.batch",
           "coarse_levels_share.batch", "coarse_levels_idle_share.batch")


def _cell(name):
    """The small cell `name`; `hs-sintel.batch128`, which BENCHMARK.json
    does not list (PERF.md, section 7), with the readers of the spans
    that apply to it."""
    if name != "hs-sintel.batch128":
        return _small.cell(name, batch=2)
    bench = layout.load_benchmark()
    bench["workloads"].append({"name": name, "config": "hs-sintel",
                               "traffic": "batch128", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in READERS and not m["name"].startswith("k2"):
            m["workloads"].append(name)
    c = layout.Cell(bench, name)
    c.traffic.update(batch=2, warmup_calls=1, trace_calls=4)
    c.config["frame"].update(ny=24, nx=40)
    return c


def _stats(name, c):
    from flowbench import harness

    I0, I1 = harness.make_inputs(c, SEED, "cpu")
    kw = c.method._kwargs(c.config["params"], I0.shape) if name.startswith(
        "hs") else c.method._batch_kwargs(c.config["params"], I0.shape)
    entry = (tpuflow_torch.hs_pyramidal_batched if name.startswith("hs")
             else tpuflow_torch.tvl1_batched)
    _, _, stats = entry(I0, I1, device="cpu", with_stats=True, **kw)
    return [n for level in stats["iterations"].values() for n in level]


@pytest.mark.parametrize("name", ["tvl1-sintel.batch128", "hs-sintel.batch128"])
def test_readers_on_a_traced_run(name):
    """The counters per call equal what the call's stats imply on the CPU:
    a read a warp and the plain solve's reads; the coarse levels' shares
    need a device trace."""
    c = _cell(name)
    result = _small.run(c, seed=SEED, trace=1)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    warps = _stats(name, c)
    solved = sum(max(n) for n in warps)
    assert got["host_reads_per_call.batch"] == 2 * len(warps) + solved
    if name.startswith("tvl1"):
        assert got["k2_iters_launched_per_call.batch"] == solved
    else:
        assert "k2_iters_launched_per_call.batch" not in got
    assert "coarse_levels_share.batch" not in got        # no device here
    assert "coarse_levels_idle_share.batch" not in got


class _Record:   # what the readers take of flowbench.harness.Record
    def __init__(self, trace):
        self.trace = trace


def _record(spans, busy, start=0, end=100, launches=()):
    """A record of device events `busy`, one kernel each, launched at
    `launches` by `cudaLaunchKernel` (each inside a `cudaLaunchKernel` of
    the driver, which is not counted twice)."""
    host = [h for t in launches
            for h in ((t, t + 1, "cudaLaunchKernel", "runtime"),
                      (t, t + 1, "cuLaunchKernel", "runtime"),
                      (t, t + 1, "aten::add", "cpu_op"))]
    trace = types.SimpleNamespace(
        start=start, end=end, busy_intervals=lambda: [list(b) for b in busy],
        device=[(s, t, "kernel_a", "kernel", 0) for s, t in busy], host=host)
    return _Record(trace), spans


SPANS = [Span(4, "host_read", 30, 40, 3, 1, None),
         Span(3, "warp", 25, 45, 2, 1, None),
         Span(2, "level_1", 20, 50, 1, 1, None),
         Span(5, "level_0", 55, 70, 1, 1, None),
         Span(1, "tvl1_batched", 10, 80, None, 1, {"host_reads": 3}),
         Span(6, "outside", 85, 120, None, 6, {})]   # past the window


def test_idle_laid_over_the_spans(monkeypatch):
    record, spans = _record(SPANS, busy=[(12, 22), (35, 60)],
                            launches=(11, 31))
    monkeypatch.setattr(_spans, "_program_spans", lambda: spans)
    view = _spans.Spans(record)
    assert [s.id for s in view.roots] == [1]
    assert view.counter("host_reads") == 3 and view.counter("iters.k2") is None
    assert view.busy_ns(20, 50) == 17
    assert view.segments() == [
        (0, 10, _spans.BETWEEN_CALLS), (10, 20, "tvl1_batched"),
        (20, 25, "level_1"), (25, 30, "warp"), (30, 40, "host_read"),
        (40, 45, "warp"), (45, 50, "level_1"), (50, 55, "tvl1_batched"),
        (55, 70, "level_0"), (70, 80, "tvl1_batched"),
        (80, 100, _spans.BETWEEN_CALLS)]
    idle = {k: round(v * 1e9) for k, v in view.idle_by_span().items()}
    assert idle == {_spans.BETWEEN_CALLS: 30, "tvl1_batched": 12,
                    "level_1": 3, "warp": 5, "host_read": 5, "level_0": 10}
    assert view.untied is None and view.launched == [(11, 10), (31, 25)]
    cell = layout.Cell(layout.load_benchmark(), "tvl1-sintel.batch128")
    read = {n: cell.metric_reader(n).read for n in READERS}
    _spans.spans_of.cache_clear()
    # the kernel launched at 31, inside level_1, runs after level_1's end
    assert read["coarse_levels_share.batch"](record) == pytest.approx(
        100 * 25 / 35)
    assert read["coarse_levels_idle_share.batch"](record) == pytest.approx(
        100 * 13 / 30)
    assert read["host_reads_per_call.batch"](record) == 3


def test_no_program_spans_reads_nothing(monkeypatch):
    """A program without spans (before them) gives every reader None."""
    record, _ = _record([], busy=[(0, 50)])
    monkeypatch.setattr(_spans, "_program_spans", lambda: [])
    _spans.spans_of.cache_clear()
    cell = layout.Cell(layout.load_benchmark(), "tvl1-sintel.batch128")
    assert [cell.metric_reader(n).read(record) for n in READERS] == [None] * 4


def test_event_before_its_launch_is_tied():
    """The card's clock lies on the host's only to within tenths of a
    millisecond: an event that reads as starting before its launch is
    tied all the same, and the offset is reported."""
    record, _ = _record([], busy=[(12, 22), (35, 60)], launches=(11, 40))
    view = _spans.Spans(record)
    assert view.untied is None and view.early_ns == 5
    assert view.launched == [(11, 10), (40, 25)]


def _tie(launches, device):
    """The tie of launches [(time, host call)] to device events [(start,
    end, kind)] in a window 0..100."""
    trace = types.SimpleNamespace(
        start=0, end=100, host=[(t, t + 1, name, "runtime")
                                for t, name in launches],
        device=[(s, e, "op", kind, 0) for s, e, kind in device])
    return _spans.Spans._tie(trace)


K, C = "cudaLaunchKernel", "cudaMemcpyAsync"


@pytest.mark.parametrize("lost", ["none", "first", "last"])
def test_tie_by_kind_past_events_lost_at_the_ends(lost):
    """Events the clocks' offset puts outside the window leave their
    launches at its ends untied; the one shift at which every kind
    agrees ties the rest."""
    launches = [(10, K), (20, C), (30, K), (40, K)]
    device = [(12, 14, "kernel"), (22, 23, "gpu_memcpy"),
              (33, 37, "kernel"), (41, 49, "kernel")]
    if lost == "first":
        device = device[1:]
    if lost == "last":
        device = device[:-1]
    tied, why, _ = _tie(launches, device)
    assert why is None
    want = [(10, 2), (20, 1), (30, 4), (40, 8)]
    assert tied == {"none": want, "first": want[1:], "last": want[:-1]}[lost]


@pytest.mark.parametrize("launches", [[(10, C), (30, K)],
                                      [(10, K), (20, K), (30, K)]],
                         ids=["another_kind", "two_ways"])
def test_tie_refused(launches):
    tied, why, _ = _tie(launches, [(12, 14, "kernel"), (33, 37, "kernel")])
    assert tied == [] and "ways to tie them" in why


@pytest.mark.parametrize("launches", [(11,), (11, 31, 40)],
                         ids=["fewer", "more"])
def test_untied_device_time_reads_nothing(monkeypatch, launches):
    """Where no one tie is sure (fewer launches than device events, or
    more, all of one kind), no device time is tied to a span and the
    coarse levels' share reads nothing."""
    record, spans = _record(SPANS[:-1], busy=[(12, 22), (35, 60)],
                            end=10_000, launches=launches)
    monkeypatch.setattr(_spans, "_program_spans", lambda: spans)
    _spans.spans_of.cache_clear()
    view = _spans.Spans(record)
    assert view.launched == [] and view.untied
    cell = layout.Cell(layout.load_benchmark(), "tvl1-sintel.batch128")
    assert cell.metric_reader("coarse_levels_share.batch").read(record) is None
    assert cell.metric_reader("host_reads_per_call.batch").read(record) == 3
