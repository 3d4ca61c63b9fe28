"""`correct` comes out false for the control and for each fault a cell
can have, at a size that a test run holds, on the CPU.

The control is the reference in the nearest precision below the
configurations' (float32 with TF32 off): its pyramid products in TF32,
put in the program's place.  The faults are planted in the port under a
whole run of the harness: a solver step that returns its state
unchanged; half of the batch left out, the mean of the rest in its
place, or an eighth of it so left out, which the median cannot see;
one answer altered where it is produced.  The cells run on one
card, so there is no exchange between cards to leave out."""

import pytest
import tpuflow_torch
import torch

import tpuflow_torch.models.batch as engine
from flowbench import check, harness
from flowbench.reference import _ops
from flowbench.tests import _small

CELLS = ("tvl1-sintel.batch128", "brox-sintel.pair")
brox_module = __import__("importlib").import_module(
    "tpuflow_torch.models.brox_spatial")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _small.run(_small.cell(name))["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = _small.cell(name)
    I0, I1 = harness.make_inputs(c, 2**31 + 77, "cpu")
    batch = c.traffic["kind"] == "batch"
    u, v = c.reference.flow(I0, I1, c.config["params"], joint_exit=batch,
                            prec=_ops.CONTROLS["tf32"])
    w = check.weights(*I0.shape[-2:], "cpu")
    if batch:
        kept, prints, order = {None: (u, v)}, [check.fingerprint(u, v, w)], [None]
    else:
        kept = {k: (u[k], v[k]) for k in range(I0.shape[0])}
        prints = [check.fingerprint(u[k], v[k], w) for k in kept]
        order = list(kept)
    correct, _, checks = check.judge(c, (I0, I1), kept, prints, order, w, 0)
    assert not correct
    assert checks["epe_median"]["value"] > checks["epe_median"]["limit"]


def _unchanged_step(state, const, thresh, max_iter, *args):
    B = state.shape[0]
    return state, torch.zeros(B, dtype=state.dtype), torch.ones(B, dtype=torch.int32)


@pytest.mark.parametrize("name,target", [
    ("tvl1-sintel.batch128", (engine, "tvl1_iterate_error")),
    ("brox-sintel.pair", (brox_module, "brox_sor_error"))])
def test_fault_state_unchanged(monkeypatch, name, target):
    monkeypatch.setattr(*target, _unchanged_step)
    assert not _small.run(_small.cell(name))["correct"]


@pytest.mark.parametrize("part,caught", [(2, "epe_median"),
                                         (8, "fields_off_pct")])
def test_fault_part_of_batch_left_out(monkeypatch, part, caught):
    real = tpuflow_torch.tvl1_batched

    def left_out(I0, I1, **kw):
        h = I0.shape[0] // part
        u, v = real(I0[h:], I1[h:], **kw)
        return (torch.cat([u.mean(0, keepdim=True).expand(h, *u.shape[1:]), u]),
                torch.cat([v.mean(0, keepdim=True).expand(h, *v.shape[1:]), v]))

    monkeypatch.setattr(tpuflow_torch, "tvl1_batched", left_out)
    result = _small.run(_small.cell("tvl1-sintel.batch128", batch=16))
    assert not result["correct"]
    assert result["checks"][caught]["value"] > result["checks"][caught]["limit"]


@pytest.mark.parametrize("name,entry", [
    ("tvl1-sintel.batch128", "tvl1_batched"),
    ("brox-sintel.pair", "brox_spatial")])
def test_fault_one_answer_altered(monkeypatch, name, entry):
    real = getattr(tpuflow_torch, entry)
    calls = []

    def altered(*args, **kw):
        u, v = real(*args, **kw)
        calls.append(1)
        if len(calls) == 2:   # the warm-up's is the first
            u = u.clone()
            u[..., 5, 7] += 0.5
        return u, v

    class Clock:   # each reading 0.25 s on: four calls in a 3 s window
        now = 0.0

        @classmethod
        def perf_counter(cls):
            cls.now += 0.25
            return cls.now

    monkeypatch.setattr(tpuflow_torch, entry, altered)
    monkeypatch.setattr(harness, "time", Clock)
    result = _small.run(_small.cell(name, roster=2), seconds=3.0)
    assert len(calls) == 5   # the warm-up's and four; the altered input came again
    assert not result["correct"]
    assert result["checks"]["repeat_mismatch"]["value"] > 0
