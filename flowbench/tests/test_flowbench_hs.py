"""The `hs-sintel.batch128` cell on the CPU (loaded from its files:
BENCHMARK.json does not list it, PERF.md section 7): its plain reference equals
the port's plain path bit for bit; a sound run is correct; the
bfloat16 control and each planted fault read `correct` false (a solve that
returns its state unchanged; an eighth of the batch left out, the mean
of the rest in its place, which only the share of fields sees; one
answer altered where it is produced)."""

import importlib

import pytest
import tpuflow_torch
import torch

from flowbench import check, harness, layout
from flowbench.reference import _ops
from flowbench.tests import _small

CELL = "hs-sintel.batch128"
engine = importlib.import_module("tpuflow_torch.models.batch")


def _cell(batch=4, shape=_small.SHAPE):
    c = layout.Cell(layout.load_benchmark(), CELL, unlisted=True)
    c.traffic.update(batch=batch, warmup_calls=1, trace_calls=4)
    c.config["frame"].update(ny=shape[0], nx=shape[1])
    return c


def test_reference_equals_the_ports_plain_path():
    c = _cell()
    I0, I1 = harness.make_inputs(c, 11, "cpu")
    u, v = c.method.call(I0, I1, c.config["params"], "cpu")
    ru, rv = c.reference.flow(I0, I1, c.config["params"], joint_exit=True)
    assert torch.equal(u, ru) and torch.equal(v, rv)


def test_control_is_not_correct():
    """The TF32 control moves the flow by 2e-6-4e-6 at this size, below
    the limits set from its readings at 1024x436 (PERF.md), so the CPU
    holds the limits to the bfloat16 control."""
    c = _cell()
    I0, I1 = harness.make_inputs(c, 2**31 + 77, "cpu")
    u, v = c.reference.flow(I0, I1, c.config["params"], joint_exit=True,
                            prec=_ops.CONTROLS["bf16"])
    w = check.weights(*I0.shape[-2:], "cpu")
    correct, _, checks = check.judge(c, (I0, I1), {None: (u, v)},
                                     [check.fingerprint(u, v, w)], [None], w, 0)
    assert not correct
    assert checks["epe_median"]["value"] > checks["epe_median"]["limit"]


def _unchanged(state, const, thresh, max_iter, alpha2):
    B = state.shape[0]
    return (state, torch.zeros(B, dtype=state.dtype),
            torch.ones(B, dtype=torch.int32))


def _eighth_left_out(I0, I1, **kw):
    h = I0.shape[0] // 8
    u, v = REAL(I0[h:], I1[h:], **kw)
    return (torch.cat([u.mean(0, keepdim=True).expand(h, *u.shape[1:]), u]),
            torch.cat([v.mean(0, keepdim=True).expand(h, *v.shape[1:]), v]))


REAL = tpuflow_torch.hs_pyramidal_batched


@pytest.mark.parametrize("fault", [None, "unchanged", "eighth"])
def test_sound_run_and_faults(monkeypatch, fault):
    if fault == "unchanged":
        monkeypatch.setattr(engine, "hs_sor_error", _unchanged)
    if fault == "eighth":
        monkeypatch.setattr(tpuflow_torch, "hs_pyramidal_batched",
                            _eighth_left_out)
    result = _small.run(_cell(batch=16 if fault == "eighth" else 4,
                              shape=(24, 40)))
    assert result["correct"] == (fault is None)
    if fault == "eighth":
        off = result["checks"]["fields_off_pct"]
        assert off["value"] > off["limit"]
        assert result["checks"]["epe_median"]["value"] <= (
            result["checks"]["epe_median"]["limit"])


def test_fault_one_answer_altered(monkeypatch):
    calls = []

    def altered(*args, **kw):
        u, v = REAL(*args, **kw)
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

    monkeypatch.setattr(tpuflow_torch, "hs_pyramidal_batched", altered)
    monkeypatch.setattr(harness, "time", Clock)
    result = _small.run(_cell(shape=(24, 40)), seconds=3.0)
    assert len(calls) == 5
    assert not result["correct"]
    assert result["checks"]["repeat_mismatch"]["value"] > 0
