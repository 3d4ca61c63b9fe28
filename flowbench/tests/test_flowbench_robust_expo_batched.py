"""The cell `robust-expo-batched-sintel.batch128` on the CPU at a small
size: its files are found by name, a run is correct against the
reference, the method's work lists each sample's solves and each K10
launch, its readers read nothing where there is no device trace; and
`correct` comes out false for the TF32 control and for each fault
planted in the port under a whole run of the harness: a K7 solve that
returns its state unchanged, the diffusivity left out (Brox's
smoothness weight), DF-AUTO's percentile taken over the whole batch,
and one answer altered where it is produced."""

import importlib

import pytest
import tpuflow_torch
import torch

from flowbench import check, harness, roofline
from flowbench.reference import _ops
from flowbench.roofline import k10
from flowbench.tests import _small

NAME = "robust-expo-batched-sintel.batch128"
READERS = ("k7_roofline.batch", "k7_sweeps_launched_per_call.batch",
           "device_idle_share.batch", "peak_mem_gb.batch", "expo_share.batch",
           "k10_roofline.batch")
batch_module = importlib.import_module("tpuflow_torch.models.batch")
brox_module = importlib.import_module("tpuflow_torch.models.brox_spatial")
expo_module = importlib.import_module("tpuflow_torch.models.robust_expo")


def test_runs_are_correct_and_readers_read_nothing_on_the_cpu():
    c = _small.cell(NAME, batch=2)
    assert {m["name"] for m in c.per_layer} == set(READERS)
    timed = _small.run(c)
    assert timed["correct"] and set(timed["metrics"]) == {"fields_per_s",
                                                          "setup_s"}
    traced = _small.run(c, trace=1)
    assert traced["correct"] and traced["metrics"] == {}


def test_work_lists_each_sample_of_each_solve_and_each_k10_launch():
    c = _small.cell(NAME, batch=2)
    I0, I1 = harness.make_inputs(c, 7, "cpu")
    w = c.method.work(I0, I1, c.config["params"], torch.device("cpu"))
    levels = 2    # 40x64 and 20x32: the shorter side stays >= 16
    p = c.config["params"]
    per_level = p["outer_iter"] * p["inner_iter"]
    assert len(w["k7_batch"]) == levels * per_level * 2
    assert {px for px, _ in w["k7_batch"]} == {40 * 64, 20 * 32}
    assert w["solver_iters"] == sum(n for _, n in w["k7_batch"]) > 0
    assert len(w["k10"]) == levels * per_level
    assert {px for px, _ in w["k10"]} == {2 * 40 * 64, 2 * 20 * 32}
    assert all(first for _, first in w["k10"])   # one inner iteration
    # the plain versions launch nothing
    assert w["launches"] == {"k7_batch": 0, "k10": 0}


def test_k10_bound_counts_its_planes_once():
    peaks = roofline.peaks("NVIDIA H100 80GB HBM3")
    px = 128 * 436 * 1024
    assert k10.bound_s([(px, True)], peaks) == pytest.approx(1.4329e-3,
                                                             rel=1e-4)
    assert k10.bound_s([(px, False)], peaks) == pytest.approx(1.5694e-3,
                                                              rel=1e-4)


def test_control_is_not_correct():
    c = _small.cell(NAME)
    I0, I1 = harness.make_inputs(c, 2**31 + 77, "cpu")
    u, v = c.reference.flow(I0, I1, c.config["params"],
                            prec=_ops.CONTROLS["tf32"])
    w = check.weights(*I0.shape[-2:], "cpu")
    correct, _, checks = check.judge(c, (I0, I1), {None: (u, v)},
                                     [check.fingerprint(u, v, w)], [None], w,
                                     0)
    assert not correct
    assert checks["epe_median"]["value"] > checks["epe_median"]["limit"]


def _unchanged_step(state, const, thresh, max_iter, *args):
    B = state.shape[0]
    return state, torch.zeros(B, dtype=state.dtype), torch.ones(B, dtype=torch.int32)


def _no_diffusivity(I1x, I1y, method_type, alpha, lam, channel_dim=0):
    return torch.ones_like(I1x)


def _percentile_over_batch(I1x, I1y, method_type, alpha, lam, channel_dim=0):
    real = expo_module.exponential_diffusivity
    whole = (1, -1, I1x.shape[-1])
    return real(I1x.reshape(whole), I1y.reshape(whole), method_type, alpha,
                lam, channel_dim=None).reshape(I1x.shape)


@pytest.mark.parametrize("target", [
    (brox_module, "brox_sor_error", _unchanged_step),
    (batch_module, "exponential_diffusivity", _no_diffusivity),
    (batch_module, "exponential_diffusivity", _percentile_over_batch)],
    ids=["state_unchanged", "no_diffusivity", "percentile_over_batch"])
def test_planted_fault_is_not_correct(monkeypatch, target):
    monkeypatch.setattr(*target)
    result = _small.run(_small.cell(NAME))
    assert not result["correct"]


def test_fault_one_answer_altered(monkeypatch):
    real = tpuflow_torch.robust_expo_batched
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

    c = _small.cell(NAME, batch=2)
    monkeypatch.setattr(c.method, "robust_expo_batched", altered)
    monkeypatch.setattr(harness, "time", Clock)
    result = _small.run(c, seconds=3.0)
    assert len(calls) == 5   # the warm-up's and four
    assert not result["correct"]
    assert result["checks"]["repeat_mismatch"]["value"] > 0
