"""The cell `brox-batched-sintel.batch128` on the CPU at a small size: its
files are found by name, a run is correct against the reference, the
method's work lists each sample's solves, and its readers read nothing
where there is no device trace."""

import torch

from flowbench import harness, roofline
from flowbench.roofline import k7, k7_batch
from flowbench.tests import _small

NAME = "brox-batched-sintel.batch128"
READERS = ("k7_roofline.batch", "k7_sweeps_launched_per_call.batch",
           "brox_terms_share.batch")


def test_runs_are_correct_and_readers_read_nothing_on_the_cpu():
    c = _small.cell(NAME, batch=2)
    assert {m["name"] for m in c.per_layer} == set(READERS)
    timed = _small.run(c)
    assert timed["correct"] and set(timed["metrics"]) == {"fields_per_s",
                                                          "setup_s"}
    traced = _small.run(c, trace=1)
    assert traced["correct"] and traced["metrics"] == {}


def test_work_lists_each_sample_of_each_solve():
    c = _small.cell(NAME, batch=2)
    I0, I1 = harness.make_inputs(c, 7, "cpu")
    w = c.method.work(I0, I1, c.config["params"], torch.device("cpu"))
    levels = 2    # 40x64 and 20x32: the shorter side stays >= 16
    per_level = c.config["params"]["outer_iter"] * c.config["params"]["inner_iter"]
    assert len(w["k7_batch"]) == levels * per_level * 2
    assert {px for px, _ in w["k7_batch"]} == {40 * 64, 20 * 32}
    assert w["solver_iters"] == sum(n for _, n in w["k7_batch"]) > 0
    assert w["launches"] == {"k7_batch": 0}   # the plain K7 launches nothing


def test_batch_bound_is_the_pair_bound_of_each_solve():
    peaks = roofline.peaks("NVIDIA H100 80GB HBM3")
    work = [(436 * 1024, 16), (436 * 1024, 300), (28 * 64, 3)]
    assert k7_batch.bound_s(work, peaks) == k7.bound_s(work, peaks)
