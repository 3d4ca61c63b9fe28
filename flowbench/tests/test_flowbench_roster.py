"""The inputs come from the seed alone: a roster of distinct pairs, the
same for one seed, another for another seed."""

import torch

from flowbench import harness
from flowbench.tests import _small


def test_roster_follows_the_seed():
    c = _small.cell("brox-sintel.pair", roster=5)
    a0, a1 = harness.make_inputs(c, 2**32 + 9, "cpu")
    b0, b1 = harness.make_inputs(c, 2**32 + 9, "cpu")
    c0, _ = harness.make_inputs(c, 2**32 + 10, "cpu")
    assert a0.shape == (5, *_small.SHAPE) and a0.dtype == torch.float32
    assert torch.equal(a0, b0) and torch.equal(a1, b1)
    assert not torch.equal(a0, c0)
    for i in range(5):
        for j in range(i):
            assert not torch.equal(a0[i], a0[j])
    assert float(a0.min()) >= 28 - 1e-4 and float(a0.max()) <= 228 + 1e-4


def test_pair_traffic_walks_the_roster_in_turn():
    c = _small.cell("tvl1-sintel.batch128")
    c.traffic.update(kind="pair", roster=3)
    window = harness.Window(c, harness.make_inputs(c, 3, "cpu"),
                            harness.Device("cpu"))
    for _ in range(7):
        window.one(record=False)
    assert window.order == [0, 1, 2, 0, 1, 2, 0]
