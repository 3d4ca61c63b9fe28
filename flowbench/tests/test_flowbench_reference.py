"""Each plain reference agrees with the port's CPU path (its kernels'
plain versions) at a small size."""

import tpuflow_torch
import torch

from flowbench import harness
from flowbench.tests import _small


def _inputs(name, **kw):
    c = _small.cell(name, **kw)
    return c, harness.make_inputs(c, 11, "cpu")


def test_tvl1_batch():
    c, (I0, I1) = _inputs("tvl1-sintel.batch128")
    u, v = c.method.call(I0, I1, c.config["params"], "cpu")
    ru, rv = c.reference.flow(I0, I1, c.config["params"], joint_exit=True)
    assert float((u - ru).abs().max()) <= 1e-6
    assert float((v - rv).abs().max()) <= 1e-6


def test_tvl1_pairs():
    c, (I0, I1) = _inputs("tvl1-sintel.batch128")
    ru, rv = c.reference.flow(I0, I1, c.config["params"], joint_exit=False)
    for k in range(I0.shape[0]):
        u, v = c.method.call(I0[k], I1[k], c.config["params"], "cpu")
        assert float(torch.hypot(u - ru[k], v - rv[k]).max()) <= 1e-6


def test_brox_pairs():
    c, (I0, I1) = _inputs("brox-sintel.pair", roster=2)
    ru, rv = c.reference.flow(I0, I1, c.config["params"])
    for k in range(2):
        u, v = tpuflow_torch.brox_spatial(I0[k], I1[k], warp_mode="fast",
                                          device="cpu")
        assert float(torch.hypot(u - ru[k], v - rv[k]).max()) <= 1e-6
