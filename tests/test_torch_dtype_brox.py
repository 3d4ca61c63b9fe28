"""The dtype policy on the CPU for Brox spatial, robust-expo, Brox
temporal and TV-L1 with occlusions: float64 inputs give float64 results
that agree with the JAX package's float64 results to 1e-9 (TV-L1 with
occlusions: 1e-7; today's float32 parity tests allow 2e-3 to 0.05 of
EPE), with each level's stopping counts equal or off by one.

The inputs are the goldens' (64x96 pairs and triplet, the 4x48x64
volume), two scales each, exact warp on both sides; the rest of the
policy is tests/test_torch_dtype.py's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow_torch as port
from tpuflow.models.brox_spatial import brox_spatial as jax_brox_spatial
from tpuflow.models.brox_temporal import brox_temporal as jax_brox_temporal
from tpuflow.models.robust_expo import robust_expo as jax_robust_expo
from tpuflow.models.tvl1occflow import tvl1occflow as jax_tvl1occflow

torch.set_num_threads(2)

FLOW_ATOL = 1e-9
# TV-L1 with occlusions: its chi branches amplify rounding differences
# (tests/test_torch_tvl1occ.py holds one level to EPE 1e-8 in float64)
OCC_ATOL = 1e-7
KW = dict(nscales=2, clamp_scales=False, with_diag=True, warp_mode="exact")


def _goldens(name):
    here = os.path.dirname(os.path.abspath(__file__))
    g = np.load(os.path.join(here, "goldens", f"{name}.npz"))
    return {k: np.asarray(g[k], dtype=np.float64) for k in g}


def _inputs(name):
    if name in ("brox_spatial", "robust_expo"):
        g = _goldens("brox" if name == "brox_spatial" else "robust_expo")
        return g["I0"], g["I1"]
    if name == "brox_temporal":
        return (_goldens("brox_temporal")["vol"],)
    g = _goldens("tvl1occ")
    return g["Im1"], g["I0"], g["I1"]


SOLVERS = {"brox_spatial": (port.brox_spatial, jax_brox_spatial),
           "robust_expo": (port.robust_expo, jax_robust_expo),
           "brox_temporal": (port.brox_temporal, jax_brox_temporal),
           "tvl1occflow": (port.tvl1occflow, jax_tvl1occflow)}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_float64_matches_jax(name):
    fn, jfn = SOLVERS[name]
    args = _inputs(name)
    *out, diags = fn(*args, device="cpu", **KW)
    assert all(o.dtype == torch.float64 for o in out), [o.dtype for o in out]
    *want, jdiags = jfn(*map(jnp.asarray, args), **KW)
    for o, w in zip(out, want):
        assert np.asarray(w).dtype == np.float64
        np.testing.assert_allclose(
            o.numpy(), np.asarray(w), rtol=0,
            atol=OCC_ATOL if name == "tvl1occflow" else FLOW_ATOL)
    for d, jd in zip(diags, jdiags):
        its, jits = np.asarray(d["iterations"]), np.asarray(jd["iterations"])
        assert its.shape == jits.shape
        assert np.all(np.abs(its - jits) <= 1), (its, jits)
