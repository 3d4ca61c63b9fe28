"""The dtype policy (tpuflow_torch.config, `_device.compute_inputs`) on
the CPU: float64 inputs give float64 results that agree with the JAX
package's float64 results (tests/conftest.py enables x64 for that), and
inputs that are not float32 or float64 give `default_dtype`.

This file holds the batched engines and the two-frame solvers whose JAX
counterparts compile fastest; tests/test_torch_dtype_brox.py holds Brox,
robust-expo, Brox temporal and TV-L1 with occlusions.  Every call runs
at 64x96, the batched engines on one scale, the others on two.
Tolerances: the flows agree to 1e-9 in float64 (the same arithmetic up
to rounding; today's float32 parity tests allow 1e-5 to 1e-2), except
the batched engines', which keep their float32 parity tests' EPE 0.01
(their warps and stopping rules differ in form from the JAX engines').
Stopping counts, where both packages report them, are equal or off by
one (the port compares summed squared updates with eps^2 * size, the
JAX package means with eps^2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow_torch as port
from tpuflow.models.batch import hs_pyramidal_batched as jax_hs_batched
from tpuflow.models.batch import tvl1_batched as jax_tvl1_batched
from tpuflow.models.hs_classic import hs_classic as jax_hs_classic
from tpuflow.models.hs_classic import hs_classic_batched as jax_classic_batched
from tpuflow.models.hs_pyramidal import hs_pyramidal as jax_hs_pyramidal
from tpuflow.models.tvl1 import tvl1_multiscale as jax_tvl1_multiscale
from tpuflow_torch.config import default_dtype, result_dtype
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

SCALES = 2
# the JAX batched engines' whole-pyramid programs compile for tens of
# seconds a level here: one level each
BATCHED_SCALES = 1
FLOW_ATOL = 1e-9
# the batched engines' float32 parity (tests/test_torch_tvl1.py,
# tests/test_torch_hs.py): their stopping rules and early exit differ in
# form from the JAX engines', so a warp's count may differ by one there
BATCHED_EPE = 0.01
MAX_MOTION = 3


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


@pytest.fixture(scope="module")
def pair64(solver_goldens):
    g = solver_goldens
    return (np.asarray(g["I0"], dtype=np.float64),
            np.asarray(g["I1"], dtype=np.float64))


def _batch(pair):
    I0, I1 = pair
    return np.stack([I0, I1]), np.stack([I1, I0])


def _assert_float64(out):
    assert all(o.dtype == torch.float64 for o in out), [o.dtype for o in out]


def _its_within_one(diags, jax_diags):
    for d, jd in zip(diags, jax_diags):
        its = np.asarray(d["iterations"])
        jits = np.asarray(jd["iterations"])
        assert its.shape == jits.shape
        assert np.all(np.abs(its - jits) <= 1), (its, jits)


def test_tvl1_batched_float64(pair64):
    B0, B1 = _batch(pair64)
    kw = dict(nscales=BATCHED_SCALES, max_motion=MAX_MOTION)
    out = port.tvl1_batched(B0, B1, device="cpu", **kw)
    _assert_float64(out)
    ju, jv = jax_tvl1_batched(jnp.asarray(B0), jnp.asarray(B1), **kw)
    assert ju.dtype == jnp.float64
    for b in range(2):
        assert _epe(out[0][b], out[1][b], ju[b], jv[b]) <= BATCHED_EPE


def test_hs_pyramidal_batched_float64(pair64):
    B0, B1 = _batch(pair64)
    kw = dict(nscales=BATCHED_SCALES, max_motion=MAX_MOTION)
    out = port.hs_pyramidal_batched(B0, B1, device="cpu", **kw)
    _assert_float64(out)
    ju, jv = jax_hs_batched(jnp.asarray(B0), jnp.asarray(B1), **kw)
    assert ju.dtype == jnp.float64
    for b in range(2):
        assert _epe(out[0][b], out[1][b], ju[b], jv[b]) <= BATCHED_EPE


@pytest.mark.parametrize("batched", [False, True], ids=["pair", "batched"])
def test_hs_classic_float64(pair64, batched):
    args = _batch(pair64) if batched else pair64
    fn, jfn = ((port.hs_classic_batched, jax_classic_batched)
               if batched else (port.hs_classic, jax_hs_classic))
    out = fn(*args, 20, 7.0, device="cpu")
    _assert_float64(out)
    want = jfn(*map(jnp.asarray, args), 20, 7.0)
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=0,
                                   atol=FLOW_ATOL)


@pytest.mark.parametrize("name", ["tvl1_multiscale", "hs_pyramidal"])
def test_single_pair_float64(pair64, name):
    fn, jfn = {"tvl1_multiscale": (port.tvl1_multiscale,
                                   jax_tvl1_multiscale),
               "hs_pyramidal": (port.hs_pyramidal, jax_hs_pyramidal)}[name]
    kw = dict(nscales=SCALES, clamp_scales=False, with_diag=True)
    u, v, diags = fn(*pair64, device="cpu", **kw)
    _assert_float64((u, v))
    ju, jv, jdiags = jfn(*map(jnp.asarray, pair64), **kw)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                               atol=FLOW_ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                               atol=FLOW_ATOL)
    _its_within_one(diags, jdiags)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float16])
def test_non_float32_or_64_inputs_give_default_dtype(pair64, dtype):
    I0, I1 = (np.clip(a, 0, 255).astype(dtype) for a in pair64)
    u, v = port.tvl1_batched(I0[None], I1[None], nscales=SCALES,
                             max_motion=MAX_MOTION, device="cpu")
    assert default_dtype == torch.float32
    assert u.dtype == v.dtype == default_dtype


def test_float32_inputs_stay_float32(pair64):
    I0, I1 = (a.astype(np.float32) for a in pair64)
    u, v = port.hs_classic(I0, I1, 5, 7.0, device="cpu")
    assert u.dtype == v.dtype == torch.float32


def test_result_dtype():
    f32 = torch.zeros(1, dtype=torch.float32)
    assert result_dtype() == default_dtype
    assert result_dtype(f32, np.zeros(1)) == torch.float64
    assert result_dtype(np.zeros(1, np.uint8)) == default_dtype
    assert result_dtype(f32, torch.zeros(1, dtype=torch.int64)) == torch.float32


def test_resume_state_follows_the_policy():
    state = {"u1": np.ones((2, 3)), "u2": np.ones((2, 3), np.float32),
             "oflow": np.zeros((), np.int32)}
    _, got = resume_from_jax(1, state, device="cpu")
    assert got["u1"].dtype == torch.float64
    assert got["u2"].dtype == torch.float32
    assert got["oflow"].dtype == torch.int32
