"""The port's Horn-Schunck engines against the JAX package's and the
reference binary's goldens.

One JAX `hs_pyramidal_batched` call (B=2, 64x96, the golden pair and its
reverse, float32) is shared by the module: it runs under one `jax.jit`
with a `level_callback`, so the same compile also yields the per-level
states that the resume test carries across.  At 64x96 every level of
the JAX CPU path is below its Pallas threshold, so it runs every warp
(no early exit); the port is compared with `warp_early_exit=False`.
`max_motion=3` keeps the JAX CPU path's shift-select warp small; the
pair's flow stays under 3 px, so the bound never clips it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.batch import hs_pyramidal_batched as jax_hs_pyramidal
from tpuflow.models.batch import hs_sweep_schedule as jax_hs_sweep_schedule
from tpuflow.models.hs_classic import hs_classic_batched as jax_hs_classic
from tpuflow_torch import hs_classic_batched, hs_pyramidal_batched
from tpuflow_torch.models.batch import hs_sweep_schedule
from tpuflow_torch.ops.hs_classic import hs_classic_fused_plain
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

MAX_MOTION = 3
LEVELS = [(64, 96), (32, 48), (16, 24)]  # clamp_nscales at 64x96


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


@pytest.fixture(scope="module")
def pair(solver_goldens):
    g = solver_goldens
    I0 = np.stack([g["I0"], g["I1"]]).astype(np.float32)
    I1 = np.stack([g["I1"], g["I0"]]).astype(np.float32)
    return I0, I1


@pytest.fixture(scope="module")
def jax_run(pair):
    """(u, v, {scale: level state}) of one JAX hs_pyramidal_batched call."""

    @jax.jit
    def run(I0, I1):
        states = {}
        u, v = jax_hs_pyramidal(I0, I1, max_motion=MAX_MOTION,
                                level_callback=states.__setitem__)
        return u, v, states

    return jax.device_get(run(*map(jnp.asarray, pair)))


def test_matches_jax(pair, jax_run):
    ju, jv, _ = jax_run
    u, v, stats = hs_pyramidal_batched(*pair, max_motion=MAX_MOTION,
                                       warp_early_exit=False, device="cpu",
                                       with_stats=True)
    assert u.dtype == torch.float32 and u.shape == pair[0].shape
    for b in range(2):
        assert _epe(u[b], v[b], ju[b], jv[b]) <= 0.01
    assert int(stats["warp_overflow_tiles"]) == 0
    # every warp of every level ran, one count per sample, each a real
    # stop (the caps are 150 sweeps)
    its = stats["iterations"]
    assert sorted(its) == [0, 1, 2]
    assert all(len(w) == 10 and all(len(n) == 2 for n in w)
               for w in its.values())
    assert all(1 <= k <= 150 for w in its.values() for n in w for k in n)


def test_default_matches_reference(pair, solver_goldens):
    """The default run (early exit on, max_motion 8) against the
    reference binary's hs_pyramidal (3 scales at 64x96)."""
    g = solver_goldens
    u, v, stats = hs_pyramidal_batched(*pair, device="cpu", with_stats=True)
    assert _epe(u[0], v[0], g["hs_pyramidal_u"], g["hs_pyramidal_v"]) <= 0.05
    assert sorted(stats["iterations"]) == [0, 1, 2]
    assert all(1 <= len(w) <= 10 for w in stats["iterations"].values())


def test_resume_from_jax_level_state(pair, jax_run):
    ju, jv, states = jax_run
    state = states[1]
    assert state["oflow"].dtype == np.int32
    resume = resume_from_jax(1, state, device="cpu")
    u, v = hs_pyramidal_batched(*pair, max_motion=MAX_MOTION,
                                warp_early_exit=False, device="cpu",
                                resume=resume)
    for b in range(2):
        assert _epe(u[b], v[b], ju[b], jv[b]) <= 0.01


def test_fixed_schedule_runs(pair):
    """stop="fixed" runs every warp to its cap from `hs_sweep_schedule`,
    the JAX package's calibrated schedule (3 warps here, to keep the
    plain path short)."""
    u, v, stats = hs_pyramidal_batched(*pair, stop="fixed", warps=3,
                                       max_motion=MAX_MOTION, device="cpu",
                                       with_stats=True)
    assert torch.isfinite(u).all() and torch.isfinite(v).all()
    for scale, (ny, nx) in enumerate(LEVELS):
        assert hs_sweep_schedule(ny, nx) == jax_hs_sweep_schedule(ny, nx)
        assert (stats["iterations"][scale]
                == [[cap] * 2 for cap in hs_sweep_schedule(ny, nx)[:3]])


@pytest.mark.parametrize("engine", [
    lambda p: hs_pyramidal_batched(*p),
    lambda p: hs_classic_batched(*p, niter=10, alpha=7.0),
])
def test_no_silent_cpu_fallback(pair, monkeypatch, engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine(pair)


def test_hs_classic_matches_jax_and_reference(pair, solver_goldens):
    """At the goldens' niter=100, alpha=20: against the JAX engine (its
    Pallas kernel interpreted), and against the reference binary's
    hs_classic in float32 (EPE) and, through the plain kernel version,
    in float64 (1e-9, as tests/test_solvers.py holds the JAX package)."""
    g = solver_goldens
    ju, jv = jax_hs_classic(*map(jnp.asarray, pair), 100, 20.0)
    u, v = hs_classic_batched(*pair, niter=100, alpha=20.0, device="cpu")
    assert u.dtype == torch.float32 and u.shape == pair[0].shape
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert _epe(u[0], v[0], g["hs_classic_u"], g["hs_classic_v"]) < 1e-4

    from tpuflow_torch.models.hs_classic import _input_derivatives

    a, b = (torch.from_numpy(g[k]).double() for k in ("I0", "I1"))
    u64, v64 = hs_classic_fused_plain(*_input_derivatives(a, b), 20.0, 100)
    np.testing.assert_allclose(u64.numpy(), g["hs_classic_u"], atol=1e-9)
    np.testing.assert_allclose(v64.numpy(), g["hs_classic_v"], atol=1e-9)
