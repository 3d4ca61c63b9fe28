"""Resume of the port's single-pair TV-L1 (`tvl1_multiscale`), mirroring
tests/test_utils.py's checkpoint-and-resume test on the CPU.

The golden pair (64x96, float64 arrays, as the JAX test feeds it) runs
at 3 unclamped scales with a level callback that keeps each level's
state.  Resuming from the coarsest level, in JAX's form (scale, u1, u2)
or in the port's (scale, {"u1": ..., "u2": ...}), must reproduce the
uninterrupted run exactly (the entry point computes in float32, so the
resumed levels repeat the same float32 arithmetic).  JAX's own
`tvl1_multiscale`, resumed with the same 3-tuple, is held to the port's
at the parity tolerance of tests/test_torch_single_pair.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.tvl1 import tvl1_multiscale as jax_tvl1_multiscale
from tpuflow_torch import tvl1_multiscale

torch.set_num_threads(2)

KW = dict(nscales=3, clamp_scales=False)


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


@pytest.fixture(scope="module")
def full_run(solver_goldens):
    """(I0, I1, u, v, {scale: (u1, u2)}) of one uninterrupted port run."""
    g = solver_goldens
    I0, I1 = g["I0"], g["I1"]
    states = {}
    u, v = tvl1_multiscale(
        I0, I1, device="cpu",
        level_callback=lambda s, st: states.__setitem__(
            s, (st["u1"].clone(), st["u2"].clone())), **KW)
    return I0, I1, u, v, states


def test_full_run_visits_every_level(full_run):
    I0, _, u, v, states = full_run
    assert sorted(states) == [0, 1, 2]
    assert u.shape == I0.shape and bool(torch.isfinite(u).all())
    # the finest level's state is the result
    assert torch.equal(states[0][0], u) and torch.equal(states[0][1], v)


@pytest.mark.parametrize("form", ["jax_tuple", "state_dict"])
def test_resume_reproduces_full_run(full_run, form):
    I0, I1, u_full, v_full, states = full_run
    u1, u2 = (t.numpy().astype(np.float64) for t in states[2])
    resume = ((2, u1, u2) if form == "jax_tuple"
              else (2, {"u1": u1, "u2": u2}))
    seen = []
    u, v = tvl1_multiscale(I0, I1, device="cpu", resume=resume,
                           level_callback=lambda s, st: seen.append(s), **KW)
    assert seen == [1, 0]
    np.testing.assert_allclose(u.numpy(), u_full.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), v_full.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bad", [(2,), (2, "u1"), [2, 1, 2, 3], "2"])
def test_resume_rejects_other_forms(full_run, bad):
    I0, I1 = full_run[:2]
    with pytest.raises(ValueError, match=r"\(scale, u1, u2\)"):
        tvl1_multiscale(I0, I1, device="cpu", resume=bad, **KW)


def test_resume_matches_jax(full_run):
    """JAX's tvl1_multiscale resumed with the same (scale, u1, u2), both
    on the exact warp (their CPU default): EPE <= 1e-3, as the port's
    single-pair TV-L1 is held to JAX's."""
    I0, I1, _, _, states = full_run
    u1, u2 = (t.numpy().astype(np.float32) for t in states[2])
    f32 = [np.asarray(a, np.float32) for a in (I0, I1)]
    ju, jv = jax_tvl1_multiscale(*map(jnp.asarray, f32),
                                 resume=(2, jnp.asarray(u1), jnp.asarray(u2)),
                                 **KW)
    u, v = tvl1_multiscale(*f32, device="cpu", resume=(2, u1, u2), **KW)
    assert _epe(u, v, ju, jv) <= 1e-3
