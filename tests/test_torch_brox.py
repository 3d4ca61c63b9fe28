"""The port's Brox spatial and robust-expo solvers against the JAX
package's and the reference binary's goldens (tests/goldens/brox.npz,
robust_expo.npz: the 64x96 pair).

One JAX call per solver is shared by the module (float32, nscales 3,
`with_diag`); the robust-expo call also hands out its level states
through `level_callback`, which the resume test carries across.  On the
CPU both packages take the exact gather warp ("auto" resolves to
"exact"), the JAX package solves with its XLA `_sor_sweep` loop and the
port with K7's plain version (the TPU kernel's arithmetic: reciprocals
instead of quotients), so the flows agree to rounding and the sweep
counts to within one.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.brox_spatial import brox_spatial as jax_brox_spatial
from tpuflow.models.robust_expo import robust_expo as jax_robust_expo
from tpuflow_torch import brox_spatial, robust_expo
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

SCALES = 3
# float32 on both sides, reciprocal against quotient in the SOR: the
# flows of a 3-level solve agree far inside the 0.05 parity budget
EPE_JAX = 2e-3


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


def _goldens(name):
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(np.load(os.path.join(here, "goldens", f"{name}.npz")))


def _f32(*arrays):
    return tuple(np.asarray(a, dtype=np.float32) for a in arrays)


def _its_within_one(diags, jax_diags):
    for d, jd in zip(diags, jax_diags):
        its = d["iterations"].numpy()
        assert its.shape == np.asarray(jd["iterations"]).shape
        assert np.all(np.abs(its - np.asarray(jd["iterations"])) <= 1)
        assert np.all((1 <= its) & (its < 300))


@pytest.fixture(scope="module")
def brox_pair():
    g = _goldens("brox")
    return _f32(g["I0"], g["I1"]), g


@pytest.fixture(scope="module")
def jax_brox(brox_pair):
    (I0, I1), _ = brox_pair
    u, v, diags = jax_brox_spatial(jnp.asarray(I0), jnp.asarray(I1),
                                   nscales=SCALES, clamp_scales=False,
                                   with_diag=True)
    return np.asarray(u), np.asarray(v), diags


def test_brox_matches_jax_and_reference(brox_pair, jax_brox):
    (I0, I1), g = brox_pair
    ju, jv, jdiags = jax_brox
    u, v, diags = brox_spatial(I0, I1, nscales=SCALES, clamp_scales=False,
                               with_diag=True, device="cpu")
    assert u.dtype == torch.float32 and u.shape == I0.shape
    assert _epe(u, v, ju, jv) <= EPE_JAX
    _its_within_one(diags, jdiags)
    assert all(int(d["warp_overflow_tiles"]) == 0 for d in diags)
    # as tests/test_brox.py holds the JAX package's float32 path
    assert _epe(u, v, g["spatial_s3_u"], g["spatial_s3_v"]) <= 1e-2


@pytest.fixture(scope="module")
def re_goldens():
    return _goldens("robust_expo")


@pytest.fixture(scope="module")
def jax_re(re_goldens):
    """(u, v, diags, {scale: level state}) of one JAX robust_expo call,
    gray, method 1."""
    states = {}
    I0, I1 = _f32(re_goldens["I0"], re_goldens["I1"])
    u, v, diags = jax_robust_expo(
        jnp.asarray(I0), jnp.asarray(I1), method_type=1, nscales=SCALES,
        clamp_scales=False, with_diag=True,
        level_callback=lambda s, st: states.__setitem__(
            s, {k: np.asarray(a) for k, a in st.items()}))
    return np.asarray(u), np.asarray(v), diags, states


def test_robust_expo_matches_jax_and_reference(re_goldens, jax_re):
    g = re_goldens
    ju, jv, jdiags, _ = jax_re
    I0, I1 = _f32(g["I0"], g["I1"])
    u, v, diags = robust_expo(I0, I1, method_type=1, nscales=SCALES,
                              clamp_scales=False, with_diag=True,
                              device="cpu")
    assert u.dtype == torch.float32 and u.shape == I0.shape
    assert _epe(u, v, ju, jv) <= EPE_JAX
    _its_within_one(diags, jdiags)
    for d, jd in zip(diags, jdiags):
        # the error that ended each solve is under tol, as in JAX
        assert float(d["error"].max()) <= 1e-4
        assert float(np.max(np.asarray(jd["error"]))) <= 1e-4
    assert _epe(u, v, g["gray_m1_u"], g["gray_m1_v"]) <= 1e-2


def test_robust_expo_resume_from_jax(re_goldens, jax_re):
    ju, jv, _, states = jax_re
    assert sorted(states) == [0, 1, 2] and states[1]["u1"].shape == (32, 48)
    resume = resume_from_jax(1, states[1], device="cpu")
    u, v = robust_expo(*_f32(re_goldens["I0"], re_goldens["I1"]),
                       method_type=1, nscales=SCALES, clamp_scales=False,
                       resume=resume, device="cpu")
    assert _epe(u, v, ju, jv) <= EPE_JAX


def test_robust_expo_df_auto_matches_reference(re_goldens):
    """Method 3 (DF-AUTO) exercises the sort and `searchsorted`."""
    g = re_goldens
    u, v = robust_expo(*_f32(g["I0"], g["I1"]), method_type=3,
                       nscales=SCALES, clamp_scales=False, device="cpu")
    assert _epe(u, v, g["gray_m3_u"], g["gray_m3_v"]) <= 1e-2


def test_robust_expo_rgb_single_scale(re_goldens):
    """Looser, as tests/test_robust_expo.py: the reference's RGB
    gradient and zoom paths read memory they should not."""
    g = re_goldens
    rgb0, rgb1 = (np.moveaxis(a, -1, 0) for a in _f32(g["rgb0"], g["rgb1"]))
    u, v = robust_expo(rgb0, rgb1, method_type=1, nscales=1,
                       clamp_scales=False, device="cpu")
    assert u.shape == rgb0.shape[1:]
    assert _epe(u, v, g["rgb_m1_u"], g["rgb_m1_v"]) <= 0.03


@pytest.mark.parametrize("solver", [brox_spatial, robust_expo])
def test_no_silent_cpu_fallback(brox_pair, monkeypatch, solver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver(*brox_pair[0], nscales=1)


@pytest.mark.parametrize("solver,line", [
    (brox_spatial, r"Iterations: (\d+)"),
    (robust_expo, r"Iterations: (\d+) Error: \S+"),
])
def test_verbose_lines(brox_pair, capsys, solver, line):
    """The reference binary's stdout format: `Scale: %d` per level, then
    one line per outer * inner iteration, the counts of `with_diag`."""
    I0, I1 = (a[:32, :48] for a in brox_pair[0])
    _, _, diags = solver(I0, I1, nscales=2, outer_iter=2, inner_iter=2,
                         clamp_scales=False, verbose=True, with_diag=True,
                         device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * (1 + 2 * 2)
    counts = []
    for k, text in enumerate(lines):
        if k % 5 == 0:
            assert text == f"Scale: {1 - k // 5}"
        else:
            counts.append(int(re.fullmatch(line, text).group(1)))
    assert counts == (diags[1]["iterations"].ravel().tolist()
                      + diags[0]["iterations"].ravel().tolist())
    if solver is robust_expo:
        float(lines[1].split("Error: ")[1])  # a %g float
