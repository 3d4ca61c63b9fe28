"""The port's single-pair solvers (`tvl1_multiscale`, `hs_pyramidal`,
`hs_classic`) against the JAX package's and the reference binary's
goldens.

Each JAX solver is called once per module, on the golden pair (64x96,
float32) with `verbose`, `with_diag` and (TV-L1) a `level_callback`, so
one compile yields the flow, the per-warp stopping counts, the stderr
lines and the level states the resume test carries across.  Those calls
take the fast warp: at 64x96 every level is below 96x96 px, so the JAX
package runs its shift path (`warp_planes_shift`) and the port K5p's
plain version.  `max_motion=3` keeps the JAX shift path's compile small;
the pair's flow stays under 3 px.  The stopping rules differ in form
(the port compares summed squared updates with eps^2 * size, the JAX
package means with eps^2), so a count may differ by one.
"""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.hs_classic import hs_classic as jax_hs_classic
from tpuflow.models.hs_pyramidal import hs_pyramidal as jax_hs_pyramidal
from tpuflow.models.tvl1 import tvl1_multiscale as jax_tvl1_multiscale
from tpuflow_torch import (hs_classic, hs_classic_batched, hs_pyramidal,
                           hs_pyramidal_batched, tvl1_batched,
                           tvl1_multiscale)
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

MAX_MOTION = 3
FAST = dict(warp_mode="fast", max_motion=MAX_MOTION)
NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


@pytest.fixture(scope="module")
def pair(solver_goldens):
    g = solver_goldens
    return g["I0"].astype(np.float32), g["I1"].astype(np.float32)


def _run(fn, *args, **kw):
    """(fn's result, its stderr lines)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args, **kw)
    return out, err.getvalue().splitlines()


def _same_lines(got, ref, count_tol=1, rel=1e-2):
    """The stderr lines agree: the same text around the numbers, equal
    integers (iteration counts within `count_tol`), and floats within
    `rel` where the counts on the line agree."""
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", r), (g, r)
        gn, rn = NUMBER.findall(g), NUMBER.findall(r)
        counts_equal = True
        for a, b in zip(gn, rn):
            if re.fullmatch(r"\d+", b):
                assert abs(int(a) - int(b)) <= count_tol, (g, r)
                counts_equal &= a == b
            elif counts_equal:
                assert float(a) == pytest.approx(float(b), rel=rel, abs=2e-6), (g, r)


@pytest.fixture(scope="module")
def jax_tvl1(pair):
    """(u, v, diags, stderr lines, {scale: level state}) of one JAX
    tvl1_multiscale call."""
    states = {}
    (u, v, diags), lines = _run(
        jax_tvl1_multiscale, *map(jnp.asarray, pair), verbose=True,
        with_diag=True, level_callback=states.__setitem__, **FAST)
    states = {s: {k: np.asarray(a) for k, a in st.items()}
              for s, st in states.items()}
    return np.asarray(u), np.asarray(v), diags, lines, states


def test_tvl1_multiscale_matches_jax(pair, jax_tvl1):
    ju, jv, jdiags, jlines, _ = jax_tvl1
    (u, v, diags), lines = _run(tvl1_multiscale, *pair, verbose=True,
                                with_diag=True, device="cpu", **FAST)
    assert u.dtype == torch.float32 and u.shape == pair[0].shape
    assert _epe(u, v, ju, jv) <= 1e-3
    assert len(diags) == len(jdiags) == 3  # clamp_nscales at 64x96
    for d, jd in zip(diags, jdiags):
        n, jn = d["iterations"].numpy(), np.asarray(jd["iterations"])
        assert n.dtype == np.int32 and n.shape == jn.shape == (5,)
        assert np.all(np.abs(n - jn) <= 1), (n, jn)
        np.testing.assert_allclose(d["error"].numpy(), np.asarray(jd["error"]),
                                   rtol=0.05)
    # Scale %d: %dx%d, then Warping: %d, Iterations: %d, Error: %f
    assert lines[0] == "Scale 2: 24x16" and len(lines) == 3 * 6
    _same_lines(lines, jlines, rel=0.05)


def test_tvl1_multiscale_matches_reference(pair, solver_goldens):
    """The exact warp (the CPU default) against the reference binary's
    tvl1flow at 5 unclamped scales, within the JAX package's f32 budget
    (tests/test_solvers.py)."""
    g = solver_goldens
    u, v = tvl1_multiscale(*pair, nscales=5, zfactor=0.5, warps=5,
                           clamp_scales=False, device="cpu")
    assert _epe(u, v, g["tvl1_multi_u"], g["tvl1_multi_v"]) < 5e-3


def test_tvl1_multiscale_fixed_and_routes(pair):
    """stop="fixed" passes thresh < 0 (every warp runs max_iterations);
    the plain fast call is the batched engine at B=1."""
    _, _, diags = tvl1_multiscale(*pair, stop="fixed", max_iterations=7,
                                  warps=2, with_diag=True, device="cpu",
                                  **FAST)
    assert all(d["iterations"].tolist() == [7, 7] for d in diags)
    u, v = tvl1_multiscale(*pair, device="cpu", **FAST)
    bu, bv = tvl1_batched(pair[0][None], pair[1][None],
                          max_motion=MAX_MOTION, device="cpu")
    assert torch.equal(u, bu[0]) and torch.equal(v, bv[0])
    with pytest.raises(ValueError, match="stop mode"):
        tvl1_multiscale(*pair, stop="sometimes", with_diag=True, device="cpu")


def test_tvl1_resume_from_jax_level_state(pair, jax_tvl1):
    ju, jv, _, _, states = jax_tvl1
    seen = []
    u, v = tvl1_multiscale(*pair, resume=resume_from_jax(1, states[1],
                                                         device="cpu"),
                           level_callback=lambda s, st: seen.append(s),
                           device="cpu", **FAST)
    assert seen == [0]
    assert _epe(u, v, ju, jv) <= 1e-3


@pytest.fixture(scope="module")
def jax_hs(pair):
    """(u, v, diags, stderr lines) of one JAX hs_pyramidal call."""
    (u, v, diags), lines = _run(jax_hs_pyramidal, *map(jnp.asarray, pair),
                                verbose=True, with_diag=True, **FAST)
    return np.asarray(u), np.asarray(v), diags, lines


def test_hs_pyramidal_matches_jax(pair, jax_hs):
    ju, jv, jdiags, jlines = jax_hs
    (u, v, diags), lines = _run(hs_pyramidal, *pair, verbose=True,
                                with_diag=True, device="cpu", **FAST)
    assert _epe(u, v, ju, jv) <= 1e-3
    for d, jd in zip(diags, jdiags):
        n, jn = d["iterations"].numpy(), np.asarray(jd["iterations"])
        assert n.shape == jn.shape == (10,) and np.all(np.abs(n - jn) <= 1)
    # the header, then Scale: %d %dx%d and Warping %d: Iterations %d (%g)
    assert lines[:2] == jlines[:2] == [
        "Multiscale Horn-Schunck of a 96x64 pair",
        "\ta=7 ns=3 zf=0.5 nw=10 eps=0.0001 mi=150"]
    assert len(lines) == 2 + 3 * 11
    _same_lines(lines, jlines)


def test_hs_pyramidal_matches_reference_and_routes(pair, solver_goldens):
    g = solver_goldens
    u, v = hs_pyramidal(*pair, device="cpu")  # exact warp on the CPU
    assert _epe(u, v, g["hs_pyramidal_u"], g["hs_pyramidal_v"]) <= 0.05
    u, v = hs_pyramidal(*pair, device="cpu", **FAST)
    bu, bv = hs_pyramidal_batched(pair[0][None], pair[1][None],
                                  max_motion=MAX_MOTION, device="cpu")
    assert torch.equal(u, bu[0]) and torch.equal(v, bv[0])
    _, _, diags = hs_pyramidal(*pair, stop="fixed", maxiter=6, warps=2,
                               with_diag=True, device="cpu", **FAST)
    assert all(d["iterations"].tolist() == [6, 6] for d in diags)


def test_hs_classic_matches_jax_and_reference(pair, solver_goldens):
    """K6's plain version at B=1 and the reference-form loop against the
    JAX XLA loop and the reference binary (niter 100, alpha 20)."""
    g = solver_goldens
    ju, jv = jax_hs_classic(*map(jnp.asarray, pair), 100, 20.0, fused=False)
    u, v = hs_classic(*pair, 100, 20.0, device="cpu")
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert _epe(u, v, g["hs_classic_u"], g["hs_classic_v"]) < 1e-4
    bu, bv = hs_classic_batched(pair[0][None], pair[1][None], 100, 20.0,
                                device="cpu")
    assert torch.equal(u, bu[0]) and torch.equal(v, bv[0])
    ru, rv = hs_classic(*pair, 100, 20.0, fused=False, device="cpu")
    np.testing.assert_allclose(ru.numpy(), u.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rv.numpy(), v.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("solver", [
    lambda p: tvl1_multiscale(*p),
    lambda p: hs_pyramidal(*p, verbose=True),
    lambda p: hs_classic(*p, 10, 7.0),
])
def test_no_silent_cpu_fallback(pair, monkeypatch, solver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver(pair)
