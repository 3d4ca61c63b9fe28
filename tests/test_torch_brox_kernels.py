"""The plain versions of the port's Brox-family kernels against the JAX
package's Pallas kernels, run in interpret mode as tests/test_fast_warp.py
and tests/test_brox_pallas.py run them on the CPU, and against the
reference-form pieces.

K5 is the bounded warp of P planes (`warp_planes_batched`, TPU
`warp_planes_pallas_batched` with `fast_only=True`, mode "planes_fast");
K7 is one inner iteration's red-black SOR with per-sample stopping
(`brox_sor_error`, TPU `brox_sor_error_quarters`).  Inputs are made with
numpy from a seed, cast to float32 and handed to both sides; each JAX
kernel is called once per module and case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.brox_spatial import _red_black as jax_red_black
from tpuflow.models.brox_spatial import _sor_sweep as jax_sor_sweep
from tpuflow.models.brox_spatial import psi_divergence as jax_psi_divergence
from tpuflow.ops.brox_pallas import brox_sor_error_quarters
from tpuflow.ops.gradients import dxx as jax_dxx
from tpuflow.ops.gradients import dxy as jax_dxy
from tpuflow.ops.gradients import dyy as jax_dyy
from tpuflow.ops.hs_pallas import from_quarters, pad_hw_q, to_quarters
from tpuflow.ops.warp_pallas import warp_planes_pallas_batched
from tpuflow_torch.models.brox_spatial import (_red_black, _sor_solve,
                                               _sor_sweep, psi_divergence)
from tpuflow_torch.ops.brox import brox_sor_error, brox_sor_error_plain
from tpuflow_torch.ops.gradients import dxx, dxy, dyy
from tpuflow_torch.ops.interp import (resolve_warp_mode, warp_planes,
                                      warp_planes_bounded)
from tpuflow_torch.ops.warp import (warp_planes_batched, warp_planes_plain,
                                    warp_planes_shift_plain)

torch.set_num_threads(2)

B, P, NY, NX, DMAX = 2, 6, 48, 128, 3
ALPHA = 50.0


def _smooth(rng, shape, scale):
    """Low-pass random field (the texture class of bench.py's pairs)."""
    noise = rng.standard_normal(shape)
    fy = np.fft.fftfreq(shape[-2])[:, None]
    fx = np.fft.fftfreq(shape[-1])[None, :]
    f = np.real(np.fft.ifft2(np.fft.fft2(noise) * np.exp(-(fx**2 + fy**2) * 200.0)))
    return scale * f / np.abs(f).max()


def test_second_derivatives_match_jax():
    I = np.random.default_rng(3).standard_normal((2, 9, 13))
    for fn, jfn in ((dxx, jax_dxx), (dyy, jax_dyy), (dxy, jax_dxy)):
        np.testing.assert_allclose(fn(torch.from_numpy(I)).numpy(),
                                   np.asarray(jfn(jnp.asarray(I))),
                                   rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def warp_inputs():
    """(planes (B, P, NY, NX), uv (B, 2, NY, NX)), float32 numpy: an image
    and five derivative-like planes of other scales, and a smooth flow of
    amplitude <= 1 px, so the TPU kernel's two +-1 windows cover every
    tile and it computes the exact bounded warp."""
    rng = np.random.default_rng(19)
    scales = (100, 20, 20, 5, 5, 5)
    planes = np.stack([np.stack([(128 if k == 0 else 0) + _smooth(rng, (NY, NX), s)
                                 for k, s in enumerate(scales)])
                       for _ in range(B)]).astype(np.float32)
    yy, xx = np.mgrid[0:NY, 0:NX].astype(np.float64)
    uv = np.stack([np.stack([np.sin(xx / 20 + b), 0.75 * np.cos(yy / 10 + b)])
                   for b in range(B)]).astype(np.float32)
    return planes, uv


def test_warp_planes_matches_pallas(warp_inputs):
    planes, uv = warp_inputs
    ref, flags = warp_planes_pallas_batched(
        jnp.asarray(planes), jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]),
        DMAX, fast_only=True, rbud=1, with_flags=True, interpret=True)
    assert int(np.sum(np.asarray(flags))) == 0
    ref = np.asarray(ref)
    got, oflow = warp_planes_batched(*map(torch.from_numpy, warp_inputs), DMAX)
    assert oflow == 0
    assert got.dtype == torch.float32 and got.shape == (B, P, NY, NX)
    # f32 sums of 16 taps in another order: a few ulp of each plane's scale
    err = np.abs(got.numpy() - ref).max(axis=(0, 2, 3))
    scale = np.abs(ref).max(axis=(0, 2, 3))
    assert np.all(err <= 1e-4 * scale), (err, scale)
    assert np.mean(ref[:, 0] != 0) > 0.9  # most pixels are in domain


def test_warp_planes_matches_exact_warp(warp_inputs):
    """In float64 the plain K5 is the exact bicubic warp for flows within
    the bound, and 0 past it."""
    planes, uv = (torch.from_numpy(a).double() for a in warp_inputs)
    uv = uv.clone()
    uv[0, 0, :, 40:50] = 3.5   # in bound: floor offset 3
    uv[0, 0, :, 80:90] = 4.2   # past the bound
    got, _ = warp_planes_plain(planes, uv, DMAX)
    for b in range(B):
        ref = warp_planes(planes[b], uv[b, 0], uv[b, 1], border_out=True)
        if b == 0:
            ref[:, :, 80:90] = 0.0
        np.testing.assert_allclose(got[b].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-10)
    assert torch.all(got[0, 0, 2:NY - 3, 40:50] != 0)
    # the solvers' entry: one (P, H, W) float32 stack, one flow
    p32, uv32 = planes.float(), uv.float()
    one = warp_planes_bounded(p32[1].contiguous(), uv32[1, 0], uv32[1, 1], DMAX)
    ref, _ = warp_planes_plain(p32[1:].contiguous(), uv32[1:], DMAX)
    assert torch.equal(one, ref[0])


def test_warp_mode_and_bounded_options(warp_inputs, monkeypatch):
    monkeypatch.delenv("TPUFLOW_EXACT_WARP", raising=False)
    assert resolve_warp_mode("auto", "cpu") == "exact"
    assert resolve_warp_mode("auto", "cuda") == "fast"
    assert resolve_warp_mode("fast", "cpu") == "fast"
    with pytest.raises(ValueError, match="warp_mode"):
        resolve_warp_mode("two-window", "cpu")
    monkeypatch.setenv("TPUFLOW_EXACT_WARP", "1")
    assert resolve_warp_mode("auto", "cuda") == "exact"
    assert resolve_warp_mode("fast", "cuda") == "exact"
    planes, uv = map(torch.from_numpy, warp_inputs)
    _, oflow = warp_planes_bounded(planes[0], uv[0, 0], uv[0, 1], DMAX,
                                   with_overflow=True)
    assert oflow == 0
    # border_out=False (tvl1occflow's warp) runs K5p: the out-of-domain
    # rim keeps its clamped taps instead of 0
    keep = warp_planes_bounded(planes[0], uv[0, 0], uv[0, 1], DMAX,
                               border_out=False)
    ref, _ = warp_planes_shift_plain(planes[:1], uv[:1], DMAX,
                                     border_out=False)
    assert torch.equal(keep, ref[0])
    assert bool((keep[0, :, 0] != 0).all())


def test_warp_planes_rejects_bad_input(warp_inputs):
    planes, uv = map(torch.from_numpy, warp_inputs)
    with pytest.raises(TypeError):
        warp_planes_batched(planes.double(), uv, DMAX)
    with pytest.raises(ValueError):
        warp_planes_batched(planes, uv[:, :, :-1], DMAX)
    with pytest.raises(ValueError, match="unsupported device"):
        warp_planes_batched(planes.to("meta"), uv.to("meta"), DMAX)


def _system(ny, nx, seed):
    """A Brox SOR system like tests/test_brox_pallas.py's: (state (1, 2),
    const (1, 9) = (Au, Av, Du, Dv, D, psi1..psi4)), float32 numpy."""
    rng = np.random.default_rng(seed)

    def plane(scale=1.0):
        return rng.standard_normal((ny, nx)) * scale

    psis = np.asarray(jax_psi_divergence(
        jnp.asarray(1.0 / np.sqrt(np.abs(plane()) + 0.3))))
    div_d = ALPHA * psis.sum(0)
    const = np.stack([plane(2.0), plane(2.0), np.abs(plane()) + div_d + 0.5,
                      np.abs(plane()) + div_d + 0.5, plane(0.3), *psis])
    state = np.stack([plane(0.1), plane(0.1)])
    return (state[None].astype(np.float32),
            np.ascontiguousarray(const[None].astype(np.float32)))


CASES = [(32, 256, "fixed"), (32, 256, "error"), (45, 67, "fixed"),
         (45, 67, "error")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}")
def jax_sor(request):
    """(ny, nx, thresh, max_iter, state, const, out, err, n) of the TPU
    kernel in interpret mode: exactly 4 sweeps (thresh < 0), or the
    stopping rule at tol = 1e-3 within 60 sweeps."""
    ny, nx, stop = request.param
    state, const = _system(ny, nx, seed=ny)
    thresh, max_iter = ((-1.0, 4) if stop == "fixed"
                        else (float(np.float32(1e-6 * ny * nx)), 60))
    out_q, err, n = brox_sor_error_quarters(
        to_quarters(pad_hw_q(jnp.asarray(state))),
        to_quarters(pad_hw_q(jnp.asarray(const))), ny, nx, thresh, max_iter,
        ALPHA, interpret=True)
    out = np.asarray(from_quarters(out_q))[:, :, :ny, :nx]
    return (ny, nx, thresh, max_iter, state, const, out, np.asarray(err),
            np.asarray(n))


def test_brox_sor_matches_pallas(jax_sor):
    ny, nx, thresh, max_iter, state0, const, j_out, j_err, j_n = jax_sor
    state = torch.from_numpy(state0.copy())
    out, err, n = brox_sor_error(state, torch.from_numpy(const), thresh,
                                 max_iter, ALPHA)
    assert out.data_ptr() == state.data_ptr()  # updated in place
    assert n.dtype == torch.int32 and err.shape == (1,)
    if thresh < 0:
        assert n.tolist() == [max_iter] and j_n.tolist() == [max_iter]
    else:
        assert 1 < int(j_n[0]) < max_iter, j_n
    assert n.tolist() == j_n.tolist()
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=2e-4)
    np.testing.assert_allclose(err.numpy(), j_err, rtol=1e-3)


@pytest.mark.parametrize("ny,nx", [(32, 256), (45, 67)])
def test_brox_sor_matches_sor_sweep(ny, nx):
    """In float64, 4 fixed sweeps of the plain K7 (the TPU kernel's
    arithmetic: reciprocals, in-place colors) equal 4 reference-form
    `_sor_sweep`s of the port and of the JAX package (quotients, masked
    full planes); in float32 the stopping counts of the plain K7 and of
    the port's twin loop (`_sor_solve(..., fused=False)`) agree within
    one."""
    state, const = (a.astype(np.float64) for a in _system(ny, nx, seed=ny))
    out, err, n = brox_sor_error_plain(torch.from_numpy(state.copy()),
                                       torch.from_numpy(const), -1.0, 4, ALPHA)
    assert n.tolist() == [4]
    c = [torch.from_numpy(const[0, k]) for k in range(9)]
    jc = [jnp.asarray(const[0, k]) for k in range(9)]
    du, dv = torch.from_numpy(state[0]).unbind(0)
    jdu, jdv = jnp.asarray(state[0, 0]), jnp.asarray(state[0, 1])
    colors = _red_black((ny, nx))
    j_colors = jax_red_black((ny, nx))
    for _ in range(4):
        du, dv, e = _sor_sweep(du, dv, *c[:5], ALPHA, c[5:], colors)
        jdu, jdv, _ = jax_sor_sweep(jdu, jdv, *jc[:5], ALPHA, jc[5:], j_colors)
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), rtol=0, atol=1e-10)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=0, atol=1e-10)
    np.testing.assert_allclose(out[0].numpy(), torch.stack([du, dv]).numpy(),
                               rtol=0, atol=1e-10)
    # err: the last sweep's summed squared update
    np.testing.assert_allclose(err.numpy(), [float(e)], rtol=1e-9)

    s32, c32 = _system(ny, nx, seed=ny)
    tol, size = 1e-3, ny * nx
    _, _, n_k = brox_sor_error_plain(torch.from_numpy(s32.copy()),
                                     torch.from_numpy(c32),
                                     float(np.float32(tol * tol * size)), 60,
                                     ALPHA)
    c = [torch.from_numpy(c32[0, k]) for k in range(9)]
    du, dv = torch.from_numpy(s32[0]).unbind(0)
    _, _, n_twin, err_twin = _sor_solve(du, dv, *c[:5], ALPHA, tuple(c[5:]),
                                        colors, tol, size, "error", 60,
                                        fused=False)
    assert 1 < int(n_twin) < 60 and float(err_twin) <= tol
    assert abs(int(n_k[0]) - int(n_twin)) <= 1


def test_psi_divergence_matches_jax():
    psi = np.random.default_rng(5).random((7, 10)) + 0.5
    got = psi_divergence(torch.from_numpy(psi))
    ref = jax_psi_divergence(jnp.asarray(psi))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-15)


def test_brox_sor_rejects_bad_input():
    state, const = map(torch.from_numpy, _system(9, 12, seed=1))
    with pytest.raises(TypeError):
        brox_sor_error(state.double(), const, -1.0, 1, ALPHA)
    with pytest.raises(ValueError):
        brox_sor_error(state, const[:, :5].contiguous(), -1.0, 1, ALPHA)
    with pytest.raises(ValueError, match="unsupported device"):
        brox_sor_error(state.to("meta"), const.to("meta"), -1.0, 1, ALPHA)
