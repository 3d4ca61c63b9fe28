"""The plain versions of the port's Horn-Schunck kernels against the JAX
package's Pallas kernels, run in interpret mode as
tests/test_tpu_kernels.py runs them on the CPU, and against the
reference-form sweeps.

K3 is the fused warp + HS constants (`warp_const_hs_batched`, TPU
`warp_const_pallas_batched` mode "hs"); K4 is one warp's 4-color SOR
with per-sample stopping (`hs_sor_error`, TPU `hs_sor_error_quarters`);
K6 is classic HS's Jacobi solve (`hs_classic_fused`, TPU
`hs_classic_fused`).  The height is odd, so the last row has even
parity, as at the bench geometry's 109- and 55-row levels.  Inputs are
made with numpy from a seed, cast to float32 and handed to both sides;
each JAX kernel is called once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.hs_pyramidal import _four_colors as jax_four_colors
from tpuflow.models.hs_pyramidal import _sor_sweep as jax_sor_sweep
from tpuflow.ops.hs_classic_pallas import hs_classic_fused as jax_hs_classic
from tpuflow.ops.hs_pallas import (from_quarters, hs_sor_error_quarters,
                                   pad_hw_q, to_quarters)
from tpuflow.ops.warp_pallas import warp_const_pallas_batched
from tpuflow_torch.models.hs_pyramidal import _four_colors, _sor_sweep
from tpuflow_torch.ops.hs import hs_sor_error, hs_sor_error_plain
from tpuflow_torch.ops.hs_classic import hs_classic_fused, hs_classic_fused_plain
from tpuflow_torch.ops.interp import warp_planes
from tpuflow_torch.ops.warp import warp_const_hs_batched, warp_const_plain

torch.set_num_threads(2)

B, NY, NX, DMAX = 2, 29, 120, 3
ALPHA = 7.0
ALPHA2 = ALPHA * ALPHA


def _smooth(rng, shape, scale):
    """Low-pass random field (the texture class of bench.py's pairs)."""
    noise = rng.standard_normal(shape)
    fy = np.fft.fftfreq(shape[-2])[:, None]
    fx = np.fft.fftfreq(shape[-1])[None, :]
    f = np.real(np.fft.ifft2(np.fft.fft2(noise) * np.exp(-(fx**2 + fy**2) * 200.0)))
    return scale * f / np.abs(f).max()


@pytest.fixture(scope="module")
def inputs():
    """(planes = (I2, I2x, I2y), uv, aux = I1), float32 numpy."""
    rng = np.random.default_rng(13)
    planes = np.stack([np.stack([128 + _smooth(rng, (NY, NX), 100),
                                 _smooth(rng, (NY, NX), 20),
                                 _smooth(rng, (NY, NX), 20)])
                       for _ in range(B)]).astype(np.float32)
    aux = (128 + _smooth(rng, (B, NY, NX), 100)).astype(np.float32)
    # smooth flow of amplitude <= 1 px: the TPU kernel's two +-1 windows
    # cover every tile, so it computes the exact bounded warp
    yy, xx = np.mgrid[0:NY, 0:NX].astype(np.float64)
    uv = np.stack([np.stack([np.sin(xx / 20 + b), 0.75 * np.cos(yy / 10 + b)])
                   for b in range(B)]).astype(np.float32)
    return planes, uv, aux


@pytest.fixture(scope="module")
def jax_const(inputs):
    """K3 of the TPU kernel in interpret mode, on the quarter-padded
    layout its caller uses, cut back to the image."""
    planes, uv, aux = inputs
    const_p, flags = warp_const_pallas_batched(
        jnp.asarray(planes), pad_hw_q(jnp.asarray(uv)),
        pad_hw_q(jnp.asarray(aux)), DMAX, "hs", NY, NX, tile=(32, 128),
        rbud=1, alpha2=ALPHA2, interpret=True)
    assert int(np.sum(np.asarray(flags))) == 0
    return np.ascontiguousarray(np.asarray(const_p)[:, :, :NY, :NX])


def _rel_err(got, ref):
    """Max abs error of each plane over that plane's largest value."""
    err = np.abs(got - ref).max(axis=(0, 2, 3))
    return err / np.maximum(np.abs(ref).max(axis=(0, 2, 3)), 1.0)


def test_warp_const_hs_matches_pallas(inputs, jax_const):
    args = [torch.from_numpy(a) for a in inputs]
    const, oflow = warp_const_hs_batched(*args, DMAX, ALPHA2)
    assert oflow == 0
    assert const.dtype == torch.float32 and const.shape == (B, 5, NY, NX)
    assert _rel_err(const.numpy(), jax_const).max() <= 1e-5
    # on the CPU the wrapper is the plain version in mode "hs"
    same, _ = warp_const_plain(*args, DMAX, "hs", ALPHA2)
    assert torch.equal(same, const)


def test_warp_const_hs_matches_exact_warp(inputs):
    """In float64 the plain K3 is the exact bicubic warp followed by the
    HS constants; past the dmax bound every warped plane is 0, so
    Au = Av = D = 0 and Du = Dv = alpha^2."""
    planes, uv, aux = (torch.from_numpy(a).double() for a in inputs)
    uv = uv.clone()
    uv[0, 0, :, 40:50] = 3.5   # in bound: floor offset 3
    uv[0, 0, :, 80:90] = 4.2   # past the bound
    const, _ = warp_const_plain(planes, uv, aux, DMAX, "hs", ALPHA2)
    for b in range(B):
        u, v = uv[b]
        iw, iwx, iwy = warp_planes(planes[b], u, v, border_out=True)
        dif = aux[b] - iw + iwx * u + iwy * v
        ref = torch.stack([dif * iwx, dif * iwy, iwx * iwx + ALPHA2,
                           iwy * iwy + ALPHA2, iwx * iwy])
        if b == 0:
            ref[:, :, 80:90] = torch.tensor([0, 0, ALPHA2, ALPHA2, 0],
                                            dtype=ref.dtype)[:, None, None]
        np.testing.assert_allclose(const[b].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-10)
    assert torch.all(const[0, 2, 2:NY - 3, 40:50] > ALPHA2)


def test_warp_const_rejects_bad_input(inputs):
    planes, uv, aux = map(torch.from_numpy, inputs)
    with pytest.raises(ValueError, match="unknown mode"):
        warp_const_plain(planes, uv, aux, DMAX, mode="brox")
    meta = [t.to("meta") for t in (planes, uv, aux)]
    with pytest.raises(ValueError, match="unsupported device"):
        warp_const_hs_batched(*meta, DMAX, ALPHA2)


def _state0(uv):
    return np.ascontiguousarray(uv * 0.5)


@pytest.fixture(scope="module", params=["fixed", "error"])
def jax_sor(request, inputs, jax_const):
    """(mode, thresh, max_iter, state, err, n) of the TPU kernel in
    interpret mode: exactly 8 sweeps (thresh < 0), or the stopping rule
    at thresh = tol^2 * size with tol = 1e-3 within 150 sweeps."""
    mode = request.param
    thresh, max_iter = ((-1.0, 8) if mode == "fixed"
                        else (float(np.float32(1e-6) * NY * NX), 150))
    sq = to_quarters(pad_hw_q(jnp.asarray(_state0(inputs[1]))))
    cq = to_quarters(pad_hw_q(jnp.asarray(jax_const)))
    out_q, err, n = hs_sor_error_quarters(sq, cq, NY, NX, thresh, max_iter,
                                          ALPHA2, interpret=True)
    state = np.asarray(from_quarters(out_q))[:, :, :NY, :NX]
    return mode, thresh, max_iter, state, np.asarray(err), np.asarray(n)


def test_hs_sor_matches_pallas(inputs, jax_const, jax_sor):
    """The port sums err in another order than XLA, so where err lands
    next to thresh a sample's n may differ by one; the states are
    compared where n agrees."""
    mode, thresh, max_iter, j_state, j_err, j_n = jax_sor
    state = torch.from_numpy(_state0(inputs[1]).copy())
    out, err, n = hs_sor_error(state, torch.from_numpy(jax_const), thresh,
                               max_iter, ALPHA2)
    assert out.data_ptr() == state.data_ptr()  # updated in place
    assert n.dtype == torch.int32 and err.shape == (B,)
    if mode == "fixed":
        assert n.tolist() == [8] * B and j_n.tolist() == [8] * B
    else:
        assert all(1 < k < max_iter for k in j_n), j_n
    assert np.all(np.abs(n.numpy() - j_n) <= 1), (n, j_n)
    same = n.numpy() == j_n
    assert same.any()
    np.testing.assert_allclose(out.numpy()[same], j_state[same], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(err.numpy()[same], j_err[same], rtol=1e-3)


def test_hs_sor_matches_sor_sweep(inputs, jax_const):
    """In float64, 8 fixed sweeps of the plain K4 (the TPU kernel's
    arithmetic: reciprocals, separable Laplacian, in-place quarters)
    equal 8 reference-form `_sor_sweep`s of the port and of the JAX
    package (quotients, masked full planes)."""
    const = jax_const.astype(np.float64)
    state = _state0(inputs[1]).astype(np.float64)
    out, err, n = hs_sor_error_plain(torch.from_numpy(state.copy()),
                                     torch.from_numpy(const), -1.0, 8, ALPHA2)
    assert n.tolist() == [8] * B
    c = [torch.from_numpy(const[:, k]) for k in range(5)]
    u, v = torch.from_numpy(state).unbind(1)
    colors = _four_colors((NY, NX))
    jc = [jnp.asarray(const[:, k]) for k in range(5)]
    ju, jv = jnp.asarray(state[:, 0]), jnp.asarray(state[:, 1])
    j_colors = jax_four_colors((NY, NX))
    for _ in range(8):
        prev = u, v
        u, v, _ = _sor_sweep(u, v, *c, ALPHA2, colors)
        ju, jv, _ = jax_sor_sweep(ju, jv, *jc, ALPHA2, j_colors)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.numpy(), torch.stack([u, v], 1).numpy(),
                               rtol=0, atol=1e-10)
    # err: the last sweep's summed squared update, per sample
    ref_err = ((u - prev[0]) ** 2 + (v - prev[1]) ** 2).sum((-2, -1))
    np.testing.assert_allclose(err.numpy(), ref_err.numpy(), rtol=1e-9)


def test_hs_sor_rejects_bad_input(jax_const):
    const = torch.from_numpy(jax_const)
    state = torch.zeros((B, 2, NY, NX))
    with pytest.raises(TypeError):
        hs_sor_error(state.double(), const, -1.0, 1, ALPHA2)
    with pytest.raises(ValueError):
        hs_sor_error(state, const[:, :4].contiguous(), -1.0, 1, ALPHA2)
    with pytest.raises(ValueError, match="unsupported device"):
        hs_sor_error(state.to("meta"), const.to("meta"), -1.0, 1, ALPHA2)


NITER = 30


@pytest.fixture(scope="module")
def derivs():
    rng = np.random.default_rng(17)
    return tuple(_smooth(rng, (B, NY, NX), s).astype(np.float32)
                 for s in (20, 20, 10))


def test_hs_classic_matches_pallas(derivs):
    ju, jv = jax_hs_classic(*map(jnp.asarray, derivs), ALPHA, NITER,
                            interpret=True)
    u, v = hs_classic_fused(*map(torch.from_numpy, derivs), ALPHA, NITER)
    assert u.dtype == torch.float32 and u.shape == (B, NY, NX)
    scale = max(np.abs(np.asarray(ju)).max(), np.abs(np.asarray(jv)).max())
    assert scale > 0.1
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5 * scale)


def test_hs_classic_matches_reference_form(derivs):
    """In float64 the plain K6 (reciprocal, the kernel's bar order) is
    the reference-form Jacobi loop of `models.hs_classic._bar`."""
    from tpuflow_torch.models.hs_classic import _bar

    Ex, Ey, Et = (torch.from_numpy(d).double() for d in derivs)
    u, v = hs_classic_fused_plain(Ex, Ey, Et, ALPHA, NITER)
    den = ALPHA2 + Ex * Ex + Ey * Ey
    ru = torch.zeros_like(Ex)
    rv = torch.zeros_like(Ex)
    for _ in range(NITER):
        ubar, vbar = _bar(ru), _bar(rv)
        t = (Ex * ubar + Ey * vbar + Et) / den
        ru, rv = ubar - Ex * t, vbar - Ey * t
    np.testing.assert_allclose(u.numpy(), ru.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), rv.numpy(), rtol=0, atol=1e-10)


def test_hs_classic_rejects_bad_input(derivs):
    Ex, Ey, Et = map(torch.from_numpy, derivs)
    with pytest.raises(TypeError):
        hs_classic_fused(Ex.double(), Ey, Et, ALPHA, 1)
    with pytest.raises(ValueError):
        hs_classic_fused(Ex, Ey[:, :-1].contiguous(), Et, ALPHA, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        hs_classic_fused(Ex.to("meta"), Ey.to("meta"), Et.to("meta"), ALPHA, 1)
