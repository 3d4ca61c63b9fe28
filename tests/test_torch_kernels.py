"""The plain versions of the port's two kernels against the JAX package's
Pallas kernels, run in interpret mode as tests/test_fast_warp.py and
tests/test_tpu_kernels.py run them on the CPU.

K1 is the fused warp + TV-L1 constants (`warp_const_batched`, TPU
`warp_const_pallas_batched` mode "tvl1"); K2 is one warp's TV-L1 fixed
point with per-sample stopping (`tvl1_iterate_error`, TPU
`tvl1_iterate_error_padded`).  Inputs are made with numpy from a seed,
cast to float32 and handed to both sides; each JAX kernel is called
once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.tvl1 import _inner_step as jax_inner_step
from tpuflow.ops.tvl1_pallas import pad_hw, tvl1_iterate_error_padded
from tpuflow.ops.warp_pallas import warp_const_pallas_batched
from tpuflow_torch.models.tvl1 import _inner_step as inner_step
from tpuflow_torch.ops.interp import warp_planes
from tpuflow_torch.ops.tvl1 import tvl1_iterate_error, tvl1_iterate_error_plain
from tpuflow_torch.ops.warp import warp_const_batched, warp_const_plain

torch.set_num_threads(2)

B, NY, NX, DMAX = 2, 30, 120, 3
L_T, THETA, TAUT = 0.15 * 0.3, 0.3, 0.25 / 0.3


def _smooth(rng, shape, scale):
    """Low-pass random field (the texture class of bench.py's pairs)."""
    noise = rng.standard_normal(shape)
    fy = np.fft.fftfreq(shape[-2])[:, None]
    fx = np.fft.fftfreq(shape[-1])[None, :]
    f = np.real(np.fft.ifft2(np.fft.fft2(noise) * np.exp(-(fx**2 + fy**2) * 200.0)))
    return scale * f / np.abs(f).max()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
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
    planes, uv, aux = inputs
    const_p, flags = warp_const_pallas_batched(
        jnp.asarray(planes), pad_hw(jnp.asarray(uv), 32),
        pad_hw(jnp.asarray(aux), 32), DMAX, "tvl1", NY, NX, tile=(32, 128),
        rbud=1, interpret=True)
    assert int(np.sum(np.asarray(flags))) == 0
    return np.ascontiguousarray(np.asarray(const_p)[:, :, :NY, :NX])


def test_warp_const_matches_pallas(inputs, jax_const):
    planes, uv, aux = inputs
    const, oflow = warp_const_batched(*map(torch.from_numpy, inputs), DMAX)
    assert oflow == 0
    assert const.dtype == torch.float32 and const.shape == (B, 4, NY, NX)
    np.testing.assert_allclose(const.numpy(), jax_const, rtol=2e-5, atol=2e-3)


def test_warp_const_matches_exact_warp(inputs):
    """In float64 the plain K1 is the exact bicubic warp (the trunc
    anchor of `warp_planes` equals the floor anchor for in-domain
    pixels) followed by the constant assembly; past the dmax bound every
    warped plane is 0."""
    planes, uv, aux = (torch.from_numpy(a).double() for a in inputs)
    uv = uv.clone()
    # columns 40-49 of sample 0 move 3.5 px (in bound: floor offset 3),
    # columns 80-89 move 4.2 px (past the bound)
    uv[0, 0, :, 40:50] = 3.5
    uv[0, 0, :, 80:90] = 4.2
    const, _ = warp_const_plain(planes, uv, aux, DMAX)
    for b in range(B):
        u, v = uv[b]
        iw, iwx, iwy = warp_planes(planes[b], u, v, border_out=True)
        ref = torch.stack([iwx, iwy, iw - iwx * u - iwy * v - aux[b],
                           iwx * iwx + iwy * iwy])
        if b == 0:
            ref[:2, :, 80:90] = 0
            ref[2, :, 80:90] = -aux[b, :, 80:90]
            ref[3, :, 80:90] = 0
        np.testing.assert_allclose(const[b].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-10)
    interior = (slice(2, NY - 3), slice(40, 50))
    assert torch.all(const[0, 3][interior] > 0)
    assert torch.all(const[0, :2, :, 80:90] == 0)


def test_warp_const_rejects_bad_input(inputs):
    planes, uv, aux = map(torch.from_numpy, inputs)
    with pytest.raises(TypeError):
        warp_const_batched(planes.double(), uv, aux, DMAX)
    with pytest.raises(ValueError):
        warp_const_batched(planes[:, :2], uv, aux, DMAX)
    with pytest.raises(ValueError):
        warp_const_batched(planes.transpose(2, 3), uv, aux, DMAX)


def _state0(uv):
    return np.concatenate([uv, np.zeros((B, 4, NY, NX), np.float32)], axis=1)


def test_tvl1_iterate_matches_inner_step(jax_const):
    """In float64, 8 fixed iterations of the plain K2 (the TPU kernel's
    arithmetic: reciprocals, sqrt) equal 8 reference-shaped
    `_inner_step`s (quotients, hypot); the port's `_inner_step` equals
    the JAX package's."""
    rng = np.random.default_rng(5)
    state = rng.standard_normal((B, 6, NY, NX)) * 0.5
    const = jax_const.astype(np.float64)
    out, err, n = tvl1_iterate_error_plain(torch.from_numpy(state.copy()),
                                           torch.from_numpy(const), -1.0, 8,
                                           L_T, THETA, TAUT)
    assert n.tolist() == [8] * B
    c = [torch.from_numpy(const[:, k]) for k in range(4)]
    s = list(torch.from_numpy(state).unbind(1))
    first = inner_step(*s, *c, L_T, THETA, TAUT)
    j_first = jax_inner_step(*(jnp.asarray(a.numpy()) for a in s + c),
                             L_T, THETA, TAUT)
    for a, b in zip(first, j_first):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)
    for _ in range(8):
        prev = s[:2]
        s = list(inner_step(*s, *c, L_T, THETA, TAUT)[:6])
    np.testing.assert_allclose(out.numpy(), torch.stack(s, dim=1).numpy(),
                               rtol=0, atol=1e-10)
    # err: the last iteration's summed (not mean) squared update
    ref_err = ((s[0] - prev[0]) ** 2 + (s[1] - prev[1]) ** 2).sum((-2, -1))
    np.testing.assert_allclose(err.numpy(), ref_err.numpy(), rtol=1e-9)


@pytest.mark.parametrize("mode", ["error", "fixed"])
def test_tvl1_iterate_matches_pallas(inputs, jax_const, mode):
    """stop on err <= 1e-4 * size within 300 iterations, or exactly 8
    iterations (thresh < 0, as tests/test_tpu_kernels.py checks).  The
    port sums err in another order than XLA, so where err lands next to
    thresh a sample's n may differ by one; the states are compared
    where n agrees."""
    _, uv, _ = inputs
    thresh, max_iter = (1e-4 * NY * NX, 300) if mode == "error" else (-1.0, 8)
    state0 = _state0(uv)
    j_state, j_err, j_n = tvl1_iterate_error_padded(
        pad_hw(jnp.asarray(state0)), pad_hw(jnp.asarray(jax_const)), NY, NX,
        thresh, max_iter, L_T, THETA, TAUT, interpret=True)
    j_state = np.asarray(j_state)[:, :, :NY, :NX]
    j_n = np.asarray(j_n)

    state = torch.from_numpy(state0.copy())
    out, err, n = tvl1_iterate_error(state, torch.from_numpy(jax_const),
                                     thresh, max_iter, L_T, THETA, TAUT)
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
    np.testing.assert_allclose(err.numpy()[same], np.asarray(j_err)[same],
                               rtol=1e-3)
