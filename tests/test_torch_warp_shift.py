"""K5p, the shift-window bounded warp, against the JAX package.

K5p (`warp_planes_shift_batched`) is the function of the TPU warp
kernel's mode "planes" (`warp_planes_pallas_batched(...,
fast_only=False)`) and of the XLA shift path `warp_planes_shift`: no
strict bound, each tap counted where its offset from the pixel lies in
[-dmax-1, dmax+2], so pixels up to 3 px past dmax keep partial taps.
The JAX package's `warp_planes_bounded` sends planes below 96x96 px and
every `border_out=False` call there; the port's must do the same, while
K5 (`fast_only`, the default) keeps its strict zeros on larger planes.

Flows are made with numpy from a seed: a smooth field plus bands at
dmax-0.5 ... dmax+4.5 px on both signs of both axes, so every side of
the asymmetric window is crossed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.ops.interp import warp_planes_bounded as jax_warp_planes_bounded
from tpuflow.ops.interp import warp_planes_shift as jax_warp_planes_shift
from tpuflow.ops.warp_pallas import warp_planes_pallas
from tpuflow_torch.ops.interp import warp_planes_bounded, warp_planes_shift
from tpuflow_torch.ops.warp import (warp_planes_plain,
                                    warp_planes_shift_batched,
                                    warp_planes_shift_plain)
from tpuflow_torch.utils import trace

torch.set_num_threads(2)

OFFSETS = (-0.5, 0.5, 1.5, 2.5, 3.5, 4.5)  # past dmax, in px


def _case(ny, nx, dmax, n_planes=3, seed=0, scale=1.0):
    """(planes (P, ny, nx), u, v) float64 numpy: smooth planes, a flow of
    amplitude 0.8 px with bands of |u| (columns) and |v| (rows) at
    dmax + each of OFFSETS, on both signs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    planes = np.stack([scale * (np.sin(xx / (5 + k) + k) * np.cos(yy / (4 + k))
                                + 0.3 * rng.standard_normal((ny, nx)))
                       for k in range(n_planes)])
    u = 0.8 * np.sin(yy / 7 + xx / 11)
    v = 0.8 * np.cos(xx / 9 - yy / 5)
    bands = [s * (dmax + d) for d in OFFSETS for s in (1, -1)]
    for k, mag in enumerate(bands, start=1):
        c = k * nx // (len(bands) + 1)
        r = k * ny // (len(bands) + 1)
        u[:, c:c + 3] = mag + 0.1 * np.sin(yy[:, c:c + 3] / 3)
        v[r:r + 2, :] = mag + 0.1 * np.cos(xx[r:r + 2] / 3)
    return planes, u, v


def _torch(*arrays, dtype=torch.float64):
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
            for a in arrays]


@pytest.mark.parametrize("border_out", [True, False])
@pytest.mark.parametrize("ny,nx,dmax", [(55, 128, 3), (64, 96, 5)])
def test_plain_matches_warp_planes_shift(ny, nx, dmax, border_out):
    """In float64 the plain K5p is JAX's `warp_planes_shift`, past the
    bound included; and it differs from K5 there."""
    planes, u, v = _case(ny, nx, dmax, seed=ny)
    ref = np.asarray(jax_warp_planes_shift(
        *map(jnp.asarray, (planes, u, v)), dmax, border_out=border_out))
    p, uu, vv = _torch(planes, u, v)
    uv = torch.stack([uu, vv])[None]
    got, oflow = warp_planes_shift_plain(p[None], uv, dmax, border_out)
    assert oflow == 0
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=0, atol=1e-10)
    past = np.maximum(np.abs(np.floor(np.arange(nx) + u) - np.arange(nx)),
                      np.abs(np.floor(np.arange(ny)[:, None] + v)
                             - np.arange(ny)[:, None])) > dmax
    partial = past & (np.abs(ref[0]) > 1e-3)
    assert partial.sum() > 50  # the band past dmax keeps partial taps
    strict, _ = warp_planes_plain(p[None], uv, dmax)
    assert float(strict[0, 0][torch.from_numpy(partial)].abs().max()) == 0.0
    if not border_out:
        # the Neumann-clamped rim is kept, not zeroed
        rim = (np.arange(nx) + u < 1) & ~past
        assert np.abs(ref[0][rim]).max() > 1e-3


def test_plain_matches_pallas_planes_mode():
    """The plain K5p against the TPU kernel's mode "planes"
    (`fast_only=False`, interpret mode, small tile), as
    tests/test_fast_warp.py runs it."""
    dmax = 3
    planes, u, v = _case(32, 128, dmax, seed=7)
    ref = np.asarray(warp_planes_pallas(*map(jnp.asarray, (planes, u, v)),
                                        dmax, tile=(16, 128), fast_only=False))
    p, uu, vv = _torch(planes, u, v)
    got, _ = warp_planes_shift_plain(p[None], torch.stack([uu, vv])[None],
                                     dmax)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("border_out", [True, False])
@pytest.mark.parametrize("ny,nx,dmax", [(55, 128, 3), (28, 64, 3)])
def test_bounded_matches_jax_below_96x96(ny, nx, dmax, border_out):
    """The solvers' entry below 96x96 px, float32: the port's
    `warp_planes_bounded` is JAX's (the shift path), where the strict K5
    would give 0 past dmax and `border_out=False` was refused."""
    planes, u, v = _case(ny, nx, dmax, seed=ny + 1, scale=4.0)
    f32 = [a.astype(np.float32) for a in (planes, u, v)]
    ref = np.asarray(jax_warp_planes_bounded(*map(jnp.asarray, f32), dmax,
                                             border_out=border_out))
    got, oflow = warp_planes_bounded(*_torch(*f32, dtype=torch.float32), dmax,
                                     border_out=border_out, with_overflow=True)
    assert oflow == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), warp_planes_shift(*_torch(*f32, dtype=torch.float32),
                                       dmax, border_out).numpy())


def test_k5_keeps_strict_zeros_from_96x96(monkeypatch):
    """At >= 96x96 px `warp_planes_bounded` runs K5 (strict: 0 past dmax)
    by default, and K5p with `fast_only=False` or TPUFLOW_WARP_EXACT."""
    monkeypatch.delenv("TPUFLOW_WARP_EXACT", raising=False)
    dmax = 4
    planes, u, v = _case(96, 128, dmax, seed=3)
    p, uu, vv = _torch(planes, u, v, dtype=torch.float32)
    uv = torch.stack([uu, vv])[None]
    strict, _ = warp_planes_plain(p[None], uv, dmax)
    shift, _ = warp_planes_shift_plain(p[None], uv, dmax)
    got = warp_planes_bounded(p, uu, vv, dmax)
    assert torch.equal(got, strict[0])
    past = (strict[0, 0] == 0) & (shift[0, 0].abs() > 1e-3)
    assert int(past.sum()) > 50
    assert torch.equal(warp_planes_bounded(p, uu, vv, dmax, fast_only=False),
                       shift[0])
    monkeypatch.setenv("TPUFLOW_WARP_EXACT", "1")
    assert torch.equal(warp_planes_bounded(p, uu, vv, dmax), shift[0])
    # border_out=False always takes the shift path, whatever the size
    monkeypatch.delenv("TPUFLOW_WARP_EXACT")
    keep, _ = warp_planes_shift_plain(p[None], uv, dmax, border_out=False)
    assert torch.equal(warp_planes_bounded(p, uu, vv, dmax, border_out=False),
                       keep[0])


def test_in_bound_flows_agree_with_k5():
    """Within the bound the two warps are one function: in float32 the
    plain K5p equals the plain K5 bit for bit (same taps, same order)."""
    planes, u, v = _case(40, 64, 8, seed=11)
    p, uu, vv = _torch(planes, u, v, dtype=torch.float32)
    uv = torch.stack([uu, vv])[None].clamp(-8, 8)
    a, _ = warp_planes_plain(p[None], uv, 9)
    b, _ = warp_planes_shift_plain(p[None], uv, 9)
    assert torch.equal(a, b)


def test_shift_wrapper_rejects_bad_input():
    planes, u, v = _case(9, 12, 2)
    p, uu, vv = _torch(planes, u, v, dtype=torch.float32)
    uv = torch.stack([uu, vv])[None]
    with pytest.raises(TypeError):
        warp_planes_shift_batched(p[None].double(), uv, 2)
    with pytest.raises(ValueError):
        warp_planes_shift_batched(p[None], uv[:, :, :-1], 2)
    with pytest.raises(ValueError, match="unsupported device"):
        warp_planes_shift_batched(p[None].to("meta"), uv.to("meta"), 2)
    # the CPU launches nothing
    assert not [k for k in trace.counters()
                if k.startswith("calls.warp_planes_shift_batched")]
