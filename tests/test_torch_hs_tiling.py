"""The tile schedules of the port's two Horn-Schunck kernels, emulated
in plain PyTorch on the CPU and held equal to their plain versions.

csrc/hs_classic.cu (K6) runs `STEPS` Jacobi iterations per launch on
tiles of `TILE` pixels with a halo of `STEPS`; csrc/hs_sor.cu (K4) runs
route "tiles" as one launch per sweep on tiles of `TILE` pixels with a
halo of `HALO`, updating color k on the interior grown by 3 - k pixels.
A CUDA kernel cannot run here, so this file replays each schedule
block by block, with the geometry the wrappers state (and check
against the sources when the library loads): a block sees only its
tile and halo, every other value is NaN, and a value a block has not
brought up to date is NaN too, so a halo too narrow, a region too
large or a fold at the tile's edge instead of the image's shows as NaN
or a difference; and every value a block computes must be finite, so
a region wider than the halo (a read outside the block's shared tile on
the card) fails too.  Neighbour indices clamp at the image's rim, as
the kernels clamp them.  In float64 each emulation must equal the plain
version exactly (`torch.equal`).
"""

import math

import numpy as np
import pytest
import torch

from tpuflow_torch.ops.hs import (HALO, LEVEL_PLANES, LEVEL_SCRATCH,
                                  SOR_OMEGA, D_FLOOR, hs_sor_error_plain,
                                  hs_sor_route)
from tpuflow_torch.ops.hs import TILE as SOR_TILE
from tpuflow_torch.ops.hs_classic import STEPS, hs_classic_fused_plain
from tpuflow_torch.ops.hs_classic import TILE as CLASSIC_TILE
from tpuflow_torch.ops.hs_classic import launch_steps
from tpuflow_torch.ops.pyramid import pyramid_sizes

NAN = float("nan")
ALPHA = 7.0
# sizes no tile divides: one partial tile (7x16), partial tiles on both
# axes (37x53), several tiles each way with partial last ones (97x125)
SIZES = [(7, 16), (37, 53), (97, 125)]
H100_SMEM_OPTIN = 232448  # bytes a block may opt in to on an H100


def _span(lo, hi, n):
    """Indices lo..hi-1 that lie in 0..n-1."""
    return torch.arange(max(lo, 0), min(hi, n))


def _grid(f, rows, cols):
    return f[:, rows][:, :, cols]


def _neighbour_sums(f, rows, cols):
    """`tpuflow_torch.ops.hs.neighbour_sums` (h, hu, hd, up, dn) at the
    grid rows x cols of (B, ny, nx) `f`, indices clamped to the image."""
    ny, nx = f.shape[-2:]
    ru, rd = (rows - 1).clamp(min=0), (rows + 1).clamp(max=ny - 1)
    cl, cr = (cols - 1).clamp(min=0), (cols + 1).clamp(max=nx - 1)
    return (_grid(f, rows, cl) + _grid(f, rows, cr),
            _grid(f, ru, cl) + _grid(f, ru, cr),
            _grid(f, rd, cl) + _grid(f, rd, cr),
            _grid(f, ru, cols), _grid(f, rd, cols))


def _block_view(f, rows, cols):
    """What a block holds of `f`: its values on rows x cols, NaN elsewhere."""
    out = torch.full_like(f, NAN)
    out[:, rows[:, None], cols] = _grid(f, rows, cols)
    return out


def _tiles(ny, nx, tile):
    ty, tx = tile
    for i0 in range(0, ny, ty):
        for j0 in range(0, nx, tx):
            yield i0, j0


def _grown(i0, j0, tile, g, ny, nx):
    """Rows and columns of the interior at (i0, j0) grown by g pixels."""
    ty, tx = tile
    return _span(i0 - g, i0 + ty + g, ny), _span(j0 - g, j0 + tx + g, nx)


def classic_tiles(Ex, Ey, Et, alpha, niter):
    """K6's schedule: `launch_steps(niter)` launches; in each, every tile
    iterates on its own copy of u and v (halo STEPS) and of the
    constants (halo STEPS - 1), iteration k of s on the interior grown
    by s - k, and writes its interior."""
    ny, nx = Ex.shape[-2:]
    rden = 1.0 / (alpha * alpha + Ex * Ex + Ey * Ey)
    u = torch.zeros_like(Ex)
    v = torch.zeros_like(Ex)
    for steps in launch_steps(niter):
        nu = torch.full_like(u, NAN)
        nv = torch.full_like(v, NAN)
        for i0, j0 in _tiles(ny, nx, CLASSIC_TILE):
            halo = _grown(i0, j0, CLASSIC_TILE, STEPS, ny, nx)
            lu, lv = _block_view(u, *halo), _block_view(v, *halo)
            inner = _grown(i0, j0, CLASSIC_TILE, STEPS - 1, ny, nx)
            x, y, t0, rd = (_block_view(c, *inner) for c in (Ex, Ey, Et, rden))
            for k in range(1, steps + 1):
                rows, cols = _grown(i0, j0, CLASSIC_TILE, steps - k, ny, nx)
                h, hu, hd, up, dn = _neighbour_sums(lu, rows, cols)
                ubar = (h + up + dn) / 6.0 + (hu + hd) / 12.0
                h, hu, hd, up, dn = _neighbour_sums(lv, rows, cols)
                vbar = (h + up + dn) / 6.0 + (hu + hd) / 12.0
                xq, yq = _grid(x, rows, cols), _grid(y, rows, cols)
                t = (xq * ubar + yq * vbar + _grid(t0, rows, cols)) * _grid(rd, rows, cols)
                assert bool(torch.isfinite(t).all()), "read outside the tile"
                lu = torch.full_like(lu, NAN)
                lv = torch.full_like(lv, NAN)
                lu[:, rows[:, None], cols] = ubar - xq * t
                lv[:, rows[:, None], cols] = vbar - yq * t
            rows, cols = _grown(i0, j0, CLASSIC_TILE, 0, ny, nx)
            nu[:, rows[:, None], cols] = _grid(lu, rows, cols)
            nv[:, rows[:, None], cols] = _grid(lv, rows, cols)
        u, v = nu, nv
    return u, v


def _laplacian(f, rows, cols):
    h, hu, hd, up, dn = _neighbour_sums(f, rows, cols)
    return (hu + hd) * (1.0 / 12.0) + (h + up + dn) * (1.0 / 6.0)


def sor_tiles_sweep(u, v, au, av, rdu, rdv, dd, alpha2):
    """One sweep of K4's route "tiles": every tile updates its own copy
    of u and v (halo HALO) with its copy of the constants (halo
    HALO - 1), color k on the interior grown by 3 - k; the pixels of
    color k outside that region are stale in the block from then on
    (NaN here).  Returns the new (u, v) and the per-sample err summed
    over the interiors."""
    ny, nx = u.shape[-2:]
    w = SOR_OMEGA
    nu = torch.full_like(u, NAN)
    nv = torch.full_like(v, NAN)
    err = torch.zeros(u.shape[0], dtype=u.dtype)
    for i0, j0 in _tiles(ny, nx, SOR_TILE):
        halo = _grown(i0, j0, SOR_TILE, HALO, ny, nx)
        lu, lv = _block_view(u, *halo), _block_view(v, *halo)
        inner = _grown(i0, j0, SOR_TILE, HALO - 1, ny, nx)
        cau, cav, crdu, crdv, cdd = (_block_view(c, *inner)
                                     for c in (au, av, rdu, rdv, dd))
        for k in range(4):
            pr, pc = divmod(k, 2)
            rows, cols = _grown(i0, j0, SOR_TILE, 3 - k, ny, nx)
            rows, cols = rows[rows % 2 == pr], cols[cols % 2 == pc]
            uq, vq, ddq = (_grid(f, rows, cols) for f in (lu, lv, cdd))
            ula = _laplacian(lu, rows, cols)
            un = ((1.0 - w) * uq
                  + w * (_grid(cau, rows, cols) - ddq * vq + alpha2 * ula)
                  * _grid(crdu, rows, cols))
            lu[:, rows[:, None], cols] = un
            vla = _laplacian(lv, rows, cols)
            vn = ((1.0 - w) * vq
                  + w * (_grid(cav, rows, cols) - ddq * un + alpha2 * vla)
                  * _grid(crdv, rows, cols))
            lv[:, rows[:, None], cols] = vn
            assert bool(torch.isfinite(un).all() and torch.isfinite(vn).all()), \
                "read outside the tile"
            # color k outside its region: updated globally, not here
            hr, hc = halo
            stale = torch.zeros((ny, nx), dtype=torch.bool)
            stale[hr[hr % 2 == pr][:, None], hc[hc % 2 == pc]] = True
            stale[rows[:, None], cols] = False
            lu[:, stale] = NAN
            lv[:, stale] = NAN
        rows, cols = _grown(i0, j0, SOR_TILE, 0, ny, nx)
        du = _grid(lu, rows, cols) - _grid(u, rows, cols)
        dv = _grid(lv, rows, cols) - _grid(v, rows, cols)
        err += torch.sum(du * du + dv * dv, dim=(-2, -1))
        nu[:, rows[:, None], cols] = _grid(lu, rows, cols)
        nv[:, rows[:, None], cols] = _grid(lv, rows, cols)
    return nu, nv, err


def _smooth(rng, shape, scale):
    return torch.from_numpy(scale * rng.standard_normal(shape))


@pytest.fixture(scope="module")
def derivs():
    rng = np.random.default_rng(31)
    shape = (2,) + max(SIZES)
    return tuple(_smooth(rng, shape, s) for s in (20.0, 20.0, 10.0))


@pytest.mark.parametrize("niter", [0, 1, STEPS - 1, STEPS, 2 * STEPS + 3])
@pytest.mark.parametrize("size", SIZES)
def test_classic_tiles_equal_plain(derivs, size, niter):
    ny, nx = size
    Ex, Ey, Et = (d[:, :ny, :nx].contiguous() for d in derivs)
    u, v = classic_tiles(Ex, Ey, Et, ALPHA, niter)
    ru, rv = hs_classic_fused_plain(Ex, Ey, Et, ALPHA, niter)
    assert len(launch_steps(niter)) == math.ceil(niter / STEPS)
    assert torch.equal(u, ru) and torch.equal(v, rv)


@pytest.fixture(scope="module")
def sor_system():
    """(state (2, 2, ny, nx), const (2, 5, ny, nx)) float64, HS-shaped
    constants from random warped gradients and residuals."""
    rng = np.random.default_rng(37)
    shape = (2,) + max(SIZES)
    ix, iy = _smooth(rng, shape, 10.0), _smooth(rng, shape, 10.0)
    dif = _smooth(rng, shape, 5.0)
    alpha2 = ALPHA * ALPHA
    const = torch.stack([dif * ix, dif * iy, ix * ix + alpha2,
                         iy * iy + alpha2, ix * iy], dim=1)
    state = torch.stack([_smooth(rng, shape, 1.0), _smooth(rng, shape, 1.0)],
                        dim=1)
    return state, const


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("size", SIZES)
def test_sor_tiles_equal_plain(sor_system, size, sweeps):
    ny, nx = size
    state, const = (t[..., :ny, :nx].contiguous() for t in sor_system)
    alpha2 = ALPHA * ALPHA
    ref, ref_err, n = hs_sor_error_plain(state.clone(), const, -1.0, sweeps,
                                         alpha2)
    assert n.tolist() == [sweeps] * 2
    au, av, du, dv, dd = const.unbind(1)
    rdu = 1.0 / torch.clamp(du, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv, min=D_FLOOR)
    u, v = state[:, 0], state[:, 1]
    for _ in range(sweeps):
        u, v, err = sor_tiles_sweep(u, v, au, av, rdu, rdv, dd, alpha2)
    assert torch.equal(u, ref[:, 0]) and torch.equal(v, ref[:, 1])
    # the same squared updates, summed tile by tile
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


def test_sor_route_by_level():
    """At 1024x436 (7 levels) levels 0-2 take route "tiles", levels 3-6
    (55x128 and below) route "level", on an H100's shared memory; the
    boundary is the level's planes plus the scratch."""
    sizes = pyramid_sizes(1024, 436, 0.5, 7)
    assert [(ny, nx) for nx, ny in sizes] == [
        (436, 1024), (218, 512), (109, 256), (55, 128), (28, 64), (14, 32),
        (7, 16)]
    routes = [hs_sor_route(ny, nx, H100_SMEM_OPTIN) for nx, ny in sizes]
    assert routes == ["tiles"] * 3 + ["level"] * 4
    need = LEVEL_PLANES * 4 * 55 * 128 + LEVEL_SCRATCH
    assert hs_sor_route(55, 128, need) == "level"
    assert hs_sor_route(55, 128, need - 1) == "tiles"
