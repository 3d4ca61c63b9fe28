"""K7's route "resident" schedule, replayed tile by tile in plain
PyTorch on the CPU and held equal to the plain version.

csrc/brox_sor.cu runs a whole SOR solve in one cooperative launch: one
block per tile of `TILE` pixels per sample, du and dv in shared memory
over the tile and a halo of `HALO`.  A sweep updates the tile's red
pixels, writes the red ones on the tile's edge to the global state,
syncs the grid and reads the neighbours' red edges into its halo; then
the same for black, and the per-tile partials of the squared update are
summed in tile order for the stopping test.  A CUDA kernel cannot run
here, so this file replays that schedule block by block with the
geometry the wrapper states (and checks against the source when the
library loads): a block sees only its tile and halo, every other value
is NaN, the halo pixels of a color are NaN from the moment the
neighbours start updating that color until the block reads them back,
and the global state holds only what the blocks wrote as edges (NaN
elsewhere).  So a skipped halo read, a halo read of the wrong color, a
phase that reads its own color's neighbours or an edge not written
shows as NaN or a difference.  Neighbour indices clamp at the image's
rim, as the kernel clamps them.  In float64 the replay must equal the
plain version exactly (`torch.equal`).
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.ops.brox import (HALO, RESIDENT_SMEM, RESIDENT_THREADS,
                                    SOR_OMEGA, TILE, brox_sor_error_plain,
                                    brox_sor_route, tile_count)
from tpuflow_torch.ops.hs import D_FLOOR
from tpuflow_torch.ops.pyramid import pyramid_sizes

NAN = float("nan")
ALPHA = 50.0
# sizes no tile divides: one partial tile (7x16, 37x53), partial tiles
# on both axes with edges between tiles both ways (97x125)
SIZES = [(7, 16), (37, 53), (97, 125)]
# an H100: the shared memory a block may opt in to, an SM's shared
# memory (1 KB of it reserved per block), its SMs and its threads
H100_SMEM_OPTIN = 232448
H100_SMEM_SM = 233472
H100_SMS = 132
H100_THREADS_SM = 2048


def _tiles(ny, nx):
    """(rows, columns) of each tile in the kernel's block order."""
    ty, tx = TILE
    return [(torch.arange(i0, min(i0 + ty, ny)), torch.arange(j0, min(j0 + tx, nx)))
            for i0 in range(0, ny, ty) for j0 in range(0, nx, tx)]


def _masks(rows, cols, ny, nx):
    """Boolean (ny, nx) masks of a tile: its pixels, its pixels on the
    tile's edge, and its halo (the pixels of the image next to the tile
    across an edge, corners excluded)."""
    ty, tx = TILE
    i0, j0 = int(rows[0]), int(cols[0])
    inner = torch.zeros((ny, nx), dtype=torch.bool)
    inner[rows[:, None], cols] = True
    edge = torch.zeros_like(inner)
    ii, jj = rows[:, None], cols[None, :]
    edge[rows[:, None], cols] = ((ii == i0) | (ii == i0 + ty - 1)
                                 | (jj == j0) | (jj == j0 + tx - 1))
    halo = torch.zeros_like(inner)
    for i in (i0 - HALO, i0 + ty):
        if 0 <= i < ny:
            halo[i, cols] = True
    for j in (j0 - HALO, j0 + tx):
        if 0 <= j < nx:
            halo[rows, j] = True
    return inner, edge, halo


def _clamped(f, di, dj):
    """f(i + di, j + dj) with the indices clamped to the image."""
    ny, nx = f.shape[-2:]
    i = (torch.arange(ny) + di).clamp(0, ny - 1)
    j = (torch.arange(nx) + dj).clamp(0, nx - 1)
    return f[..., i, :][..., j]


def resident_replay(state, const, thresh, max_iter, alpha):
    """Route "resident"'s schedule on (B, 2, ny, nx) `state` and (B, 9,
    ny, nx) `const`; returns (state, err (B,), n (B,), the per-tile
    partials of the last sweep (B, tiles))."""
    B, _, ny, nx = state.shape
    w = SOR_OMEGA
    au, av, du_c, dv_c, dd = const[:, :5].unbind(1)
    psi1, psi2, psi3, psi4 = const[:, 5:].unbind(1)
    rdu = 1.0 / torch.clamp(du_c, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv_c, min=D_FLOOR)
    ii = torch.arange(ny)[:, None]
    jj = torch.arange(nx)
    color_of = (ii + jj) % 2
    tiles = [_masks(rows, cols, ny, nx) for rows, cols in _tiles(ny, nx)]
    # each block's shared copy: its tile and its black halo at the load
    local = []
    for inner, _, halo in tiles:
        loc = torch.full_like(state, NAN)
        keep = inner | (halo & (color_of == 1))
        loc[..., keep] = state[..., keep]
        local.append(loc)
    exchange = torch.full_like(state, NAN)  # what the blocks wrote as edges
    err = torch.full((B,), float("inf"), dtype=state.dtype)
    n = torch.zeros((B,), dtype=torch.int32)
    active = torch.full((B,), max_iter > 0)
    part = torch.zeros((B, len(tiles)), dtype=state.dtype)
    while bool(active.any()):
        act = active[:, None, None]
        part = torch.zeros((B, len(tiles)), dtype=state.dtype)
        for color in (0, 1):
            mine = color_of == color
            for k, (loc, (inner, edge, halo)) in enumerate(zip(local, tiles)):
                # the neighbours are updating this color: stale halo
                loc[..., halo & mine] = NAN
                upd = inner & mine
                du, dv = loc[:, 0], loc[:, 1]
                dpu = (psi1 * _clamped(du, 1, 0) + psi2 * _clamped(du, -1, 0)
                       + psi3 * _clamped(du, 0, 1) + psi4 * _clamped(du, 0, -1))
                dpv = (psi1 * _clamped(dv, 1, 0) + psi2 * _clamped(dv, -1, 0)
                       + psi3 * _clamped(dv, 0, 1) + psi4 * _clamped(dv, 0, -1))
                dun = (1.0 - w) * du + w * (au - dd * dv + alpha * dpu) * rdu
                dvn = (1.0 - w) * dv + w * (av - dd * dun + alpha * dpv) * rdv
                sq = (dun - du) ** 2 + (dvn - dv) ** 2
                part[:, k] += torch.where(upd, sq, 0.0).sum(dim=(-2, -1))
                sel = upd & act
                loc[:, 0] = torch.where(sel, dun, du)
                loc[:, 1] = torch.where(sel, dvn, dv)
                out = edge & mine & act[..., None]
                exchange = torch.where(out, loc, exchange)
            # grid sync; each block reads this color's halo back
            for loc, (_, _, halo) in zip(local, tiles):
                back = halo & mine
                loc[..., back] = exchange[..., back]
        # every sample's partials, summed in tile order
        e = torch.zeros((B,), dtype=state.dtype)
        for k in range(len(tiles)):
            e = e + part[:, k]
        err = torch.where(active, e, err)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    out = torch.full_like(state, NAN)
    for loc, (inner, _, _) in zip(local, tiles):
        out[..., inner] = loc[..., inner]
    return out, err, n, part


def _smooth(rng, shape, scale):
    return torch.from_numpy(scale * rng.standard_normal(shape))


@pytest.fixture(scope="module")
def system():
    """(state (2, 2, ny, nx), const (2, 9, ny, nx)) float64, Brox-shaped:
    constants from random warped gradients and residuals, psi_i from a
    positive robustness weight, 0 across the image boundary."""
    rng = np.random.default_rng(41)
    shape = (2,) + max(SIZES)
    ix, iy = _smooth(rng, shape, 10.0), _smooth(rng, shape, 10.0)
    dif = _smooth(rng, shape, 5.0)
    psi = 0.5 + torch.from_numpy(rng.random(shape))
    const = torch.stack([dif * ix, dif * iy, ix * ix, iy * iy, ix * iy,
                         psi, psi, psi, psi], dim=1)
    state = torch.stack([_smooth(rng, shape, 1.0), _smooth(rng, shape, 1.0)],
                        dim=1)
    return state, const


def _cut(system, size, batch):
    ny, nx = size
    state, const = (t[:batch, :, :ny, :nx].clone() for t in system)
    # psi1 (down) 0 on the last row, psi2 (up) on the first, psi3
    # (right) on the last column, psi4 (left) on the first
    const[:, 5, -1], const[:, 6, 0] = 0.0, 0.0
    const[:, 7, :, -1], const[:, 8, :, 0] = 0.0, 0.0
    # Du, Dv as the solver assembles them: the data terms plus the
    # smoothness weights' sum
    const[:, 2:4] += ALPHA * const[:, 5:].sum(dim=1, keepdim=True)
    return state.contiguous(), const.contiguous()


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("sweeps", [1, 2, 7])
@pytest.mark.parametrize("size", SIZES)
def test_resident_replay_equals_plain(system, size, sweeps, batch):
    state, const = _cut(system, size, batch)
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, -1.0,
                                               sweeps, ALPHA)
    got, err, n, part = resident_replay(state, const, -1.0, sweeps, ALPHA)
    assert n.tolist() == n_ref.tolist() == [sweeps] * batch
    assert part.shape[1] == tile_count(*size)
    assert torch.equal(got, ref)
    # the same squared updates, summed tile by tile in a fixed order
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


@pytest.mark.parametrize("size", SIZES)
def test_resident_replay_stop_error(system, size):
    """stop="error": the fixed-order sum of the per-tile partials stops
    each sample at the plain version's sweep (samples 0 and 1 stop at
    different sweeps), with the state equal to the plain one."""
    state, const = _cut(system, size, 2)
    state[1] *= 0.01
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, -1.0, 3,
                                               ALPHA)
    thresh = float(ref_err.min()) * 0.05
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, thresh,
                                               300, ALPHA)
    got, err, n, _ = resident_replay(state, const, thresh, 300, ALPHA)
    assert 3 < int(n_ref.min()) and int(n_ref.max()) < 300
    assert n_ref[0] != n_ref[1]
    assert n.tolist() == n_ref.tolist()
    assert torch.equal(got, ref)
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


def test_route_by_size():
    """On an H100 every Brox level of 1024x436 takes route "resident" at
    B=1 (level 0: 112 tiles, one block of `RESIDENT_SMEM` bytes an SM on
    132 SMs); B=2 at 436x1024 takes "stream".  The boundary is the
    resident blocks, the opt-in shared memory and the samples a launch
    takes."""
    per_sm = min(H100_SMEM_SM // (RESIDENT_SMEM + 1024),
                 H100_THREADS_SM // RESIDENT_THREADS)
    assert per_sm == 1
    resident = per_sm * H100_SMS
    sizes = pyramid_sizes(1024, 436, 0.5, 5)
    assert [(ny, nx) for nx, ny in sizes] == [
        (436, 1024), (218, 512), (109, 256), (55, 128), (28, 64)]
    assert [brox_sor_route(1, ny, nx, H100_SMEM_OPTIN, resident)
            for nx, ny in sizes] == ["resident"] * 5
    assert brox_sor_route(2, 436, 1024, H100_SMEM_OPTIN, resident) == "stream"
    tiles = tile_count(436, 1024)
    assert tiles == 112
    assert brox_sor_route(1, 436, 1024, H100_SMEM_OPTIN, tiles) == "resident"
    assert brox_sor_route(1, 436, 1024, H100_SMEM_OPTIN, tiles - 1) == "stream"
    assert brox_sor_route(1, 28, 64, RESIDENT_SMEM, 1) == "resident"
    assert brox_sor_route(1, 28, 64, RESIDENT_SMEM - 1, resident) == "stream"
    assert brox_sor_route(RESIDENT_THREADS + 1, 7, 16, H100_SMEM_OPTIN,
                          10 ** 6) == "stream"
