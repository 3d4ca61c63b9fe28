"""K7's route "stream" schedule, replayed block by block in plain
PyTorch on the CPU and held equal to the plain version.

csrc/brox_sor.cu runs route "stream" as one launch per sweep, then
common.cuh's `stop_finalize`, with the host reading `active` every
CHECK_EVERY sweeps.  A grid of blocks walks the (active sample, tile)
items, sample-major, block k taking items k, k + grid, ...; a block
copies du and dv over its tile's interior of `STREAM_TILE` pixels and a
halo of `STREAM_HALO`, updates red on the interior grown by one pixel
and black on the interior, writes the interior to the other of two
state buffers (a sample's current buffer is the parity of its sweep
count n) and its summed squared update to its slot; a last launch
copies the samples whose count is odd back from the scratch buffer.  A
CUDA kernel cannot run here, so this file replays that schedule with
the geometry the wrapper states (and checks against the source when the
library loads): a block sees du and dv only over its interior and halo
and the constants only at the pixels it updates, every other value is
NaN, the scratch buffer starts as NaN, and every value a block computes
must be finite.  So a halo too narrow, a red region too small, a read
of the wrong buffer or a missing settle shows as NaN or a difference.
Neighbour indices clamp at the image's rim, as the kernel clamps them.
In float64 the replay must equal the plain version exactly
(`torch.equal`).
"""

import collections

import numpy as np
import pytest
import torch

from tpuflow_torch.ops.brox import (SOR_OMEGA, STREAM_HALO, STREAM_THREADS,
                                    STREAM_TILE, brox_sor_error_plain,
                                    tile_count)
from tpuflow_torch.ops.hs import D_FLOOR
from tpuflow_torch.ops.pyramid import pyramid_sizes
from tpuflow_torch.ops.sweeps import CHECK_EVERY

NAN = float("nan")
ALPHA = 50.0
# sizes no tile divides: one partial tile (7x16), partial tiles on both
# axes (37x53, odd width), several tiles each way with partial last ones
# (97x125)
SIZES = [(7, 16), (37, 53), (97, 125)]
FIN_THREADS = 256  # common.cuh: stop_finalize's threads
GRID = 5  # blocks of the replayed launches (the card's: occupancy x SMs)


def walk(active, tiles, grid):
    """The items of one launch, as the kernel's blocks walk them: [(block,
    sample, tile)], each block's in its order.  The active samples are
    listed STREAM_THREADS at a time, and the items numbered sample-major
    across the lists."""
    B = len(active)
    out = []
    base = 0
    for c0 in range(0, B, STREAM_THREADS):
        samples = [b for b in range(c0, min(c0 + STREAM_THREADS, B))
                   if active[b]]
        items = len(samples) * tiles
        for block in range(grid):
            for it in range(base + (block - base % grid) % grid, base + items,
                            grid):
                k, tile = divmod(it - base, tiles)
                out.append((block, samples[k], tile))
        base += items
    return out


def _tile_origins(ny, nx):
    """(i0, j0) of each tile in the kernel's tile order."""
    ty, tx = STREAM_TILE
    return [(i0, j0) for i0 in range(0, ny, ty) for j0 in range(0, nx, tx)]


def _region(i0, j0, grow, halo_rows, ny, nx):
    """(ny, nx) mask of the interior at (i0, j0) grown by `grow` pixels
    (`halo_rows` rows and columns beyond the interior), cut to the
    image."""
    ty, tx = STREAM_TILE
    mask = torch.zeros((ny, nx), dtype=torch.bool)
    mask[max(i0 - grow, 0):min(i0 + ty + halo_rows, ny),
         max(j0 - grow, 0):min(j0 + tx + halo_rows, nx)] = True
    return mask


def _clamped(f, di, dj):
    """f(i + di, j + dj) with the indices clamped to the image."""
    ny, nx = f.shape[-2:]
    i = (torch.arange(ny) + di).clamp(0, ny - 1)
    j = (torch.arange(nx) + dj).clamp(0, nx - 1)
    return f[..., i, :][..., j]


def _update(du, dv, k, mask, alpha):
    """The kernel's update of the pixels in `mask`, in place on the
    block's (ny, nx) du and dv with the constants k (9, ny, nx); returns
    the squared updates (NaN outside `mask`)."""
    w = SOR_OMEGA
    au, av, du_c, dv_c, dd, psi1, psi2, psi3, psi4 = k
    rdu = 1.0 / torch.clamp(du_c, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv_c, min=D_FLOOR)
    dpu = (psi1 * _clamped(du, 1, 0) + psi2 * _clamped(du, -1, 0)
           + psi3 * _clamped(du, 0, 1) + psi4 * _clamped(du, 0, -1))
    dun = (1.0 - w) * du + w * (au - dd * dv + alpha * dpu) * rdu
    dpv = (psi1 * _clamped(dv, 1, 0) + psi2 * _clamped(dv, -1, 0)
           + psi3 * _clamped(dv, 0, 1) + psi4 * _clamped(dv, 0, -1))
    dvn = (1.0 - w) * dv + w * (av - dd * dun + alpha * dpv) * rdv
    assert bool(torch.isfinite(dun[mask]).all()
                and torch.isfinite(dvn[mask]).all()), "read outside the block"
    sq = torch.where(mask, (dun - du) ** 2 + (dvn - dv) ** 2, NAN)
    du.copy_(torch.where(mask, dun, du))
    dv.copy_(torch.where(mask, dvn, dv))
    return sq


def sweep_tile(src, dst, const, i0, j0, alpha):
    """One block's work on one tile of one sample: src, dst (2, ny, nx)
    are the sample's current and other buffer, const (9, ny, nx); writes
    the interior to dst and returns its summed squared update."""
    ny, nx = src.shape[-2:]
    red = (torch.arange(ny)[:, None] + torch.arange(nx)) % 2 == 0
    staged = _region(i0, j0, STREAM_HALO, STREAM_HALO, ny, nx)
    ring = _region(i0, j0, 1, 1, ny, nx)
    inner = _region(i0, j0, 0, 0, ny, nx)
    do_red, do_black = ring & red, inner & ~red
    local = torch.where(staged, src, NAN)
    k = torch.where(do_red | do_black, const, NAN)
    sq_red = _update(local[0], local[1], k, do_red, alpha)
    sq_black = _update(local[0], local[1], k, do_black, alpha)
    dst[:, inner] = local[:, inner]
    return float(sq_red[inner & red].sum() + sq_black[do_black].sum())


def finalize_sum(partials):
    """stop_finalize's order: each thread sums the slots t, t + 256, ...,
    then the threads' sums are added."""
    return sum(sum(partials[t::FIN_THREADS]) for t in range(FIN_THREADS))


def stream_replay(state, const, thresh, max_iter, alpha, grid=GRID):
    """Route "stream"'s schedule on (B, 2, ny, nx) `state` and (B, 9, ny,
    nx) `const`; returns (state, err (B,), n (B,), the launches made,
    the per-tile partials of the last sweep (B, tiles))."""
    B, _, ny, nx = state.shape
    origins = _tile_origins(ny, nx)
    tiles = len(origins)
    bufs = (state.clone(), torch.full_like(state, NAN))  # state, scratch
    err = [float("inf")] * B
    n = [0] * B
    active = [max_iter > 0] * B
    partial = torch.full((B, tiles), NAN, dtype=state.dtype)
    launches = 0
    done = 0
    while done < max_iter:
        chunk = min(CHECK_EVERY, max_iter - done)
        for _ in range(chunk):
            launches += 1
            for _, b, t in walk(active, tiles, grid):
                odd = n[b] % 2
                partial[b, t] = sweep_tile(bufs[odd][b], bufs[1 - odd][b],
                                           const[b], *origins[t], alpha)
            for b in range(B):  # stop_finalize
                if active[b]:
                    err[b] = finalize_sum(partial[b].tolist())
                    n[b] += 1
                    active[b] = err[b] > thresh and n[b] < max_iter
        done += chunk
        if done < max_iter and not any(active):
            break
    for b in range(B):  # the settle
        if n[b] % 2:
            bufs[0][b] = bufs[1][b]
    return (bufs[0], torch.tensor(err, dtype=state.dtype),
            torch.tensor(n, dtype=torch.int32), launches, partial)


def _smooth(rng, shape, scale):
    return torch.from_numpy(scale * rng.standard_normal(shape))


@pytest.fixture(scope="module")
def system():
    """(state (2, 2, ny, nx), const (2, 9, ny, nx)) float64, Brox-shaped:
    constants from random warped gradients and residuals, psi_i from a
    positive robustness weight, 0 across the image boundary."""
    rng = np.random.default_rng(43)
    shape = (2,) + max(SIZES)
    ix, iy = _smooth(rng, shape, 10.0), _smooth(rng, shape, 10.0)
    dif = _smooth(rng, shape, 5.0)
    psi = 0.5 + torch.from_numpy(rng.random(shape))
    const = torch.stack([dif * ix, dif * iy, ix * ix, iy * iy, ix * iy,
                         psi, psi, psi, psi], dim=1)
    state = torch.stack([_smooth(rng, shape, 1.0), _smooth(rng, shape, 1.0)],
                        dim=1)
    return state, const


def _cut(system, size):
    ny, nx = size
    state, const = (t[:, :, :ny, :nx].clone() for t in system)
    # psi1 (down) 0 on the last row, psi2 (up) on the first, psi3
    # (right) on the last column, psi4 (left) on the first
    const[:, 5, -1], const[:, 6, 0] = 0.0, 0.0
    const[:, 7, :, -1], const[:, 8, :, 0] = 0.0, 0.0
    # Du, Dv as the solver assembles them: the data terms plus the
    # smoothness weights' sum
    const[:, 2:4] += ALPHA * const[:, 5:].sum(dim=1, keepdim=True)
    return state.contiguous(), const.contiguous()


@pytest.mark.parametrize("sweeps", [1, 2, CHECK_EVERY + 1])
@pytest.mark.parametrize("size", SIZES)
def test_stream_replay_equals_plain(system, size, sweeps):
    """Fixed sweeps (thresh < 0): an odd count ends in the scratch buffer
    and is settled, an even one in `state`; more than CHECK_EVERY sweeps
    take two host chunks."""
    state, const = _cut(system, size)
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, -1.0,
                                               sweeps, ALPHA)
    got, err, n, launches, part = stream_replay(state, const, -1.0, sweeps,
                                                ALPHA)
    assert n.tolist() == n_ref.tolist() == [sweeps] * 2
    assert launches == sweeps
    assert part.shape[1] == tile_count(*size, STREAM_TILE)
    assert torch.equal(got, ref)
    # the same squared updates, summed tile by tile in a fixed order
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


@pytest.mark.parametrize("size", SIZES)
def test_stream_replay_stop_error(system, size):
    """stop="error": samples 0 and 1 stop at different sweeps, each at the
    plain version's; the stopped sample's blocks are not walked, its
    buffer is left as its last sweep wrote it, and the loop ends in the
    chunk after the last sample stopped."""
    state, const = _cut(system, size)
    state[1] *= 0.01
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, -1.0, 3,
                                               ALPHA)
    thresh = float(ref_err.min()) * 0.05
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, thresh,
                                               300, ALPHA)
    got, err, n, launches, _ = stream_replay(state, const, thresh, 300, ALPHA)
    assert 3 < int(n_ref.min()) and int(n_ref.max()) < 300
    assert n_ref[0] != n_ref[1]
    assert n.tolist() == n_ref.tolist()
    assert launches == -(-int(n_ref.max()) // CHECK_EVERY) * CHECK_EVERY
    assert torch.equal(got, ref)
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


@pytest.mark.parametrize("B, tiles, grid, pattern", [
    (2, 12, 5, "all"), (2, 12, 5, "first"), (128, 270, 264, "all"),
    (128, 270, 264, "even"), (600, 7, 13, "random"), (600, 7, 13, "none"),
    (3, 1, 264, "last")])
def test_stream_walk(B, tiles, grid, pattern):
    """One launch's items: every tile of every active sample exactly once,
    no item of a stopped sample, and the blocks' counts within one of
    each other, over lists of STREAM_THREADS samples too."""
    rng = np.random.default_rng(B + tiles)
    active = {"all": [True] * B, "none": [False] * B,
              "first": [b == 0 for b in range(B)],
              "last": [b == B - 1 for b in range(B)],
              "even": [b % 2 == 0 for b in range(B)],
              "random": list(rng.random(B) < 0.6)}[pattern]
    items = walk(active, tiles, grid)
    got = collections.Counter((b, t) for _, b, t in items)
    assert got == collections.Counter(
        (b, t) for b in range(B) if active[b] for t in range(tiles))
    per_block = collections.Counter(block for block, _, _ in items)
    counts = [per_block.get(k, 0) for k in range(grid)]
    assert max(counts) - min(counts) <= 1


def test_stream_geometry():
    """A block's threads own every column pair of the interior grown by
    one, ITEMS a thread; the interior's width is even (a pair is one red
    and one black pixel, and the shared rows split by column parity keep
    the image's parity); a du / dv half row is the 32 banks.  The tiles
    of the batched Brox levels of 1024x436 that take the route."""
    ty, tx = STREAM_TILE
    assert tx % 2 == 0 and STREAM_THREADS % 32 == 0
    assert (ty + 2) * (tx // 2 + 2) % STREAM_THREADS == 0
    assert (tx + 2 * STREAM_HALO) // 2 == 32
    sizes = pyramid_sizes(1024, 436, 0.5, 4)
    assert [tile_count(ny, nx, STREAM_TILE) for nx, ny in sizes] == [
        270, 72, 20, 6]
