"""K7's route "stream" schedule, replayed block by block in plain
PyTorch on the CPU and held equal to the plain version.

csrc/brox_sor.cu runs route "stream" as one launch per K sweeps (K =
`brox_sor_depth`'s 1 or DEEP_K), then the stop's finalize, with the host
reading `active` every CHECK_EVERY sweeps.  A grid of blocks walks the
(active sample, tile) items, sample-major, block k taking items k, k +
grid, ...  At K = 1 a block copies du and dv over its tile's interior of
`STREAM_TILE` pixels and a halo of `STREAM_HALO`, updates red on the
interior grown by one pixel and black on the interior, writes the
interior to the other of two state buffers and its summed squared update
to its slot, and common.cuh's `stop_finalize` sums the slots.  At K > 1
a block copies du and dv over its tile of `DEEP_TILE` and a halo of 2K,
the constants over a halo of 2K - 1, and runs K sweeps: sweep s updates
red on the interior grown by 2(K - s) + 1 and black on the interior
grown by 2(K - s); each sweep's summed squared update over the interior
goes to its own slot, and `stop_finalize_sweeps` walks a sample's K sums
in order, stopping at the first that meets the stop.  A sample that
stops at sweep j < K keeps j as its redo.  A sample's current buffer is
the parity of its launches (n / K); the settle runs the redo samples'
j sweeps again from their last launch's input (which no later launch
touches) into the other buffer, then copies the samples whose launches
number ceil(n / K) is odd back from the scratch buffer.

A CUDA kernel cannot run here, so this file replays that schedule with
the geometry the wrapper states (and checks against the source when the
library loads): a block sees du and dv only over its interior and halo
and the constants only over the pixels it may update, every other value
is NaN, the scratch buffer starts as NaN, and every value a block
computes must be finite.  So a halo too narrow (2K - 1 for du and dv, or
2K - 2 for the constants), a red region too small, a read of the wrong
buffer, a redo from the wrong buffer or a missing redo or settle shows as
NaN or a difference.  Neighbour indices clamp at the image's rim, as the
kernel clamps them.  In float64 the replay must equal the plain version
exactly (`torch.equal`).
"""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow_torch.ops.brox import (DEEP_K, DEEP_SMEM,
                                    DEEP_THREADS, DEEP_TILE, SOR_OMEGA,
                                    STREAM_HALO, STREAM_THREADS, STREAM_TILE,
                                    brox_sor_depth, brox_sor_error_plain,
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


# the sweeps a launch `brox_sor_depth` can pick
DEPTHS = (1, DEEP_K)


def walk(active, tiles, grid, threads=STREAM_THREADS):
    """The items of one launch, as the kernel's blocks walk them: [(block,
    sample, tile)], each block's in its order.  The selected samples are
    listed `threads` at a time, and the items numbered sample-major
    across the lists."""
    B = len(active)
    out = []
    base = 0
    for c0 in range(0, B, threads):
        samples = [b for b in range(c0, min(c0 + threads, B)) if active[b]]
        items = len(samples) * tiles
        for block in range(grid):
            for it in range(base + (block - base % grid) % grid, base + items,
                            grid):
                k, tile = divmod(it - base, tiles)
                out.append((block, samples[k], tile))
        base += items
    return out


def _tile_origins(ny, nx, tile=STREAM_TILE):
    """(i0, j0) of each tile in the kernel's tile order."""
    ty, tx = tile
    return [(i0, j0) for i0 in range(0, ny, ty) for j0 in range(0, nx, tx)]


def _region(i0, j0, grow, halo_rows, ny, nx, tile=STREAM_TILE):
    """(ny, nx) mask of the interior at (i0, j0) grown by `grow` pixels
    (`halo_rows` rows and columns beyond the interior), cut to the
    image."""
    ty, tx = tile
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


def deep_tile(src, dst, const, i0, j0, alpha, depth, sweeps,
              halo=None, const_halo=None):
    """One block of the K-sweep launch (K = `depth`) on one tile of one
    sample: src, dst (2, ny, nx) are the sample's current and other
    buffer, const (9, ny, nx); du and dv staged over a halo of `halo`
    (2K), the constants over `const_halo` (2K - 1); runs sweeps K -
    sweeps + 1 .. K of the launch, writes the interior to dst and returns
    the K sweeps' summed squared updates over the interior (NaN for a
    sweep not run)."""
    ny, nx = src.shape[-2:]
    halo = 2 * depth if halo is None else halo
    const_halo = 2 * depth - 1 if const_halo is None else const_halo

    def region(grow):
        return _region(i0, j0, grow, grow, ny, nx, DEEP_TILE)

    red = (torch.arange(ny)[:, None] + torch.arange(nx)) % 2 == 0
    inner = region(0)
    local = torch.where(region(halo), src, NAN)
    k = torch.where(region(const_halo), const, NAN)
    parts = [NAN] * depth
    for s in range(depth - sweeps + 1, depth + 1):
        g = 2 * (depth - s)
        sq_red = _update(local[0], local[1], k, region(g + 1) & red, alpha)
        sq_black = _update(local[0], local[1], k, region(g) & ~red, alpha)
        parts[s - 1] = float(sq_red[inner & red].sum()
                             + sq_black[inner & ~red].sum())
    dst[:, inner] = local[:, inner]
    return parts


def finalize_sum(partials):
    """stop_finalize's order: each thread sums the slots t, t + 256, ...,
    then the threads' sums are added."""
    return sum(sum(partials[t::FIN_THREADS]) for t in range(FIN_THREADS))


def stream_replay(state, const, thresh, max_iter, alpha, grid=GRID,
                  depth=1, fault=None):
    """Route "stream"'s schedule, `depth` sweeps a launch, on (B, 2, ny,
    nx) `state` and (B, 9, ny, nx) `const`; returns (state, err (B,), n
    (B,), the sweeps launched, the partials of the last launch (B, tiles,
    depth), the redo each sample kept).  `fault` plants one: "halo" (du
    and dv staged over 2K - 1), "redo_buffer" (the redo reads the
    launch's output) or "no_redo" (the settle only copies)."""
    B, _, ny, nx = state.shape
    halo = 2 * depth - 1 if fault == "halo" else None
    tile = STREAM_TILE if depth == 1 else DEEP_TILE
    origins = _tile_origins(ny, nx, tile)
    tiles = len(origins)
    threads = STREAM_THREADS if depth == 1 else DEEP_THREADS
    bufs = (state.clone(), torch.full_like(state, NAN))  # state, scratch
    err = [float("inf")] * B
    n = [0] * B
    active = [max_iter > 0] * B
    redo = [0] * B
    partial = torch.full((B, tiles, depth), NAN, dtype=state.dtype)
    launched = 0
    done = 0
    while done < max_iter:
        chunk = min(CHECK_EVERY, max_iter - done)
        for _ in range(-(-chunk // depth)):
            launched += depth
            for _, b, t in walk(active, tiles, grid, threads):
                odd = n[b] // depth % 2
                src, dst = bufs[odd][b], bufs[1 - odd][b]
                if depth == 1:
                    partial[b, t, 0] = sweep_tile(src, dst, const[b],
                                                  *origins[t], alpha)
                else:
                    partial[b, t] = torch.tensor(deep_tile(
                        src, dst, const[b], *origins[t], alpha, depth,
                        depth, halo), dtype=state.dtype)
            for b in range(B):  # the finalize: each sweep's sum in turn
                if not active[b]:
                    continue
                for s in range(depth):
                    err[b] = finalize_sum(partial[b, :, s].tolist())
                    n[b] += 1
                    if not (err[b] > thresh and n[b] < max_iter):
                        active[b] = False
                        redo[b] = s + 1 if s + 1 < depth else 0
                        break
        done += chunk
        if done < max_iter and not any(active):
            break
    for b in range(B):  # the settle: the redo, then the copy
        if redo[b] and fault != "no_redo":
            odd = (n[b] // depth + (fault == "redo_buffer")) % 2
            for t in range(tiles):
                deep_tile(bufs[odd][b], bufs[1 - odd][b], const[b],
                          *origins[t], alpha, depth, redo[b], halo)
    for b in range(B):
        if -(-n[b] // depth) % 2:
            bufs[0][b] = bufs[1][b]
    return (bufs[0], torch.tensor(err, dtype=state.dtype),
            torch.tensor(n, dtype=torch.int32), launched, partial,
            torch.tensor(redo, dtype=torch.int32))


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
    got, err, n, launches, part, _ = stream_replay(state, const, -1.0,
                                                   sweeps, ALPHA)
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
    got, err, n, launches, _, _ = stream_replay(state, const, thresh, 300,
                                                ALPHA)
    assert 3 < int(n_ref.min()) and int(n_ref.max()) < 300
    assert n_ref[0] != n_ref[1]
    assert n.tolist() == n_ref.tolist()
    assert launches == -(-int(n_ref.max()) // CHECK_EVERY) * CHECK_EVERY
    assert torch.equal(got, ref)
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


def _err_sequence(state, const, sweeps):
    """err of each of the first `sweeps` sweeps of the plain version, per
    sample: (sweeps, B)."""
    return torch.stack([brox_sor_error_plain(state.clone(), const, -1.0, t,
                                             ALPHA)[1]
                        for t in range(1, sweeps + 1)])


@pytest.mark.parametrize("sweeps", [1, 3, CHECK_EVERY + 1])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_deep_replay_equals_plain(system, size, depth, sweeps):
    """Fixed sweeps (thresh < 0) at each depth the rule picks: 1 and 3
    sweeps end inside the first launch of DEEP_K (max_iter reached at its
    sweep 1 and at its sweep K - 1), CHECK_EVERY + 1 inside the first
    launch of the second host chunk; each is redone by the settle from
    the launch's input, and equals the plain version."""
    state, const = _cut(system, size)
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, -1.0,
                                               sweeps, ALPHA)
    got, err, n, launched, part, redo = stream_replay(
        state, const, -1.0, sweeps, ALPHA, depth=depth)
    assert n.tolist() == n_ref.tolist() == [sweeps] * 2
    tile = STREAM_TILE if depth == 1 else DEEP_TILE
    assert part.shape == (2, tile_count(*size, tile), depth)
    assert redo.tolist() == [sweeps % depth] * 2
    assert launched == (-(-min(sweeps, CHECK_EVERY) // depth) * depth
                        + -(-max(sweeps - CHECK_EVERY, 0) // depth) * depth)
    assert torch.equal(got, ref)
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


@pytest.mark.parametrize("offset", ["first", "last"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_deep_replay_stop_error(system, size, depth, offset):
    """stop="error" at each depth the rule picks: thresh set between two
    of sample 0's sweeps so that it stops at sweep 1 ("first") or sweep
    K - 1 ("last") of a launch of K (sweep 5 or 7 at K = 4; at K = 1
    every sweep ends a launch), while sample 1 stops elsewhere: the
    finalize walks each sample's K sums in order, the later sweeps'
    partials are ignored, and the settle redoes the stopped sample from
    its last launch's input.  n, the state and err equal the plain
    version's."""
    state, const = _cut(system, size)
    state[1] *= 0.3
    errs = _err_sequence(state, const, 8)
    t = DEEP_K + 1 if offset == "first" else 2 * DEEP_K - 1
    # the sequence falls at every sweep here, so sample 0 stops at sweep t
    assert bool((errs[1:, 0] < errs[:-1, 0]).all())
    thresh = float(errs[t - 1, 0] + errs[t - 2, 0]) / 2
    ref, ref_err, n_ref = brox_sor_error_plain(state.clone(), const, thresh,
                                               300, ALPHA)
    got, err, n, _, _, redo = stream_replay(state, const, thresh, 300, ALPHA,
                                            depth=depth)
    assert int(n_ref[0]) == t and n_ref[0] != n_ref[1]
    assert n.tolist() == n_ref.tolist()
    assert redo.tolist() == [int(k) % depth for k in n_ref]
    assert torch.equal(got, ref)
    torch.testing.assert_close(err, ref_err, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fault", ["halo", "redo_buffer", "no_redo"])
def test_deep_replay_catches_faults(system, fault):
    """The replay fails where the K-sweep schedule is broken: du and dv
    staged over a halo of 2K - 1 read NaN outside the block; a redo that
    reads the launch's output instead of its input, or none at all,
    leaves a state other than the plain version's."""
    state, const = _cut(system, SIZES[-1])
    sweeps = DEEP_K + 1  # the second launch stops at its sweep 1
    ref = brox_sor_error_plain(state.clone(), const, -1.0, sweeps, ALPHA)[0]
    if fault == "halo":
        with pytest.raises(AssertionError, match="read outside the block"):
            stream_replay(state, const, -1.0, sweeps, ALPHA, depth=DEEP_K,
                          fault=fault)
        return
    got = stream_replay(state, const, -1.0, sweeps, ALPHA, depth=DEEP_K,
                        fault=fault)[0]
    assert bool(torch.isfinite(got).all())
    assert not torch.equal(got, ref)


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


CSRC = Path(__file__).resolve().parents[1] / "tpuflow_torch" / "csrc"
# an H100: the shared memory a block may opt in to, an SM's, its SMs
H100_SMEM_OPTIN = 232448
H100_SMEM_SM = 233472
H100_SMS = 132


def _source_geometry():
    """Route "stream"'s constants as csrc/brox_sor.cu defines them."""
    src = (CSRC / "brox_sor.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (STY|STX|SHALO|ST|DK|DTY|DTX|DT) = (\d+);", src)}


def test_stream_geometry():
    """The geometry the wrapper states is the source's (the library
    checks it again when it loads on the card).  At one sweep a launch a
    block's threads own every column pair of the interior grown by one,
    ITEMS a thread; the interior's width is even (a pair is one red and
    one black pixel, and the shared rows split by column parity keep the
    image's parity); a du / dv half row is the 32 banks.  At DEEP_K a
    block's shared memory (du and dv over a halo of 2K, the constants
    over 2K - 1, and its static words) fits one block an SM.  The tiles
    of the batched Brox levels of 1024x436 that take the route."""
    g = _source_geometry()
    assert (g["STY"], g["STX"]) == STREAM_TILE
    assert (g["SHALO"], g["ST"]) == (STREAM_HALO, STREAM_THREADS)
    assert (g["DK"], (g["DTY"], g["DTX"]), g["DT"]) == (
        DEEP_K, DEEP_TILE, DEEP_THREADS)
    ty, tx = STREAM_TILE
    assert tx % 2 == 0 and STREAM_THREADS % 32 == 0
    assert (ty + 2) * (tx // 2 + 2) % STREAM_THREADS == 0
    assert (tx + 2 * STREAM_HALO) // 2 == 32
    dty, dtx = DEEP_TILE
    assert dtx % 2 == 0 and DEEP_THREADS % 32 == 0
    assert DEEP_SMEM == 4 * (
        2 * (dty + 4 * DEEP_K) * (dtx + 4 * DEEP_K)
        + 9 * (dty + 4 * DEEP_K - 2) * (dtx + 4 * DEEP_K - 2))
    # static: the per-sweep sums (doubles), the sample list, the warps'
    static = 8 * DEEP_K * DEEP_THREADS // 32 + 4 * DEEP_THREADS + 4 * 32
    assert DEEP_SMEM + static <= H100_SMEM_OPTIN
    assert DEEP_SMEM + static + 1024 <= H100_SMEM_SM
    sizes = pyramid_sizes(1024, 436, 0.5, 4)
    assert [tile_count(ny, nx, STREAM_TILE) for nx, ny in sizes] == [
        270, 72, 20, 6]
    assert [tile_count(ny, nx, DEEP_TILE) for nx, ny in sizes] == [
        154, 42, 12, 4]


def test_depth_by_size():
    """The sweeps a launch of route "stream": a pure function of the
    blocks of the K-sweep kernel the device holds at once (0 where its
    shared memory does not fit a block).  Every depth it picks divides
    CHECK_EVERY, so the host reads the stop every CHECK_EVERY sweeps at
    either; one sweep a launch is reachable, where a block does not fit;
    on an H100 (one block an SM) every level of 1024x436 that takes route
    "stream", at any B, takes DEEP_K, as a sweep there was faster at
    DEEP_K down to 3.9 tiles a block."""
    assert all(CHECK_EVERY % k == 0 for k in DEPTHS)
    assert brox_sor_depth(H100_SMS) == DEEP_K
    assert brox_sor_depth(1) == DEEP_K
    assert brox_sor_depth(0) == 1
    assert {brox_sor_depth(b) for b in (0, 1, H100_SMS, 2 * H100_SMS)} == (
        set(DEPTHS))
