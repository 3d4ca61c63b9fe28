"""K5's and K5p's kernel, replayed block by block in plain PyTorch on the
CPU and held equal to the plain versions; and the planes a thread warps.

csrc/warp_planes.cu runs one thread per pixel and group of planes on
blocks of BLOCK pixels, each thread gathering its pixel's taps from
device memory: an in-domain K5 pixel's taps lie within dmax +
TAP_MARGIN[0] before and dmax + TAP_MARGIN[1] after it on each axis, a
K5p tap outside that shift window is read at the pixel's own row or
column (its weight is 0), and K5's out-of-domain pixels read nothing.  So
a block reads only its window: its rows and columns widened by those
margins.  A CUDA kernel cannot run here, so this file replays the kernel
with the geometry the wrapper states (and checks against the source when
the library loads): for each block, sample and group of planes
(`plane_groups`, with each of GROUPS planes a thread) a copy of the
planes holds the real values only inside the block's window, clamped to
the image, and only for the group's planes, NaN everywhere else; the
block's pixels are warped from that copy with the kernel's cell.  A
window one pixel too narrow, a missing redirect, or a group that reads
another group's planes shows as NaN or a difference.  The flows cross
the bound in bands, point off every rim and hold NaN pixels.  In float64
each replay must equal the plain version exactly (`torch.equal`).
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.ops.pyramid import pyramid_sizes
from tpuflow_torch.ops.warp import (BLOCK, GROUPS, TAP_MARGIN, WAVES, _keys,
                                    plane_groups, warp_planes_group,
                                    warp_planes_on_group, warp_planes_plain,
                                    warp_planes_shift_plain)

NAN = float("nan")
# sizes no block divides: one partial block column (37x53), partial
# blocks on both axes (97x125), and Brox's level 3 at 1024x436 (55x128)
SIZES = [(37, 53), (55, 128), (97, 125)]
# (planes, samples): one group of 3, one group of 6 for two samples, and
# groups of 6, 3 and 1 (of 3, 3, 3 and 1 at 3 planes a thread)
PLANES_SAMPLES = ((3, 1), (6, 2), (10, 1))
# an H100's SMs
H100_SMS = 132


def _axis_cell(c, pos, n, dmax, strict):
    """Tap weights and indices on one axis as the kernel takes them: K5's
    anchor taps (read only in domain); K5p's taps outside the shift
    window weighted 0 and redirected to `pos`, the others clamped."""
    c0 = torch.floor(c)
    w = list(_keys(c - c0))
    a = torch.nan_to_num(c0).clamp(-4, n + 3).long() - 1
    if strict:
        return w, [a + m for m in range(4)]
    idx = []
    for m in range(4):
        off = c0 - pos - 1 + m
        keep = (off >= -dmax - TAP_MARGIN[0]) & (off <= dmax + TAP_MARGIN[1])
        w[m] = torch.where(keep, w[m], torch.zeros_like(w[m]))
        idx.append(torch.where(keep, (a + m).clamp(0, n - 1), pos.long()))
    return w, idx


def _pixels(seen, u, v, ii, jj, dmax, strict, border_out):
    """The warped values of the pixels (ii, jj) of `seen` (size, ny, nx)
    by the flow (u, v) at those pixels, read as the kernel reads them."""
    size, ny, nx = seen.shape
    xx, yy = jj + u, ii + v
    x0, y0 = torch.floor(xx), torch.floor(yy)
    in_img = (xx >= 1) & (x0 <= nx - 3) & (yy >= 1) & (y0 <= ny - 3)
    if strict:
        read = in_img & ((x0 - jj).abs() <= dmax) & ((y0 - ii).abs() <= dmax)
    else:
        read = in_img if border_out else torch.ones_like(in_img)
    out = torch.zeros((size, ii.numel()), dtype=seen.dtype)
    ii, jj, xx, yy = ii[read], jj[read], xx[read], yy[read]
    cx, cols = _axis_cell(xx, jj, nx, dmax, strict)
    cy, rows = _axis_cell(yy, ii, ny, dmax, strict)
    acc = torch.zeros((size, ii.numel()), dtype=seen.dtype)
    for m in range(4):
        for l in range(4):
            acc = acc + (cy[m] * cx[l]) * seen[:, rows[m], cols[l]]
    out[:, read] = acc
    return out


def block_windows(ny, nx, dmax):
    """The kernel's blocks of an (ny, nx) plane, each ((first row, first
    column), (window rows), (window columns)): the block is BLOCK[1] x
    BLOCK[0] pixels (cut at the image's edge), its window every row and
    column within dmax + TAP_MARGIN[0] before and dmax + TAP_MARGIN[1]
    after the block, cut to the image, both as inclusive (first, last)."""
    lo, hi = dmax + TAP_MARGIN[0], dmax + TAP_MARGIN[1]
    return [((i0, j0),
             (max(i0 - lo, 0), min(i0 + BLOCK[1] - 1 + hi, ny - 1)),
             (max(j0 - lo, 0), min(j0 + BLOCK[0] - 1 + hi, nx - 1)))
            for i0 in range(0, ny, BLOCK[1]) for j0 in range(0, nx, BLOCK[0])]


def block_replay(planes, uv, dmax, group, strict, border_out=True):
    """The kernel block by block, `group` planes a thread: each block's
    pixels warped from a copy of the planes that holds only its window of
    its group's planes."""
    B, P, ny, nx = planes.shape
    out = torch.full_like(planes, NAN)
    blocks = block_windows(ny, nx, dmax)
    for b in range(B):
        for k0, size in plane_groups(P, group):
            for (i0, j0), (wy0, wy1), (wx0, wx1) in blocks:
                seen = torch.full((size, ny, nx), NAN, dtype=planes.dtype)
                seen[:, wy0:wy1 + 1, wx0:wx1 + 1] = \
                    planes[b, k0:k0 + size, wy0:wy1 + 1, wx0:wx1 + 1]
                ti = torch.arange(i0, min(i0 + BLOCK[1], ny))
                tj = torch.arange(j0, min(j0 + BLOCK[0], nx))
                ii, jj = (g.reshape(-1) for g in torch.meshgrid(ti, tj,
                                                                indexing="ij"))
                got = _pixels(seen, uv[b, 0, ii, jj], uv[b, 1, ii, jj],
                              ii.to(planes.dtype), jj.to(planes.dtype), dmax,
                              strict, border_out)
                out[b, k0:k0 + size, ii, jj] = got
    return out


def _flow(rng, ny, nx, dmax):
    """A smooth flow of about dmax / 2 px with a third of its pixels
    anywhere within dmax + 4.5 px, bands of |u| (columns) and |v| (rows)
    at dmax - 0.5 ... dmax + 4.5 px on both signs, rows and columns whose
    flow points off each rim of the image, and NaN pixels."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    u = 0.5 * dmax * np.sin(2 * np.pi * (xx / nx + rng.random()))
    v = 0.5 * dmax * np.cos(2 * np.pi * (yy / ny + rng.random()))
    u, v = u + rng.normal(0, 0.3, u.shape), v + rng.normal(0, 0.3, v.shape)
    # a third of the pixels anywhere within dmax + 4.5, so that pixels on
    # every tile's edges reach each side of the window
    for f in (u, v):
        pick = rng.random(f.shape) < 0.3
        f[pick] = rng.uniform(-dmax - 4.5, dmax + 4.5, int(pick.sum()))
    mags = [s * (dmax + d) for d in (-0.5, 0.5, 1.5, 2.5, 3.5, 4.5)
            for s in (1, -1)]
    for k, mag in enumerate(mags):
        u[:, (3 * k + 1) % nx] = mag
        v[(2 * k + 1) % ny, :] = mag
    u[ny // 2, :] = -(xx[0] + 3.0)          # off the left rim
    u[ny // 2 + 1, :] = nx + 2.0 - xx[0]    # off the right rim
    v[:, nx // 2] = -(yy[:, 0] + 3.0)       # off the top
    v[:, nx // 2 + 1] = ny + 2.0 - yy[:, 0]  # off the bottom
    u[ny // 3, nx // 4:nx // 4 + 5] = np.nan
    v[ny // 4, nx // 3:nx // 3 + 5] = np.nan
    return np.stack([u, v])


@pytest.fixture(scope="module")
def cases():
    """(planes, uv) per (size, dmax, P, B), float64, made from a seed."""
    rng = np.random.default_rng(8)
    out = {}
    for ny, nx in SIZES:
        for dmax in (3, 4, 8):
            for P, B in PLANES_SAMPLES:
                planes = rng.normal(0, 60, (B, P, ny, nx)) + 128
                uv = np.stack([_flow(rng, ny, nx, dmax) for _ in range(B)])
                out[ny, nx, dmax, P, B] = (torch.from_numpy(planes),
                                           torch.from_numpy(uv))
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dmax", [3, 4, 8])
@pytest.mark.parametrize("variant", ["k5", "k5p_border_out", "k5p_keep"])
def test_block_replay_equals_plain(cases, size, dmax, variant):
    """Both plane counts a thread may take, each of PLANES_SAMPLES: the
    replay equals the plain version bit for bit, and the flows exercise
    each case a block's window must hold (taps past the bound, off the
    rim, NaN flow)."""
    strict, border_out = variant == "k5", variant != "k5p_keep"
    for P, B in PLANES_SAMPLES:
        planes, uv = cases[(*size, dmax, P, B)]
        if strict:
            ref, _ = warp_planes_plain(planes, uv, dmax)
        else:
            ref, _ = warp_planes_shift_plain(planes, uv, dmax, border_out)
        assert bool(torch.isfinite(ref).all())
        for group in GROUPS:
            got = block_replay(planes, uv, dmax, group, strict, border_out)
            assert torch.equal(got, ref), (P, B, group)
    # the flows reach past the window and off the image, so a narrower
    # window or a missing redirect would read outside it
    u = uv[:, 0]
    assert bool((u.abs() > dmax + 3).any()) and bool(torch.isnan(u).any())


def test_plane_groups():
    """Groups cover every plane once, in order: groups of 6, a group of 3
    where 3 or more remain, then ones (6 planes a thread); groups of 3,
    then ones (3 planes a thread).  Robust-expo RGB's 18 planes are three
    groups of 6."""
    for largest in GROUPS:
        for P in range(1, 25):
            groups = plane_groups(P, largest)
            assert [k for k0, n in groups for k in range(k0, k0 + n)] == \
                list(range(P))
            sizes = [n for _, n in groups]
            assert sizes == sorted(sizes, reverse=True)
            assert set(sizes) <= {largest, 3, 1}
            assert sizes.count(3) <= (P // 3 if largest == 3 else 1)
    assert plane_groups(18, 6) == [(0, 6), (6, 6), (12, 6)]
    assert plane_groups(7, 6) == [(0, 6), (6, 1)]
    assert plane_groups(6, 3) == [(0, 3), (3, 3)]
    assert plane_groups(5, 6) == [(0, 3), (3, 1), (4, 1)]


def test_block_windows():
    """The blocks cover the image once, and each block's window is its
    rows and columns widened by dmax and the margins, cut to the image."""
    for ny, nx in SIZES + [(436, 1024)]:
        for dmax in (3, 4, 8):
            cover = torch.zeros((ny, nx), dtype=torch.int64)
            for (i0, j0), (wy0, wy1), (wx0, wx1) in block_windows(ny, nx,
                                                                  dmax):
                cover[i0:i0 + BLOCK[1], j0:j0 + BLOCK[0]] += 1
                assert wy0 == max(i0 - dmax - TAP_MARGIN[0], 0)
                assert wy1 == min(i0 + BLOCK[1] - 1 + dmax + TAP_MARGIN[1],
                                  ny - 1)
                assert wx0 == max(j0 - dmax - TAP_MARGIN[0], 0)
                assert wx1 == min(j0 + BLOCK[0] - 1 + dmax + TAP_MARGIN[1],
                                  nx - 1)
            assert bool((cover == 1).all())


def test_group_by_size():
    """On an H100 the Brox and robust-expo levels of 1024x436 take six
    planes a thread at levels 0-1, whose blocks fill the card WAVES times
    over, and three at levels 2-4; robust-expo RGB's 18 planes at level 0
    run as three groups of 6; more samples fill the card sooner."""
    sizes = pyramid_sizes(1024, 436, 0.5, 5)
    assert [(ny, nx) for nx, ny in sizes] == [
        (436, 1024), (218, 512), (109, 256), (55, 128), (28, 64)]
    groups = [warp_planes_group(1, ny, nx, H100_SMS) for nx, ny in sizes]
    assert groups == [6, 6, 3, 3, 3]
    blocks = -(-218 // BLOCK[1]) * -(-512 // BLOCK[0])
    assert blocks >= WAVES * H100_SMS > blocks // 4
    assert plane_groups(18, warp_planes_group(1, 436, 1024, H100_SMS)) == [
        (0, 6), (6, 6), (12, 6)]
    assert warp_planes_group(4, 109, 256, H100_SMS) == 6
    assert warp_planes_group(1, 218, 512, 4 * H100_SMS) == 3


def test_on_group_refuses_cpu_tensors():
    """Forcing the planes a thread warps runs on CUDA tensors only, after
    the same input checks as the wrappers'."""
    planes = torch.zeros((1, 6, 8, 8))
    uv = torch.zeros((1, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        warp_planes_on_group(planes, uv, 3, GROUPS[0])
    with pytest.raises(ValueError, match="uv must be"):
        warp_planes_on_group(planes, uv[:, :1], 3, GROUPS[0])
    with pytest.raises(TypeError, match="float32"):
        warp_planes_on_group(planes.double(), uv, 3, GROUPS[0])
