"""Exact bicubic backward warp (reference src/bicubic_interpolation.cpp).

The oracle that the warp kernel's plain version is checked against.
Semantics are the reference's, including two quirks that affect
results:

  * coordinates are truncated toward zero, not floored
    (`(int) uu` at src/bicubic_interpolation.cpp:170), so for
    -1 < uu < 0 the cell anchor is 0 and the fraction is negative;
  * the y "minus" neighbor uses the X sign: `my = (int)vv - sx`
    (src/bicubic_interpolation.cpp:173);
  * a pixel is out of domain iff any of its 8 tap indices clamps
    (Neumann BC, src/bicubic_interpolation.cpp:24-39); with
    `border_out=True` such pixels are 0 (src/bicubic_interpolation.cpp:352-374).

`warp_stack` shares the 16 tap indices and weights across the planes;
`bicubic_at`, `warp` and `warp_planes` are built on it, and its
`window` serves the tiled lane (tpuflow_torch.parallel.tiled).
`interpolate_bilinear` and `image_restriction` are the reference's
bilinear sampler and cell-centred restriction.

`warp_planes_bounded` is the solvers' fast warp, chosen by
`resolve_warp_mode`: the displacement-bounded warp of K5 on large
planes and `warp_planes_shift` (K5p) on small ones, routed as the JAX
package routes them (tpuflow_torch.ops.warp has both kernels, and
`warp_planes_uv` hands them u and v as they are: a call launches the
kernel and nothing else).  Both, and `warp_by_mode`, also take B
stacks (B, P, H, W) with B flow fields (B, H, W), as Brox temporal
warps its frames: one launch for all B.
"""

import os

import torch

from tpuflow_torch.ops.warp import warp_planes_uv

# planes of at least this many pixels take K5 (tpuflow/ops/interp.py:211)
K5_MIN_PIXELS = 96 * 96


def _cubic(v0, v1, v2, v3, x):
    """Keys cubic cell (reference src/bicubic_interpolation.cpp:108-123)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3
                       + x * (3.0 * (v1 - v2) + v3 - v0)))


def _sign(c):
    return torch.where(c < 0, -1, 1).to(torch.int64)


def _taps(raw, n):
    out = torch.zeros(raw[0].shape, dtype=torch.bool, device=raw[0].device)
    clamped = []
    for r in raw:
        out = out | (r < 0) | (r >= n)
        clamped.append(r.clamp(0, n - 1))
    return clamped, out


def bicubic_at(img, xx, yy, border_out=False):
    """Bicubic sample of `img` (H, W) at coordinates (xx, yy) of any
    shape (reference bicubic_interpolation_at,
    src/bicubic_interpolation.cpp:153-245, at every (xx, yy))."""
    return warp_stack(img[None], xx, yy, border_out)[0]


def warp_stack(planes, xx, yy, border_out=False, window=None):
    """Bicubic-sample a (N, H, W) stack at shared coordinates (xx, yy) of
    any shape; returns (N,) + xx.shape.

    `window=(origin_y, origin_x, global_ny, global_nx)` is for tiled
    execution: `planes` then hold only the window that starts at that
    global origin, while the tap indices, their clamping and the
    out-of-domain test use the GLOBAL extent.  Taps that fall outside
    the window clamp to its rim, which is exact wherever the halo covers
    the displacement (tpuflow_torch.parallel.tiled)."""
    n_planes, wny, wnx = planes.shape
    if window is None:
        oy = ox = 0
        ny, nx = wny, wnx
    else:
        oy, ox, ny, nx = (int(w) for w in window)
    sx = _sign(xx)
    sy = _sign(yy)
    xi = torch.trunc(xx).to(torch.int64)
    yi = torch.trunc(yy).to(torch.int64)
    xs, out_x = _taps((xi - sx, xi, xi + sx, xi + 2 * sx), nx)
    # reference quirk: the y minus-neighbor offset uses sx
    ys, out_y = _taps((yi - sx, yi, yi + sy, yi + 2 * sy), ny)
    out = out_x | out_y
    fx = xx - xs[1].to(xx.dtype)
    fy = yy - ys[1].to(yy.dtype)
    if window is not None:
        xs = [(x - ox).clamp(0, wnx - 1) for x in xs]
        ys = [(y - oy).clamp(0, wny - 1) for y in ys]
    flat = planes.reshape(n_planes, wny * wnx)
    results = []
    for p in range(n_planes):
        fp = flat[p]
        cols = [_cubic(*(fp[ys[m] * wnx + xs[l]] for m in range(4)), fy)
                for l in range(4)]  # x-offset l: interpolate along y first
        val = _cubic(*cols, fx)
        if border_out:
            val = torch.where(out, torch.zeros_like(val), val)
        results.append(val)
    return torch.stack(results)


def _grid(ny, nx, like):
    jj = torch.arange(nx, dtype=like.dtype, device=like.device)[None, :]
    ii = torch.arange(ny, dtype=like.dtype, device=like.device)[:, None]
    return jj, ii


def warp(img, u, v, border_out=True):
    """Backward-warp one (H, W) image or a (C, H, W) stack by the flow
    (u, v): out(x) = img(x + u(x)) (reference
    bicubic_interpolation_warp, src/bicubic_interpolation.cpp:352-374)."""
    jj, ii = _grid(*img.shape[-2:], img)
    if img.ndim == 2:
        return warp_stack(img[None], jj + u, ii + v, border_out)[0]
    return warp_stack(img, jj + u, ii + v, border_out)


def warp_planes(planes, u, v, border_out=True):
    """Warp a (N, H, W) stack by one flow field: out(x) = I(x + u(x))."""
    jj, ii = _grid(*planes.shape[-2:], planes)
    return warp_stack(planes, jj + u, ii + v, border_out)


def interpolate_bilinear(img, xx, yy):
    """Bilinear sample of `img` (..., H, W) at (xx, yy) (reference
    me_interpolate_bilinear, src/bicubic_interpolation.cpp:407-446).

    Floor anchors with the +1 taps clamped: the reference's
    exact-integer branches only skip neighbours whose weight is 0, so
    this gives its values at every in-domain coordinate (the only use,
    `image_restriction`, stays in the domain)."""
    ny, nx = img.shape[-2:]
    lf = torch.floor(xx)
    kf = torch.floor(yy)
    a = xx - lf
    b = yy - kf
    l = lf.to(torch.int64)
    k = kf.to(torch.int64)
    l0, l1 = l.clamp(0, nx - 1), (l + 1).clamp(0, nx - 1)
    k0, k1 = k.clamp(0, ny - 1), (k + 1).clamp(0, ny - 1)
    x0 = img[..., k0, l0]
    x1 = img[..., k0, l1]
    x2 = img[..., k1, l0]
    x3 = img[..., k1, l1]
    return ((1 - b) * ((1 - a) * x0 + a * x1)
            + b * ((1 - a) * x2 + a * x3))


def image_restriction(img, out_size):
    """Cell-centred bilinear restriction of `img` to `out_size` =
    (new_nx, new_ny) (reference me_image_restriction,
    src/bicubic_interpolation.cpp:653-688): output sample (i, j) reads
    the input at gamma/2 - 0.5 + index*gamma along each axis."""
    ny, nx = img.shape[-2:]
    new_nx, new_ny = out_size
    gx = nx / new_nx
    gy = ny / new_ny
    xs = (gx / 2.0 - 0.5) + gx * torch.arange(new_nx, dtype=img.dtype,
                                              device=img.device)
    ys = (gy / 2.0 - 0.5) + gy * torch.arange(new_ny, dtype=img.dtype,
                                              device=img.device)
    xx = xs[None, :].expand(new_ny, new_nx)
    yy = ys[:, None].expand(new_ny, new_nx)
    return interpolate_bilinear(img, xx, yy)


def resolve_warp_mode(mode, device):
    """Resolve warp_mode="auto" by device: "fast" (the bounded warp, K5
    on the card) for CUDA tensors, "exact" (`warp_planes`) elsewhere, as
    the JAX package takes its fast path only on the TPU.  The
    TPUFLOW_EXACT_WARP environment variable forces "exact" everywhere."""
    if os.environ.get("TPUFLOW_EXACT_WARP"):
        return "exact"
    if mode == "auto":
        return "fast" if torch.device(device).type == "cuda" else "exact"
    if mode not in ("fast", "exact"):
        raise ValueError(f"unknown warp_mode {mode!r}")
    return mode


def warp_by_mode(planes, u, v, warp_mode, dmax, border_out=True):
    """A (P, H, W) stack warped by (u, v), or B stacks (B, P, H, W) each
    by its field of (B, H, W) u and v, as the solvers warp:
    `warp_planes_bounded` for warp_mode "fast", the exact gather
    `warp_planes` (field by field) for "exact"."""
    if warp_mode == "fast":
        return warp_planes_bounded(planes, u, v, dmax, border_out)
    if planes.ndim == 4:
        return torch.stack([warp_planes(p, a, b, border_out)
                            for p, a, b in zip(planes, u, v)])
    return warp_planes(planes, u, v, border_out)


def warp_planes_bounded(planes, u, v, dmax, border_out=True, fast_only=None,
                        with_overflow=False):
    """Displacement-bounded warp of a (P, H, W) stack by one flow field
    (or of B stacks (B, P, H, W) by B fields, one launch):
    `warp_planes(..., border_out)` for flows whose integer displacement
    stays within dmax.

    Routed as tpuflow/ops/interp.py:196-222 routes it: with `border_out`
    and H*W >= 96*96 it runs K5 (`warp_planes_batched`, 0 past the
    bound) when `fast_only`, else K5p; below that size, and for every
    `border_out=False` call, it runs `warp_planes_shift` (K5p, partial
    taps up to 3 px past the bound).  `fast_only` defaults to on, off
    where the TPUFLOW_WARP_EXACT environment variable is set.  The two
    are different functions past dmax, not two approximations of one:
    K5 gives 0 there, K5p the taps inside its shift window.  Each runs
    its plain version where the tensors lie on the CPU.

    The JAX package's `rbud` and TPUFLOW_WARP_RBUD only size the TPU
    kernel's residual windows, which the port does not have (both
    kernels are exact for every pixel), so they are left out.
    `with_overflow=True` also returns the degraded-tile count, always 0."""
    if fast_only is None:
        fast_only = not os.environ.get("TPUFLOW_WARP_EXACT")
    H, W = planes.shape[-2:]
    if border_out and fast_only and H * W >= K5_MIN_PIXELS:
        out = warp_planes_uv(planes, u, v, dmax)
    else:
        out = warp_planes_shift(planes, u, v, dmax, border_out)
    if with_overflow:
        return out, 0
    return out


def warp_planes_shift(planes, u, v, dmax, border_out=True):
    """Shift-window bounded warp of a (P, H, W) stack by one flow field
    (K5p, `warp_planes_shift_batched`; tpuflow/ops/interp.py:225-342).

    The 16-tap bicubic at the floor anchor, each tap counted only where
    its offset from the pixel lies in [-dmax-1, dmax+2]: equal to
    `warp_planes(..., border_out=True)` for flows within dmax, partial
    taps up to 3 px past it, 0 beyond.  With `border_out=False`
    (tvl1occflow's mode) out-of-domain pixels keep the bicubic value at
    clamped tap indices (the reference's Neumann clamping for
    non-negative coordinates; negative coordinates use the floor
    anchor, not the reference's trunc anchor, a sub-pixel difference
    confined to the one-cell image rim)."""
    return warp_planes_uv(planes, u, v, dmax, shift=True,
                          border_out=border_out)
