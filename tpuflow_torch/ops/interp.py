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

`warp_stack` shares the 16 tap indices and weights across the planes.
"""

import torch


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


def warp_stack(planes, xx, yy, border_out=True):
    """Bicubic-sample a (N, H, W) stack at shared coordinates (H, W)."""
    n_planes, ny, nx = planes.shape
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
    flat = planes.reshape(n_planes, ny * nx)
    results = []
    for p in range(n_planes):
        fp = flat[p]
        cols = [_cubic(*(fp[ys[m] * nx + xs[l]] for m in range(4)), fy)
                for l in range(4)]  # x-offset l: interpolate along y first
        val = _cubic(*cols, fx)
        if border_out:
            val = torch.where(out, torch.zeros_like(val), val)
        results.append(val)
    return torch.stack(results)


def warp_planes(planes, u, v, border_out=True):
    """Warp a (N, H, W) stack by one flow field: out(x) = I(x + u(x))."""
    ny, nx = planes.shape[-2:]
    jj = torch.arange(nx, dtype=planes.dtype, device=planes.device)[None, :]
    ii = torch.arange(ny, dtype=planes.dtype, device=planes.device)[:, None]
    return warp_stack(planes, jj + u, ii + v, border_out)
