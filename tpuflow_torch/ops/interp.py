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

`warp_planes_bounded` is the solvers' fast warp: the displacement-
bounded warp of K5 (tpuflow_torch.ops.warp), chosen by
`resolve_warp_mode`.
"""

import os

import torch

from tpuflow_torch.ops.warp import warp_planes_batched


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


def warp_planes_bounded(planes, u, v, dmax, border_out=True,
                        with_overflow=False):
    """Displacement-bounded warp of a (P, H, W) stack by one flow field:
    `warp_planes(..., border_out=True)` for flows whose integer
    displacement stays within dmax, and 0 past the bound (the strict
    bound of the JAX package's fast_only mode).

    Runs `warp_planes_batched` (K5) at every size; its plain version
    where the tensors lie on the CPU.  The JAX package's `rbud`,
    `fast_only` and its TPUFLOW_WARP_RBUD / TPUFLOW_WARP_EXACT knobs only
    tune the TPU kernel's two-window approximation, which the port does
    not have (K5 is exact for every pixel), so they are left out.
    `with_overflow=True` also returns the degraded-tile count, always 0.
    `border_out=False` is tvl1occflow's shift-path warp, not ported yet."""
    if not border_out:
        raise NotImplementedError(
            "warp_planes_bounded(border_out=False) is tvl1occflow's "
            "shift-path warp (warp_planes_shift), to be ported with "
            "tvl1occflow")
    uv = torch.stack([u, v])[None]
    out, oflow = warp_planes_batched(planes[None].contiguous(), uv, dmax)
    if with_overflow:
        return out[0], oflow
    return out[0]
