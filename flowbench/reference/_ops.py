"""Plain operators shared by the references: a frozen copy of the
arithmetic of the reference binaries (IPOL 2013.21 and 2013.26, src/)
as the port's plain versions write it, on (B, ny, nx) stacks.

`Precision` is how a reference computes: float32 (what the
configurations state), bfloat16, or float32 with the pyramid's
resampling products in TF32.  TF32 is emulated, so that it reads the
same on every device: both operands of each product are rounded to
TF32's 10 mantissa bits (to nearest), and the product runs in float32.
"""

import dataclasses
import math

import numpy as np
import torch

ZOOM_SIGMA_ZERO = 0.6        # src/zoom.cpp:15
PRESMOOTHING_SIGMA = 0.8     # src/tvl1flow.cpp:23
GAUSSIAN_WINDOW = 5          # src/operators.h:120
K5_MIN_PIXELS = 96 * 96      # planes this large take the strict bound


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float32
    tf32: bool = False


FLOAT32 = Precision()
CONTROLS = {"tf32": Precision(tf32=True),
            "bf16": Precision(dtype=torch.bfloat16)}


def scalar_dtype(dtype):
    """The numpy type a stopping threshold is rounded to."""
    return np.float64 if dtype == torch.float64 else np.float32


def round_tf32(x):
    """float32 `x` rounded to nearest at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


# ---- finite differences (src/operators.cpp) ----

def shift_clamp(a, off, dim):
    """`a` at index i+off along `dim`, edge-clamped (off is +-1)."""
    n = a.shape[dim]
    if off == 1:
        return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)],
                         dim=dim)
    return torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim=dim)


def centered_gradient(f):
    dx = 0.5 * (shift_clamp(f, 1, -1) - shift_clamp(f, -1, -1))
    dy = 0.5 * (shift_clamp(f, 1, -2) - shift_clamp(f, -1, -2))
    return dx, dy


def forward_gradient(f):
    fx = torch.cat([f[..., :, 1:] - f[..., :, :-1],
                    torch.zeros_like(f[..., :, :1])], dim=-1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :],
                    torch.zeros_like(f[..., :1, :])], dim=-2)
    return fx, fy


def divergence(v1, v2):
    a = v1.clone()
    a[..., :, -1] = 0
    div_x = a - torch.cat([torch.zeros_like(a[..., :, :1]), a[..., :, :-1]],
                          dim=-1)
    b = v2.clone()
    b[..., -1, :] = 0
    div_y = b - torch.cat([torch.zeros_like(b[..., :1, :]), b[..., :-1, :]],
                          dim=-2)
    return div_x + div_y


def dxx(f):
    return shift_clamp(f, -1, -1) - 2.0 * f + shift_clamp(f, 1, -1)


def dyy(f):
    return shift_clamp(f, -1, -2) - 2.0 * f + shift_clamp(f, 1, -2)


def dxy(f):
    up = shift_clamp(f, -1, -2)
    dn = shift_clamp(f, 1, -2)
    return 0.25 * (shift_clamp(up, -1, -1) - shift_clamp(up, 1, -1)
                   - shift_clamp(dn, -1, -1) + shift_clamp(dn, 1, -1))


# ---- normalization, smoothing, pyramid (src/utils.cpp, operators.cpp, zoom.cpp) ----

def normalize_pair(a, b):
    """Each (a[i], b[i]) jointly to [0, 255] (image_normalization_2)."""
    mn = torch.minimum(a.amin(dim=(-2, -1), keepdim=True),
                       b.amin(dim=(-2, -1), keepdim=True))
    den = torch.maximum(a.amax(dim=(-2, -1), keepdim=True),
                        b.amax(dim=(-2, -1), keepdim=True)) - mn
    ok = den > 0
    safe = torch.where(ok, den, torch.ones_like(den))
    return tuple(torch.where(ok, 255.0 * (x - mn) / safe, x) for x in (a, b))


def gaussian(f, sigma):
    """Separable Gaussian, rows first, with the reference's asymmetric
    reflecting pad (left mirrors without the edge, right with it)."""
    size = int(GAUSSIAN_WINDOW * sigma) + 1
    j = np.arange(size, dtype=np.float64)
    w = np.exp(-(j * j) / (2.0 * sigma * sigma))
    w = torch.tensor(w / (2.0 * w.sum() - w[0]), dtype=f.dtype).tolist()
    for dim in (-1, -2):
        n = f.shape[dim]
        p = torch.cat([torch.flip(f.narrow(dim, 1, size), (dim,)), f,
                       torch.flip(f.narrow(dim, n - size, size), (dim,))],
                      dim=dim)
        out = w[0] * p.narrow(dim, size, n)
        for k in range(1, size):
            out = out + w[k] * (p.narrow(dim, size - k, n)
                                + p.narrow(dim, size + k, n))
        f = out
    return f


def zoom_size(nx, ny, factor):
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


def pyramid_sizes(nx, ny, factor, nscales):
    """(nx, ny) of each level, finest first."""
    sizes = [(nx, ny)]
    for _ in range(1, nscales):
        sizes.append(zoom_size(*sizes[-1], factor))
    return sizes


def clamp_nscales(nx, ny, factor, nscales, use_hypot):
    """The CLIs' clamp: the coarsest level keeps >= 16 px along the
    diagonal (tvl1flow) or the shorter side (the Brox mains)."""
    base = math.hypot(nx, ny) if use_hypot else min(nx, ny)
    return max(1, min(nscales, int(1 + math.log(base / 16) / math.log(1 / factor))))


def _resample_matrix(n_out, n_in, inv_factor):
    """Bicubic (Keys, a = -0.5) resampling weights of a regular grid at
    i * inv_factor, taps clamped (src/bicubic_interpolation.cpp:153-245)."""
    A = np.zeros((n_out, n_in))
    for i in range(n_out):
        y = i * inv_factor
        c = int(y)
        t = y - c
        t2, t3 = t * t, t * t * t
        w = (0.5 * (-t3 + 2 * t2 - t), 0.5 * (3 * t3 - 5 * t2 + 2),
             0.5 * (-3 * t3 + 4 * t2 + t), 0.5 * (t3 - t2))
        for m, tap in enumerate((c - 1, c, c + 1, c + 2)):
            A[i, min(max(tap, 0), n_in - 1)] += w[m]
    return A


def _matmul(a, b, prec):
    if prec.tf32:
        a, b = round_tf32(a), round_tf32(b)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def resample(f, nxx, nyy, inv_fx, inv_fy, prec):
    ay = torch.as_tensor(_resample_matrix(nyy, f.shape[-2], inv_fy),
                         dtype=f.dtype, device=f.device)
    ax = torch.as_tensor(_resample_matrix(nxx, f.shape[-1], inv_fx),
                         dtype=f.dtype, device=f.device)
    return _matmul(ay, _matmul(f, ax.T, prec), prec)


def zoom_out(f, factor, size, prec):
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    return resample(gaussian(f, sigma), *size, 1 / factor, 1 / factor, prec)


def zoom_in(f, size, prec):
    ny, nx = f.shape[-2:]
    return resample(f, *size, nx / size[0], ny / size[1], prec)


def pyramid(a, b, nscales, zfactor, prec):
    """Normalized, presmoothed pyramid of the pair stacks, finest first,
    and the (nx, ny) of each level."""
    a, b = normalize_pair(a, b)
    levels = [(gaussian(a, PRESMOOTHING_SIGMA), gaussian(b, PRESMOOTHING_SIGMA))]
    sizes = pyramid_sizes(a.shape[-1], a.shape[-2], zfactor, nscales)
    for s in range(1, nscales):
        levels.append(tuple(zoom_out(f, zfactor, sizes[s], prec)
                            for f in levels[-1]))
    return levels, sizes


# ---- the bounded bicubic warp ----

def _keys(t):
    t2 = t * t
    t3 = t2 * t
    return (0.5 * (-t3 + 2 * t2 - t), 0.5 * (3 * t3 - 5 * t2 + 2),
            0.5 * (-3 * t3 + 4 * t2 + t), 0.5 * (t3 - t2))


def bounded_warp(planes, u, v, dmax, strict):
    """Every plane of (B, P, ny, nx) `planes` sampled bicubically at
    (x + u, y + v) from the floor anchor; 0 where the 4x4 cell leaves
    the image (x+u < 1, x0 > nx-3, y+v < 1, y0 > ny-3).  `strict`: also
    0 where |x0 - x| or |y0 - y| exceeds dmax; else each tap counts only
    where its offset from the pixel lies in [-dmax-1, dmax+2]."""
    B, P, ny, nx = planes.shape
    dt, dev = planes.dtype, planes.device
    jj = torch.arange(nx, dtype=dt, device=dev)
    ii = torch.arange(ny, dtype=dt, device=dev)[:, None]
    xx = jj + u
    yy = ii + v
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    inside = (xx >= 1) & (x0 <= nx - 3) & (yy >= 1) & (y0 <= ny - 3)
    cx = _keys(xx - x0)
    cy = _keys(yy - y0)
    if strict:
        inside = inside & ((x0 - jj).abs() <= dmax) & ((y0 - ii).abs() <= dmax)
        lo_x, hi_x, lo_y, hi_y = -1, nx, -1, ny
    else:
        def window(c, rel):
            return tuple(torch.where((rel - 1 + m >= -dmax - 1)
                                     & (rel - 1 + m <= dmax + 2),
                                     w, torch.zeros_like(w))
                         for m, w in enumerate(c))
        cx = window(cx, x0 - jj)
        cy = window(cy, y0 - ii)
        lo_x, hi_x, lo_y, hi_y = -4, nx + 3, -4, ny + 3
    xa = torch.nan_to_num(x0).clamp(lo_x, hi_x).long() - 1
    ya = torch.nan_to_num(y0).clamp(lo_y, hi_y).long() - 1
    flat = planes.reshape(B, P, ny * nx)
    acc = torch.zeros_like(flat)
    for m in range(4):
        row = (ya + m).clamp(0, ny - 1) * nx
        for l in range(4):
            idx = (row + (xa + l).clamp(0, nx - 1)).reshape(B, 1, -1)
            w = (cy[m] * cx[l]).reshape(B, 1, -1)
            acc = acc + w * torch.gather(flat, 2, idx.expand(B, P, -1))
    acc = torch.where(inside.reshape(B, 1, -1), acc, torch.zeros_like(acc))
    return acc.reshape(B, P, ny, nx)
