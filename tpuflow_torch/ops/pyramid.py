"""Gaussian pyramid resampling (zoom in/out).

Matches reference src/zoom.cpp:

  * `zoom_size`: round(n * factor) via the +0.5 trick (src/zoom.cpp:22-34)
  * `zoom_out`:  presmooth with sigma = 0.6*sqrt(1/factor^2 - 1)
    (ZOOM_SIGMA_ZERO, src/zoom.cpp:15,61) then bicubic-sample at
    (j/factor, i/factor) with border_out=False (src/zoom.cpp:41-78)
  * `zoom_in`:   bicubic-sample at (j/factorx, i/factory) where
    factor = new/old per axis (src/zoom.cpp:132-155)

Grid resampling has row- and column-constant tap positions, so the 2-D
bicubic sample factorizes into out = A_y @ I @ A_x^T: two plain
float32 matrix products (`torch.matmul`).  They run with TF32 OFF
(`torch.backends.cuda.matmul.allow_tf32 = False` inside `_full_fp32`,
which restores the caller's setting): TF32 keeps about three decimal
digits, far from the reference's double-precision resampling.  The
matrices are built once in float64 with numpy and cached per
(size, dtype, device).
"""

import contextlib
import functools
import math

import numpy as np
import torch

from tpuflow_torch.ops.gaussian import gaussian

ZOOM_SIGMA_ZERO = 0.6


def zoom_size(nx, ny, factor):
    """(nx, ny) -> zoomed size, reference src/zoom.cpp:22-34."""
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


def pyramid_sizes(nx, ny, factor, nscales):
    """Per-scale (nx, ny) list, finest first."""
    sizes = [(nx, ny)]
    for _ in range(1, nscales):
        sizes.append(zoom_size(*sizes[-1], factor))
    return sizes


def clamp_nscales(nx, ny, factor, nscales, min_size=16, use_hypot=True):
    """Auto-clamp nscales so the coarsest scale stays >= min_size px.

    tvl1flow uses hypot(nx, ny) (src/tvl1flow_main.cpp:185-187), the
    Brox mains use min(nx, ny) (src/brox_spatial_main.cpp:154)."""
    base = math.hypot(nx, ny) if use_hypot else min(nx, ny)
    n_max = int(1 + math.log(base / min_size) / math.log(1.0 / factor))
    return max(1, min(nscales, n_max))


@functools.lru_cache(maxsize=256)
def _resample_matrix(n_out, n_in, inv_factor):
    """(n_out, n_in) float64 bicubic resampling matrix for a regular grid.

    Weights replicate reference bicubic_interpolation_at with
    border_out=False: Keys cell at the truncated anchor, taps clamped
    to the valid range (src/bicubic_interpolation.cpp:153-245; all grid
    coords are >= 0, so trunc == floor)."""
    A = np.zeros((n_out, n_in))
    for i in range(n_out):
        y = i * inv_factor
        c = int(y)
        t = y - c
        t2, t3 = t * t, t * t * t
        w = (0.5 * (-t3 + 2 * t2 - t),
             0.5 * (3 * t3 - 5 * t2 + 2),
             0.5 * (-3 * t3 + 4 * t2 + t),
             0.5 * (t3 - t2))
        for m, tap in enumerate((c - 1, c, c + 1, c + 2)):
            A[i, min(max(tap, 0), n_in - 1)] += w[m]
    A.setflags(write=False)
    return A


@functools.lru_cache(maxsize=256)
def _matrix(n_out, n_in, inv_factor, dtype, device):
    return torch.as_tensor(_resample_matrix(n_out, n_in, inv_factor).copy(),
                           dtype=dtype, device=device)


@contextlib.contextmanager
def _full_fp32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _resample(I, nxx, nyy, inv_fx, inv_fy):
    Ay = _matrix(nyy, I.shape[-2], inv_fy, I.dtype, I.device)
    Ax = _matrix(nxx, I.shape[-1], inv_fx, I.dtype, I.device)
    with _full_fp32():
        return torch.matmul(Ay, torch.matmul(I, Ax.T))


def zoom_out(I, factor, out_size=None):
    """Downsample (..., H, W) by `factor` in (0, 1); returns the
    presmoothed-and-resampled image of size zoom_size(...)."""
    ny, nx = I.shape[-2:]
    if out_size is None:
        nxx, nyy = zoom_size(nx, ny, factor)
    else:
        nxx, nyy = out_size
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    inv = 1.0 / factor
    return _resample(gaussian(I, sigma), nxx, nyy, inv, inv)


def zoom_in(I, out_size):
    """Bicubic-upsample (..., H, W) to out_size = (nxx, nyy)."""
    ny, nx = I.shape[-2:]
    nxx, nyy = out_size
    return _resample(I, nxx, nyy, nx / nxx, ny / nyy)
