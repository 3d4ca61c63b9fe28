"""Gaussian pyramid resampling (zoom in/out).

Matches reference src/zoom.cpp:

  * `zoom_size`: round(n * factor) via the +0.5 trick (src/zoom.cpp:22-34)
  * `zoom_out`:  presmooth with sigma = 0.6*sqrt(1/factor^2 - 1)
    (ZOOM_SIGMA_ZERO, src/zoom.cpp:15,61) then bicubic-sample at
    (j/factor, i/factor) with border_out=False (src/zoom.cpp:41-78)
  * `zoom_in`:   bicubic-sample at (j/factorx, i/factory) where
    factor = new/old per axis (src/zoom.cpp:132-155)

Grid resampling has row- and column-constant tap positions: each
output row (column) reads the 4-tap Keys cell at one anchor, given by
`resample_taps` as an anchor and 4 weights per output, computed in
float64.  On a tensor not on the CPU `zoom_out` is one launch of K8
(`tpuflow_torch.ops.pyramid_level`; CUDA float32, else a ValueError),
which blurs a tile in shared memory and gathers the 4 taps of each
output from those tables.  Its plain version, `zoom_out_plain` (a CPU
tensor), and `zoom_in` on every device factorize the 2-D bicubic sample into out = A_y @ I @ A_x^T, the
tables' dense matrices: two plain matrix products (`torch.matmul`).
They run with TF32 OFF (`torch.backends.cuda.matmul.allow_tf32 = False`
inside `_full_fp32`, which restores the caller's setting): TF32 keeps
about three decimal digits, far from the reference's double-precision
resampling.  The tables and matrices are built once in float64 with
numpy and cached per (size, dtype, device).
"""

import contextlib
import functools
import math

import numpy as np
import torch

from tpuflow_torch._device import on_card
from tpuflow_torch.ops.gaussian import gaussian_plain, gaussian_taps
from tpuflow_torch.ops.pyramid_level import pyramid_level

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
def resample_taps(n_out, n_in, inv_factor):
    """(anchors (n_out,) int, weights (n_out, 4) float64) of bicubic
    resampling on a regular grid: output i reads taps anchor-1 ..
    anchor+2, each clamped to [0, n_in-1], with these weights.

    Weights replicate reference bicubic_interpolation_at with
    border_out=False: Keys cell at the truncated anchor
    (src/bicubic_interpolation.cpp:153-245; all grid coords are >= 0, so
    trunc == floor)."""
    anchors = np.zeros(n_out, dtype=np.int64)
    weights = np.zeros((n_out, 4))
    for i in range(n_out):
        y = i * inv_factor
        c = int(y)
        t = y - c
        t2, t3 = t * t, t * t * t
        anchors[i] = c
        weights[i] = (0.5 * (-t3 + 2 * t2 - t),
                      0.5 * (3 * t3 - 5 * t2 + 2),
                      0.5 * (-3 * t3 + 4 * t2 + t),
                      0.5 * (t3 - t2))
    anchors.setflags(write=False)
    weights.setflags(write=False)
    return anchors, weights


def taps_matrix(anchors, weights, n_in):
    """The dense (n_out, n_in) float64 matrix of tap tables: clamped taps
    of one output add up, in tap order."""
    A = np.zeros((len(anchors), n_in))
    for i, c in enumerate(anchors):
        for m in range(4):
            A[i, min(max(c - 1 + m, 0), n_in - 1)] += weights[i, m]
    return A


@functools.lru_cache(maxsize=256)
def _resample_matrix(n_out, n_in, inv_factor):
    """(n_out, n_in) float64 bicubic resampling matrix for a regular grid:
    `resample_taps` made dense."""
    A = taps_matrix(*resample_taps(n_out, n_in, inv_factor), n_in)
    A.setflags(write=False)
    return A


@functools.lru_cache(maxsize=256)
def _matrix(n_out, n_in, inv_factor, dtype, device):
    return torch.as_tensor(_resample_matrix(n_out, n_in, inv_factor).copy(),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=256)
def _taps(n_out, n_in, inv_factor, dtype, device):
    """K8's table of one axis: (anchors, anchors and weights on `device`
    as int32 and `dtype`, rounded as `_matrix` rounds, n_in)."""
    anchors, weights = resample_taps(n_out, n_in, inv_factor)
    return (anchors, torch.tensor(anchors, dtype=torch.int32, device=device),
            torch.tensor(weights, dtype=dtype, device=device), n_in)


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


def _zoom_out_args(I, factor, out_size):
    ny, nx = I.shape[-2:]
    if out_size is None:
        nxx, nyy = zoom_size(nx, ny, factor)
    else:
        nxx, nyy = out_size
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    return nxx, nyy, sigma, 1.0 / factor


def zoom_out_plain(I, factor, out_size=None):
    """Plain PyTorch version of `zoom_out`: `gaussian_plain`, then the
    two resampling products."""
    nxx, nyy, sigma, inv = _zoom_out_args(I, factor, out_size)
    return _resample(gaussian_plain(I, sigma), nxx, nyy, inv, inv)


def zoom_out_levels(images, factor, out_size=None):
    """`zoom_out` of each of `images` (same-shape CUDA float32 tensors) in
    one launch of K8; returns the (len(images), ...) buffer."""
    I = images[0]
    nxx, nyy, sigma, inv = _zoom_out_args(I, factor, out_size)
    taps = gaussian_taps(sigma, I.dtype)
    ny, nx = I.shape[-2:]
    tables = (_taps(nyy, ny, inv, I.dtype, I.device),
              _taps(nxx, nx, inv, I.dtype, I.device))
    return pyramid_level(images, taps, resample=tables)


def zoom_out(I, factor, out_size=None):
    """Downsample (..., H, W) by `factor` in (0, 1); returns the
    presmoothed-and-resampled image of size zoom_size(...).
    `zoom_out_plain` for a CPU tensor; else one launch of K8: a CUDA
    float32 tensor, a ValueError for any other dtype or device."""
    if on_card(I):
        return zoom_out_levels((I,), factor, out_size)[0]
    return zoom_out_plain(I, factor, out_size)


def zoom_in(I, out_size):
    """Bicubic-upsample (..., H, W) to out_size = (nxx, nyy)."""
    ny, nx = I.shape[-2:]
    nxx, nyy = out_size
    return _resample(I, nxx, nyy, nx / nxx, ny / nyy)
