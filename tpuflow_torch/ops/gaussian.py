"""Separable Gaussian smoothing with the reference's exact kernel + BCs.

Replicates reference src/operators.cpp:506-624:

  * one-sided kernel length  size = int(window*sigma) + 1  (window=5)
  * weights B[j] = exp(-j^2 / (2 sigma^2)), normalized by (2*sum - B[0])
  * full kernel covers offsets -(size-1) .. +(size-1)
  * 'reflecting' (default) boundary is ASYMMETRIC in the reference:
    the left/top pad mirrors WITHOUT repeating the edge pixel
    (x[-m] = x[m]) while the right/bottom pad mirrors WITH the edge
    (x[n-1+m] = x[n-m]); replicated exactly.
  * 'dirichlet' pads with zeros.

Each axis is a shift-and-add over the padded rows: half-widths are at
most ~13 taps, and the sum keeps the reference's order of terms.  That
is `gaussian_plain`; `gaussian` with the reflecting pad on any tensor
not on the CPU is one launch of K8 (`tpuflow_torch.ops.pyramid_level`),
which keeps the same order of terms and rounding, takes CUDA float32
and raises for any other dtype or device.

`sgauss_kernel` and `sepconvol` are the reference's other Gaussian
(me_sgauss, me_sepconvol, src/utils.cpp:15-127), with mirror-no-edge
("symmetric") boundaries.
"""

import numpy as np
import torch

from tpuflow_torch._device import on_card
from tpuflow_torch.ops.pyramid_level import pyramid_level

DEFAULT_WINDOW = 5  # reference src/operators.h:120


def gaussian_kernel_1d(sigma, window=DEFAULT_WINDOW, dtype=np.float64):
    """One-sided weights B[0..size-1] per reference src/operators.cpp:524-539."""
    size = int(window * sigma) + 1
    j = np.arange(size, dtype=np.float64)
    b = np.exp(-(j * j) / (2.0 * sigma * sigma))
    norm = 2.0 * b.sum() - b[0]
    return (b / norm).astype(dtype), size


def _pad(a, size, dim, bc):
    n = a.shape[dim]
    if bc == "reflecting":
        if size > n:
            raise ValueError(
                f"gaussian: pad {size} exceeds dim {n} (sigma too large)")
        left = torch.flip(a.narrow(dim, 1, size), (dim,))
        right = torch.flip(a.narrow(dim, n - size, size), (dim,))
    elif bc == "dirichlet":
        shape = list(a.shape)
        shape[dim] = size
        left = right = a.new_zeros(shape)
    else:
        raise ValueError(f"unknown boundary condition {bc!r}")
    return torch.cat([left, a, right], dim=dim)


def _conv_axis(a, weights, size, dim, bc):
    p = _pad(a, size, dim, bc)
    n = a.shape[dim]

    def window(off):  # offset relative to center; p index = size + off
        return p.narrow(dim, size + off, n)

    out = weights[0] * window(0)
    for j in range(1, size):
        out = out + weights[j] * (window(-j) + window(j))
    return out


def gaussian_taps(sigma, dtype, window=DEFAULT_WINDOW):
    """The one-sided weights as Python floats, rounded to `dtype`, as the
    reference's arithmetic; none for sigma <= 0."""
    if sigma <= 0:
        return []
    return torch.tensor(gaussian_kernel_1d(sigma, window)[0],
                        dtype=dtype).tolist()


def gaussian(I, sigma, bc="reflecting", window=DEFAULT_WINDOW):
    """Separable Gaussian smoothing of (..., H, W) tensors, rows first.

    Matches reference `gaussian()` (src/operators.cpp:506-624) to
    floating-point accuracy, including its asymmetric reflecting pad.
    `gaussian_plain` for a CPU tensor and for the zero pad; else one
    launch of K8 for the reflecting pad: a CUDA float32 tensor, a
    ValueError for any other dtype or device."""
    if sigma > 0 and bc == "reflecting" and on_card(I):
        return pyramid_level((I,), gaussian_taps(sigma, I.dtype, window))[0]
    return gaussian_plain(I, sigma, bc, window)


def gaussian_plain(I, sigma, bc="reflecting", window=DEFAULT_WINDOW):
    """Plain PyTorch version of `gaussian`."""
    if sigma <= 0:
        return I
    weights = gaussian_taps(sigma, I.dtype, window)
    size = len(weights)
    if size <= 1:
        return I * weights[0]
    out = _conv_axis(I, weights, size, -1, bc)
    return _conv_axis(out, weights, size, -2, bc)


def sgauss_kernel(std, n, dtype=np.float64):
    """Symmetric n-tap Gaussian kernel (reference me_sgauss,
    src/utils.cpp:15-45): sampled at i - (n-1)/2, unit mass."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    i = np.arange(n, dtype=np.float64)
    v = (i - 0.5 * (n - 1)) / std
    out = np.exp(-0.5 * v * v)
    return (out / out.sum()).astype(dtype)


def _symmetric_pad(a, before, after, dim):
    """numpy's "symmetric" pad (mirror with the edge) of `dim`; pads
    wider than the axis reflect again, as numpy's do."""
    while before > 0 or after > 0:
        n = a.shape[dim]
        b, e = min(before, n), min(after, n)
        parts = [torch.flip(a.narrow(dim, 0, b), (dim,)), a,
                 torch.flip(a.narrow(dim, n - e, e), (dim,))]
        a = torch.cat(parts, dim=dim)
        before, after = before - b, after - e
    return a


def sepconvol(I, filter_x, filter_y):
    """Separable convolution with mirror-no-edge boundaries, x then y
    (reference me_sepconvol, src/utils.cpp:47-127): a sample at s
    outside [0, n-1] folds as s < 0 -> -s-1 and s > n-1 -> 2n-s-1, i.e.
    numpy's "symmetric" padding."""
    out = I
    for f, dim in ((filter_x, -1), (filter_y, -2)):
        f = torch.as_tensor(np.asarray(f, dtype=np.float64),
                            dtype=I.dtype).tolist()
        size = len(f)
        org = (size - 1) // 2
        n = out.shape[dim]
        # out[x] = sum_i f[i] * in[x - (i - org)]: pad size-1-org before
        # and org after
        p = _symmetric_pad(out, size - 1 - org, org, dim)
        acc = None
        for i in range(size):
            term = f[i] * p.narrow(dim, size - 1 - i, n)
            acc = term if acc is None else acc + term
        out = acc
    return out
