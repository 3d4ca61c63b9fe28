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
most ~13 taps, and the sum keeps the reference's order of terms.
"""

import numpy as np
import torch

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


def gaussian(I, sigma, bc="reflecting", window=DEFAULT_WINDOW):
    """Separable Gaussian smoothing of (..., H, W) tensors, rows first.

    Matches reference `gaussian()` (src/operators.cpp:506-624) to
    floating-point accuracy, including its asymmetric reflecting pad."""
    if sigma <= 0:
        return I
    w_np, size = gaussian_kernel_1d(sigma, window)
    # weights rounded to the input's dtype, as the reference's arithmetic
    weights = torch.tensor(w_np, dtype=I.dtype).tolist()
    if size <= 1:
        return I * weights[0]
    out = _conv_axis(I, weights, size, -1, bc)
    return _conv_axis(out, weights, size, -2, bc)
