"""Finite-difference stencils with the reference's boundary rules.

  * `centered_gradient` — central differences, one-sided at the borders
    (clamp-pad; reference src/operators.cpp:335-406)
  * `forward_gradient`  — forward differences, zero at the last row/col
    (reference src/operators.cpp:86-125)
  * `divergence`        — backward differences, the adjoint: the first
    row/col uses +v, the last row/col uses -v[previous]
    (reference src/operators.cpp:35-78, Chambolle's discretization)
  * `mask3x3` — a 3x3 mask with edge-fold (edge padding) boundaries
    (reference src/operators.cpp:132-256)
  * `dxx`, `dyy`, `dxy` — second derivatives with clamped neighbours
    (reference src/operators.cpp:263-328), each what `mask3x3` gives
    for its mask
  * `centered_gradient3` — central differences over (x, y, frame) for
    Brox temporal (reference src/operators.cpp:413-499)

All take (H, W) or (..., H, W) tensors and return the same shape/dtype.
"""

import torch


def _shift_clamp(a, off, dim):
    """`a` at index i+off along `dim`, edge-clamped (off is +-1)."""
    n = a.shape[dim]
    if off == 1:
        return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)],
                         dim=dim)
    return torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim=dim)


def centered_gradient(I):
    """Central-difference gradient (dx, dy), one-sided at the borders:
    dx = 0.5*(I[:, j+1] - I[:, j-1]) with j+-1 clamped to the image."""
    dx = 0.5 * (_shift_clamp(I, 1, -1) - _shift_clamp(I, -1, -1))
    dy = 0.5 * (_shift_clamp(I, 1, -2) - _shift_clamp(I, -1, -2))
    return dx, dy


def centered_gradient3(vol):
    """Central-difference gradient (dx, dy, dt) of a (T, H, W) volume:
    the spatial part is `centered_gradient` per frame, dt is
    0.5*(f[t+1] - f[t-1]) with one-sided halves at the first and last
    frame, and 0 when T == 1."""
    dx, dy = centered_gradient(vol)
    if vol.shape[0] > 1:
        dt = 0.5 * (_shift_clamp(vol, 1, 0) - _shift_clamp(vol, -1, 0))
    else:
        dt = torch.zeros_like(vol)
    return dx, dy, dt


def forward_gradient(f):
    """Forward-difference gradient (fx, fy); zero at the last col/row."""
    fx = torch.cat([f[..., :, 1:] - f[..., :, :-1],
                    torch.zeros_like(f[..., :, :1])], dim=-1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :],
                    torch.zeros_like(f[..., :1, :])], dim=-2)
    return fx, fy


def divergence(v1, v2):
    """Backward-difference divergence (adjoint of `forward_gradient`).

    The last column of v1 (last row of v2) never contributes; the
    first column (row) uses +v."""
    a = v1.clone()
    a[..., :, -1] = 0
    div_x = a - torch.cat([torch.zeros_like(a[..., :, :1]), a[..., :, :-1]],
                          dim=-1)
    b = v2.clone()
    b[..., -1, :] = 0
    div_y = b - torch.cat([torch.zeros_like(b[..., :1, :]), b[..., :-1, :]],
                          dim=-2)
    return div_x + div_y


def mask3x3(I, mask):
    """3x3 convolution with edge-fold boundary handling (= edge padding).

    `mask` is 3x3 (or 9 values) laid out as in the reference, row-major;
    the output pixel is sum_{l,m} I[i+l-1, j+m-1] * mask[l, m] with
    out-of-range taps clamped to the edge (reference
    src/operators.cpp:132-256 folds out-of-range mask weights onto the
    edge pixel, which is exactly edge padding)."""
    mask = torch.as_tensor(mask, dtype=I.dtype).reshape(3, 3).tolist()
    rows = (_shift_clamp(I, -1, -2), I, _shift_clamp(I, 1, -2))
    out = torch.zeros_like(I)
    for l in range(3):
        row = rows[l]
        out = out + mask[l][0] * _shift_clamp(row, -1, -1)
        out = out + mask[l][1] * row
        out = out + mask[l][2] * _shift_clamp(row, 1, -1)
    return out


def dxx(I):
    """Second x-derivative, [1 -2 1] horizontal (reference src/operators.cpp:263-280)."""
    return _shift_clamp(I, -1, -1) - 2.0 * I + _shift_clamp(I, 1, -1)


def dyy(I):
    """Second y-derivative, [1 -2 1] vertical (reference src/operators.cpp:283-304)."""
    return _shift_clamp(I, -1, -2) - 2.0 * I + _shift_clamp(I, 1, -2)


def dxy(I):
    """Mixed second derivative via the 4-point diagonal mask
    (reference src/operators.cpp:307-328)."""
    up = _shift_clamp(I, -1, -2)
    dn = _shift_clamp(I, 1, -2)
    ul = _shift_clamp(up, -1, -1)
    ur = _shift_clamp(up, 1, -1)
    dl = _shift_clamp(dn, -1, -1)
    dr = _shift_clamp(dn, 1, -1)
    return 0.25 * (ul - ur - dl + dr)
