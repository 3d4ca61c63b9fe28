"""Pyramidal (warping) Horn-Schunck's 4-color SOR in reference form.

Counterpart of the sweep helpers of tpuflow/models/hs_pyramidal.py.  Per
warp the linearised system constants are (reference
src/horn_schunck_pyramidal.cpp:128-137)

    Au = (I1 - I2w + I2wx*u + I2wy*v) * I2wx      Du = I2wx^2 + alpha^2
    Av = (...same...) * I2wy                      Dv = I2wy^2 + alpha^2
    D  = I2wx * I2wy

and the SOR update with the 12-point weighted Laplacian
(sor_iteration, :32-71, omega = 1.9):

    u <- (1-w)u + w(Au - D v + alpha^2 * ula)/Du
    v <- (1-w)v + w(Av - D u_new + alpha^2 * vla)/Dv

in 4-COLOR order on the 2x2 parity grid: every one of the 8 stencil
neighbours has another color than the centre, so the four masked
updates are a true multicolor Gauss-Seidel sweep, stable at 1.9.

`_sor_sweep` is the twin that the plain version of the SOR kernel
(`tpuflow_torch.ops.hs.hs_sor_error_plain`, the TPU kernel's arithmetic)
is tested against.
"""

import torch

from tpuflow_torch.ops.gradients import _shift_clamp
from tpuflow_torch.ops.hs import SOR_OMEGA

# CLI defaults, reference src/horn_schunck_pyramidal_main.cpp:24-33
DEFAULT_ALPHA = 7.0
DEFAULT_NSCALES = 10
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 10
DEFAULT_TOL = 1e-4
DEFAULT_MAXITER = 150


def _weighted_laplacian(f):
    """12-point neighbourhood average: 1/12 diagonals + 1/6 direct,
    Neumann-clamped (reference sor_iteration neighbour lists,
    src/horn_schunck_pyramidal.cpp:148-228)."""
    l = _shift_clamp(f, -1, -1)
    r = _shift_clamp(f, 1, -1)
    up = _shift_clamp(f, -1, -2)
    dn = _shift_clamp(f, 1, -2)
    ul = _shift_clamp(up, -1, -1)
    ur = _shift_clamp(up, 1, -1)
    dl = _shift_clamp(dn, -1, -1)
    dr = _shift_clamp(dn, 1, -1)
    return (ul + ur + dl + dr) / 12.0 + (l + r + up + dn) / 6.0


def _four_colors(shape, device=None):
    """2x2-block coloring: masks of colors 0..3 = 2*(row parity) +
    (column parity), each of `shape` (..., ny, nx)."""
    ny, nx = shape[-2:]
    ii = torch.arange(ny, device=device)[:, None]
    jj = torch.arange(nx, device=device)[None, :]
    c = (ii % 2) * 2 + (jj % 2)
    return tuple(c == k for k in range(4))


def _sor_sweep(u, v, Au, Av, Du, Dv, D, al, colors):
    """One 4-color SOR sweep (four masked updates); returns (u, v, sum
    of squared updates over everything)."""
    w = SOR_OMEGA
    err = torch.zeros((), dtype=u.dtype, device=u.device)
    for mask in colors:
        ula = _weighted_laplacian(u)
        u_cand = (1.0 - w) * u + w * (Au - D * v + al * ula) / Du
        u_new = torch.where(mask, u_cand, u)
        vla = _weighted_laplacian(v)
        v_cand = (1.0 - w) * v + w * (Av - D * u_new + al * vla) / Dv
        v_new = torch.where(mask, v_cand, v)
        err = err + torch.sum((u_new - u) ** 2 + (v_new - v) ** 2)
        u, v = u_new, v_new
    return u, v, err
