"""Single-pair pyramidal (warping) Horn-Schunck, and its 4-color SOR in
reference form.

Counterpart of tpuflow/models/hs_pyramidal.py.  `hs_pyramidal` is what
the horn_schunck_pyramidal CLI calls.  Its plain call on the card (fast
warp, stop="error", no verbose or diagnostics) is the batched engine at
B=1 (`hs_pyramidal_batched`: K3 and K4 at every level), as the JAX
package routes it.  Every other call runs `hs_scale` per level: each
warp through `warp_planes_bounded` (K5 on planes of at least 96x96 px,
K5p below) or the exact gather warp, the constants below in PyTorch,
and the SOR solve through K4's wrapper `hs_sor_error` at B=1, stopping
at err <= tol^2 * size (the reference's sqrt(err/size) <= tol).

Per warp the linearised system constants are (reference
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

import math
import sys

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.config import numpy_dtype
from tpuflow_torch.models.common import run_pyramid
from tpuflow_torch.ops.gradients import _shift_clamp, centered_gradient
from tpuflow_torch.ops.hs import SOR_OMEGA, hs_sor_error
from tpuflow_torch.ops.interp import resolve_warp_mode, warp_by_mode
from tpuflow_torch.ops.pyramid import clamp_nscales
from tpuflow_torch.utils.trace import traced

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


def hs_scale(I1, I2, u, v, alpha=DEFAULT_ALPHA, warps=DEFAULT_WARPS,
             tol=DEFAULT_TOL, maxiter=DEFAULT_MAXITER, stop="error",
             with_diag=False, warp_mode="exact", dmax=8):
    """Single-scale warping Horn-Schunck (reference
    horn_schunck_optical_flow, src/horn_schunck_pyramidal.cpp:78-249) on
    (ny, nx) images.  Every warp runs (no early exit).

    `with_diag=True` also returns {"iterations": (warps,) int32,
    "error": (warps,)}: each warp's sweep count and sqrt(err/size) of
    its last sweep, the scalars the reference prints when verbose
    (src/horn_schunck_pyramidal.cpp:233-235)."""
    if stop not in ("error", "fixed"):
        raise ValueError(f"unknown stop mode {stop!r}")
    size = I1.numel()
    alpha2 = alpha * alpha
    f = numpy_dtype(I1.dtype)
    thresh = (float(f(tol * tol) * f(size))
              if stop == "error" else -1.0)
    planes = torch.stack([I2, *centered_gradient(I2)])
    state = torch.stack([u, v])[None].contiguous()
    ns, errs = [], []
    for _ in range(warps):
        u, v = state[0, 0], state[0, 1]
        I2w, I2wx, I2wy = warp_by_mode(planes, u, v, warp_mode, dmax)
        dif = I1 - I2w + I2wx * u + I2wy * v
        const = torch.stack([dif * I2wx, dif * I2wy, I2wx * I2wx + alpha2,
                             I2wy * I2wy + alpha2, I2wx * I2wy])[None]
        state, err, n = hs_sor_error(state, const, thresh, maxiter, alpha2)
        ns.append(n[0])
        errs.append(torch.sqrt(err[0] / size))
    u, v = state[0, 0].clone(), state[0, 1].clone()
    if with_diag:
        return u, v, {"iterations": torch.stack(ns),
                      "error": torch.stack(errs)}
    return u, v


@traced
def hs_pyramidal(I1, I2, alpha=DEFAULT_ALPHA, nscales=DEFAULT_NSCALES,
                 zfactor=DEFAULT_ZFACTOR, warps=DEFAULT_WARPS,
                 tol=DEFAULT_TOL, maxiter=DEFAULT_MAXITER, stop="error",
                 clamp_scales=True, verbose=False, with_diag=False,
                 warp_mode="auto", max_motion=8, device=None):
    """Multiscale warping Horn-Schunck (reference horn_schunck_pyramidal,
    src/horn_schunck_pyramidal.cpp:258-370): (H, W) pair -> (u, v).

    Inputs (tensors or arrays) are moved to `device` in the dtype it
    computes in (`compute_inputs`: float32 on the card, float32 or
    float64 on the CPU); the default device is the card, and with no
    card present the call raises unless device="cpu" is given.

    `verbose` prints the reference binary's stderr lines: the multiscale
    header (src/horn_schunck_pyramidal.cpp:274-277), `Scale: %d %dx%d`
    per level (:326-328), and per warp `Warping %d: Iterations %d (%g)`
    (:118-120, :233-235).  `with_diag=True` returns (u, v, diags) with
    diags[s] the per-warp dict of `hs_scale` at scale s (finest first).
    `warp_mode` as in `tvl1_multiscale`."""
    I1, I2 = compute_inputs(device, I1, I2)
    warp_mode = resolve_warp_mode(warp_mode, I1.device)
    ny, nx = I1.shape[-2:]
    if clamp_scales:
        # the reference main clamps so the coarsest pyramid diagonal
        # stays >= 16 px (src/horn_schunck_pyramidal_main.cpp:141-144)
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=True)

    if (warp_mode == "fast" and stop == "error" and not verbose
            and not with_diag and I1.ndim == 2):
        # the plain single-pair call (the CLI default): the batched engine
        # at B=1, as tpuflow/models/hs_pyramidal.py:201-212 routes it
        from tpuflow_torch.models.batch import hs_pyramidal_batched

        u, v = hs_pyramidal_batched(I1[None], I2[None], alpha=alpha,
                                    nscales=nscales, zfactor=zfactor,
                                    warps=warps, tol=tol, maxiter=maxiter,
                                    max_motion=max_motion, stop="error",
                                    device=I1.device)
        return u[0], v[0]

    if verbose:
        print(f"Multiscale Horn-Schunck of a {nx}x{ny} pair\n"
              f"\ta={alpha:g} ns={nscales} zf={zfactor:g} nw={warps} "
              f"eps={tol:g} mi={maxiter}", file=sys.stderr)

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(images, u, v, scale):
        lvl1, lvl2 = images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        u, v, *d = hs_scale(lvl1, lvl2, u, v, alpha, warps, tol, maxiter,
                            stop, with_diag=diag, warp_mode=warp_mode,
                            dmax=dmax)
        if diag:
            diags[scale] = d[0]
            if verbose:
                lny, lnx = lvl1.shape[-2:]
                print(f"Scale: {scale} {lnx}x{lny}", file=sys.stderr)
                its = d[0]["iterations"].tolist()
                errs = d[0]["error"].tolist()
                for w in range(warps):
                    print(f"Warping {w}: Iterations {its[w]} ({errs[w]:g})",
                          file=sys.stderr)
        return u, v

    u, v, _ = run_pyramid((I1, I2), nscales, zfactor, solve)
    if with_diag:
        return u, v, diags
    return u, v
