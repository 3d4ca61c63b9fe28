"""Classic (1981) Horn-Schunck: single scale, no warping, no pyramid.

Counterpart of tpuflow/models/hs_classic.py (reference
src/horn_schunck_classic.cpp): the derivative stencils (2x2x2 cube
averages, :47-75), the 12-point neighbourhood average (compute_bar,
:79-95) and the fixed-count Jacobi iteration (hs_iteration, :99-122).
All boundary handling is Neumann clamping.  The batched engine and the
single-pair `hs_classic` (what the horn_schunck_classic CLI calls) run
the iteration through `hs_classic_fused` (K6, csrc/hs_classic.cu on the
card, at B=1 for one pair, as tpuflow/models/hs_classic.py:57-66 does
on the TPU); `_bar` is the reference-form twin its plain version is
tested against, and `hs_classic(..., fused=False)` runs it.
"""

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.ops.gradients import _shift_clamp
from tpuflow_torch.ops.hs_classic import hs_classic_fused


def _input_derivatives(a, b):
    """Ex, Ey, Et via 2x2x2 cube averaging (reference
    src/horn_schunck_classic.cpp:47-75)."""
    ar = _shift_clamp(a, 1, -1)      # a(i+1, j)
    ad = _shift_clamp(a, 1, -2)      # a(i, j+1)
    adr = _shift_clamp(ad, 1, -1)    # a(i+1, j+1)
    br = _shift_clamp(b, 1, -1)
    bd = _shift_clamp(b, 1, -2)
    bdr = _shift_clamp(bd, 1, -1)
    Ey = 0.25 * ((ad - a) + (adr - ar) + (bd - b) + (bdr - br))
    Ex = 0.25 * ((ar - a) + (adr - ad) + (br - b) + (bdr - bd))
    Et = 0.25 * ((b - a) + (br - ar) + (bd - ad) + (bdr - adr))
    return Ex, Ey, Et


def _bar(u):
    """12-point weighted neighbourhood average (reference
    src/horn_schunck_classic.cpp:79-95)."""
    l = _shift_clamp(u, -1, -1)
    r = _shift_clamp(u, 1, -1)
    up = _shift_clamp(u, -1, -2)
    dn = _shift_clamp(u, 1, -2)
    ul = _shift_clamp(up, -1, -1)
    ur = _shift_clamp(up, 1, -1)
    dl = _shift_clamp(dn, -1, -1)
    dr = _shift_clamp(dn, 1, -1)
    return (l + r + up + dn) / 6.0 + (ul + ur + dl + dr) / 12.0


def hs_classic_batched(a, b, niter, alpha, device=None):
    """Batched classic HS: (B, H, W) pairs -> (B, H, W) flows (u, v).

    Inputs (tensors or arrays) are moved to `device` in the dtype it
    computes in (`compute_inputs`: float32 on the card, float32 or
    float64 on the CPU); the default device is the card, and with no
    card present the call raises unless device="cpu" is given.  No
    normalisation, as in the reference."""
    a, b = compute_inputs(device, a, b)
    Ex, Ey, Et = _input_derivatives(a, b)
    return hs_classic_fused(Ex, Ey, Et, alpha, niter)


def hs_classic(a, b, niter, alpha, fused=None, device=None):
    """`niter` iterations of classic Horn-Schunck on one (H, W) pair
    (reference `hs`, src/horn_schunck_classic.cpp:125-149).  Returns
    (u, v).

    Inputs are moved to `device` as `hs_classic_batched` moves them.  By
    default (`fused` None or True) the Jacobi solve is K6 at B=1 (its
    plain version on the CPU); `fused=False` runs the reference-form
    loop (a quotient by alpha^2 + Ex^2 + Ey^2 and `_bar`), on request
    only."""
    a, b = compute_inputs(device, a, b)
    Ex, Ey, Et = _input_derivatives(a, b)
    if fused is None or fused:
        u, v = hs_classic_fused(Ex[None].contiguous(), Ey[None].contiguous(),
                                Et[None].contiguous(), alpha, niter)
        return u[0], v[0]
    den = alpha * alpha + Ex * Ex + Ey * Ey
    u = torch.zeros_like(a)
    v = torch.zeros_like(a)
    for _ in range(int(niter)):
        ubar = _bar(u)
        vbar = _bar(v)
        t = (Ex * ubar + Ey * vbar + Et) / den
        u, v = ubar - Ex * t, vbar - Ey * t
    return u, v
