"""Classic Horn-Schunck's fixed-count Jacobi solve: kernel and plain
version.

Counterpart of tpuflow/ops/hs_classic_pallas.py (`hs_classic_fused`).
From zero flow, `niter` iterations of (reference hs_iteration,
src/horn_schunck_classic.cpp:99-122)

    t = (Ex*bar(u) + Ey*bar(v) + Et) * rden,  u, v = bar(u) - Ex*t, bar(v) - Ey*t

with rden = 1/(alpha^2 + Ex^2 + Ey^2) and bar the 12-point weighted
average with Neumann folds.  The arithmetic is the TPU kernel's
(hs_classic_pallas.py:51-70): a reciprocal then a product, and
bar = (h + up + dn)/6 + (hu + hd)/12 over the same neighbour sums as
the SOR kernel's Laplacian (`tpuflow_torch.ops.hs.neighbour_sums`).

On a CUDA tensor `hs_classic_fused` launches csrc/hs_classic.cu or
raises; on a CPU tensor it runs `hs_classic_fused_plain`.  The kernel
is temporally blocked: each launch runs `STEPS` iterations on tiles of
`TILE` pixels held in shared memory with a halo of `STEPS` pixels
(`launch_steps` gives the iterations of each launch; see the note in
the source).
"""

import ctypes

import torch

from tpuflow_torch import _build
from tpuflow_torch._device import check_inputs, on_card
from tpuflow_torch.ops.hs import neighbour_sums
from tpuflow_torch.utils.trace import count

# the kernel's geometry, as csrc/hs_classic.cu states it (checked when
# the library loads): a block's interior (rows, columns), and the
# Jacobi iterations of one launch, which are also the halo's width
TILE = (40, 48)
STEPS = 8

_SIGNATURES = {
    "hs_classic_run": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p],
    "hs_classic_geometry": [ctypes.c_int],
}


def launch_steps(niter):
    """Iterations of each launch for `niter` iterations: q launches of
    STEPS, then one of the remainder r (niter = q * STEPS + r)."""
    q, r = divmod(int(niter), STEPS)
    return [STEPS] * q + ([r] if r else [])


def _bar(f):
    h, hu, hd, up, dn = neighbour_sums(f)
    return (h + up + dn) / 6.0 + (hu + hd) / 12.0


def hs_classic_fused_plain(Ex, Ey, Et, alpha, niter):
    """Plain PyTorch version of the kernel; same contract as
    `hs_classic_fused`."""
    rden = 1.0 / (alpha * alpha + Ex * Ex + Ey * Ey)
    u = torch.zeros_like(Ex)
    v = torch.zeros_like(Ex)
    for _ in range(int(niter)):
        ubar = _bar(u)
        vbar = _bar(v)
        t = (Ex * ubar + Ey * vbar + Et) * rden
        u, v = ubar - Ex * t, vbar - Ey * t
    return u, v


def hs_classic_fused(Ex, Ey, Et, alpha, niter):
    """Classic HS's whole Jacobi solve.

    Ex, Ey, Et: (B, ny, nx) float32 contiguous derivatives (computed once
    per pair, src/horn_schunck_classic.cpp:139); alpha, niter: Python
    scalars.  Returns (u, v), each (B, ny, nx) float32."""
    check_inputs("hs_classic_fused", Ex=(Ex, ("B", "ny", "nx")),
                 Ey=(Ey, ("B", "ny", "nx")), Et=(Et, ("B", "ny", "nx")))
    if int(niter) != niter or niter < 0:
        raise ValueError(f"niter must be a non-negative integer, got {niter}")
    if not on_card(Ex):
        return hs_classic_fused_plain(Ex, Ey, Et, alpha, niter)
    B, ny, nx = Ex.shape
    bufs = torch.empty((2, B, 2, ny, nx), dtype=torch.float32,
                       device=Ex.device)
    bufs[0].zero_()
    niter = int(niter)
    if bufs.numel() == 0 or niter == 0:
        return bufs[0, :, 0], bufs[0, :, 1]
    lib = _build.load("hs_classic", _SIGNATURES,
                      ("hs_classic_geometry", (*TILE, STEPS)))
    _build.launch(lib, "hs_classic_run", bufs[0], bufs[1], Ex, Ey, Et, B, ny,
                  nx, float(alpha * alpha), niter, device=Ex.device)
    count("calls.hs_classic_fused")
    out = bufs[len(launch_steps(niter)) % 2]
    return out[:, 0], out[:, 1]
