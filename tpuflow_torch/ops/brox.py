"""One inner iteration's red-black SOR for the Brox family with
per-sample stopping: kernel and plain version.

Counterpart of tpuflow/ops/brox_pallas.py (`brox_sor_error_quarters`).
`brox_sor_error` relaxes the coupled 5-point system on the flow
increment (du, dv) of Brox spatial and robust-expo (reference
sor_iteration, src/brox_optic_flow_spatial.cpp:129-172, omega = 1.9;
src/robust_expo_generic_tensor.cpp:18-167) until, per sample, the
summed squared update of the last full sweep `err` drops to `thresh`
(= tol^2 * size) or `max_iter` sweeps ran; `err` starts at inf and
`thresh < 0` runs exactly `max_iter` sweeps.

A sweep updates RED pixels ((i+j) even) first, then BLACK, and within a
color du first, then dv with that pixel's new du.  That order defines
the iterates; the TPU kernel's quarter-plane layout and (16, 256)
padding were layout choices and are not carried over: the layout is
unpadded (B, C, ny, nx), and the neighbour reads are index clamps (the
psi_i are 0 across the image boundary, so a clamped neighbour never
contributes).

The arithmetic is the TPU kernel's (brox_pallas.py:68-125), not
`_sor_sweep`'s (tpuflow_torch.models.brox_spatial): rdu = 1/max(Du, 1e-30)
then a product, and the divergence psi1*down + psi2*up + psi3*right +
psi4*left in that order.

On a CUDA tensor the wrapper launches csrc/brox_sor.cu (three kernels
per sweep, see the note there) or raises; on a CPU tensor it runs
`brox_sor_error_plain`.  Both update `state` IN PLACE and return it.
The kernel sums `err` in another order than PyTorch, so a sample's `n`
may differ from the plain version's by one where `err` lands next to
`thresh`.
"""

import ctypes

import torch
import torch.nn.functional as F

from tpuflow_torch.ops.hs import D_FLOOR
from tpuflow_torch.ops.sweeps import check_state_const, run_until_stopped

SOR_OMEGA = 1.9  # reference src/brox_optic_flow_spatial.cpp:25

_SIGNATURES = {
    "brox_sor_run": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_float, ctypes.c_int,
                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "brox_sor_partial_len": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
}


def _sweep(s, au, av, rdu, rdv, dd, psis, alpha, colors):
    """One red-black sweep of every sample, in place on the (B, 2, ny,
    nx) state `s` = (du, dv); `colors` are the (red, black) masks and
    the psi_i are (B, 1, ny, nx).  Each color's update is evaluated over
    the whole plane and kept where the mask is set: every neighbour of a
    pixel has the other color, so that is the same as updating the
    color's pixels alone, and both divergences of a color can be taken
    before its du update."""
    w = SOR_OMEGA
    psi1, psi2, psi3, psi4 = psis
    du, dv = s[:, 0], s[:, 1]
    for mask in colors:
        # edge-replicated copy: fp[i + 1, j + 1] = s[clamp(i), clamp(j)]
        fp = F.pad(s, (1, 1, 1, 1), mode="replicate")
        dp = (psi1 * fp[..., 2:, 1:-1] + psi2 * fp[..., :-2, 1:-1]
              + psi3 * fp[..., 1:-1, 2:] + psi4 * fp[..., 1:-1, :-2])
        new = (1.0 - w) * du + w * (au - dd * dv + alpha * dp[:, 0]) * rdu
        torch.where(mask, new, du, out=du)
        # dv with this color's new du
        new = (1.0 - w) * dv + w * (av - dd * du + alpha * dp[:, 1]) * rdv
        torch.where(mask, new, dv, out=dv)


def brox_sor_error_plain(state, const, thresh, max_iter, alpha):
    """Plain PyTorch version of the kernel; same contract as
    `brox_sor_error`."""
    B, _, ny, nx = state.shape
    au, av, du_c, dv_c, dd = const[:, :5].unbind(1)
    psis = const[:, 5:, None].unbind(1)
    rdu = 1.0 / torch.clamp(du_c, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv_c, min=D_FLOOR)
    ii = torch.arange(ny, device=state.device)[:, None]
    jj = torch.arange(nx, device=state.device)
    red = (ii + jj) % 2 == 0
    colors = (red, ~red)
    err = torch.full((B,), float("inf"), dtype=state.dtype,
                     device=state.device)
    n = torch.zeros((B,), dtype=torch.int32, device=state.device)
    active = torch.full((B,), max_iter > 0, dtype=torch.bool,
                        device=state.device)
    s = state.clone()
    while bool(active.any()):
        s0 = s.clone()
        _sweep(s, au, av, rdu, rdv, dd, psis, alpha, colors)
        if not bool(active.all()):
            s = torch.where(active[:, None, None, None], s, s0)
        d = s - s0
        err = torch.where(active, torch.sum(d * d, dim=(1, 2, 3)), err)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    state.copy_(s)
    return state, err, n


def brox_sor_error(state, const, thresh, max_iter, alpha):
    """Run one inner iteration's SOR solve in place.

    state: (B, 2, ny, nx) = (du, dv) float32 contiguous, updated in place;
    const: (B, 9, ny, nx) = (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4)
    float32 contiguous; thresh, max_iter, alpha: Python scalars.
    Returns (state, err (B,) float32, n (B,) int32)."""
    check_state_const(state, const, 2, 9)
    if state.device.type == "cpu":
        return brox_sor_error_plain(state, const, thresh, max_iter, alpha)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    return run_until_stopped(brox_sor_error, "brox_sor", _SIGNATURES,
                             "brox_sor_run", "brox_sor_partial_len", state,
                             const, thresh, max_iter, (alpha,))


brox_sor_error.launches = 0
