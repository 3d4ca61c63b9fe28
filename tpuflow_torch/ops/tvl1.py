"""One warp's TV-L1 fixed point with per-sample stopping: kernel and
plain version.

Counterpart of tpuflow/ops/tvl1_pallas.py (`tvl1_iterate_error_padded`).
`tvl1_iterate_error` runs thresholding -> primal step through
Chambolle's divergence -> dual ascent (reference
src/tvl1flow.cpp:113-181) until, per sample, the summed squared flow
update `err` drops to `thresh` (= epsilon^2 * level size) or `max_iter`
iterations ran; `thresh < 0` runs exactly `max_iter`.  The check comes
after each full iteration (the TPU kernel's while loop), so the
stopping iteration's dual update is applied.

The arithmetic is the TPU kernel's (tvl1_pallas.py:117-144), not
`_inner_step`'s: fi = -1/max(grad, 1e-10) then rho*fi, and
ng = 1/(1 + taut*sqrt(...)) then a product.  `err` is the per-sample
SUM (not mean) over the image.

On a CUDA tensor the wrapper launches csrc/tvl1_iterate.cu (three
kernels per iteration, see the note there) or raises; on a CPU tensor
it runs `tvl1_iterate_error_plain`.  Both update `state` IN PLACE (the
solver state is the largest buffer of a level) and return it.  The
kernel sums `err` in another order than PyTorch, so a sample's `n` may
differ from the plain version's by one where `err` lands next to
`thresh`.
"""

import ctypes

import torch

from tpuflow_torch._device import check_inputs, on_card
from tpuflow_torch.ops.gradients import divergence, forward_gradient
from tpuflow_torch.ops.sweeps import run_until_stopped
from tpuflow_torch.utils.trace import count

GRAD_IS_ZERO = 1e-10  # reference src/tvl1flow.cpp:24

_SIGNATURES = {
    "tvl1_iterate_run": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float, ctypes.c_int,
                         ctypes.c_float, ctypes.c_float, ctypes.c_float,
                         ctypes.c_int, ctypes.c_void_p],
    "tvl1_partial_len": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
}


def _step(state, iwx, iwy, rho_c, grad, fi, l_t, theta, taut,
          divergence=divergence, forward_gradient=forward_gradient):
    """One fixed-point iteration for every sample; returns the new
    state and the per-sample err.  The two stencils are parameters so
    that the tiled lane (tpuflow_torch.parallel.tiled) runs the same
    arithmetic through its halo-exchanged ones."""
    u1, u2, p11, p12, p21, p22 = state.unbind(1)
    rho = rho_c + iwx * u1 + iwy * u2
    zero = torch.zeros_like(rho)
    mul = torch.where(rho < -l_t * grad, l_t,
                      torch.where(rho > l_t * grad, -l_t,
                                  torch.where(grad < GRAD_IS_ZERO, zero,
                                              rho * fi)))
    u1n = u1 + mul * iwx + theta * divergence(p11, p12)
    u2n = u2 + mul * iwy + theta * divergence(p21, p22)
    du = u1n - u1
    dv = u2n - u2
    err = torch.sum(du * du + dv * dv, dim=(-2, -1))
    u1x, u1y = forward_gradient(u1n)
    u2x, u2y = forward_gradient(u2n)
    ng1 = 1.0 / (1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y))
    ng2 = 1.0 / (1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y))
    new = torch.stack([u1n, u2n, (p11 + taut * u1x) * ng1,
                       (p12 + taut * u1y) * ng1, (p21 + taut * u2x) * ng2,
                       (p22 + taut * u2y) * ng2], dim=1)
    return new, err


def tvl1_iterate_error_plain(state, const, thresh, max_iter, l_t, theta,
                             taut):
    """Plain PyTorch version of the kernel; same contract as
    `tvl1_iterate_error`.  Counts each read of `active` in `host_reads`
    and each iteration in `iters.k2`."""
    B = state.shape[0]
    iwx, iwy, rho_c, grad = const.unbind(1)
    fi = -1.0 / torch.clamp(grad, min=GRAD_IS_ZERO)
    err = torch.full((B,), float("inf"), dtype=state.dtype,
                     device=state.device)
    n = torch.zeros((B,), dtype=torch.int32, device=state.device)
    active = torch.full((B,), max_iter > 0, dtype=torch.bool,
                        device=state.device)
    cur = state
    while True:
        count("host_reads")
        if not bool(active.any()):
            break
        count("iters.k2")
        new, e = _step(cur, iwx, iwy, rho_c, grad, fi, l_t, theta, taut)
        cur = torch.where(active[:, None, None, None], new, cur)
        err = torch.where(active, e, err)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    state.copy_(cur)
    return state, err, n


def tvl1_iterate_error(state, const, thresh, max_iter, l_t, theta, taut):
    """Run one warp's fixed point in place.

    state: (B, 6, ny, nx) = (u1, u2, p11, p12, p21, p22) float32
    contiguous, updated in place; const: (B, 4, ny, nx) =
    (I1wx, I1wy, rho_c, grad); thresh, max_iter: Python scalars.
    Returns (state, err (B,) float32, n (B,) int32)."""
    check_inputs("tvl1_iterate_error", state=(state, ("B", 6, "ny", "nx")),
                 const=(const, ("B", 4, "ny", "nx")))
    if not on_card(state):
        return tvl1_iterate_error_plain(state, const, thresh, max_iter, l_t,
                                        theta, taut)
    return run_until_stopped("tvl1_iterate_error", "k2", "tvl1_iterate",
                             _SIGNATURES, "tvl1_iterate_run",
                             "tvl1_partial_len", state, const, thresh,
                             max_iter, (l_t, theta, taut))
