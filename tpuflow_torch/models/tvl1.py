"""Single-pair multiscale TV-L1 (reference src/tvl1flow.cpp), its
constants and the reference-shaped inner step.

Counterpart of tpuflow/models/tvl1.py.  `tvl1_multiscale` is what the
tvl1flow CLI calls.  Its plain call on the card (fast warp, stop="error",
no verbose, diagnostics or hooks) is the batched engine at B=1
(`tvl1_batched`: K1 and K2 at every level), as the JAX package routes
it.  Every other call runs `tvl1_scale` per level: each warp through
`warp_planes_bounded` (K5 on planes of at least 96x96 px, K5p below)
or the exact gather warp, the constants in PyTorch, and the inner fixed
point through K2's wrapper `tvl1_iterate_error` at B=1, stopping at
err <= epsilon^2 * size with err the SUMMED squared update.  The JAX
package tests the MEAN against epsilon^2, so a warp's stopping count
may differ from it by one where err lands next to the threshold.

`_inner_step` is one TV-L1 fixed-point iteration written as the
reference writes it (src/tvl1flow.cpp:113-181): fi = -rho/grad, hypot,
a division by (1 + taut*|grad u|), and the per-image MEAN of the
squared update.  No solver calls it (they run the kernel's arithmetic,
`tpuflow_torch.ops.tvl1`); the tests use it as an independent
reference for that arithmetic.
"""

import math
import sys

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.config import numpy_dtype
from tpuflow_torch.models.common import run_pyramid_state
from tpuflow_torch.ops.gradients import (centered_gradient, divergence,
                                         forward_gradient)
from tpuflow_torch.ops.interp import resolve_warp_mode, warp_by_mode
from tpuflow_torch.ops.pyramid import clamp_nscales
from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
from tpuflow_torch.utils.trace import count, traced

MAX_ITERATIONS = 300  # reference src/tvl1flow.cpp:22
GRAD_IS_ZERO = 1e-10  # reference src/tvl1flow.cpp:24

# CLI defaults, reference src/tvl1flow_main.cpp:24-33
DEFAULT_TAU = 0.25
DEFAULT_LAMBDA = 0.15
DEFAULT_THETA = 0.3
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 5
DEFAULT_EPSILON = 0.01


def _inner_step(u1, u2, p11, p12, p21, p22, I1wx, I1wy, rho_c, grad,
                l_t, theta, taut):
    """One TV-L1 fixed-point iteration (reference src/tvl1flow.cpp:113-181)."""
    rho = rho_c + I1wx * u1 + I1wy * u2
    fi = -rho / torch.clamp(grad, min=GRAD_IS_ZERO)
    lo = rho < -l_t * grad
    hi = rho > l_t * grad
    tiny = grad < GRAD_IS_ZERO
    zero = torch.zeros_like(rho)
    d1 = torch.where(lo, l_t * I1wx, torch.where(
        hi, -l_t * I1wx, torch.where(tiny, zero, fi * I1wx)))
    d2 = torch.where(lo, l_t * I1wy, torch.where(
        hi, -l_t * I1wy, torch.where(tiny, zero, fi * I1wy)))
    u1_new = u1 + d1 + theta * divergence(p11, p12)
    u2_new = u2 + d2 + theta * divergence(p21, p22)
    error = torch.mean((u1_new - u1) ** 2 + (u2_new - u2) ** 2)
    u1x, u1y = forward_gradient(u1_new)
    u2x, u2y = forward_gradient(u2_new)
    ng1 = 1.0 + taut * torch.hypot(u1x, u1y)
    ng2 = 1.0 + taut * torch.hypot(u2x, u2y)
    return (u1_new, u2_new, (p11 + taut * u1x) / ng1, (p12 + taut * u1y) / ng1,
            (p21 + taut * u2x) / ng2, (p22 + taut * u2y) / ng2, error)


def tvl1_scale(I0, I1, u1, u2, tau=DEFAULT_TAU, lam=DEFAULT_LAMBDA,
               theta=DEFAULT_THETA, warps=DEFAULT_WARPS,
               epsilon=DEFAULT_EPSILON, max_iterations=MAX_ITERATIONS,
               stop="error", with_diag=False, warp_mode="exact", dmax=8):
    """Single-scale TV-L1 (reference Dual_TVL1_optic_flow,
    src/tvl1flow.cpp:46-212) on normalised, presmoothed (ny, nx)
    images.  Every warp runs (no early exit); the dual variables carry
    across warps.

    `with_diag=True` also returns {"iterations": (warps,) int32,
    "error": (warps,)}: each warp's inner iteration count and its last
    mean squared update, the scalars the reference prints when verbose
    (src/tvl1flow.cpp:184-188)."""
    if stop not in ("error", "fixed"):
        raise ValueError(f"unknown stop mode {stop!r}")
    size = I0.numel()
    l_t = lam * theta
    taut = tau / theta
    f = numpy_dtype(I0.dtype)
    thresh = (float(f(epsilon * epsilon) * f(size))
              if stop == "error" else -1.0)
    planes = torch.stack([I1, *centered_gradient(I1)])
    state = I0.new_zeros((1, 6) + tuple(I0.shape))
    state[0, 0] = u1
    state[0, 1] = u2
    ns, errs = [], []
    for _ in range(warps):
        u, v = state[0, 0], state[0, 1]
        I1w, I1wx, I1wy = warp_by_mode(planes, u, v, warp_mode, dmax)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u - I1wy * v - I0
        const = torch.stack([I1wx, I1wy, rho_c, grad])[None]
        state, err, n = tvl1_iterate_error(state, const, thresh,
                                           max_iterations, l_t, theta, taut)
        ns.append(n[0])
        errs.append(err[0] / size)
    u1, u2 = state[0, 0].clone(), state[0, 1].clone()
    if with_diag:
        return u1, u2, {"iterations": torch.stack(ns),
                        "error": torch.stack(errs)}
    return u1, u2


def _resume_state(resume):
    """`resume` as `run_pyramid_state` takes it, (scale, state dict),
    from JAX's (scale, u1, u2) or from (scale, state dict)."""
    if resume is None:
        return None
    if isinstance(resume, (tuple, list)):
        if len(resume) == 3:
            scale, u1, u2 = resume
            return scale, {"u1": u1, "u2": u2}
        if len(resume) == 2 and isinstance(resume[1], dict):
            return tuple(resume)
    raise ValueError("resume must be (scale, u1, u2) or (scale, "
                     "{'u1': ..., 'u2': ...})")


@traced
def tvl1_multiscale(I0, I1, tau=DEFAULT_TAU, lam=DEFAULT_LAMBDA,
                    theta=DEFAULT_THETA, nscales=DEFAULT_NSCALES,
                    zfactor=DEFAULT_ZFACTOR, warps=DEFAULT_WARPS,
                    epsilon=DEFAULT_EPSILON, max_iterations=MAX_ITERATIONS,
                    stop="error", clamp_scales=True, level_callback=None,
                    resume=None, verbose=False, with_diag=False,
                    warp_mode="auto", max_motion=8, device=None,
                    scale_solver=None):
    """Multiscale TV-L1 (reference Dual_TVL1_optic_flow_multiscale,
    src/tvl1flow.cpp:219-328): (H, W) pair -> (u, v), or (u, v, diags)
    with `with_diag=True`, diags[s] the per-warp dict of `tvl1_scale` at
    scale s (finest first, None for levels skipped by resume).

    Inputs (tensors or arrays) are moved to `device` in the dtype it
    computes in (`compute_inputs`: float32 on the card, float32 or
    float64 on the CPU); the default device is the card, and with no
    card present the call raises unless device="cpu" is given.

    `clamp_scales` applies the CLI's auto-clamp so the coarsest level
    stays >= 16 px along the diagonal (src/tvl1flow_main.cpp:185-187).
    `level_callback(scale, {"u1", "u2"})` runs after each level;
    `resume` restarts below an already-solved level, given as JAX's
    `(scale, u1, u2)` or as `(scale, {"u1": ..., "u2": ...})` (see
    tpuflow_torch.utils.convert.resume_from_jax).  `verbose` prints the
    reference binary's stderr lines: `Scale %d: %dx%d` per level
    (src/tvl1flow.cpp:284-286) and `Warping: %d, Iterations: %d, Error:
    %f` per warp (src/tvl1flow.cpp:184-188).

    `warp_mode`: "exact" = the full bicubic gather; "fast" = the bounded
    warp with per-level bound max(3, ceil(max_motion * zfactor**s));
    "auto" (default) = fast on the card, exact elsewhere
    (tpuflow_torch.ops.interp.resolve_warp_mode).

    `scale_solver` replaces `tvl1_scale` as the per-level solver, called
    with `tvl1_scale`'s arguments; a call that gives one never takes the
    batched engine's route (tpuflow_torch.parallel.spatial.tvl1_spatial
    gives its tiled solver)."""
    I0, I1 = compute_inputs(device, I0, I1)
    resume = _resume_state(resume)
    warp_mode = resolve_warp_mode(warp_mode, I0.device)
    ny, nx = I0.shape[-2:]
    if clamp_scales:
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=True)

    if (warp_mode == "fast" and stop == "error" and not verbose
            and not with_diag and level_callback is None and resume is None
            and I0.ndim == 2 and scale_solver is None):
        # the plain single-pair call (the CLI default): the batched engine
        # at B=1, as tpuflow/models/tvl1.py:201-216 routes it
        from tpuflow_torch.models.batch import tvl1_batched

        u, v = tvl1_batched(I0[None], I1[None], tau=tau, lam=lam,
                            theta=theta, nscales=nscales, zfactor=zfactor,
                            stop="error", warps=warps, epsilon=epsilon,
                            max_iterations=max_iterations,
                            max_motion=max_motion, device=I0.device)
        return u[0], v[0]

    diag = with_diag or verbose
    diags = [None] * nscales
    solver = tvl1_scale if scale_solver is None else scale_solver

    def solve(images, state, scale):
        lvl0, lvl1 = images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        u1, u2, *d = solver(lvl0, lvl1, state["u1"], state["u2"], tau, lam,
                            theta, warps, epsilon, max_iterations, stop,
                            with_diag=diag, warp_mode=warp_mode, dmax=dmax)
        if diag:
            diags[scale] = d[0]
            if verbose:
                lny, lnx = lvl0.shape[-2:]
                print(f"Scale {scale}: {lnx}x{lny}", file=sys.stderr)
                count("host_reads", 2)
                its = d[0]["iterations"].tolist()
                errs = d[0]["error"].tolist()
                for w in range(warps):
                    print(f"Warping: {w}, Iterations: {its[w]}, "
                          f"Error: {errs[w]:f}", file=sys.stderr)
        return {"u1": u1, "u2": u2}

    state = run_pyramid_state((I0, I1), nscales, zfactor, solve,
                              level_callback=level_callback, resume=resume)
    if with_diag:
        return state["u1"], state["u2"], diags
    return state["u1"], state["u2"]
