"""Brox et al. 2004 robust optical flow, spatial smoothness.

Counterpart of tpuflow/models/brox_spatial.py (reference
src/brox_optic_flow_spatial.cpp + src/brox_spatial_mask.cpp, IPOL
2013.21).  Per scale (brox_optic_flow, :179-444):

  outer loop (outer_iter):
    warp I2 and its 5 derivative planes by the current flow (:246-251)
    psi_smooth from the flow gradient (:101-122)
    psi1..psi4 half-sum divergence coefficients, zero across the image
      boundary (src/brox_spatial_mask.cpp:16-93)
    div_u/div_v: psi-weighted divergence of the current flow (:100-171)
    inner loop (inner_iter, lagged nonlinearity):
      psi_data / psi_gradient robustness weights (:33-92)
      assemble Au/Av/Du/Dv/D incl. gradient-constancy Hessian terms
        (:283-309)
      red-black SOR on the increment (du, dv) until sqrt(err/size) <= TOL
        or 300 sweeps (:315-390, omega = 1.9)
    u += du (:398-401)

Each outer iteration runs three kernels on the card, for one pair or B
pairs at once (`brox_spatial_batched`, tpuflow_torch.models.batch, runs
this `brox_scale` on (B, ny, nx) stacks; a pair is the case B = 1):
  * the warp of the B stacks of six planes, `warp_planes_bounded` when
    `warp_mode` resolves to "fast", as "auto" does for CUDA tensors: K5
    (csrc/warp_planes.cu) on levels of at least 96x96 px, K5p (the
    shift path's function) below, where the JAX package takes its XLA
    shift path (tpuflow/ops/interp.py:211);
  * each inner iteration's system, psi_s, psi1..psi4, the divergences
    and the data terms written straight into K7's (B, 9, ny, nx)
    constants, `brox_terms` -> K9 (csrc/brox_terms.cu) in one launch;
  * each inner iteration's SOR solve of the B systems, `_solve` -> K7
    (csrc/brox_sor.cu, `brox_sor_error`), at EVERY level, each sample
    stopping on its own: route "resident" (one launch a solve, the level
    in the SMs' shared memory, the stop tested on the device) at every
    level of a 1024x436 pair on an H100, route "stream" where the tiles
    outnumber the blocks the card holds (B = 128 at levels 0-3).  JAX
    solves on XLA below 96x96 px (tpuflow/models/brox_spatial.py:123).
On the CPU the wrappers run their plain versions, and "auto" resolves
to the exact gather warp.

`_sor_sweep` (masked full planes, quotients) is the reference-form twin
that the plain version of K7 is tested against; `_sor_solve(...,
fused=False)` runs it, on request only.  Computation is float32 on the
card, in the inputs' dtype (float32 or float64) on the CPU.
"""

import math
import sys

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.config import numpy_dtype
from tpuflow_torch.models.common import (PRESMOOTHING_SIGMA,
                                         default_flow_state,
                                         run_pyramid_state)
from tpuflow_torch.ops.brox import SOR_OMEGA, brox_sor_error
# EPSILON and the two psi stencils are also imported from here by the
# other Brox-family solvers, the tiled lanes and the tests
from tpuflow_torch.ops.brox_terms import (EPSILON, brox_terms,  # noqa: F401
                                          expo_terms, psi_divergence,
                                          psi_weighted_divergence)
from tpuflow_torch.ops.gradients import _shift_clamp, centered_gradient, dxx, dxy, dyy
from tpuflow_torch.ops.interp import resolve_warp_mode, warp_by_mode
from tpuflow_torch.ops.pyramid import clamp_nscales
from tpuflow_torch.utils.trace import count, span, traced

MAXITER_SOR = 300   # :24

# CLI defaults, reference src/brox_spatial_main.cpp:26-36 (2013 v2)
DEFAULT_ALPHA = 50.0
DEFAULT_GAMMA = 10.0
DEFAULT_NSCALES = 10
DEFAULT_ZFACTOR = 0.5
DEFAULT_TOL = 1e-4
DEFAULT_INNER = 1
DEFAULT_OUTER = 15


def _red_black(shape, device=None):
    """(red, black) masks of `shape` (..., ny, nx): (i+j) even, odd."""
    ny, nx = shape[-2:]
    ii = torch.arange(ny, device=device)[:, None]
    jj = torch.arange(nx, device=device)[None, :]
    par = (ii + jj) % 2
    return par == 0, par == 1


def _sor_sweep(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors):
    """One red-black SOR sweep on the coupled (du, dv) system
    (reference sor_iteration, src/brox_optic_flow_spatial.cpp:129-172);
    returns (du, dv, sum of squared updates)."""
    psi1, psi2, psi3, psi4 = psis
    w = SOR_OMEGA
    err = torch.zeros((), dtype=du.dtype, device=du.device)
    for mask in colors:
        div_du = (psi1 * _shift_clamp(du, 1, -2) + psi2 * _shift_clamp(du, -1, -2)
                  + psi3 * _shift_clamp(du, 1, -1) + psi4 * _shift_clamp(du, -1, -1))
        du_cand = (1.0 - w) * du + w * (Au - D * dv + alpha * div_du) / Du
        du_new = torch.where(mask, du_cand, du)
        div_dv = (psi1 * _shift_clamp(dv, 1, -2) + psi2 * _shift_clamp(dv, -1, -2)
                  + psi3 * _shift_clamp(dv, 1, -1) + psi4 * _shift_clamp(dv, -1, -1))
        dv_cand = (1.0 - w) * dv + w * (Av - D * du_new + alpha * div_dv) / Dv
        dv_new = torch.where(mask, dv_cand, dv)
        err = err + torch.sum((du_new - du) ** 2 + (dv_new - dv) ** 2)
        du, dv = du_new, dv_new
    return du, dv, err


def _system(*planes):
    """The (B, len(planes), ny, nx) contiguous stack of (B, ny, nx) planes
    (of (ny, nx) planes: B = 1), as K7 takes its state and constants."""
    ny, nx = planes[0].shape[-2:]
    return torch.stack(planes, dim=-3).reshape(-1, len(planes), ny, nx)


def _solve(state, const, alpha, tol, size, stop, maxiter):
    """K7 (`brox_sor_error`) on B systems, (B, 2, ny, nx) `state` and
    (B, 9, ny, nx) `const`, each sample stopping on its own at
    thresh = tol^2 * size.  Returns (du, dv) (B, ny, nx) and, per
    sample, the sweeps n and err = sqrt(summed squared update / size)."""
    if stop == "error":
        thresh = float(numpy_dtype(state.dtype)(tol * tol * size))
    elif stop == "fixed":
        thresh = -1.0
    else:
        raise ValueError(f"unknown stop mode {stop!r}")
    state, err, n = brox_sor_error(state, const, thresh, maxiter, alpha)
    return state[:, 0], state[:, 1], n, torch.sqrt(err / size)


def _sor_solve(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors, tol, size,
               stop, maxiter=MAXITER_SOR, fused=None):
    """Run SOR sweeps with the reference stopping rule
    `sqrt(err/size) > TOL && nsor < 300`
    (src/brox_optic_flow_spatial.cpp:315-389) on one (ny, nx) system.
    Returns (du, dv, nsor, err) as tensors, err = sqrt(summed squared
    update / size) of the last sweep: the scalars the reference prints
    when verbose (`Iterations: nsor`, :392-394; robust-expo also prints
    the error, src/robust_expo_methods.cpp:402-404).

    By default (`fused` None or True) the solve is one call of the K7
    wrapper `brox_sor_error` (`_solve`), on the card and on the CPU
    alike (where it runs the kernel's plain version), with thresh =
    tol^2 * size and stopping checked after every sweep.  `fused=False`
    runs the `_sor_sweep` twin in a host loop instead."""
    if fused is None or fused:
        du, dv, n, err = _solve(_system(du, dv),
                                _system(Au, Av, Du, Dv, D, *psis), alpha,
                                tol, size, stop, maxiter)
        return du[0], dv[0], n[0], err[0]
    err = torch.tensor(1000.0, dtype=du.dtype, device=du.device)
    nsor = 0
    while nsor < maxiter and (stop == "fixed" or float(err) > tol):
        du, dv, e = _sor_sweep(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors)
        err = torch.sqrt(e / size)
        nsor += 1
    return du, dv, torch.tensor(nsor, dtype=torch.int32, device=du.device), err


def brox_scale(I1, I2, u, v, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
               tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
               outer_iter=DEFAULT_OUTER, stop="error",
               maxiter=MAXITER_SOR, with_diag=False, warp_mode="exact",
               dmax=8, diffusivity=None):
    """Single-scale Brox spatial flow (reference brox_optic_flow,
    src/brox_optic_flow_spatial.cpp:179-444) of one (ny, nx) pair, or
    of B pairs (B, ny, nx) at once: one warp of the B stacks of six
    planes per outer iteration (span `warp`), the zeroed increment (a
    span `terms`), then per inner iteration the B systems formed by one
    `brox_terms` call (K9 on the card; a span `terms`) and one K7 call
    for all of them, each sample's solve stopping on its own at
    sqrt(err / (ny * nx)) <= tol.  A pair runs as B = 1.

    `diffusivity(I1x, I1y)`, where given, makes the system robust-expo's
    on gray samples (src/robust_expo_methods.cpp:161-455): the weight
    expo it gives (B, ny, nx) from I1's centred gradient, once in a span
    `expo`, modulates the smoothness, and each inner iteration's system
    is `expo_terms`' (K10 on the card) instead of `brox_terms`'.

    `with_diag=True` also returns {"iterations": (outer, inner) int32,
    "warp_overflow_tiles": 0}, (B, outer, inner) for B pairs: the SOR
    sweep counts the reference prints when verbose
    (src/brox_optic_flow_spatial.cpp:392-394)."""
    pair = I1.ndim == 2
    if pair:
        I1, I2, u, v = I1[None], I2[None], u[None], v[None]
    B, ny, nx = I1.shape
    size = ny * nx

    I1x, I1y = centered_gradient(I1)
    if diffusivity is None:
        terms = brox_terms
    else:
        with span("expo"):
            expo = diffusivity(I1x, I1y)

        def terms(u, v, *args, **kw):
            return expo_terms(u, v, expo, *args, **kw)
    I2x, I2y = centered_gradient(I2)
    planes = torch.stack([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)], dim=1)
    const = torch.empty((B, 9, ny, nx), dtype=I1.dtype, device=I1.device)
    nsors = []
    for _ in range(outer_iter):
        with span("warp"):
            warped = warp_by_mode(planes, u, v, warp_mode, dmax)
        with span("terms"):
            state = torch.zeros((B, 2, ny, nx), dtype=u.dtype, device=u.device)
        for k in range(inner_iter):
            with span("terms"):
                terms(u, v, I1, I1x, I1y, warped, state, const, alpha,
                      gamma, first=k == 0)
            # K7 updates (du, dv) in place
            _, _, nsor, _ = _solve(state, const, alpha, tol, size, stop,
                                   maxiter)
            nsors.append(nsor)
        u = u + state[:, 0]
        v = v + state[:, 1]
    if pair:
        u, v = u[0], v[0]
    if not with_diag:
        return u, v
    its = torch.stack(nsors, dim=-1).reshape(-1, outer_iter, inner_iter)
    return u, v, {"iterations": its[0] if pair else its,
                  "warp_overflow_tiles": torch.zeros((), dtype=torch.int32,
                                                     device=u.device)}


def print_iterations(scale, diag, outer_iter, inner_iter, with_error=False):
    """The reference binary's verbose lines for one solved level:
    `Scale: %d`, then `Iterations: %d` (with ` Error: %g` for robust-expo)
    per outer * inner iteration."""
    print(f"Scale: {scale}", file=sys.stdout)
    count("host_reads", 1 + bool(with_error))
    its = diag["iterations"].tolist()
    errs = diag["error"].tolist() if with_error else None
    for o in range(outer_iter):
        for i in range(inner_iter):
            line = f"Iterations: {int(its[o][i])}"
            if with_error:
                line += f" Error: {float(errs[o][i]):g}"
            print(line, file=sys.stdout)


def brox_pyramid(I1, I2, alpha, gamma, nscales, zfactor, tol, inner_iter,
                 outer_iter, stop, maxiter, clamp_scales, warp_mode,
                 max_motion, device, on_diag=None, preprocess="normalize",
                 presmooth=PRESMOOTHING_SIGMA, diffusivity=None):
    """The coarse-to-fine loop of `brox_spatial` (one (H, W) pair) and
    the batched Brox-family engines (B pairs, (B, H, W)): inputs moved
    as `compute_inputs` moves them, each pair normalised jointly and
    presmoothed (`preprocess`, `presmooth`: `run_pyramid_state`'s), the
    pyramid (K8 on the card), `brox_scale` with `diffusivity` at every
    level with dmax = max(3, ceil(max_motion * zfactor**s)) and
    `zoom_in` between levels.  `on_diag(scale, diag)`, where given,
    receives each level's `brox_scale` diagnostics as the level is
    solved.  Returns (u, v)."""
    I1, I2 = compute_inputs(device, I1, I2)
    warp_mode = resolve_warp_mode(warp_mode, I1.device)
    ny, nx = I1.shape[-2:]
    if clamp_scales:
        # reference main clamps on min(nx, ny) >= 16
        # (src/brox_spatial_main.cpp:151-157)
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    def state_init(size, dtype):
        return default_flow_state(size, dtype, I1.shape[:-2], I1.device)

    def solve(images, state, scale):
        lvl1, lvl2 = images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = brox_scale(lvl1, lvl2, state["u1"], state["u2"], alpha, gamma,
                         tol, inner_iter, outer_iter, stop, maxiter,
                         with_diag=on_diag is not None, warp_mode=warp_mode,
                         dmax=dmax, diffusivity=diffusivity)
        if on_diag is not None:
            on_diag(scale, out[2])
        return {"u1": out[0], "u2": out[1]}

    state = run_pyramid_state((I1, I2), nscales, zfactor, solve, state_init,
                              presmooth, preprocess)
    return state["u1"], state["u2"]


@traced
def brox_spatial(I1, I2, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                 nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                 tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                 outer_iter=DEFAULT_OUTER, stop="error",
                 maxiter=MAXITER_SOR, clamp_scales=True, verbose=False,
                 with_diag=False, warp_mode="auto", max_motion=8,
                 device=None):
    """Multiscale Brox spatial flow (reference brox_optic_flow_spatial,
    src/brox_optic_flow_spatial.cpp:451-549): (H, W) pair -> (u, v).

    Inputs (tensors or arrays) are moved to `device` in the dtype it
    computes in (`compute_inputs`: float32 on the card, float32 or
    float64 on the CPU); the default device is the card, and with no
    card present the call raises unless device="cpu" is given.

    stop="error" stops each SOR solve at sqrt(err/size) <= tol (or
    `maxiter` sweeps); stop="fixed" runs `maxiter` sweeps.  The
    displacement bound of the fast warp at level s is
    max(3, ceil(max_motion * zfactor**s)).  The levels run in a host
    loop (`brox_pyramid`, which `brox_spatial_batched` runs for B
    pairs): the JAX package's whole-pyramid jit (`_brox_spatial_whole`,
    a TPU-only single-program wrapper) has no counterpart here.

    `verbose` prints the reference binary's stdout lines: `Scale: %d`
    per level (src/brox_optic_flow_spatial.cpp:517-519) and
    `Iterations: %d` per outer*inner iteration (:392-394).
    `with_diag=True` returns (u, v, diags) with diags[s] =
    {"iterations": (outer, inner) int32, "warp_overflow_tiles": 0} per
    scale, finest first."""
    diags = {}

    def on_diag(scale, diag):
        diags[scale] = diag
        if verbose:
            print_iterations(scale, diag, outer_iter, inner_iter)

    u, v = brox_pyramid(I1, I2, alpha, gamma, nscales, zfactor, tol,
                        inner_iter, outer_iter, stop, maxiter, clamp_scales,
                        warp_mode, max_motion, device,
                        on_diag if with_diag or verbose else None)
    if with_diag:
        return u, v, [diags[s] for s in range(len(diags))]
    return u, v
