"""Batched multiscale TV-L1, pyramidal Horn-Schunck, Brox spatial and
robust-expo: the throughput paths on the card.

Counterpart of the TV-L1 and HS halves of tpuflow/models/batch.py.  Many
frame pairs run as one batch; every pyramid level runs each warp as TWO
kernels:

  * TV-L1: `warp_const_batched` (K1, csrc/warp_const.cu), the bounded
    bicubic warp of (I1, I1x, I1y) fused with the per-warp TV-L1
    constants, and `tvl1_iterate_error` (K2, csrc/tvl1_iterate.cu), the
    whole inner fixed point of that warp;
  * HS: `warp_const_hs_batched` (K3, the same source in mode "hs"), the
    warp of (I2, I2x, I2y) fused with (Au, Av, Du, Dv, D), and
    `hs_sor_error` (K4, csrc/hs_sor.cu), the whole 4-color SOR solve of
    that warp;

each inner solve stopping per sample.  Brox spatial
(`brox_spatial_batched`, which has no counterpart in the JAX package)
runs the single-pair solver's own `brox_scale` on the B pairs: per
outer iteration one K5 or K5p launch for the B stacks of six planes,
the system in one K9 launch per inner iteration, and one K7 call for
the B SOR solves.  Robust-expo on gray pairs (`robust_expo_batched`,
no counterpart in the JAX package either) runs the same `brox_scale`
with its per-sample exponential diffusivity and its system in one K10
launch per inner iteration.  On the
card the kernels run at every level; on the CPU (device="cpu") their
plain PyTorch versions run at every level.  The layout is unpadded
(B, C, ny, nx), contiguous, float32 on the card (float32 or float64 on
the CPU).

Two stopping modes:
  * stop="error" — the reference CLI's operating point: per-sample
    data-dependent stopping at err <= eps^2 * level size
    (src/tvl1flow.cpp:113,150-162; src/horn_schunck_pyramidal.cpp:143,230);
  * stop="fixed" — a fixed per-warp iteration schedule, calibrated as an
    upper envelope of the reference's observed stopping iterations.

The displacement bound follows the pyramid: at level s it is
max(3, ceil(max_motion * zfactor**s)); flow beyond it warps to 0, the
reference's own degradation for out-of-frame motion.
"""

import math

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.config import numpy_dtype
from tpuflow_torch.models.brox_spatial import (
    DEFAULT_ALPHA as BROX_ALPHA, DEFAULT_GAMMA as BROX_GAMMA,
    DEFAULT_INNER as BROX_INNER, DEFAULT_NSCALES as BROX_NSCALES,
    DEFAULT_OUTER as BROX_OUTER, DEFAULT_TOL as BROX_TOL,
    DEFAULT_ZFACTOR as BROX_ZFACTOR, MAXITER_SOR, brox_pyramid)
from tpuflow_torch.models.common import run_pyramid_state
from tpuflow_torch.models.robust_expo import (
    DEFAULT_ALPHA as RX_ALPHA, DEFAULT_GAMMA as RX_GAMMA,
    DEFAULT_INNER as RX_INNER, DEFAULT_LAMBDA as RX_LAMBDA,
    DEFAULT_METHOD as RX_METHOD, DEFAULT_NSCALES as RX_NSCALES,
    DEFAULT_OUTER as RX_OUTER, DEFAULT_TOL as RX_TOL,
    DEFAULT_ZFACTOR as RX_ZFACTOR, exponential_diffusivity, preprocess)
from tpuflow_torch.models.hs_pyramidal import (DEFAULT_ALPHA, DEFAULT_MAXITER,
                                               DEFAULT_NSCALES, DEFAULT_TOL,
                                               DEFAULT_WARPS, DEFAULT_ZFACTOR)
from tpuflow_torch.ops.gradients import centered_gradient
from tpuflow_torch.ops.hs import hs_sor_error
from tpuflow_torch.ops.pyramid import clamp_nscales, zoom_size
from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
from tpuflow_torch.ops.warp import warp_const_batched, warp_const_hs_batched
from tpuflow_torch.utils.trace import count, span, traced


def tvl1_iter_schedule(ny, nx):
    """Per-warp iteration schedule for stop="fixed", calibrated as a
    1.3x envelope of the reference binary's observed data-dependent
    stopping iterations at default params over bench-geometry pairs
    (raw data: tools/tvl1_calibration.json).  Coarse levels iterate
    longest (their threshold epsilon^2*size is smallest); fine levels
    collapse after the first warp."""
    px = ny * nx
    if px <= 32 * 64:
        return (30, 20, 10, 8, 8)
    if px <= 55 * 128:
        return (30, 16, 8, 6, 8)
    if px <= 109 * 256:
        return (16, 7, 4, 4, 4)
    if px <= 218 * 512:
        return (8, 3, 3, 3, 3)
    return (20, 3, 6, 3, 3)


def hs_sweep_schedule(ny, nx):
    """Per-warp sweep schedule for stop="fixed", calibrated as a ~1.3x
    envelope of the reference binary's observed per-warp stopping
    sweeps at default parameters (tol=1e-4, alpha=7, 10 warps) over
    bench-geometry pairs (raw data: tools/hs_calibration.json).  Small
    levels need more sweeps (the threshold tol^2 * size is smallest);
    fine levels collapse after the first warp."""
    px = ny * nx
    if px <= 64 * 128:       # coarse levels (<= 55x128)
        return (104, 104, 96, 88, 80, 80, 80, 76, 76, 76)
    if px <= 109 * 256:
        return (96, 78, 60, 46, 35, 25, 16, 10, 7, 6)
    if px <= 218 * 512:
        return (80, 40, 11, 5, 3, 2, 3, 2, 2, 6)
    return (73, 12, 6, 4, 4, 3, 3, 4, 4, 4)


def _run_warps(state, caps, thresh, ee, iterations, warp):
    """One level's warp loop: `warp(state, cap)` runs one warp and
    returns (state, n), n the per-sample inner iteration counts.

    `ee` is the warp-level early exit: when stopping is on (thresh > 0)
    and every sample's inner solve converged within `ee` iterations, the
    remaining warps are skipped (ee <= 0 runs every warp, as the
    reference does).  Deciding it reads `n` on the host once per warp
    (span `host_read`, counter `host_reads`).  If `iterations` is a
    list, each warp's per-sample counts are appended to it.  Each warp
    is a span `warp`."""
    early_exit = thresh > 0 and ee > 0
    for cap in caps:
        with span("warp"):
            state, n = warp(state, cap)
            if iterations is None and not early_exit:
                continue
            with span("host_read"):
                count("host_reads")
                n_host = n.tolist()
        if iterations is not None:
            iterations.append(n_host)
        if early_exit and max(n_host, default=0) <= ee:
            break
    return state


def _flow_state(ref, u, v, extra_planes):
    """(B, 2 + extra_planes, ny, nx) zeros with the flow in planes 0, 1."""
    B, ny, nx = ref.shape
    state = ref.new_zeros((B, 2 + extra_planes, ny, nx))
    state[:, 0] = u
    state[:, 1] = v
    return state


def tvl1_scale_batched(I0, I1, u1, u2, dmax, tau, lam, theta, thresh, caps,
                       ee=2, iterations=None):
    """Batched single-scale TV-L1 with bounded-displacement warps.

    I0, I1, u1, u2: (B, ny, nx), one float dtype.  `thresh` is the stopping
    threshold epsilon^2 * size (thresh < 0: every warp runs exactly its
    cap); `caps` the per-warp iteration caps; `ee` and `iterations` as
    in `_run_warps`.  Returns (u1, u2)."""
    l_t = lam * theta
    taut = tau / theta
    planes = torch.stack([I1, *centered_gradient(I1)], dim=1)
    aux = I0.contiguous()

    def warp(state, cap):
        const, _ = warp_const_batched(planes, state[:, :2], aux, dmax)
        state, _, n = tvl1_iterate_error(state, const, thresh, cap, l_t,
                                         theta, taut)
        return state, n

    state = _run_warps(_flow_state(I0, u1, u2, 4), caps, thresh, ee,
                       iterations, warp)
    return state[:, 0].contiguous(), state[:, 1].contiguous()


def hs_scale_batched(I1, I2, u, v, dmax, alpha, thresh, caps, ee=2,
                     iterations=None):
    """Batched single-scale warping Horn-Schunck.

    I1, I2, u, v: (B, ny, nx), one float dtype.  `thresh` = tol^2 * size
    (src/horn_schunck_pyramidal.cpp:143,230; thresh < 0: every warp runs
    exactly its cap); `caps` the per-warp sweep caps; `ee` and
    `iterations` as in `_run_warps`.  Returns (u, v)."""
    alpha2 = alpha * alpha
    planes = torch.stack([I2, *centered_gradient(I2)], dim=1)
    aux = I1.contiguous()

    def warp(state, cap):
        const, _ = warp_const_hs_batched(planes, state, aux, dmax, alpha2)
        state, _, n = hs_sor_error(state, const, thresh, cap, alpha2)
        return state, n

    state = _run_warps(_flow_state(I1, u, v, 0), caps, thresh, ee,
                       iterations, warp)
    return state[:, 0].contiguous(), state[:, 1].contiguous()


def _batched_pyramid(I0, I1, nscales, zfactor, max_motion, thresh_base,
                     caps_all, solve_scale, level_callback=None,
                     resume=None, iterations=None):
    """Coarse-to-fine loop of both engines: `solve_scale(l0, l1, u1,
    u2, dmax, thresh, caps, iterations)` -> (u1, u2) solves one level.

    The level state is {"u1", "u2", "oflow"}, the JAX engines' keys;
    "oflow" counts degraded warp tiles and stays 0 here (the kernels'
    warp is exact, see tpuflow_torch.ops.warp)."""
    B = I0.shape[0]
    dev = I0.device

    def state_init(size, dtype):
        cnx, cny = size
        z = torch.zeros((B, cny, cnx), dtype=dtype, device=dev)
        return {"u1": z, "u2": z,
                "oflow": torch.zeros((), dtype=torch.int32, device=dev)}

    def solve(level_images, state, scale):
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        l0, l1 = level_images
        cny, cnx = l0.shape[-2:]
        # in the images' dtype, as the stopping test compares in it
        f = numpy_dtype(l0.dtype)
        thresh = float(f(thresh_base) * f(cny * cnx))
        its = None if iterations is None else iterations.setdefault(scale, [])
        u1, u2 = solve_scale(l0, l1, state["u1"], state["u2"], dmax, thresh,
                             caps_all[scale], its)
        oflow = state.get("oflow",
                          torch.zeros((), dtype=torch.int32, device=dev))
        return {"u1": u1, "u2": u2, "oflow": oflow}

    state = run_pyramid_state(
        (I0, I1), nscales, zfactor, solve, state_init, presmooth=0.8,
        preprocess="normalize",   # (B, H, W) pairs: each pair jointly
        level_callback=level_callback, resume=resume)
    return state["u1"], state["u2"], state["oflow"]


def _mode_scalars(stop, eps, max_inner, warps, nscales, zfactor, ny, nx,
                  schedule):
    """(thresh_base, caps_all) of a stopping mode: thresh_base is eps^2
    (error) or -1 (fixed); caps_all[s] the per-warp caps of level s,
    `max_inner` for every warp (error) or `schedule(ny, nx)` of the
    level, its last entry repeated past its end (fixed)."""
    if stop == "error":
        return eps * eps, [[max_inner] * warps] * nscales
    if stop != "fixed":
        raise ValueError(f"unknown stop mode {stop!r}")
    rows = []
    cnx, cny = nx, ny
    for _ in range(nscales):
        sched = schedule(cny, cnx)
        rows.append(list(sched[:warps])
                    + [sched[-1]] * max(0, warps - len(sched)))
        cnx, cny = zoom_size(cnx, cny, zfactor)
    return -1.0, rows


@traced
def tvl1_batched(I0, I1, tau=0.25, lam=0.15, theta=0.3, nscales=None,
                 zfactor=0.5, iter_schedule=None, max_motion=8,
                 stop="error", warps=5, epsilon=0.01, max_iterations=300,
                 level_callback=None, resume=None, with_stats=False,
                 warp_early_exit=True, device=None):
    """Batched multiscale TV-L1: (B, H, W) pairs -> (B, H, W) flows.

    Inputs (tensors or arrays) are moved to `device` in the dtype it
    computes in (`compute_inputs`: float32 on the card, float32 or
    float64 on the CPU); the default device is the card, and with no
    card present the call raises unless device="cpu" is given.

    stop="error" (default) reproduces the reference CLI's operating
    point: per-sample data-dependent stopping at `epsilon`.
    stop="fixed" runs the calibrated per-level schedule
    (`tvl1_iter_schedule`), or `iter_schedule` for every level if given.

    `level_callback(scale, state)` runs after each level;
    `resume=(scale, state)` restarts below an already-solved level
    (see tpuflow_torch.utils.convert.resume_from_jax).

    `with_stats=True` returns (u1, u2, stats): stats["warp_overflow_tiles"]
    (always 0: the kernel's warp is exact) and stats["iterations"],
    {scale: per-warp lists of per-sample inner iteration counts}.

    DELIBERATE DEVIATION (default on): in stop="error" mode a level's
    warp loop exits once every sample's fixed point converged within 2
    iterations, whereas the reference always runs all `warps` warps
    (src/tvl1flow.cpp:92).  `warp_early_exit=False` gives the strictly
    reference-faithful schedule."""
    I0, I1 = compute_inputs(device, I0, I1)
    ny, nx = I0.shape[-2:]
    if nscales is None:
        nscales = clamp_nscales(nx, ny, zfactor, 100, use_hypot=True)
    if stop == "fixed" and iter_schedule is not None:
        warps = len(iter_schedule)

        def schedule(cny, cnx):
            return tuple(iter_schedule)
    else:
        schedule = tvl1_iter_schedule
    thresh_base, caps_all = _mode_scalars(
        stop, epsilon, max_iterations, warps, nscales, zfactor, ny, nx,
        schedule)
    ee = 2 if warp_early_exit else 0

    def solve_scale(l0, l1, u1, u2, dmax, thresh, caps, its):
        return tvl1_scale_batched(l0, l1, u1, u2, dmax, tau, lam, theta,
                                  thresh, caps, ee=ee, iterations=its)

    iterations = {} if with_stats else None
    u1, u2, oflow = _batched_pyramid(
        I0, I1, nscales, zfactor, max_motion, thresh_base, caps_all,
        solve_scale, level_callback=level_callback,
        resume=resume, iterations=iterations)
    if with_stats:
        return u1, u2, {"warp_overflow_tiles": oflow,
                        "iterations": iterations}
    return u1, u2


@traced
def hs_pyramidal_batched(I1, I2, alpha=DEFAULT_ALPHA, nscales=None,
                         zfactor=DEFAULT_ZFACTOR, warps=DEFAULT_WARPS,
                         tol=DEFAULT_TOL, maxiter=DEFAULT_MAXITER,
                         max_motion=8, stop="error", level_callback=None,
                         resume=None, warp_early_exit=True, with_stats=False,
                         device=None):
    """Batched multiscale warping Horn-Schunck: (B, H, W) pairs ->
    (B, H, W) flows (reference src/horn_schunck_pyramidal.cpp).

    Same pyramid, devices, hooks and stats as `tvl1_batched`:
    stop="error" (default) stops each warp's SOR per sample at
    sqrt(err/size) <= tol; stop="fixed" runs `hs_sweep_schedule` per
    level.  The default `nscales` clamps the coarsest level's diagonal
    to >= 16 px (src/horn_schunck_pyramidal_main.cpp:141-144).

    DELIBERATE DEVIATION (default on): in stop="error" mode a level's
    warp loop exits once every sample's SOR converged within 2 sweeps,
    whereas the reference always runs all `warps` warps
    (src/horn_schunck_pyramidal.cpp:111-240).  `warp_early_exit=False`
    gives the strictly reference-faithful schedule."""
    I1, I2 = compute_inputs(device, I1, I2)
    ny, nx = I1.shape[-2:]
    if nscales is None:
        nscales = clamp_nscales(nx, ny, zfactor, DEFAULT_NSCALES,
                                use_hypot=True)
    thresh_base, caps_all = _mode_scalars(
        stop, tol, maxiter, warps, nscales, zfactor, ny, nx,
        hs_sweep_schedule)
    ee = 2 if warp_early_exit else 0

    def solve_scale(l1, l2, u, v, dmax, thresh, caps, its):
        return hs_scale_batched(l1, l2, u, v, dmax, alpha, thresh, caps,
                                ee=ee, iterations=its)

    iterations = {} if with_stats else None
    u, v, oflow = _batched_pyramid(
        I1, I2, nscales, zfactor, max_motion, thresh_base, caps_all,
        solve_scale, level_callback=level_callback,
        resume=resume, iterations=iterations)
    if with_stats:
        return u, v, {"warp_overflow_tiles": oflow, "iterations": iterations}
    return u, v


@traced
def brox_spatial_batched(I1, I2, alpha=BROX_ALPHA, gamma=BROX_GAMMA,
                         nscales=BROX_NSCALES, zfactor=BROX_ZFACTOR,
                         tol=BROX_TOL, inner_iter=BROX_INNER,
                         outer_iter=BROX_OUTER, stop="error",
                         maxiter=MAXITER_SOR, clamp_scales=True,
                         warp_mode="auto", max_motion=8, with_stats=False,
                         device=None):
    """Batched multiscale Brox spatial flow: (B, H, W) pairs -> (B, H, W)
    flows, each sample `brox_spatial` of its pair (reference
    src/brox_optic_flow_spatial.cpp), with its arguments, defaults and
    devices.

    Every SOR solve stops per sample at sqrt(err / (ny * nx)) <= tol
    (or `maxiter` sweeps); no sample waits for another, and every
    sample runs every outer iteration, as the reference does.

    `with_stats=True` returns (u, v, stats): stats["iterations"],
    {scale: per-solve lists (outer-major over the outer and inner
    iterations) of per-sample SOR sweeps}, read on the host once a
    level."""
    if len(I1.shape) != 3:
        raise ValueError(f"brox_spatial_batched takes (B, H, W) stacks, got "
                         f"{tuple(I1.shape)}")
    diags = {}
    u, v = brox_pyramid(
        I1, I2, alpha, gamma, nscales, zfactor, tol, inner_iter, outer_iter,
        stop, maxiter, clamp_scales, warp_mode, max_motion, device,
        diags.__setitem__ if with_stats else None)
    if not with_stats:
        return u, v
    return u, v, _sweeps_by_level(diags)


def _sweeps_by_level(diags):
    """{"iterations": {scale: per-solve lists of per-sample SOR sweeps}}
    of `brox_scale`'s diagnostics of each level, read on the host once a
    level."""
    iterations = {}
    for scale, diag in diags.items():
        its = diag["iterations"]
        count("host_reads")
        iterations[scale] = its.reshape(its.shape[0], -1).T.tolist()
    return {"iterations": iterations}


@traced
def robust_expo_batched(I1, I2, method_type=RX_METHOD, alpha=RX_ALPHA,
                        gamma=RX_GAMMA, lam=RX_LAMBDA, nscales=RX_NSCALES,
                        zfactor=RX_ZFACTOR, tol=RX_TOL, inner_iter=RX_INNER,
                        outer_iter=RX_OUTER, stop="error",
                        maxiter=MAXITER_SOR, clamp_scales=True,
                        presmooth_mode="reference", warp_mode="auto",
                        max_motion=8, with_stats=False, device=None):
    """Batched multiscale robust-expo flow on gray pairs: (B, H, W) pairs
    -> (B, H, W) flows, each sample `robust_expo` of its pair (reference
    src/robust_expo_methods.cpp), with its arguments, defaults and
    devices.

    `brox_spatial_batched`'s loop (`brox_pyramid`): each pair normalised
    jointly and presmoothed as `presmooth_mode` says, the pyramid's
    levels zoomed out from it with no further presmooth, and at every
    level each sample's exponential diffusivity (DF-AUTO: its lambda
    from its own gradient histogram, on the device) in a span `expo`,
    then per outer iteration one warp of the B stacks of six planes, per
    inner iteration one `expo_terms` call (K10) and one K7 call, each
    sample's solve stopping at sqrt(err / (ny * nx)) <= tol.

    Gray only: a (B, C, H, W) colour stack raises a ValueError (its data
    terms sum over the channels; `robust_expo` runs one colour pair).
    `with_stats=True` returns (u, v, stats) as `brox_spatial_batched`
    does."""
    if len(I1.shape) != 3:
        raise ValueError(f"robust_expo_batched takes gray (B, H, W) stacks, "
                         f"got {tuple(I1.shape)}; a colour pair runs in "
                         f"robust_expo")
    # alpha adapted for the one channel and truncated to int
    # (src/robust_expo_methods.cpp:527)
    alpha = float(int(alpha))

    def diffusivity(I1x, I1y):
        return exponential_diffusivity(I1x, I1y, method_type, alpha, lam,
                                       channel_dim=None)

    diags = {}
    u, v = brox_pyramid(
        I1, I2, alpha, gamma, nscales, zfactor, tol, inner_iter, outer_iter,
        stop, maxiter, clamp_scales, warp_mode, max_motion, device,
        diags.__setitem__ if with_stats else None,
        preprocess=lambda images: preprocess(images, presmooth_mode,
                                             gray_samples=True),
        presmooth=None, diffusivity=diffusivity)
    if not with_stats:
        return u, v
    return u, v, _sweeps_by_level(diags)
