"""Batched multiscale TV-L1: the throughput path on the card.

Counterpart of the TV-L1 half of tpuflow/models/batch.py.  Many frame
pairs run as one batch; every pyramid level runs each warp as TWO
kernels:

  * `warp_const_batched` (csrc/warp_const.cu): bounded bicubic warp of
    (I1, I1x, I1y) by the current flow fused with the assembly of the
    per-warp TV-L1 constants;
  * `tvl1_iterate_error` (csrc/tvl1_iterate.cu): the whole inner fixed
    point of that warp, each sample stopping at its own iteration.

On the card the kernels run at every level; on the CPU (device="cpu")
their plain PyTorch versions run at every level.  The layout is
unpadded (B, C, ny, nx), contiguous, float32.

Two stopping modes:
  * stop="error" — the reference CLI's operating point: per-sample
    data-dependent stopping at err <= epsilon^2 * level size
    (src/tvl1flow.cpp:113,150-162);
  * stop="fixed" — a fixed per-warp iteration schedule, calibrated as an
    upper envelope of the reference's observed stopping iterations.

The displacement bound follows the pyramid: at level s it is
max(3, ceil(max_motion * zfactor**s)); flow beyond it warps to 0, the
reference's own degradation for out-of-frame motion.
"""

import math

import numpy as np
import torch

from tpuflow_torch._device import resolve_device
from tpuflow_torch.models.common import run_pyramid_state
from tpuflow_torch.ops.gradients import centered_gradient
from tpuflow_torch.ops.normalize import normalize_pair_batched
from tpuflow_torch.ops.pyramid import clamp_nscales, zoom_size
from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
from tpuflow_torch.ops.warp import warp_const_batched

# per-warp inner-iteration schedule: upper envelope of the reference's
# observed data-dependent stopping at default params (epsilon=0.01);
# used when the caller pins one schedule for every level
DEFAULT_ITER_SCHEDULE = (30, 20, 10, 6, 6)


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


def tvl1_scale_batched(I0, I1, u1, u2, dmax, tau, lam, theta, thresh, caps,
                       ee=2, iterations=None):
    """Batched single-scale TV-L1 with bounded-displacement warps.

    I0, I1, u1, u2: (B, ny, nx) float32.  `thresh` is the stopping
    threshold epsilon^2 * size (thresh < 0: every warp runs exactly its
    cap); `caps` the per-warp iteration caps.

    `ee` is the warp-level early exit: when stopping is on and every
    sample's fixed point converged within `ee` iterations, the
    remaining warps are skipped (ee <= 0 runs every warp, as the
    reference does).  Deciding it reads `n` on the host once per warp.
    If `iterations` is a list, each warp's per-sample counts are
    appended to it.

    Returns (u1, u2, oflow); oflow counts degraded warp tiles and is
    always 0 here (see tpuflow_torch.ops.warp)."""
    l_t = lam * theta
    taut = tau / theta
    B, ny, nx = I0.shape
    I1x, I1y = centered_gradient(I1)
    planes = torch.stack([I1, I1x, I1y], dim=1)
    aux = I0.contiguous()
    state = I0.new_zeros((B, 6, ny, nx))
    state[:, 0] = u1
    state[:, 1] = u2
    oflow = 0
    early_exit = thresh > 0 and ee > 0
    for cap in caps:
        const, flags = warp_const_batched(planes, state[:, :2], aux, dmax)
        oflow += flags
        state, _, n = tvl1_iterate_error(state, const, thresh, cap, l_t,
                                         theta, taut)
        if iterations is None and not early_exit:
            continue
        n_host = n.tolist()
        if iterations is not None:
            iterations.append(n_host)
        if early_exit and max(n_host, default=0) <= ee:
            break
    return state[:, 0].contiguous(), state[:, 1].contiguous(), oflow


def _tvl1_pyramid(I0, I1, tau, lam, theta, nscales, zfactor, max_motion,
                  thresh_base, caps_all, ee, level_callback=None,
                  resume=None, iterations=None):
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
        # float32 arithmetic, as the stopping test runs in float32
        thresh = float(np.float32(thresh_base) * np.float32(cny * cnx))
        its = None if iterations is None else iterations.setdefault(scale, [])
        u1, u2, oflow = tvl1_scale_batched(
            l0, l1, state["u1"], state["u2"], dmax=dmax, tau=tau, lam=lam,
            theta=theta, thresh=thresh, caps=caps_all[scale], ee=ee,
            iterations=its)
        prev = state.get("oflow",
                         torch.zeros((), dtype=torch.int32, device=dev))
        return {"u1": u1, "u2": u2, "oflow": prev + oflow}

    state = run_pyramid_state(
        (I0, I1), nscales, zfactor, solve, state_init, presmooth=0.8,
        preprocess=lambda ims: normalize_pair_batched(*ims),
        level_callback=level_callback, resume=resume,
        trace_name="tvl1_batched")
    return state["u1"], state["u2"], state["oflow"]


def _tvl1_mode_scalars(stop, epsilon, max_iterations, iter_schedule,
                       warps, nscales, zfactor, ny, nx):
    """(thresh_base, caps_all) of a stopping mode: thresh_base is
    epsilon^2 (error) or -1 (fixed); caps_all[s] the per-warp iteration
    caps of level s."""
    if stop == "error":
        return epsilon * epsilon, [[max_iterations] * warps] * nscales
    if stop != "fixed":
        raise ValueError(f"unknown stop mode {stop!r}")
    if iter_schedule is not None:
        return -1.0, [list(iter_schedule)] * nscales
    rows = []
    cnx, cny = nx, ny
    for _ in range(nscales):
        sched = tvl1_iter_schedule(cny, cnx)
        rows.append(list(sched[:warps])
                    + [sched[-1]] * max(0, warps - len(sched)))
        cnx, cny = zoom_size(cnx, cny, zfactor)
    return -1.0, rows


def tvl1_batched(I0, I1, tau=0.25, lam=0.15, theta=0.3, nscales=None,
                 zfactor=0.5, iter_schedule=None, max_motion=8,
                 stop="error", warps=5, epsilon=0.01, max_iterations=300,
                 level_callback=None, resume=None, with_stats=False,
                 warp_early_exit=True, device=None):
    """Batched multiscale TV-L1: (B, H, W) pairs -> (B, H, W) flows.

    Inputs (tensors or arrays) are moved to `device` as float32; the
    default device is the card, and with no card present the call
    raises unless device="cpu" is given.

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
    dev = resolve_device(device)
    I0 = torch.as_tensor(I0, device=dev).to(torch.float32)
    I1 = torch.as_tensor(I1, device=dev).to(torch.float32)
    ny, nx = I0.shape[-2:]
    if nscales is None:
        nscales = clamp_nscales(nx, ny, zfactor, 100, use_hypot=True)
    if stop == "fixed" and iter_schedule is not None:
        warps = len(iter_schedule)
    thresh_base, caps_all = _tvl1_mode_scalars(
        stop, epsilon, max_iterations, iter_schedule, warps, nscales,
        zfactor, ny, nx)
    iterations = {} if with_stats else None
    u1, u2, oflow = _tvl1_pyramid(
        I0, I1, tau, lam, theta, nscales, zfactor, max_motion, thresh_base,
        caps_all, 2 if warp_early_exit else 0, level_callback=level_callback,
        resume=resume, iterations=iterations)
    if with_stats:
        return u1, u2, {"warp_overflow_tiles": oflow,
                        "iterations": iterations}
    return u1, u2
