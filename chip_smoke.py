#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py      # from the root of a checkout; needs one card

Builds tpuflow_torch/csrc/*.cu with nvcc (sm_90a) into build/tpuflow_torch/,
then runs these phases, each printing one JSON line:

  1. card, torch and CUDA versions, and the kernels' build time;
  2. each kernel against its plain version, at the level-0 shape
     (436x1024, synth_pair's flow; B=4 for the batched engines' kernels,
     B=1 for the single-pair solvers') and a small level:
     K1 (warp_const) and K2 (tvl1_iterate) at 7x16; K3 (warp_const_hs),
     K4 (hs_sor) and K6 (hs_classic) at 55x128, whose
     odd height puts the last row at the even parity; K4 also at 218x512
     and 109x256 (its route "tiles", at sizes no tile divides) and 7x16
     (its route "level" at the smallest level; 55x128 takes it too),
     each check naming its route; K6 also 13 and 1 iterations at
     436x1024 and 100 at 109x257 (no tile divides it).  K7 (brox_sor)
     at the five Brox levels of 1024x436, B=1 (its route "resident"),
     and at B=2 x 436x1024 (its route "stream"), each check naming its
     route; then route "stream" at one sweep a launch and at DEEP_K
     against route "resident" at B=2 x 218x512, which both take (8 and
     17 fixed sweeps, bit-equal expected), and the kernels one 16-sweep
     stream solve launches by name at each (`stream_kernels`); route
     "stream" at DEEP_K against one sweep a launch at levels 0-3, B=4
     and B=128 (fixed sweeps bit-equal, n within one, and du, dv
     bit-equal where n is the same, with stops inside a launch).
     K7 solves the system that `brox_scale` assembles (K9) from
     the synthetic flow.  K9 (brox_terms) at the five Brox levels, B=128
     and B=1, on the first inner iteration (a nonzero state it must not
     read) and a later one, each plane within 1e-5 of its scale; K10
     (expo_terms) the same, each sample with a DF-AUTO diffusivity of
     its own, bit for bit.  K5 (warp_planes) and K5p (warp_planes_shift, with
     border_out on and off) warp Brox's six derivative planes at each of
     the five Brox levels with its dmax, at level 0 also 3 planes (K5p
     without border_out: tvl1occflow's level 0) and 18 (robust-expo
     RGB), at level 1 also two samples, at level 2 also 7 and 4 planes,
     each with both plane counts a thread may take (6 and 3, the
     wrapper's first), then at Brox temporal's twelve levels at B = 8
     (K5 at 0-6, K5p at 7-11) and, for K5p, TV-L1 with occlusions'
     levels 1-4 at P = 3 without border_out,
     by a flow with a few NaN pixels and
     bands 0.5 px inside to 4.5 px past the bound on both signs of both
     axes.  The iterative
     kernels run a fixed count (K2, K4, K7: 8; K6: 100), then K2, K4 and
     K7 stop="error" from a zero flow or increment (n equal or off by
     one), and K7 300 sweeps with thresh < 0 (n == 300);
  3. the main paths at 1024x436, each run with every launch count set to
     0 just before it and read just after: `tvl1_batched` and
     `hs_pyramidal_batched` (4 pairs, stop="error"),
     `hs_classic_batched` (4 pairs, 100 iterations, alpha 7), and the
     single-pair `brox_spatial` and `robust_expo` (gray, method 1) at the
     reference CLI defaults (45 K5 launches at the three levels of at
     least 96x96 px, 30 K5p launches at the two below, each with the
     planes a thread warps at that level, 75 K7 calls, all on route
     "resident", which launches exactly the sweeps the solves need);
     then `brox_temporal` on 9 frames (8 fields; `synth_sequence`, the
     seed-100 pair's I0 drifted frame after frame) and `tvl1occflow` on
     one triplet (I-1 = I0 rolled by a column) at the reference CLI
     defaults, each level's warps recorded and held to what the level
     sizes give (Brox temporal: 15 K5 launches at B = 8 on each level of
     at least 96x96 px, 15 K5p below; TV-L1 with occlusions: 4 K5p
     launches a level without border_out, 20 in all), with the SOR
     sweeps, host reads and iterations per level;
     kernels against plain versions (both on the card), the flow against
     the pairs' synthetic ground truth (Brox temporal's against the
     drift), and the HS, Brox, robust-expo, Brox temporal and TV-L1-
     occlusion solvers against the reference binary's goldens
     (tests/goldens/); then the seven CLIs (`python -m
     tpuflow_torch.cli.<name>`, run in process) on the seed-100 pair
     written as PFM (robust_expo_methods: as RGB PNG), tvl1flow also on
     gray PNG, tvl1flow and horn_schunck_pyramidal also verbose; the PNGs' rows are filtered as
     libpng filters them (mostly Paeth here): each `.flo` against the
     direct solver call on the same inputs, the kernels each run
     launched, seconds per call with the image IO, and the IO's seconds
     alone (brox_temporal on the 9 frames as PFM, each flowNN.flo against
     the direct call; tvl1occflow on the triplet as PFM, its occlusion
     PNG equal to chi * 255 of the direct call);
  4. `brox_spatial_batched` on the B=128 timing pairs at the reference
     CLI defaults: each level's K7 route as `brox_sor_route` gives it on
     the card (15 calls a level), its K5 or K5p launches (15 a level),
     K7's sweeps launched against what the stats imply, 15 K9 calls a
     level (75 a call), the call's
     seconds and peak memory, and samples 0, 1, 63 and 127 against
     `brox_spatial` on their pairs (EPE <= 0.01); then
     `robust_expo_batched` (method 3, DF-AUTO) the same way, with 15 K10
     calls a level and no K9, its samples against `robust_expo`;
  5. timing at the benchmark geometry: the batched engines at B=128
     (fields/s), the single-pair solvers on one pair (seconds per pair),
     each over 3 reps after one warm call (Brox temporal per volume and
     TV-L1 with occlusions per triplet over 2, after the kernel timing
     below), with peak device memory,
     where one call's time goes (per pyramid level, and by kernel under
     torch.profiler), and each kernel's time at level 0 against its
     bound and its plain version (the single-pair kernels from device
     memory, L2 flushed before each call; K4's route "level" alone: one
     warp's whole solve at 55x128, B=128; and the HS call's sweeps
     needed against launched; K7 as one resident solve of 16 and of 300
     fixed sweeps, one launch each, beside route "stream"'s time per
     sweep; K7's launches per Brox pair per route and by kernel name;
     route "stream" at B=128 at levels 0-3 by graph: one sweep in a
     chunk of 16 at one sweep a launch and at DEEP_K against the bound
     of its 13 planes moved once a launch, the settle's most redo, and
     a 16-sweep chunk with every sample stopped).
     K5, K5p and K7's resident solves are timed as CUDA graphs between
     CUDA events (`graph_ms`), the profiler's median beside them; K5 and
     K5p at every shape where the main paths launch them, with both plane
     counts a thread may take (K5 also at B = 8, Brox temporal's level
     0), and K9 at level 0 at B=128 by graph against its bytes bound (at
     most 3 times it), K10 likewise (at most 2 times it, K9 on the same
     inputs beside it).  A kernel read below its bound fails the run.  Then K8 (the
     pyramid, `check_pyramid`) on the B=128 timing pairs against the
     plain pyramid on the card: every level of both images bit for bit
     at zfactor 0.5 and within 1e-4 at 0.75, one launch a level, and its
     device time per level and per call beside its bound and the plain
     pyramid's; the batched TV-L1 and HS main paths must launch K8 once a
     level (7 at 1024x436).

Right after the build, `warmup` of every method; after the main paths,
the ops that no solver calls against their float64 CPU run, float64
inputs, and checkpoint and resume; after the engines' timing, the
`parallel` phase: every lane of tpuflow_torch.parallel at world size 1
in a one-rank NCCL group (data parallel; the tile lane; `tvl1_spatial`
on one 1024x436 pair against `tvl1_multiscale(warp_mode="fast")`'s
per-level route, EPE <= 1e-4 and each warp's iterations within one,
with K5's and K5p's launches per level and the level-0 warp's K5 and
K5p outputs against their plain versions; `robust_expo_spatial` on the
same pair, method 1 at robust_expo_methods' defaults, against
`robust_expo(warp_mode="fast")`: EPE <= 1e-4 and each solve's sweeps
within one, 45 K5, 30 K5p and 75 K7 launches (each solve on the
gathered level) and no other kernel, the level-0 warp's K5 output
against its plain version, and a
method-3 call against the untiled one at the same bounds;
`tvl1occflow_spatial` on the timing triplet against
`tvl1occflow(warp_mode="fast")`: EPE <= 1e-4, chi differing on fewer
than 1% of the pixels, each warp's iterations within one, 20 K5p
launches without border_out and no other kernel; and the frame-sharded
Brox temporal lane on the 9-frame volume against the single-device
solver with the exact warp, EPE <= 1e-5 per field and equal sweeps per
level).

Then the script's wall time, the {"kernels": [...]} line, the card's
name and power limit as nvidia-smi gives them, and last {"ok": true, "device": {...}}.  Every
check raises on failure, so any failed phase exits non-zero.  Without a
card, or outside a checkout, it exits non-zero and prints no result.
"""

import contextlib
import importlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# f32 operations per pixel, counted from the CUDA sources: K1/K3 for one
# in-domain pixel (two Keys weight sets, 16 tap weights, 48 tap FMAs,
# the constants); K2 for one iteration (primal + dual); K4 for one
# sweep (two Laplacians, two updates, the squared update); K6 for one
# iteration (two averages, the reciprocal, the update)
K1_FLOPS_PX = 170
K2_FLOPS_PX = 60
K3_FLOPS_PX = 175
K4_FLOPS_PX = 45
K6_FLOPS_PX_ITER = 32
# K5 for one in-domain pixel of P planes (two Keys weight sets, 16 tap
# weights, 32 operations per plane); K7 for one sweep (two divergences,
# two reciprocals and updates, the squared update)
K5_FLOPS_PX_BASE, K5_FLOPS_PX_PLANE = 40, 32
# K5p: K5's and 16 window compares
K5P_FLOPS_PX_BASE = 56
K7_FLOPS_PX = 40
K1_PLANES = 6 + 4   # reads I1, I1x, I1y, u, v, I0; writes 4 constants
K2_PLANES = 10 + 6  # reads 6 state + 4 constant planes; writes 6 state
K3_PLANES = 6 + 5   # reads I2, I2x, I2y, u, v, I1; writes 5 constants
K4_PLANES = 7 + 2   # reads u, v + 5 constant planes; writes u, v
K6_PLANES = 3 + 2   # one call reads Ex, Ey, Et; writes u, v
K7_PLANES = 11 + 2  # reads du, dv + 9 constant planes; writes du, dv
# K9 at the first inner iteration reads u, v, I1, I1x, I1y and the six
# warped planes and writes the 9 constants; later ones also read du, dv.
# Its f32 operations per pixel, counted from csrc/brox_terms.cu (a square
# root and a division one each): psi_s 18, psi1..psi4 8, the divergences
# 26, the data terms and the constants 65
K9_PLANES_FIRST = 11 + 9
K9_PLANES_LATER = 13 + 9
K9_FLOPS_PX = 117
# K9 at level 0, B=128, may take at most this many times its bytes bound
K9_X_BOUND = 3.0
# K10 reads K9's planes and expo (21, 23 with du and dv); its operations:
# K9's and the product of expo in psi_s
K10_PLANES_FIRST = K9_PLANES_FIRST + 1
K10_PLANES_LATER = K9_PLANES_LATER + 1
K10_FLOPS_PX = K9_FLOPS_PX + 1
# K10 at level 0, B=128, may take at most this many times its bytes bound
K10_X_BOUND = 2.0
# one K7 stream sweep at level 0, B=128, may take at most this many times
# the bound of its 13 planes
K7_STREAM_X_BOUND = 2.0
B_CHECK, B_TIME = 4, 128
SEED0 = 100
# TV-L1 (l_t, theta, taut) at the CLI defaults; HS and classic alpha
TVL1_PARAMS = (0.15 * 0.3, 0.3, 0.25 / 0.3)
HS_ALPHA2 = 7.0 * 7.0
CLASSIC_NITER, CLASSIC_ALPHA = 100, 7.0  # tools/bench_all7.py:83
GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "goldens"
GOLDENS = GOLDEN_DIR / "solvers.npz"
BROX_DMAX0 = 8  # level 0's displacement bound at max_motion 8
CLI_REPS = 3
# Brox temporal at the reference CLI defaults: 9 frames, 8 fields
# (tools/bench_all7.py:98), zfactor 0.75; TV-L1 with occlusions' zfactor
TEMPORAL_FRAMES, TEMPORAL_ZFACTOR = 9, 0.75
OCC_ZFACTOR = 0.5
# reps after the first call of the two multi-frame CLIs (seconds each)
SEQUENCE_CLI_REPS = 1


T_START = time.perf_counter()


def emit(**fields):
    """One JSON line; a phase's line also carries the seconds since the
    script started (`t_s`)."""
    if "phase" in fields:
        fields["t_s"] = time.perf_counter() - T_START
    print(json.dumps(fields), flush=True)


def bound_ms(px, planes, flops_px):
    """Least time for the work: bytes over the memory rate or operations
    over the f32 rate, whichever is larger; and which one it is."""
    t_bytes = px * planes * 4 / HBM_BYTES_PER_S
    t_ops = px * flops_px / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, n):
    """Mean device time of `fn` over n calls, from CUDA events, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def pairs(batch, ny, nx, dev):
    from tpuflow_torch.data import synth_pair

    I0, I1 = zip(*(synth_pair(ny, nx, seed=SEED0 + b) for b in range(batch)))
    return (torch.from_numpy(np.stack(I0)).to(dev),
            torch.from_numpy(np.stack(I1)).to(dev))


def kernel_inputs(I0, I1, dev, dmax, mode="tvl1"):
    """(planes, state, aux, const) of a warp kernel and its iteration
    kernel for raw pairs: the second image with its centred gradient,
    the pairs' synthetic flow (state (B, 6) for "tvl1", (B, 2) for
    "hs"), the first image, and the constants that flow gives."""
    from tpuflow_torch.data import synth_flow
    from tpuflow_torch.ops.gradients import centered_gradient
    from tpuflow_torch.ops.warp import warp_const_plain

    B, ny, nx = I0.shape
    planes = torch.stack([I1, *centered_gradient(I1)], dim=1).contiguous()
    u, v = (torch.as_tensor(f, dtype=torch.float32, device=dev)
            for f in synth_flow(ny, nx))
    state = torch.zeros((B, 6 if mode == "tvl1" else 2, ny, nx), device=dev)
    state[:, 0] = -u  # the flow that takes I0 to I1 (synth_pair warps by +u)
    state[:, 1] = -v
    const, _ = warp_const_plain(planes, state[:, :2], I0, dmax, mode,
                                HS_ALPHA2)
    return planes, state, I0.contiguous(), const


def rel_err(got, ref):
    """Max abs error of each plane over that plane's largest value
    (at least 1), maximised over the planes; and the max abs error."""
    err = (got - ref).abs().amax(dim=(0, 2, 3))
    scale = ref.abs().amax(dim=(0, 2, 3)).clamp(min=1.0)
    return float((err / scale).max()), float(err.max())


def check_warp(dev, ny, nx, dmax, mode):
    """K1 (mode "tvl1") or K3 ("hs") against the plain version."""
    from tpuflow_torch.ops.warp import (warp_const_batched,
                                        warp_const_hs_batched,
                                        warp_const_plain)

    planes, state, aux, _ = kernel_inputs(*pairs(B_CHECK, ny, nx, dev), dev,
                                          dmax, mode)
    uv = state[:, :2]
    if mode == "hs":
        got, oflow = warp_const_hs_batched(planes, uv, aux, dmax, HS_ALPHA2)
    else:
        got, oflow = warp_const_batched(planes, uv, aux, dmax)
    ref, _ = warp_const_plain(planes, uv, aux, dmax, mode, HS_ALPHA2)
    torch.cuda.synchronize()
    rel, err = rel_err(got, ref)
    # plane 3 (grad, Dv) exceeds its out-of-domain value (0, alpha^2)
    # where the warp found texture
    floor = HS_ALPHA2 if mode == "hs" else 0.0
    out = {"shape": [B_CHECK, ny, nx], "dmax": dmax, "max_abs_err": err,
           "max_rel_err": rel,
           "in_domain": float((ref[:, 3] > floor).float().mean()),
           "overflow": oflow}
    # f32 sums of 16 taps, contracted to FMAs on the card: a few ulp of
    # each plane's largest value
    if not rel <= 1e-5 or oflow != 0:
        raise AssertionError(f"warp {mode} disagrees with its plain version: {out}")
    return out


def check_iterative(dev, ny, nx, dmax, mode):
    """K2 (mode "tvl1") or K4 ("hs") against the plain version: 8 fixed
    iterations from the synthetic flow, then stop="error" at the main
    path's threshold from a zero flow (a level's first warp, its longest
    solve).  The kernel sums err in another order, so where err lands
    next to thresh n may move by one."""
    from tpuflow_torch.ops.hs import hs_sor_error, hs_sor_error_plain
    from tpuflow_torch.ops.tvl1 import (tvl1_iterate_error,
                                        tvl1_iterate_error_plain)
    from tpuflow_torch.ops.warp import warp_const_plain

    if mode == "tvl1":
        kernel, plain, args = tvl1_iterate_error, tvl1_iterate_error_plain, TVL1_PARAMS
        eps, max_iter = 0.01, 300
    else:
        kernel, plain, args = hs_sor_error, hs_sor_error_plain, (HS_ALPHA2,)
        eps, max_iter = 1e-4, 150
    planes, state, aux, const = kernel_inputs(*pairs(B_CHECK, ny, nx, dev),
                                              dev, dmax, mode)
    out = {"shape": [B_CHECK, ny, nx]}
    if mode == "hs":
        from tpuflow_torch.ops.hs import device_route

        out["route"] = device_route(ny, nx)
    got, _, n = kernel(state.clone(), const, -1.0, 8, *args)
    ref, _, n_ref = plain(state.clone(), const, -1.0, 8, *args)
    torch.cuda.synchronize()
    out["fixed8_max_abs_err"] = float((got - ref).abs().max())
    # f32, FMA-contracted on the card, on flows of about 2 px
    if not (out["fixed8_max_abs_err"] <= 2e-4
            and n.tolist() == [8] * B_CHECK and n_ref.tolist() == [8] * B_CHECK):
        raise AssertionError(f"{mode} (8 iterations) disagrees: {out}")
    state.zero_()
    const, _ = warp_const_plain(planes, state[:, :2], aux, dmax, mode,
                                HS_ALPHA2)
    thresh = float(np.float32(eps * eps) * np.float32(ny * nx))
    got, err, n = kernel(state.clone(), const, thresh, max_iter, *args)
    ref, err_ref, n_ref = plain(state.clone(), const, thresh, max_iter, *args)
    out.update(n=n.tolist(), n_plain=n_ref.tolist(), err=err.tolist(),
               err_plain=err_ref.tolist())
    same = n == n_ref
    out["error_max_abs_err_where_n_equal"] = (
        float((got - ref)[same].abs().max()) if bool(same.any()) else None)
    if not bool(((n - n_ref).abs() <= 1).all()):
        raise AssertionError(f"{mode} stopping counts differ by more than 1: {out}")
    return out


def check_classic(dev, ny, nx, niter=CLASSIC_NITER):
    """K6 against its plain version, `niter` iterations from zero flow."""
    from tpuflow_torch.models.hs_classic import _input_derivatives
    from tpuflow_torch.ops.hs_classic import (hs_classic_fused,
                                              hs_classic_fused_plain,
                                              launch_steps)

    d = _input_derivatives(*pairs(B_CHECK, ny, nx, dev))
    got = torch.stack(hs_classic_fused(*d, CLASSIC_ALPHA, niter), 1)
    ref = torch.stack(hs_classic_fused_plain(*d, CLASSIC_ALPHA, niter), 1)
    torch.cuda.synchronize()
    out = {"shape": [B_CHECK, ny, nx], "niter": niter,
           "launch_steps": launch_steps(niter),
           "max_abs_err": float((got - ref).abs().max())}
    # f32 Jacobi, FMA-contracted on the card, on flows of about 3 px
    if not out["max_abs_err"] <= 1e-4:
        raise AssertionError(f"hs_classic disagrees with its plain version: {out}")
    return out


def brox_levels(zfactor=0.5, nscales=10):
    """(nx, ny) of a solver's levels at 1024x436 at the reference CLI
    defaults, nscales clamped on min(nx, ny) >= 16: 5 for the
    single-pair Brox solvers (zfactor 0.5, nscales 10) and for TV-L1 with
    occlusions (0.5, 100), 12 for Brox temporal (0.75, 100)."""
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.ops.pyramid import clamp_nscales, pyramid_sizes

    return pyramid_sizes(NX, NY, zfactor, clamp_nscales(NX, NY, zfactor,
                                                        nscales,
                                                        use_hypot=False))


def brox_dmax(scale, zfactor=0.5):
    """The solvers' displacement bound at level `scale` (max_motion 8)."""
    return max(3, math.ceil(BROX_DMAX0 * zfactor ** scale))


def brox_inputs(dev, ny, nx):
    """Level-0 inputs of one Brox solve on synth_pair's first pair: the
    normalised, presmoothed images (I1, I2) as `brox_spatial` hands
    them to `brox_scale`, the six planes (I2, I2x, I2y, I2xx, I2xy,
    I2yy) that K5 warps, and the synthetic flow (u, v) from I1 to I2."""
    from tpuflow_torch.data import synth_flow
    from tpuflow_torch.models.common import build_pyramid
    from tpuflow_torch.ops.gradients import centered_gradient, dxx, dxy, dyy

    I1, I2 = (im[0] for im in pairs(1, ny, nx, dev))
    (I1, I2), = build_pyramid((I1, I2), 1, 0.5)[0]
    planes = torch.stack([I2, *centered_gradient(I2), dxx(I2), dxy(I2),
                          dyy(I2)])[None].contiguous()
    u, v = (-torch.as_tensor(f, dtype=torch.float32, device=dev)
            for f in synth_flow(ny, nx))
    return I1, I2, planes, u, v


def past_bound_flow(ny, nx, dmax, dev):
    """synth_flow's (-u, -v) with bands of |u| (columns) and |v| (rows) at
    dmax - 0.5 ... dmax + 4.5 px on both signs: each side of K5p's
    window [-dmax-1, dmax+2] and the pixels beyond it."""
    from tpuflow_torch.data import synth_flow

    u, v = (-np.asarray(f, np.float32) for f in synth_flow(ny, nx))
    mags = [s * (dmax + d) for d in (-0.5, 0.5, 1.5, 2.5, 3.5, 4.5)
            for s in (1, -1)]
    for k, mag in enumerate(mags, start=1):
        c, r = k * nx // (len(mags) + 1), k * ny // (len(mags) + 1)
        u[:, c:c + max(3, nx // 64)] = mag
        v[r:r + max(2, ny // 64), :] = mag
    return torch.stack([torch.from_numpy(u), torch.from_numpy(v)])[None].to(dev)


def warp_case(dev, ny, nx, dmax, n_planes, batch=1):
    """Inputs of a K5 / K5p check: `n_planes` planes per sample cycled
    from the six Brox planes (each cycle scaled by 1.5), sample 1 the
    mirror image of sample 0; the flow `past_bound_flow` (sample 1's
    mirrored and halved), with a few NaN pixels, as the first two planes
    of a (batch, 6, ny, nx) state, so that uv has the batch stride of a
    view of the solver state.  Samples 2k and 2k+1 repeat 0 and 1, the
    planes scaled by 1 + k / 4 and the flow by 1 - k / 8."""
    six = brox_inputs(dev, ny, nx)[2]
    planes = torch.cat([six * 1.5 ** c for c in range(-(-n_planes // 6))],
                       dim=1)[:, :n_planes]
    flow = past_bound_flow(ny, nx, dmax, dev)
    flow[0, :, ny // 3, nx // 5:nx // 5 + 8] = float("nan")
    k = torch.arange(batch, device=dev)[:, None, None, None] // 2
    planes = (torch.cat([planes, planes.flip(-1)]).repeat(-(-batch // 2), 1, 1, 1)
              [:batch] * (1 + k / 4)).contiguous()
    flow = (torch.cat([flow, 0.5 * flow.flip(-1)]).repeat(-(-batch // 2), 1, 1, 1)
            [:batch] * (1 - k / 8))
    state = torch.zeros((batch, 6, ny, nx), device=dev)
    state[:, :2] = flow
    return planes, state[:, :2]


def planes_groups(B, ny, nx):
    """The planes a K5 / K5p thread warps at this size, the wrapper's
    choice first, then the other one the kernel takes."""
    from tpuflow_torch.ops.warp import GROUPS, device_group

    chosen = device_group(B, ny, nx, torch.cuda.current_device())
    return [chosen] + [g for g in GROUPS if g != chosen]


def check_warp_planes(dev, ny, nx, dmax, n_planes, batch=1, shift=False,
                      border_out=True):
    """K5 (K5p with `shift`) against its plain version on `warp_case`'s
    inputs, with each plane count a thread may take (the wrapper's
    first).  K5: within 1e-5 of each plane's scale (f32 sums of 16 taps,
    contracted to FMAs on the card).  K5p: equal bit for bit (it rounds
    each operation as the plain version does), and within 1e-4 absolute
    in any case."""
    from tpuflow_torch.ops.warp import (warp_planes_on_group,
                                        warp_planes_plain,
                                        warp_planes_shift_plain)

    planes, uv = warp_case(dev, ny, nx, dmax, n_planes, batch)
    if shift:
        ref, _ = warp_planes_shift_plain(planes, uv, dmax, border_out)
    else:
        ref, _ = warp_planes_plain(planes, uv, dmax)
    out = []
    for group in planes_groups(batch, ny, nx):
        got, oflow = warp_planes_on_group(planes, uv, dmax, group, shift,
                                          border_out)
        torch.cuda.synchronize()
        rel, err = rel_err(got, ref)
        c = {"group": group, "shape": list(planes.shape), "dmax": dmax,
             "uv_bstride": uv.stride(0), "max_abs_err": err,
             "max_rel_err": rel, "overflow": oflow,
             "finite": bool(torch.isfinite(got).all()),
             "nonzero_share": float((ref[:, 0] != 0).float().mean())}
        if shift:
            strict, _ = warp_planes_plain(planes, uv, dmax)
            partial = (strict[:, 0] == 0) & (ref[:, 0] != 0)
            c.update(border_out=border_out,
                     bit_equal=bool(torch.equal(got, ref)),
                     partial_tap_share=float(partial.float().mean()))
            ok = c["bit_equal"] and err <= 1e-4 and c["partial_tap_share"] > 0
        else:
            ok = rel <= 1e-5
        out.append(c)
        if not (ok and oflow == 0 and c["finite"]):
            raise AssertionError(f"warp_planes{'_shift' if shift else ''} "
                                 f"disagrees with its plain version: {c}")
    return out


def warp_planes_checks(dev, shift):
    """K5 (K5p with `shift`, border_out on and off) at each Brox level of
    1024x436 with its dmax and P = 6; at level 0 also P = 3 (K5p without
    border_out: tvl1occflow's level 0) and P = 18 (robust-expo RGB:
    three groups of 6); at level 1 also B = 2; at level 2 also P = 7 and
    4 (groups of 6 or 3 and of 1).  Flows past the bound
    throughout, each check with both plane counts a thread may take."""
    modes = (True, False) if shift else (True,)
    # level: [(planes, samples)] beside (6, 1)
    extra = {0: [(3, 1), (18, 1)], 1: [(6, 2)], 2: [(7, 1), (4, 1)]}
    out = []
    for s, (nx, ny) in enumerate(brox_levels()):
        for n_planes, batch in [(6, 1)] + extra.get(s, []):
            for bo in modes:
                out += check_warp_planes(dev, ny, nx, brox_dmax(s), n_planes,
                                         batch, shift, bo)
    return out


def sequence_warp_checks(dev, shift):
    """K5 (K5p with `shift`) at the shapes the two multi-frame solvers
    give it at 1024x436: Brox temporal's levels at B = 8 and P = 6 with
    their dmax (K5 at levels of at least 96x96 px, K5p below), and, for
    K5p, TV-L1 with occlusions' levels at P = 3 without border_out (level
    0 is `warp_planes_checks`'); flows past the bound, each check with
    both plane counts a thread may take."""
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS

    out = []
    for s, (nx, ny) in enumerate(brox_levels(TEMPORAL_ZFACTOR, 100)):
        if (nx * ny < K5_MIN_PIXELS) == shift:
            out += check_warp_planes(dev, ny, nx,
                                     brox_dmax(s, TEMPORAL_ZFACTOR), 6,
                                     TEMPORAL_FRAMES - 1, shift)
    if shift:
        for s, (nx, ny) in list(enumerate(brox_levels(OCC_ZFACTOR, 100)))[1:]:
            out += check_warp_planes(dev, ny, nx, brox_dmax(s, OCC_ZFACTOR),
                                     3, 1, True, False)
    return out


@contextlib.contextmanager
def swapped(swaps):
    """Set each (module, name) to a replacement inside the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def brox_system(dev, ny, nx, dmax, batch=1):
    """(state, const, thresh, alpha) of the first SOR solve of a level-0
    Brox outer iteration from the synthetic flow, the constants
    assembled by `brox_scale` itself (captured at its K7 call); the
    state is the zero increment.  With batch > 1 the samples share the
    system's matrix, sample k's right-hand side (Au, Av) scaled by
    1 / (k + 1), so their solves stop at different sweeps."""
    bs = importlib.import_module("tpuflow_torch.models.brox_spatial")
    from tpuflow_torch.ops.brox import brox_sor_error_plain

    I1, I2, _, u, v = brox_inputs(dev, ny, nx)
    seen = []

    def capture(state, const, thresh, max_iter, alpha):
        seen.append((state.clone(), const.clone(), thresh, alpha))
        return brox_sor_error_plain(state, const, thresh, max_iter, alpha)

    with swapped([(bs, "brox_sor_error", capture)]):
        bs.brox_scale(I1, I2, u, v, outer_iter=1, warp_mode="exact",
                      dmax=dmax)
    state, const, thresh, alpha = seen[0]
    if batch > 1:
        state = state.repeat(batch, 1, 1, 1)
        const = const.repeat(batch, 1, 1, 1)
        for k in range(1, batch):
            const[k, :2] /= k + 1
    return state.contiguous(), const.contiguous(), thresh, alpha


def brox_terms_case(dev, ny, nx, dmax, batch):
    """K9's inputs (u, v, I1, I1x, I1y, warped, state) at one Brox level
    for `batch` samples: `brox_inputs`' pair at (ny, nx), sample k's flow
    the synthetic flow times 1 - k / (2 batch), the six planes warped by
    it as the solver warps them (K5 or K5p), and an increment of a
    tenth of the flow in the state."""
    from tpuflow_torch.ops.gradients import centered_gradient
    from tpuflow_torch.ops.interp import warp_by_mode

    I1, _, planes, u, v = brox_inputs(dev, ny, nx)
    k = torch.arange(batch, dtype=torch.float32, device=dev)[:, None, None]
    u, v = u * (1 - k / (2 * batch)), v * (1 - k / (2 * batch))
    warped = warp_by_mode(planes.repeat(batch, 1, 1, 1), u, v, "fast", dmax)
    I1 = I1.repeat(batch, 1, 1)
    I1x, I1y = centered_gradient(I1)
    state = (0.1 * torch.stack([u, v], dim=1)).contiguous()
    return u, v, I1, I1x, I1y, warped.contiguous(), state


def check_brox_terms(dev):
    """K9 (`brox_terms`) against its plain version on the card at every
    Brox level of 1024x436, for B_TIME samples and for one, on the first
    inner iteration (the state holds a nonzero increment that K9 must
    not read) and on a later one: each of the nine planes within 1e-5 of
    its scale (the kernel rounds every operation as the plain version
    does, so they should agree bit for bit), one launch a call; and a
    CUDA float64 call refused with a ValueError."""
    from tpuflow_torch.models.brox_spatial import DEFAULT_ALPHA, DEFAULT_GAMMA
    from tpuflow_torch.ops.brox_terms import brox_terms, brox_terms_plain

    out = []
    for s, (nx, ny) in enumerate(brox_levels()):
        for batch in (B_TIME, 1):
            args = brox_terms_case(dev, ny, nx, brox_dmax(s), batch)
            for first in (True, False):
                reset()
                got = brox_terms(*args, torch.empty((batch, 9, ny, nx),
                                                    device=dev),
                                 DEFAULT_ALPHA, DEFAULT_GAMMA, first)
                launches = since_reset("calls.brox_terms")
                ref = brox_terms_plain(*args, torch.empty_like(got),
                                       DEFAULT_ALPHA, DEFAULT_GAMMA, first)
                torch.cuda.synchronize()
                rel, err = rel_err(got, ref)
                c = {"shape": [batch, ny, nx], "first": first,
                     "launches": launches, "max_abs_err": err,
                     "max_rel_err": rel, "bit_equal": bool(torch.equal(got, ref)),
                     "finite": bool(torch.isfinite(got).all())}
                out.append(c)
                if not (rel <= 1e-5 and launches == 1 and c["finite"]):
                    raise AssertionError(f"brox_terms disagrees with its "
                                         f"plain version: {c}")
                del got, ref
            del args
    u, v, I1, I1x, I1y, warped, state = brox_terms_case(dev, 28, 64, 3, 2)
    try:
        brox_terms(*(t.double() for t in (u, v, I1, I1x, I1y, warped, state)),
                   torch.empty((2, 9, 28, 64), dtype=torch.float64, device=dev),
                   DEFAULT_ALPHA, DEFAULT_GAMMA, True)
        refused = False
    except ValueError:
        refused = True
    out.append({"float64_refused": refused})
    if not refused:
        raise AssertionError("brox_terms: a CUDA float64 call ran")
    return out


def brox_terms_timing(dev):
    """K9 at level 0 of B_TIME 1024x436 pairs, the cell's shape: one launch
    on the first inner iteration and on a later one, by `graph_ms` (the
    inputs are 20 times the L2, so it is not flushed), with the
    profiler's median beside it, against the bytes each moves; the
    state's zero fill that precedes it in a span `terms`; and the plain
    version's device time (CUDA events: its ~60 ops a call are
    device-bound at this size).  Fails above K9_X_BOUND times the bound
    or below the bound."""
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.models.brox_spatial import DEFAULT_ALPHA, DEFAULT_GAMMA
    from tpuflow_torch.ops.brox_terms import brox_terms, brox_terms_plain

    args = brox_terms_case(dev, NY, NX, BROX_DMAX0, B_TIME)
    const = torch.empty((B_TIME, 9, NY, NX), device=dev)
    state = args[-1]
    px = B_TIME * NY * NX

    def k9(first):
        return brox_terms(*args, const, DEFAULT_ALPHA, DEFAULT_GAMMA, first)

    k = {"unit": f"one launch, B={B_TIME} at {NX}x{NY} (level 0)"}
    k["ms"] = graph_ms(lambda: k9(True), 10, False)
    k["profiler_ms"], k["profiler_us"] = device_ms(
        lambda: k9(True), 10, {"brox_terms_kernel": 1}, flush_l2=False)
    k["bound_ms"], k["bound_by"] = bound_ms(px, K9_PLANES_FIRST, K9_FLOPS_PX)
    k["x_bound"] = k["ms"] / k["bound_ms"]
    k["later_ms"] = graph_ms(lambda: k9(False), 10, False)
    k["later_bound_ms"] = bound_ms(px, K9_PLANES_LATER, K9_FLOPS_PX)[0]
    k["state_fill_ms"] = graph_ms(lambda: torch.zeros_like(state), 10, False)
    k["plain_ms"] = time_ms(lambda: brox_terms_plain(
        *args, const, DEFAULT_ALPHA, DEFAULT_GAMMA, True), 3)
    if not k["bound_ms"] <= k["ms"] <= K9_X_BOUND * k["bound_ms"]:
        raise AssertionError(f"brox_terms at level 0 outside [1, "
                             f"{K9_X_BOUND}] times its bound: {k}")
    return k


def expo_terms_case(dev, ny, nx, dmax, batch):
    """K10's inputs (u, v, expo, I1, I1x, I1y, warped, state): K9's
    (`brox_terms_case`), and sample k's DF-AUTO diffusivity (method 3 at
    robust_expo_methods' defaults) of I1's gradient times 1 + k / batch,
    so that each sample has a diffusivity of its own."""
    from tpuflow_torch.models.robust_expo import (DEFAULT_ALPHA,
                                                  DEFAULT_LAMBDA,
                                                  exponential_diffusivity)

    u, v, I1, I1x, I1y, warped, state = brox_terms_case(dev, ny, nx, dmax,
                                                        batch)
    k = torch.arange(batch, dtype=torch.float32, device=dev)[:, None, None]
    expo = exponential_diffusivity(I1x * (1 + k / batch), I1y * (1 + k / batch),
                                   3, DEFAULT_ALPHA, DEFAULT_LAMBDA,
                                   channel_dim=None)
    return u, v, expo.contiguous(), I1, I1x, I1y, warped, state


def check_expo_terms(dev):
    """K10 (`expo_terms`) against its plain version on the card at every
    Brox level of 1024x436, for B_TIME samples and for one, on the first
    inner iteration (the state holds a nonzero increment that K10 must
    not read) and on a later one: bit for bit (the kernel rounds every
    operation as the plain version does, in its order), one launch a
    call; and a CUDA float64 call refused with a ValueError."""
    from tpuflow_torch.models.robust_expo import DEFAULT_ALPHA, DEFAULT_GAMMA
    from tpuflow_torch.ops.brox_terms import expo_terms, expo_terms_plain

    out = []
    for s, (nx, ny) in enumerate(brox_levels()):
        for batch in (B_TIME, 1):
            args = expo_terms_case(dev, ny, nx, brox_dmax(s), batch)
            for first in (True, False):
                reset()
                got = expo_terms(*args, torch.empty((batch, 9, ny, nx),
                                                    device=dev),
                                 DEFAULT_ALPHA, DEFAULT_GAMMA, first)
                launches = since_reset("calls.expo_terms")
                ref = expo_terms_plain(*args, torch.empty_like(got),
                                       DEFAULT_ALPHA, DEFAULT_GAMMA, first)
                torch.cuda.synchronize()
                rel, err = rel_err(got, ref)
                c = {"shape": [batch, ny, nx], "first": first,
                     "launches": launches, "max_abs_err": err,
                     "max_rel_err": rel, "bit_equal": bool(torch.equal(got, ref)),
                     "finite": bool(torch.isfinite(got).all())}
                out.append(c)
                if not (c["bit_equal"] and launches == 1 and c["finite"]):
                    raise AssertionError(f"expo_terms disagrees with its "
                                         f"plain version: {c}")
                del got, ref
            del args
    args = expo_terms_case(dev, 28, 64, 3, 2)
    try:
        expo_terms(*(t.double() for t in args),
                   torch.empty((2, 9, 28, 64), dtype=torch.float64, device=dev),
                   DEFAULT_ALPHA, DEFAULT_GAMMA, True)
        refused = False
    except ValueError:
        refused = True
    out.append({"float64_refused": refused})
    if not refused:
        raise AssertionError("expo_terms: a CUDA float64 call ran")
    return out


def expo_terms_timing(dev):
    """K10 at level 0 of B_TIME 1024x436 pairs, the cell's shape: one
    launch on the first inner iteration and on a later one, by
    `graph_ms` (not L2-flushed, as K9), with the profiler's median beside
    it, against the bytes each moves, K9 on the same inputs beside it;
    and the plain version's device time (CUDA events).  Fails above
    K10_X_BOUND times the bound or below the bound."""
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.models.robust_expo import DEFAULT_ALPHA, DEFAULT_GAMMA
    from tpuflow_torch.ops.brox_terms import (brox_terms, expo_terms,
                                              expo_terms_plain)

    args = expo_terms_case(dev, NY, NX, BROX_DMAX0, B_TIME)
    const = torch.empty((B_TIME, 9, NY, NX), device=dev)
    px = B_TIME * NY * NX

    def k10(first):
        return expo_terms(*args, const, DEFAULT_ALPHA, DEFAULT_GAMMA, first)

    k = {"unit": f"one launch, B={B_TIME} at {NX}x{NY} (level 0)"}
    k["ms"] = graph_ms(lambda: k10(True), 10, False)
    k["profiler_ms"], k["profiler_us"] = device_ms(
        lambda: k10(True), 10, {"expo_terms_kernel": 1}, flush_l2=False)
    k["bound_ms"], k["bound_by"] = bound_ms(px, K10_PLANES_FIRST, K10_FLOPS_PX)
    k["x_bound"] = k["ms"] / k["bound_ms"]
    k["later_ms"] = graph_ms(lambda: k10(False), 10, False)
    k["later_bound_ms"] = bound_ms(px, K10_PLANES_LATER, K10_FLOPS_PX)[0]
    k["later_x_bound"] = k["later_ms"] / k["later_bound_ms"]
    no_expo = args[:2] + args[3:]
    k["k9_ms"] = graph_ms(lambda: brox_terms(
        *no_expo, const, DEFAULT_ALPHA, DEFAULT_GAMMA, True), 10, False)
    k["plain_ms"] = time_ms(lambda: expo_terms_plain(
        *args, const, DEFAULT_ALPHA, DEFAULT_GAMMA, True), 3)
    if not (k["bound_ms"] <= k["ms"] <= K10_X_BOUND * k["bound_ms"]
            and k["later_bound_ms"] <= k["later_ms"]
            <= K10_X_BOUND * k["later_bound_ms"]):
        raise AssertionError(f"expo_terms at level 0 outside [1, "
                             f"{K10_X_BOUND}] times its bound: {k}")
    return k


def check_brox_sor(dev, ny, nx, dmax, batch=1):
    """K7 against its plain version on a Brox system, naming the route
    the wrapper takes: 8 fixed sweeps, then stop="error" at the solver's
    threshold from the zero increment (n equal or off by one: the kernel
    sums err in another order; du and dv within the 8 sweeps' tolerance
    in each sample whose n is equal), then thresh < 0 at max_iter 300
    (n == 300 exactly)."""
    from tpuflow_torch.ops.brox import (brox_sor_error, brox_sor_error_plain,
                                        device_route)

    state, const, thresh, alpha = brox_system(dev, ny, nx, dmax, batch)
    out = {"shape": list(state.shape), "route": device_route(batch, ny, nx),
           "thresh": thresh}
    reset()
    got, _, n = brox_sor_error(state.clone(), const, -1.0, 8, alpha)
    ref, _, n_ref = brox_sor_error_plain(state.clone(), const, -1.0, 8, alpha)
    torch.cuda.synchronize()
    out["fixed8_max_abs_err"] = float((got - ref).abs().max())
    out["fixed8_scale"] = float(ref.abs().max())
    # f32, FMA-contracted on the card: 2e-4 of the increment's scale
    if not (out["fixed8_max_abs_err"] <= 2e-4 * max(out["fixed8_scale"], 1e-3)
            and n.tolist() == [8] * batch and n_ref.tolist() == [8] * batch):
        raise AssertionError(f"brox_sor (8 sweeps) disagrees: {out}")
    got, err, n = brox_sor_error(state.clone(), const, thresh, 300, alpha)
    ref, err_ref, n_ref = brox_sor_error_plain(state.clone(), const, thresh,
                                               300, alpha)
    out.update(n=n.tolist(), n_plain=n_ref.tolist(), err=err.tolist(),
               err_plain=err_ref.tolist())
    out.update(stopped_equal_within_tol(got, n, ref, n_ref))
    if not bool(((n - n_ref).abs() <= 1).all()):
        raise AssertionError(f"brox_sor stopping counts differ by more than 1: {out}")
    if not out["error_within_tol"]:
        raise AssertionError(f"brox_sor (stop error) disagrees: {out}")
    got, _, n = brox_sor_error(state.clone(), const, -1.0, 300, alpha)
    ref, _, n_ref = brox_sor_error_plain(state.clone(), const, -1.0, 300, alpha)
    out.update(fixed300_n=n.tolist(),
               fixed300_max_abs_err=float((got - ref).abs().max()),
               fixed300_scale=float(ref.abs().max()))
    if not (n.tolist() == [300] * batch and n_ref.tolist() == [300] * batch
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"brox_sor (300 sweeps, thresh < 0) disagrees: {out}")
    # route "stream" launches the 8 sweeps, the stop's rounded up to
    # CHECK_EVERY, and the 300; route "resident" none through the host loop
    from tpuflow_torch.ops.sweeps import CHECK_EVERY

    out["k7_stream_sweeps"] = since_reset("iters.k7")
    want = (8 + min(-(-max(out["n"]) // CHECK_EVERY) * CHECK_EVERY, 300) + 300
            if out["route"] == "stream" else 0)
    if out["k7_stream_sweeps"] != want:
        raise AssertionError(f"brox_sor launched {out['k7_stream_sweeps']} "
                             f"sweeps through the host loop, not {want}: {out}")
    return out


def stopped_equal_within_tol(got, n, ref, n_ref):
    """The largest |got - ref| of each sample whose stopping count n
    equals the plain version's (None where it does not), and whether each
    lies within 2e-4 of that sample's increment scale (f32, FMA-contracted
    on the card, as the fixed sweeps' tolerance)."""
    errs, ok = [], True
    for k in range(n.numel()):
        if int(n[k]) != int(n_ref[k]):
            errs.append(None)
            continue
        e = float((got[k] - ref[k]).abs().max())
        errs.append(e)
        ok = ok and e <= 2e-4 * max(float(ref[k].abs().max()), 1e-3)
    return {"error_max_abs_err": max((e for e in errs if e is not None),
                                     default=None),
            "error_samples_compared": sum(e is not None for e in errs),
            "error_within_tol": ok}


def stream_kernels(depth, sweeps):
    """{part of a kernel name: launches} of one `sweeps`-sweep stream
    solve at `depth`: at 1, one `brox_sor_colors` and one `stop_finalize`
    a sweep; at DEEP_K, one `brox_sor_color_sweeps` and one
    `stop_finalize_sweeps` a launch of DEEP_K (which `stop_finalize`
    names too) and the redo's `brox_sor_color_sweeps`; one
    `brox_sor_color_settle` a solve."""
    launches = -(-sweeps // depth)
    if depth == 1:
        return {"brox_sor_colors": launches, "stop_finalize": launches,
                "brox_sor_color_sweeps": 0, "brox_sor_color_settle": 1}
    return {"brox_sor_colors": 0, "brox_sor_color_sweeps": launches + 1,
            "stop_finalize": launches, "brox_sor_color_settle": 1}


def check_brox_stream(dev):
    """K7's route "stream" on a system route "resident" takes too (B=2 at
    218x512), at both depths `brox_sor_depth` picks (1 and DEEP_K): du
    and dv after 8 and after 17 fixed sweeps of `_solve_stream` against
    `brox_sor_error`'s resident solve (bit-equal: the same arithmetic; 17
    ends inside a launch of DEEP_K, so the settle redoes it, and on the
    scratch buffer at depth 1, so the settle copies it back); the kernels
    the profiler records for one 16-sweep stream solve by name
    (`stream_kernels`; a window in which the profiler missed a kernel is
    profiled again, up to 3 times, as `device_ms` does); then
    `check_stream_depth` and stop="error" at level 0 of B_TIME samples
    (`batch_stop_error`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch.ops.brox import (DEEP_K, _solve_stream, brox_sor_error,
                                        device_route)

    ny, nx = 218, 512
    state, const, _, alpha = brox_system(dev, ny, nx, brox_dmax(1), 2)
    out = {"shape": list(state.shape), "route": device_route(2, ny, nx)}
    if out["route"] != "resident":
        raise AssertionError(f"brox_sor stream check: {out}")
    for depth in (1, DEEP_K):
        for sweeps in (8, 17):
            got, _, n = _solve_stream(state.clone(), const, -1.0, sweeps,
                                      alpha, depth)
            ref, _, n_ref = brox_sor_error(state.clone(), const, -1.0,
                                           sweeps, alpha)
            torch.cuda.synchronize()
            key = f"depth{depth}_fixed{sweeps}"
            out.update({f"{key}_n": n.tolist(),
                        f"{key}_n_resident": n_ref.tolist(),
                        f"{key}_max_abs_err": float((got - ref).abs().max()),
                        f"{key}_bit_equal": bool(torch.equal(got, ref))})
            if not (n.tolist() == n_ref.tolist() == [sweeps] * 2
                    and out[f"{key}_bit_equal"]):
                raise AssertionError(
                    f"brox_sor stream against resident: {out}")
        want = stream_kernels(depth, 16)
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _solve_stream(state.clone(), const, -1.0, 16, alpha, depth)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            recorded = {part: sum(part in name for name in names)
                        for part in want}
            if recorded == want:
                break
        out.update({f"depth{depth}_kernels_16_sweeps": recorded,
                    f"depth{depth}_profiled_windows": attempt + 1})
        if recorded != want:
            raise AssertionError(f"brox_sor stream launches by name: {out}")
    del state, const, got, ref
    out["depth"] = check_stream_depth(dev)
    out["batch"] = batch_stop_error(dev)
    return out


def check_stream_depth(dev):
    """Route "stream" at DEEP_K sweeps a launch against its one-sweep
    schedule, at levels 0-3 of 1024x436 and B = 4 and B_TIME (each
    sample's right-hand side scaled as `brox_system` does), whatever
    depth `brox_sor_depth` picks there (reported): 7 and 17 fixed sweeps
    (max_iter reached inside a launch of DEEP_K), bit-equal; stop="error"
    at the solver's threshold, and at a threshold that stops samples
    inside a launch (the one-sweep schedule's err after 6 sweeps, the
    median over the samples): each n within one of the plain version and
    of the one-sweep schedule, du and dv bit-equal to the one-sweep
    schedule wherever n is the same, and at least one sample stopped
    inside a launch."""
    from tpuflow_torch.ops.brox import (DEEP_K, _solve_stream,
                                        brox_sor_error_plain, device_depth,
                                        device_route)

    out = []
    for B in (B_CHECK, B_TIME):
        for scale, (nx, ny) in enumerate(brox_levels()[:4]):
            state, const, thresh, alpha = brox_system(dev, ny, nx,
                                                      brox_dmax(scale), B)
            row = {"B": B, "level": scale, "route": device_route(B, ny, nx),
                   "depth": device_depth()}

            def both(th, max_iter):
                one = _solve_stream(state.clone(), const, th, max_iter, alpha,
                                    1)
                deep = _solve_stream(state.clone(), const, th, max_iter,
                                     alpha, DEEP_K)
                torch.cuda.synchronize()
                return one, deep

            for sweeps in (7, 17):
                one, deep = both(-1.0, sweeps)
                row[f"fixed{sweeps}_bit_equal"] = bool(
                    torch.equal(one[0], deep[0])
                    and one[2].tolist() == deep[2].tolist() == [sweeps] * B)
            six = _solve_stream(state.clone(), const, -1.0, 6, alpha, 1)[1]
            early = float(six.median())
            for name, th in (("stop", thresh), ("early_stop", early)):
                one, deep = both(th, 300)
                plain_n = brox_sor_error_plain(state.clone(), const, th, 300,
                                               alpha)[2].to(dev)
                same = one[2] == deep[2]
                row[name] = {
                    "thresh": th,
                    "n_range": [int(deep[2].min()), int(deep[2].max())],
                    "inside_launch": int((deep[2] % DEEP_K != 0).sum()),
                    "n_off_one_sweep": int((~same).sum()),
                    "max_off_plain": int((deep[2] - plain_n).abs().max()),
                    "max_off_one_sweep": int((deep[2] - one[2]).abs().max()),
                    "bit_equal_where_same": all(
                        bool(torch.equal(one[0][k], deep[0][k]))
                        for k in range(B) if same[k])}
            out.append(row)
            r = row["early_stop"]
            if not (row["fixed7_bit_equal"] and row["fixed17_bit_equal"]
                    and all(row[k]["max_off_plain"] <= 1
                            and row[k]["max_off_one_sweep"] <= 1
                            and row[k]["bit_equal_where_same"]
                            for k in ("stop", "early_stop"))
                    and r["inside_launch"] > 0):
                raise AssertionError(f"brox_sor at depth {DEEP_K} against "
                                     f"one sweep a launch: {row}")
            del state, const
    return out


def batch_stop_error(dev):
    """`check_brox_stream`'s stop="error" case at level 0 of B_TIME
    samples, at the depth `brox_sor_depth` picks (and the one-sweep
    schedule beside it: du and dv bit-equal where n is the same)."""
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.ops.brox import (_solve_stream, brox_sor_error,
                                        brox_sor_error_plain, device_depth,
                                        device_route)

    state, const, thresh, alpha = brox_system(dev, NY, NX, BROX_DMAX0, B_TIME)
    out = {"shape": list(state.shape), "route": device_route(B_TIME, NY, NX),
           "depth": device_depth()}
    got, _, n = brox_sor_error(state.clone(), const, thresh, 300, alpha)
    ref, _, n_ref = brox_sor_error_plain(state.clone(), const, thresh, 300,
                                         alpha)
    one, _, n_one = _solve_stream(state.clone(), const, thresh, 300, alpha, 1)
    torch.cuda.synchronize()
    same = n == n_one
    out.update(n_distinct=sorted(set(n.tolist())),
               n_plain_distinct=sorted(set(n_ref.tolist())),
               n_off_by_one=int((n != n_ref).sum()),
               n_odd=int((n % 2 == 1).sum()),
               n_off_one_sweep=int((~same).sum()),
               bit_equal_one_sweep_where_same=all(
                   bool(torch.equal(got[k], one[k]))
                   for k in range(B_TIME) if same[k]))
    out.update(stopped_equal_within_tol(got, n, ref, n_ref))
    if not (out["route"] == "stream" and len(out["n_distinct"]) > 1
            and out["n_odd"] > 0 and bool(((n - n_ref).abs() <= 1).all())
            and out["error_within_tol"]
            and out["bit_equal_one_sweep_where_same"]):
        raise AssertionError(f"brox_sor stream at B={B_TIME} (stop error) "
                             f"disagrees with the plain version: {out}")
    return out


def levels_brox_stream(dev):
    """K7's route "stream" at its main path's shapes, levels 0-3 of B_TIME
    1024x436 pairs (one system repeated), timed by `graph_ms` (the planes
    are 50 times the L2 at level 0, so it is not flushed): a 16-sweep
    chunk of the library's run entry with every sample active (thresh <
    0) at one sweep a launch and at DEEP_K, per sweep against the bound
    of its 13 planes moved once a launch; the settle with every sample
    to redo DEEP_K - 1 sweeps (its most); and, at level 0, a 16-sweep
    chunk with every sample stopped (what the host loop launches after
    the last sample stopped).  Fails, at level 0, below a bound or above
    K7_STREAM_X_BOUND times the one-sweep bound, and at any level where
    `brox_sor_depth` picks DEEP_K, where a sweep at DEEP_K is not faster
    than one at one sweep a launch."""
    from tpuflow_torch import _build
    from tpuflow_torch.ops.brox import (DEEP_K, DEEP_TILE, STREAM_TILE,
                                        _library, device_depth, tile_count)

    B = B_TIME
    lib = _library()
    out = {"unit": f"ms a sweep, B={B}, in a chunk of 16"}
    for scale, (nx, ny) in enumerate(brox_levels()[:4]):
        state, const, _, alpha = brox_system(dev, ny, nx, brox_dmax(scale))
        state = state.expand(B, -1, -1, -1).contiguous()
        const = const.expand(B, -1, -1, -1).contiguous()
        scratch = torch.empty_like(state)
        k = {"shape": [ny, nx], "depth": device_depth()}
        for depth in (1, DEEP_K):
            tile = STREAM_TILE if depth == 1 else DEEP_TILE
            partial = torch.empty(B * tile_count(ny, nx, tile) * depth,
                                  device=dev)
            err = torch.full((B,), float("inf"), device=dev)
            n = torch.zeros((B,), dtype=torch.int32, device=dev)
            redo = torch.zeros((B,), dtype=torch.int32, device=dev)

            def chunk(active):
                _build.launch(lib, "brox_sor_run", state, scratch, const,
                              partial, partial.numel(), err, n, active, redo,
                              B, ny, nx, -1.0, 2 ** 30, float(alpha), 16,
                              depth, device=state.device)

            on = torch.ones((B,), dtype=torch.int32, device=dev)
            ms = graph_ms(lambda: chunk(on), 2, False) / 16
            bound = bound_ms(B * ny * nx, K7_PLANES / depth, K7_FLOPS_PX)
            k[f"depth{depth}"] = {"ms": ms, "bound_ms": bound[0],
                                  "bound_by": bound[1],
                                  "x_bound": ms / bound[0]}
            if depth > 1:
                n_redo = torch.full((B,), depth - 1, dtype=torch.int32,
                                    device=dev)

                def settle():
                    _build.launch(lib, "brox_sor_finish", state, scratch,
                                  const, n_redo, n_redo, B, ny, nx,
                                  float(alpha), depth, device=state.device)

                k[f"depth{depth}"]["settle_redo_all_ms"] = graph_ms(settle, 5,
                                                                   False)
            if scale == 0:
                if not (bound[0] <= ms and ms <= K7_STREAM_X_BOUND * bound_ms(
                        B * ny * nx, K7_PLANES, K7_FLOPS_PX)[0]):
                    raise AssertionError(f"brox_sor stream sweep outside its "
                                         f"bounds: {k}")
                if depth == 1:
                    off = torch.zeros((B,), dtype=torch.int32, device=dev)
                    k["stopped_chunk_ms"] = graph_ms(lambda: chunk(off), 10,
                                                     False)
        k["speedup"] = k["depth1"]["ms"] / k[f"depth{DEEP_K}"]["ms"]
        if k["depth"] == DEEP_K and not k["speedup"] > 1:
            raise AssertionError(f"brox_sor stream at depth {DEEP_K} no "
                                 f"faster than one sweep a launch where "
                                 f"brox_sor_depth picks it: {k}")
        torch.cuda.synchronize()
        if not bool(torch.isfinite(state).all()):
            raise AssertionError(f"brox_sor stream at B={B}: state not finite")
        out[f"level{scale}"] = k
        del state, const, scratch
    return out


def _warp_hs_plain(planes, uv, aux, dmax, alpha2):
    from tpuflow_torch.ops.warp import warp_const_plain

    return warp_const_plain(planes, uv, aux, dmax, "hs", alpha2)


@contextlib.contextmanager
def plain_versions():
    """Run the engines through the kernels' plain versions (on whatever
    device the tensors lie on) inside the block."""
    import tpuflow_torch.models.batch as batch
    import tpuflow_torch.models.common as common
    # tpuflow_torch.models exports functions of these modules' names
    brox = importlib.import_module("tpuflow_torch.models.brox_spatial")
    classic = importlib.import_module("tpuflow_torch.models.hs_classic")
    temporal = importlib.import_module("tpuflow_torch.models.brox_temporal")
    rexpo = importlib.import_module("tpuflow_torch.models.robust_expo")
    import tpuflow_torch.ops.interp as interp
    from tpuflow_torch.ops.brox import brox_sor_error_plain
    from tpuflow_torch.ops.brox_terms import brox_terms_plain
    from tpuflow_torch.ops.gaussian import gaussian_plain
    from tpuflow_torch.ops.hs import hs_sor_error_plain
    from tpuflow_torch.ops.hs_classic import hs_classic_fused_plain
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error_plain
    from tpuflow_torch.ops.warp import warp_const_plain, warp_planes_uv_plain

    with swapped([(batch, "warp_const_batched", warp_const_plain),
                  (batch, "tvl1_iterate_error", tvl1_iterate_error_plain),
                  (batch, "warp_const_hs_batched", _warp_hs_plain),
                  (batch, "hs_sor_error", hs_sor_error_plain),
                  (classic, "hs_classic_fused", hs_classic_fused_plain),
                  (interp, "warp_planes_uv", warp_planes_uv_plain),
                  (brox, "brox_sor_error", brox_sor_error_plain),
                  (brox, "brox_terms", brox_terms_plain),
                  (common, "build_pyramid", common.build_pyramid_plain),
                  (temporal, "gaussian", gaussian_plain),
                  (rexpo, "gaussian", gaussian_plain)]):
        yield


def epe(u, v, ru, rv):
    """Mean endpoint error per sample."""
    return torch.hypot(u - ru, v - rv).mean(dim=(-2, -1)).tolist()


# the counters of tpuflow_torch.utils.trace that count each wrapper's
# calls that launched its kernel: K1's and K3's launches, K7's per route,
# K5's and K5p's per group of planes a thread warps
K7_ROUTES = ("resident", "stream")
_COUNTED = {"warp_const_batched": ("launches.k1",),
            "warp_const_hs_batched": ("launches.k3",),
            "brox_sor_error": tuple(f"calls.brox_sor_error.{r}"
                                    for r in K7_ROUTES)}
_since = {}   # the counters at the last `reset`


def trace_counters():
    from tpuflow_torch.utils.trace import counters

    return counters()


def reset():
    """Count launches, routes and groups from now on."""
    _since.clear()
    _since.update(trace_counters())


def since_reset(name):
    """Counter `name` of tpuflow_torch.utils.trace since the last `reset`."""
    return trace_counters().get(name, 0) - _since.get(name, 0)


def group_launches(wrapper):
    """{planes a thread: calls} of K5's or K5p's wrapper since `reset`."""
    from tpuflow_torch.ops.warp import GROUPS

    return {g: since_reset(f"calls.{wrapper.__name__}.g{g}") for g in GROUPS}


def launch_count(wrapper):
    """Calls of `wrapper` that launched its kernel since `reset`."""
    name = wrapper.__name__
    if name in ("warp_planes_batched", "warp_planes_shift_batched"):
        return sum(group_launches(wrapper).values())
    return sum(since_reset(k) for k in _COUNTED.get(name, (f"calls.{name}",)))


def route_launches():
    """{route: K7 calls} since `reset`."""
    return {r: since_reset(f"calls.brox_sor_error.{r}") for r in K7_ROUTES}


def counted(counters, fn):
    """Run fn() counting from just before it; returns (fn's result,
    seconds, {wrapper: launches in that run})."""
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, seconds, {c.__name__: launch_count(c) for c in counters}


def golden_epe(engine, dev, key, **kw):
    """EPE (a float) of `engine(**kw)` on the goldens' pair (64x96)
    against the reference binary's flow `key`_u, `key`_v."""
    g = np.load(GOLDENS)
    I0 = torch.as_tensor(g["I0"][None], dtype=torch.float32, device=dev)
    I1 = torch.as_tensor(g["I1"][None], dtype=torch.float32, device=dev)
    u, v = engine(I0, I1, **kw)[:2]
    ru, rv = (torch.as_tensor(g[f"{key}_{c}"], dtype=torch.float32, device=dev)
              for c in "uv")
    return epe(u[0], v[0], ru, rv)


def main_path(dev, counters, engine, kernels_used, synth_bound, **kw):
    """One main path on B_CHECK pairs at 1024x436 through the kernels,
    then through the plain versions; `kernels_used` must each launch."""
    from tpuflow_torch.data import NX, NY, synth_flow

    I0, I1 = pairs(B_CHECK, NY, NX, dev)
    (u, v, *stats), seconds, launches = counted(
        counters, lambda: engine(I0, I1, **kw))
    reads = [since_reset("host_reads"), since_reset("iters.k2")]
    k8 = since_reset("launches.k8")   # the pyramid: once a level
    with plain_versions():
        pu, pv, *_ = engine(I0, I1, **{k: a for k, a in kw.items()
                                       if k != "with_stats"})
    if tuple(u.shape) != (B_CHECK, NY, NX) or not bool(
            torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("main path: flow of the wrong shape or not finite")
    tu, tv = (torch.as_tensor(f, dtype=torch.float32, device=dev)
              for f in synth_flow(NY, NX))
    out = {"engine": engine.__name__, "shape": [B_CHECK, NY, NX],
           "seconds": seconds, "launches": launches, "k8_launches": k8,
           "epe_kernels_vs_plain": epe(u, v, pu, pv),
           "epe_vs_synthetic_flow": epe(u, v, -tu, -tv)}
    if stats:
        out["iterations"] = {str(s): w for s, w in
                             sorted(stats[0]["iterations"].items())}
        # [counted, implied by the stats]
        out["host_reads_k2_iters"] = [reads, list(solve_reads(
            engine, stats[0]["iterations"], NY, NX))]
        if reads != out["host_reads_k2_iters"][1]:
            raise AssertionError(f"main path: host reads or K2 iterations "
                                 f"not those the stats imply: {out}")
    if not all(e <= 0.01 for e in out["epe_kernels_vs_plain"]):
        raise AssertionError(f"main path: kernels vs plain EPE > 0.01: {out}")
    if not all(launches[k.__name__] > 0 for k in kernels_used):
        raise AssertionError(f"main path did not launch every kernel: {out}")
    if synth_bound is not None and not all(
            e <= synth_bound for e in out["epe_vs_synthetic_flow"]):
        raise AssertionError(f"main path: flow far from the truth: {out}")
    return out


def sweeps_launched(its, ny, nx, max_iter=300):
    """Sweeps K7 launches for one-sample solves of an (ny, nx) level that
    needed `its` sweeps: route "resident" runs no more than a solve
    needs; route "stream" rounds up to CHECK_EVERY, the host reading
    `active` every CHECK_EVERY sweeps."""
    from tpuflow_torch.ops.brox import device_route
    from tpuflow_torch.ops.sweeps import CHECK_EVERY

    if device_route(1, ny, nx) == "resident":
        return sum(its)
    return sum(min(-(-n // CHECK_EVERY) * CHECK_EVERY, max_iter) for n in its)


def solve_reads(engine, its, ny, nx):
    """(host reads, K2 iterations launched) of one `tvl1_batched` or
    `hs_pyramidal_batched` call at its defaults with stop="error" and
    stats `its`: a read a warp (the warp early exit), and where a solve
    reads its stop every CHECK_EVERY iterations (K2, K4's route "tiles")
    a read after each chunk but one that reaches the cap."""
    from tpuflow_torch.ops.hs import device_route
    from tpuflow_torch.ops.pyramid import pyramid_sizes
    from tpuflow_torch.ops.sweeps import CHECK_EVERY

    tvl1 = engine.__name__ == "tvl1_batched"
    cap = 300 if tvl1 else 150
    sizes = pyramid_sizes(nx, ny, 0.5, len(its))
    reads = k2 = 0
    for s, warps in its.items():
        lnx, lny = sizes[int(s)]
        chunked = tvl1 or device_route(lny, lnx) == "tiles"
        for n in warps:
            reads += 1
            if chunked:
                chunks = -(-max(n) // CHECK_EVERY)
                launched = min(chunks * CHECK_EVERY, cap)
                reads += chunks - (launched >= cap)
                k2 += launched if tvl1 else 0
    return reads, k2


def hs_sweeps(its, ny, nx, cap=150):
    """Per level of an HS engine call with stats `its`, [sweeps needed,
    sweeps launched]: a warp needs its slowest sample's count; route
    "tiles" launches that rounded up to CHECK_EVERY (within the cap),
    route "level" no more than it needs."""
    from tpuflow_torch.ops.hs import device_route
    from tpuflow_torch.ops.pyramid import pyramid_sizes
    from tpuflow_torch.ops.sweeps import CHECK_EVERY

    sizes = pyramid_sizes(nx, ny, 0.5, len(its))
    out = {}
    for s, warps in sorted(its.items()):
        lnx, lny = sizes[int(s)]
        need = [max(n) for n in warps]
        launched = ([min(-(-k // CHECK_EVERY) * CHECK_EVERY, cap) for k in need]
                    if device_route(lny, lnx) == "tiles" else need)
        out[str(s)] = [sum(need), sum(launched)]
    return out


def pair_warp_groups():
    """{K5's and K5p's wrapper: {planes a thread: launches}} of one
    Brox-family pair at 1024x436: 15 warps at each level, K5 at levels of
    at least 96x96 px, K5p below, each with the planes a thread warps
    there by its wrapper's rule."""
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS
    from tpuflow_torch.ops.warp import (GROUPS, device_group,
                                        warp_planes_batched,
                                        warp_planes_shift_batched)

    out = {k: dict.fromkeys(GROUPS, 0)
           for k in (warp_planes_batched, warp_planes_shift_batched)}
    for nx, ny in brox_levels():
        k = (warp_planes_batched if nx * ny >= K5_MIN_PIXELS
             else warp_planes_shift_batched)
        out[k][device_group(1, ny, nx, torch.cuda.current_device())] += 15
    return out


def pair_main_path(dev, counters, engine, synth_bound, expect,
                   warp_groups, **kw):
    """One single-pair main path at 1024x436 (synth_pair, seed SEED0)
    through the kernels, then through the plain versions; `expect` maps
    each wrapper of the path to the launches it must make, and
    `warp_groups` K5's and K5p's wrappers to their launches per group.
    Every K7 call must take route "resident", and K7 must launch exactly
    the sweeps the solves needed."""
    from tpuflow_torch.data import NX, NY, synth_flow
    from tpuflow_torch.ops.brox import brox_sor_error

    I0, I1 = (im[0] for im in pairs(1, NY, NX, dev))
    (u, v, diags), seconds, launches = counted(
        counters, lambda: engine(I0, I1, with_diag=True, **kw))
    with plain_versions():
        pu, pv = engine(I0, I1, **kw)
    if tuple(u.shape) != (NY, NX) or not bool(
            torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("main path: flow of the wrong shape or not finite")
    tu, tv = (torch.as_tensor(f, dtype=torch.float32, device=dev)
              for f in synth_flow(NY, NX))
    routes = route_launches()
    warp_launches = {k.__name__: group_launches(k) for k in warp_groups}
    its = {str(s): d["iterations"].ravel().tolist() for s, d in enumerate(diags)}
    out = {"engine": engine.__name__, "shape": [NY, NX], "seconds": seconds,
           "launches": launches, "brox_sor_route_launches": routes,
           "warp_group_launches": warp_launches,
           "epe_kernels_vs_plain": epe(u, v, pu, pv),
           "epe_vs_synthetic_flow": epe(u, v, -tu, -tv),
           "sweeps_per_solve": its,
           "sweeps_needed_launched": {
               s: [sum(n), sweeps_launched(n, ny, nx)]
               for (s, n), (nx, ny) in zip(its.items(), brox_levels())}}
    if not out["epe_kernels_vs_plain"] <= 0.01:
        raise AssertionError(f"main path: kernels vs plain EPE > 0.01: {out}")
    if routes != {"resident": launches["brox_sor_error"], "stream": 0} or any(
            need != launched for need, launched
            in out["sweeps_needed_launched"].values()):
        raise AssertionError(f"main path: K7 not resident throughout: {out}")
    if warp_launches != {k.__name__: g for k, g in warp_groups.items()}:
        raise AssertionError(f"main path: K5 / K5p groups {warp_launches}, "
                             f"expected {warp_groups}")
    wrong = {k.__name__: launches[k.__name__] for k in expect
             if launches[k.__name__] != expect[k]}
    if wrong:
        raise AssertionError(f"main path launches {wrong}, expected "
                             f"{ {k.__name__: n for k, n in expect.items()} }")
    if not out["epe_vs_synthetic_flow"] <= synth_bound:
        raise AssertionError(f"main path: flow far from the truth: {out}")
    return out


# the batched Brox-family paths against the single-pair ones on the same
# pairs: K7 takes route "stream" there and "resident" here, which sum each
# solve's error in other orders, so a solve may stop a sweep apart
# (about 1e-4 px a pixel at tol 1e-4), which the levels above magnify;
# the bound is the one the pair paths' kernels hold against their plain
# versions, and a batching fault (a sample's flow, stop, diffusivity or
# pyramid mixed with another's) lands far above it
BATCHED_BROX_EPE = 0.01
BATCHED_BROX_SAMPLES = (0, 1, 63, 127)


def batched_brox_path(dev, counters, I0, I1, engine, pair, terms, **kw):
    """`engine` (`brox_spatial_batched`, or `robust_expo_batched` with
    its system `terms` K10) on the B_TIME timing pairs at 1024x436 at the
    reference CLI defaults and `kw`, with its stats, each level's K7
    route, K5 / K5p and `terms` launches recorded as the level is
    solved: per level 15 K7 calls on the route `device_route` gives
    B_TIME systems of the level (expected: "stream" at levels 0-3,
    "resident" at level 4), 15 warp launches (K5 at levels of at least
    96x96 px, K5p below), and K7's `iters.k7` the sweeps the stats imply
    (route "stream" rounds each solve's slowest sample up to
    CHECK_EVERY), 15 `terms` calls a level (K9 or K10; 75 a call) and
    none of the other's; then a few samples against `pair` (the
    single-pair solver) on their pairs (BATCHED_BROX_EPE)."""
    from tpuflow_torch.ops.brox import device_route
    from tpuflow_torch.ops.brox_terms import brox_terms, expo_terms
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS
    from tpuflow_torch.ops.sweeps import CHECK_EVERY
    from tpuflow_torch.ops.warp import (device_group, warp_planes_batched,
                                        warp_planes_shift_batched)

    bs = importlib.import_module("tpuflow_torch.models.brox_spatial")
    scale_fn = bs.brox_scale
    B = I0.shape[0]
    per_level = []
    other = expo_terms if terms is brox_terms else brox_terms

    def recorded(l1, *args, **kw):
        before = trace_counters()
        out = scale_fn(l1, *args, **kw)
        after = trace_counters()
        ny, nx = l1.shape[-2:]
        per_level.append({
            "shape": [ny, nx],
            "route_expected": device_route(B, ny, nx, dev),
            "k7_calls": {r: after.get(f"calls.brox_sor_error.{r}", 0)
                         - before.get(f"calls.brox_sor_error.{r}", 0)
                         for r in K7_ROUTES},
            "iters_k7": after.get("iters.k7", 0) - before.get("iters.k7", 0),
            "terms_calls": {f.__name__: (after.get(f"calls.{f.__name__}", 0)
                                         - before.get(f"calls.{f.__name__}", 0))
                            for f in (terms, other)},
            "warps": {k: after.get(k, 0) - before.get(k, 0)
                      for k in after if k.startswith("calls.warp_planes")
                      and after.get(k, 0) != before.get(k, 0)}})
        return out

    torch.cuda.reset_peak_memory_stats()
    with swapped([(bs, "brox_scale", recorded)]):
        (u, v, stats), seconds, launches = counted(
            counters, lambda: engine(I0, I1, with_stats=True, **kw))
    peak = torch.cuda.max_memory_allocated()
    levels = dict(zip(sorted(stats["iterations"], reverse=True), per_level))
    wrong = []
    for s, lv in levels.items():
        ny, nx = lv["shape"]
        solves = stats["iterations"][s]
        lv["sweeps_needed"] = sum(sum(n) for n in solves)
        lv["sweeps_slowest"] = [max(n) for n in solves]
        lv["sweeps_launched"] = sum(min(-(-max(n) // CHECK_EVERY)
                                        * CHECK_EVERY, 300) for n in solves)
        kernel = (warp_planes_batched if nx * ny >= K5_MIN_PIXELS
                  else warp_planes_shift_batched)
        group = device_group(B, ny, nx, torch.cuda.current_device())
        want = {"k7_calls": {r: 15 * (r == lv["route_expected"])
                             for r in K7_ROUTES},
                "iters_k7": (lv["sweeps_launched"]
                             if lv["route_expected"] == "stream" else 0),
                "terms_calls": {terms.__name__: 15, other.__name__: 0},
                "warps": {f"calls.{kernel.__name__}.g{group}": 15}}
        if any(lv[k] != w for k, w in want.items()):
            wrong.append((s, want))
    pairs_epe = {}
    for k in BATCHED_BROX_SAMPLES:
        pu, pv = pair(I0[k], I1[k], **kw)
        pairs_epe[k] = epe(u[k], v[k], pu, pv)
    name = engine.__name__
    out = {"shape": list(I0.shape), "seconds": seconds,
           "fields_per_s": B / seconds, "max_memory_allocated_bytes": peak,
           "launches": launches, "levels": {str(s): lv
                                             for s, lv in levels.items()},
           "epe_vs_pair": pairs_epe}
    if wrong or launches[terms.__name__] != 15 * len(levels):
        raise AssertionError(f"{name}: routes, K7 sweeps, system calls or "
                             f"warps {wrong}: {out}")
    if not all(e <= BATCHED_BROX_EPE for e in pairs_epe.values()):
        raise AssertionError(f"{name}: samples far from their pair calls: "
                             f"{out}")
    if not bool(torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError(f"{name}: flow not finite")
    return out


def sequence_goldens(dev):
    """Brox temporal (nscales 2) and TV-L1 with occlusions (nscales 3) on
    the card through the kernels, as the goldens were made, against the
    reference binary's flows: the largest EPE over Brox temporal's
    fields, TV-L1-occlusion's EPE and its occluded share's distance from
    the reference's."""
    from tpuflow_torch import brox_temporal, tvl1occflow

    def on(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    g = np.load(GOLDEN_DIR / "brox_temporal.npz")
    u, v = brox_temporal(g["vol"], nscales=2, clamp_scales=False, device=dev)
    out = {"brox_temporal_s2": max(epe(u, v, on(g["s2_u"]), on(g["s2_v"])))}
    g = np.load(GOLDEN_DIR / "tvl1occ.npz")
    u1, u2, chi = tvl1occflow(*(g[k] for k in ("Im1", "I0", "I1")), nscales=3,
                              clamp_scales=False, device=dev)
    out["tvl1occ_m3"] = epe(u1, u2, on(g["m3_u"]), on(g["m3_v"]))
    out["tvl1occ_m3_chi_mean_diff"] = abs(float(chi.mean()) - float(g["m3_chi"].mean()))
    return out


def pair_golden_epe(engine, dev, name, key):
    """EPE of `engine` (nscales 3, as the goldens were made) on the
    golden pair against the reference binary's flow `key`_u, `key`_v of
    tests/goldens/`name`.npz."""
    g = np.load(GOLDEN_DIR / f"{name}.npz")
    I0, I1 = (torch.as_tensor(g[k], dtype=torch.float32, device=dev)
              for k in ("I0", "I1"))
    u, v = engine(I0, I1, nscales=3, clamp_scales=False)
    ru, rv = (torch.as_tensor(g[f"{key}_{c}"], dtype=torch.float32, device=dev)
              for c in "uv")
    return epe(u, v, ru, rv)


@contextlib.contextmanager
def marking_levels(mark):
    """Call mark(k, None) after the k-th `brox_scale` call (coarsest
    first) inside the block: `brox_spatial` has no level callback."""
    bs = importlib.import_module("tpuflow_torch.models.brox_spatial")

    scale_fn = bs.brox_scale
    calls = []

    def wrapped(*args, **kw):
        out = scale_fn(*args, **kw)
        mark(len(calls), None)
        calls.append(None)
        return out

    with swapped([(bs, "brox_scale", wrapped)]):
        yield


def pair_timing(engine, I0, I1, counters, groups, levels_via_callback):
    """Seconds per pair of a single-pair solver at 1024x436 over 3 reps
    after one warm call, peak memory, launches per pair (K7's per route
    too: route "resident" on every call) and the breakdown of one call,
    with K7's device kernels by name as the profiler recorded them."""
    from tpuflow_torch.ops.brox import brox_sor_error

    out = {"engine": engine.__name__, "shape": list(I0.shape)}
    engine(I0, I1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine(I0, I1)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per_pair = {c.__name__: launch_count(c) / len(reps) for c in counters}
    routes = {r: k / len(reps) for r, k in route_launches().items()}
    if routes != {"resident": per_pair["brox_sor_error"], "stream": 0}:
        raise AssertionError(f"{engine.__name__}: K7 routes per pair {routes}")
    if levels_via_callback:
        where = breakdown(lambda cb: engine(I0, I1, level_callback=cb), groups,
                          name_parts=K7_KERNELS)
    else:
        def run(cb):
            if cb is None:
                return engine(I0, I1)
            with marking_levels(cb):
                return engine(I0, I1)
        where = breakdown(run, groups, name_parts=K7_KERNELS)
        # marks count calls coarsest first: name them by pyramid level
        n = len(where["seconds_to_level_end"])
        where["seconds_to_level_end"] = {
            str(n - 1 - int(k)): t
            for k, t in where["seconds_to_level_end"].items()}
    out.update(seconds_per_pair=sum(reps) / len(reps), rep_s=reps,
               launches_per_pair=per_pair, brox_sor_routes_per_pair=routes,
               max_memory_allocated_bytes=peak, breakdown=where)
    return out


@contextlib.contextmanager
def recording_warps(calls):
    """Append (kernel, border_out, B, P, ny, nx, dmax) to `calls` for each
    warp the solvers ask for inside the block (`interp.warp_planes_uv`,
    through which `warp_planes_bounded` makes each K5 and K5p launch),
    passing the call through."""
    import tpuflow_torch.ops.interp as interp

    inner = interp.warp_planes_uv

    def record(planes, u, v, dmax, shift=False, border_out=True):
        B, P = (1, planes.shape[0]) if planes.ndim == 3 else planes.shape[:2]
        calls.append(("K5p" if shift else "K5", bool(border_out), int(B),
                      int(P), *planes.shape[-2:], int(dmax)))
        return inner(planes, u, v, dmax, shift, border_out)

    with swapped([(interp, "warp_planes_uv", record)]):
        yield


def level_warps(calls, marks, levels, expect):
    """Per level, the warps recorded by `recording_warps` between the
    level callback's marks [(scale, calls so far)] against
    `expect(scale, nx, ny)`'s list; the K5 and K5p launches per plane
    group the expected calls make; and the levels that differ (or
    "levels" where the callback did not mark each level once, coarsest
    first)."""
    from tpuflow_torch.ops.warp import GROUPS, device_group

    names = {"K5": "warp_planes_batched", "K5p": "warp_planes_shift_batched"}
    groups = {n: dict.fromkeys(GROUPS, 0) for n in names.values()}
    per_level, wrong, start = {}, [], 0
    for scale, end in marks:
        nx, ny = levels[scale]
        want, got = expect(scale, nx, ny), calls[start:end]
        start = end
        for kernel, _, B, _, lny, lnx, _ in want:
            groups[names[kernel]][device_group(B, lny, lnx,
                                               torch.cuda.current_device())] += 1
        per_level[str(scale)] = {"size": [ny, nx], "warps": len(got),
                                 "warp": list(got[0]) if got else None,
                                 "as_expected": got == want}
        if got != want:
            wrong.append(scale)
    if start != len(calls) or [s for s, _ in marks] != list(
            range(len(levels) - 1, -1, -1)):
        wrong.append("levels")
    return per_level, groups, wrong


def check_sequence_launches(out, launches, groups, want_groups, wrong):
    """Fail unless every level warped as expected, K5's and K5p's
    launches in all and per group are those of the expected warps, and
    no other kernel launched."""
    want = {k: sum(g.values()) for k, g in want_groups.items()}
    others = {k: n for k, n in launches.items() if n and k not in want}
    if wrong or groups != want_groups or others or any(
            launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{out['engine']}: warps not as the level sizes "
                             f"give (levels {wrong}; expected {want_groups}): {out}")


def temporal_main_path(dev, counters):
    """Brox temporal at the reference CLI defaults on TEMPORAL_FRAMES
    frames of 1024x436 (`synth_sequence`, seed SEED0: synth_pair's I0
    drifted by synth_flow frame after frame) through the kernels, then
    through the plain versions (EPE <= 0.01 per field).  Per level the
    recorded warps must be 15 (one per outer iteration) of K5 at B = 8 on
    levels of at least 96x96 px and of K5p below, with border_out, P = 6
    and the level's dmax, and the wrappers' launches in all and per
    group those the level sizes give; per level also the SOR sweeps and
    the host reads of its stop."""
    from tpuflow_torch import brox_temporal
    from tpuflow_torch.data import NX, NY, synth_flow, synth_sequence
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS
    from tpuflow_torch.ops.warp import (warp_planes_batched,
                                        warp_planes_shift_batched)

    vol = torch.from_numpy(synth_sequence(TEMPORAL_FRAMES, NY, NX,
                                          seed=SEED0)).to(dev)
    B = TEMPORAL_FRAMES - 1
    calls, marks = [], []

    def run():
        return brox_temporal(vol, with_diag=True, level_callback=lambda s, _:
                             marks.append((s, len(calls))))

    with recording_warps(calls):
        (u, v, diags), seconds, launches = counted(counters, run)
    groups = {k.__name__: group_launches(k)
              for k in (warp_planes_batched, warp_planes_shift_batched)}
    with plain_versions():
        pu, pv = brox_temporal(vol)
    if tuple(u.shape) != (B, NY, NX) or not bool(
            torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("brox_temporal: flow of the wrong shape or not finite")

    def expect(s, nx, ny):
        kernel = "K5" if nx * ny >= K5_MIN_PIXELS else "K5p"
        return [(kernel, True, B, 6, ny, nx,
                 brox_dmax(s, TEMPORAL_ZFACTOR))] * 15

    per_level, want_groups, wrong = level_warps(
        calls, marks, brox_levels(TEMPORAL_ZFACTOR, 100), expect)
    for s, d in enumerate(diags):
        per_level.setdefault(str(s), {}).update(sweeps=int(d["iterations"].sum()),
                                 host_reads=d["host_reads"])
    tu, tv = (torch.as_tensor(f, dtype=torch.float32, device=dev)
              for f in synth_flow(NY, NX))
    out = {"engine": "brox_temporal", "shape": [TEMPORAL_FRAMES, NY, NX],
           "seconds": seconds, "seconds_per_frame_pair": seconds / B,
           "launches": launches, "warp_group_launches": groups,
           "sweeps": sum(int(d["iterations"].sum()) for d in diags),
           "host_reads": sum(d["host_reads"] for d in diags),
           "epe_kernels_vs_plain": epe(u, v, pu, pv),
           "epe_vs_drift": epe(u, v, -tu, -tv), "per_level": per_level}
    if not max(out["epe_kernels_vs_plain"]) <= 0.01:
        raise AssertionError(f"brox_temporal: kernels vs plain EPE > 0.01: {out}")
    check_sequence_launches(out, launches, groups, want_groups, wrong)
    return out


def occ_triplet(dev):
    """(I-1, I0, I1) at 1024x436: synth_pair's seed-SEED0 pair with I-1 =
    I0 rolled by one column (tools/bench_all7.py:130)."""
    from tpuflow_torch.data import NX, NY, synth_pair

    I0, I1 = synth_pair(NY, NX, seed=SEED0)
    return [torch.from_numpy(a).to(dev)
            for a in (np.ascontiguousarray(np.roll(I0, 1, axis=1)), I0, I1)]


def occ_main_path(dev, counters):
    """TV-L1 with occlusions at the reference CLI defaults on
    `occ_triplet` through the kernels, then through the plain versions
    (flow EPE <= 0.01; the occlusion maps' agreement reported).  Per
    level the recorded warps must be two 3-plane stacks per warp, K5p
    without border_out at the level's dmax, and K5p's launches in all
    and per group those the level sizes give; per level also each warp's
    iterations, its last error and the host reads of its stop."""
    from tpuflow_torch import tvl1occflow
    from tpuflow_torch.data import NX, NY, synth_flow
    from tpuflow_torch.models.tvl1occflow import DEFAULT_WARPS
    from tpuflow_torch.ops.warp import (warp_planes_batched,
                                        warp_planes_shift_batched)

    triplet = occ_triplet(dev)
    calls, marks = [], []

    def run():
        return tvl1occflow(*triplet, with_diag=True, level_callback=lambda s, _:
                           marks.append((s, len(calls))))

    with recording_warps(calls):
        (u1, u2, chi, diags), seconds, launches = counted(counters, run)
    groups = {k.__name__: group_launches(k)
              for k in (warp_planes_batched, warp_planes_shift_batched)}
    with plain_versions():
        pu1, pu2, pchi = tvl1occflow(*triplet)
    if tuple(u1.shape) != (NY, NX) or not bool(
            torch.isfinite(u1).all() and torch.isfinite(u2).all()):
        raise AssertionError("tvl1occflow: flow of the wrong shape or not finite")

    def expect(s, nx, ny):
        # I1's stack by +u and I-1's by -u, once per warp
        return [("K5p", False, 1, 3, ny, nx,
                 brox_dmax(s, OCC_ZFACTOR))] * (2 * DEFAULT_WARPS)

    per_level, want_groups, wrong = level_warps(
        calls, marks, brox_levels(OCC_ZFACTOR, 100), expect)
    for s, d in enumerate(diags):
        per_level.setdefault(str(s), {}).update(iterations=d["iterations"].tolist(),
                                 error=d["error"].tolist(),
                                 host_reads=d["host_reads"])
    tu, tv = (torch.as_tensor(f, dtype=torch.float32, device=dev)
              for f in synth_flow(NY, NX))
    out = {"engine": "tvl1occflow", "shape": [3, NY, NX], "seconds": seconds,
           "launches": launches, "warp_group_launches": groups,
           "host_reads": sum(d["host_reads"] for d in diags),
           "epe_kernels_vs_plain": epe(u1, u2, pu1, pu2),
           "chi_agreement_kernels_vs_plain": float((chi == pchi).double().mean()),
           "occluded_share": float(chi.mean()),
           "epe_vs_synthetic_flow": epe(u1, u2, -tu, -tv),
           "per_level": per_level}
    if not out["epe_kernels_vs_plain"] <= 0.01:
        raise AssertionError(f"tvl1occflow: kernels vs plain EPE > 0.01: {out}")
    check_sequence_launches(out, launches, groups, want_groups, wrong)
    return out


def solver_timing(name, run, counters, groups, reps=2):
    """Seconds per call of `run(level_callback)` over `reps` calls (its
    main path's calls warmed it), peak device memory, launches per call
    and the breakdown of one call (seconds to each level's end, device
    time by kernel group, the busy and idle share)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"engine": name, "seconds_per_call": sum(times) / reps,
            "rep_s": times,
            "launches_per_call": {c.__name__: launch_count(c) / reps
                                  for c in counters},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "breakdown": breakdown(run, groups)}


def device_ms(fn, n, per_call=None, flush_l2=True):
    """Device time of one call of `fn` under torch.profiler, over n calls
    after one warm call; and what the profiler recorded.  At B = 1 a
    wrapper's host work outlasts its kernel, so CUDA events around a run
    of calls would time the host's enqueueing instead.

    With `per_call`, {part of a kernel name: launches per call}, and
    `flush_l2`, each call is preceded by a read of a 128 MB buffer, so
    that `fn` reads its inputs from device memory and not from the 50 MB
    L2, as the bytes bound assumes (a read leaves no dirty lines to write
    back during the kernel).  The time is the sum over the parts of the median duration
    of the recorded kernels of that part times its launches per call:
    the profiler records only part of a window's kernels on an H100's
    sandboxed host, so a total over calls would read fast, and a median
    is not moved by a few mistimed records.  The record gives, per part,
    [kernels recorded, expected, min, median, max us].  Without
    `per_call` (the plain versions, many kernels per call) the time is
    the total device time over n, L2 warm, and the record is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = (torch.ones(32 << 20, dtype=torch.float32, device="cuda")
             if per_call and flush_l2 else None)
    fn()
    torch.cuda.synchronize()
    # the profiler on that host has at times recorded none of a part's
    # kernels in a window; such a window is profiled again, up to 3 times
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush.sum()
                fn()
            torch.cuda.synchronize()
        if not per_call:
            return sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3 / n, None
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = {part: np.array([e.time_range.elapsed_us() for e in kernels
                              if part in e.name], dtype=np.float64)
              for part in per_call}
        if all(u.size for u in us.values()):
            break
    ms, record = 0.0, {}
    for part, count in per_call.items():
        if us[part].size == 0:
            raise AssertionError(f"profiler recorded no kernel named *{part}* "
                                 f"in {attempt + 1} windows")
        ms += float(np.median(us[part])) * count / 1e3
        record[part] = [int(us[part].size), n * count, float(us[part].min()),
                        float(np.median(us[part])), float(us[part].max())]
    return ms, record


def warp_shapes():
    """The shapes where the main paths launch K5 and K5p: (wrapper name,
    B, P, ny, nx, dmax, border_out, L2 states to time).  K5 at Brox
    levels 0-2 (level 0's 25 MB is timed from device memory and warm in
    the 50 MB L2; levels 1-2 warm, as the solver finds them), K5p at
    levels 3-4 (warm); K5p at level 0 with P = 3 and no border_out
    (tvl1occflow's level 0) and with P = 6 past the bound, and K5 at
    level 0 with robust-expo RGB's P = 18, all three from device memory;
    Brox temporal's levels at B = 8 (K5 at 7, K5p at 5; level 0, 86 MB,
    from device memory and warm, the others warm); tvl1occflow's levels
    1-4 (K5p, P = 3, no border_out, warm)."""
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS

    def name(nx, ny):
        if nx * ny >= K5_MIN_PIXELS:
            return "warp_planes_batched"
        return "warp_planes_shift_batched"

    out = []
    for s, (nx, ny) in enumerate(brox_levels()):
        l2 = (True, False) if s == 0 else (False,)
        out.append((name(nx, ny), 1, 6, ny, nx, brox_dmax(s), True, l2))
    nx, ny = brox_levels()[0]
    out.append(("warp_planes_shift_batched", 1, 3, ny, nx, BROX_DMAX0, False,
                (True,)))
    out.append(("warp_planes_shift_batched", 1, 6, ny, nx, BROX_DMAX0, True,
                (True,)))
    out.append(("warp_planes_batched", 1, 18, ny, nx, BROX_DMAX0, True,
                (True,)))
    for s, (nx, ny) in enumerate(brox_levels(TEMPORAL_ZFACTOR, 100)):
        l2 = (True, False) if s == 0 else (False,)
        out.append((name(nx, ny), TEMPORAL_FRAMES - 1, 6, ny, nx,
                    brox_dmax(s, TEMPORAL_ZFACTOR), True, l2))
    for s, (nx, ny) in list(enumerate(brox_levels(OCC_ZFACTOR, 100)))[1:]:
        out.append(("warp_planes_shift_batched", 1, 3, ny, nx,
                    brox_dmax(s, OCC_ZFACTOR), False, (False,)))
    return out


def warp_inputs(dev, shift, B, P, ny, nx, dmax):
    """(planes, uv) of a `warp_timing` shape: P planes cycled from the six
    Brox planes, warped by the synthetic flow (K5) or `past_bound_flow`
    (K5p), the same in each of the B samples."""
    from tpuflow_torch.data import synth_flow

    p = torch.cat([brox_inputs(dev, ny, nx)[2]] * 3, dim=1)[:, :P]
    if shift:
        f = past_bound_flow(ny, nx, dmax, dev)
    else:
        f = torch.stack([-torch.as_tensor(a, dtype=torch.float32, device=dev)
                         for a in synth_flow(ny, nx)])[None]
    return p.repeat(B, 1, 1, 1).contiguous(), f.repeat(B, 1, 1, 1)


def warp_timing(dev):
    """K5 and K5p at every `warp_shapes` shape: device ms per launch from
    `graph_ms` with the planes a thread warps by the wrapper's rule and
    with the other plane count, the profiler's median (`device_ms`) beside it as a cross-check,
    the plain version's device ms, and the bound.  K5 warps the six Brox
    planes by the synthetic flow, K5p by `past_bound_flow`.  Per wrapper
    the level-0 reading from device memory leads (K5 P = 6, K5p P = 6
    past the bound), as earlier PRs read them."""
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.ops.warp import (warp_planes_batched,
                                        warp_planes_on_group,
                                        warp_planes_plain,
                                        warp_planes_shift_batched,
                                        warp_planes_shift_plain)

    wrappers = {"warp_planes_batched": (warp_planes_batched, False,
                                        K5_FLOPS_PX_BASE),
                "warp_planes_shift_batched": (warp_planes_shift_batched,
                                              True, K5P_FLOPS_PX_BASE)}
    out = {name: {"shapes": []} for name in wrappers}
    for name, B, P, ny, nx, dmax, bo, l2s in warp_shapes():
        wrapper, shift, flops = wrappers[name]
        p, f = warp_inputs(dev, shift, B, P, ny, nx, dmax)
        if shift:
            def kernel(group=None):
                if group is None:
                    return wrapper(p, f, dmax, bo)
                return warp_planes_on_group(p, f, dmax, group, True, bo)

            def plain():
                return warp_planes_shift_plain(p, f, dmax, bo)
        else:
            def kernel(group=None):
                if group is None:
                    return wrapper(p, f, dmax)
                return warp_planes_on_group(p, f, dmax, group)

            def plain():
                return warp_planes_plain(p, f, dmax)
        group, other = planes_groups(B, ny, nx)
        k = {"shape": list(p.shape), "dmax": dmax, "border_out": bo,
             "group": group}
        k["bound_ms"], k["bound_by"] = bound_ms(
            B * ny * nx, 2 * P + 2, flops + K5_FLOPS_PX_PLANE * P)
        k["plain_ms"] = device_ms(plain, 5)[0]
        for flush in l2s:
            state = "l2_flushed" if flush else "l2_warm"
            n = 20 if flush else 50
            r = {"ms": graph_ms(kernel, n, flush)}
            r["profiler_ms"], r["profiler_us"] = device_ms(
                kernel, 50, {"warp_planes_kernel": 1}, flush_l2=flush)
            r["other_group_ms"] = graph_ms(lambda: kernel(other), n, flush)
            k[state] = r
        out[name]["shapes"].append(k)
        if ny * nx == NY * NX and B == 1 and P == 6 and bo and "ms" not in out[name]:
            out[name].update(ms=k["l2_flushed"]["ms"], plain_ms=k["plain_ms"],
                             bound_ms=k["bound_ms"], bound_by=k["bound_by"])
    return out


def graph_ms(fn, n, flush_l2, replays=5):
    """Device ms per call of `fn`, from CUDA events around a CUDA graph:
    after one warm call, n calls are captured into one graph, each
    preceded with `flush_l2` by a read of a 128 MB buffer (so that `fn`
    reads its inputs from device memory, as `device_ms` flushes); the
    graph is replayed `replays` times, each between two CUDA events, and
    the median taken; with `flush_l2` the median of a graph of the n
    reads alone is subtracted; the result is over n.  A replay launches
    the calls' kernels without the host, so at B = 1 this times the
    device and not the wrapper's host work (which CUDA events around
    plain calls would time), and it needs no profiler."""
    flush = (torch.ones(32 << 20, dtype=torch.float32, device="cuda")
             if flush_l2 else None)
    fn()
    torch.cuda.synchronize()

    def replayed(with_fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                if flush is not None:
                    flush.sum()
                if with_fn:
                    fn()
        graph.replay()
        torch.cuda.synchronize()
        ms = []
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return float(np.median(ms))

    total = replayed(True)
    return (total - (replayed(False) if flush is not None else 0.0)) / n


def graph_ms_if_captured(fn, n, flush_l2):
    """(`graph_ms`, None), or (None, the error) where `fn`'s launches
    cannot be captured in a CUDA graph."""
    try:
        return graph_ms(fn, n, flush_l2), None
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, str(e).strip().splitlines()[0][:300]


def level0_brox(dev):
    """K7 alone at level 0 of the 1024x436 pair: one resident solve of 16
    fixed sweeps (one launch), also of 300, timed by `graph_ms` where a
    cooperative launch can be captured in a graph, with torch.profiler's
    median from device memory (`device_ms`, L2 flushed) beside it, the
    plain version's device ms, the bound, and both calls' ms between
    CUDA events (host-bound here); beside it route "stream" on the same
    system: a one-sweep call (both colors, finalize, settle) and its
    device ms per sweep in a 16-sweep call."""
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.ops.brox import (_solve_stream, brox_sor_error,
                                        brox_sor_error_plain, device_route)

    out = {}
    state, const, _, alpha = brox_system(dev, NY, NX, BROX_DMAX0)

    def k7(sweeps):
        return brox_sor_error(state, const, -1.0, sweeps, alpha)

    def k7_stream(sweeps):
        return _solve_stream(state, const, -1.0, sweeps, alpha, 1)

    def k7_plain():
        return brox_sor_error_plain(state, const, -1.0, 16, alpha)

    # one resident solve of N fixed sweeps: one launch, its bound the
    # solve's (13 planes once, N sweeps' operations)
    k = {"route": device_route(1, NY, NX),
         "unit": "one resident solve of 16 fixed sweeps"}
    k["profiler_ms"], k["profiler_us"] = device_ms(lambda: k7(16), 20,
                                                   {"brox_sor_resident": 1})
    k["graph_ms"], k["graph_refused"] = graph_ms_if_captured(
        lambda: k7(16), 10, True)
    k["ms"] = k["profiler_ms"] if k["graph_ms"] is None else k["graph_ms"]
    k["event_ms"] = time_ms(lambda: k7(16), 20)
    k["ms_per_sweep_in_16"] = k["ms"] / 16
    k["bound_ms"], k["bound_by"] = bound_ms(NY * NX, K7_PLANES, 16 * K7_FLOPS_PX)
    k["plain_ms"] = device_ms(k7_plain, 3)[0]
    k["plain_call_ms"] = time_ms(k7_plain, 3)
    s300 = {}
    s300["profiler_ms"], s300["profiler_us"] = device_ms(
        lambda: k7(300), 5, {"brox_sor_resident": 1})
    s300["graph_ms"], s300["graph_refused"] = graph_ms_if_captured(
        lambda: k7(300), 3, True)
    s300["ms"] = (s300["profiler_ms"] if s300["graph_ms"] is None
                  else s300["graph_ms"])
    s300["event_ms"] = time_ms(lambda: k7(300), 5)
    s300["ms_per_sweep"] = s300["ms"] / 300
    s300["bound_ms"], s300["bound_by"] = bound_ms(NY * NX, K7_PLANES,
                                                  300 * K7_FLOPS_PX)
    k["solve_300"] = s300
    # route "stream" on the same system (the wrapper takes "resident"
    # here): a one-sweep call (both colors, finalize, the settle) and per
    # sweep in 16 (the settle's share included)
    st = {}
    st["one_sweep_ms"], st["profiler_us"] = device_ms(
        lambda: k7_stream(1), 50, {"brox_sor_colors": 1, "stop_finalize": 1,
                                   "brox_sor_color_settle": 1})
    st["ms_per_sweep_in_16"] = device_ms(
        lambda: k7_stream(16), 10, {"brox_sor_colors": 16, "stop_finalize": 16,
                                    "brox_sor_color_settle": 1})[0] / 16
    st["one_sweep_bound_ms"] = bound_ms(NY * NX, K7_PLANES, K7_FLOPS_PX)[0]
    k["stream"] = st
    out["brox_sor_error"] = k
    return out


def cli_files(tmp):
    """The seed-SEED0 synth_pair at 1024x436 written as PFM (I0.pfm,
    I1.pfm), as 8-bit gray PNG (I0g.png, I1g.png) and as an RGB PNG whose
    channels are I, 0.75 I + 32 and 255 - I (I0.png, I1.png); the PNGs'
    rows filtered as libpng filters them.  Returns ({name: path},
    {PNG name: rows per filter type None, Sub, Up, Average, Paeth})."""
    from tpuflow_torch.data import NX, NY, synth_pair
    from tpuflow_torch.io import write_image, write_pfm
    from tpuflow_torch.io.image import _chunks

    paths, filters = {}, {}
    for name, im in zip(("I0", "I1"), synth_pair(NY, NX, seed=SEED0)):
        paths[f"{name}.pfm"] = str(tmp / f"{name}.pfm")
        write_pfm(paths[f"{name}.pfm"], im)
        for png, arr in ((f"{name}g.png", im),
                         (f"{name}.png", np.stack([im, 0.75 * im + 32, 255 - im],
                                                  axis=-1))):
            paths[png] = str(tmp / png)
            arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
            write_image(paths[png], arr)
            data = Path(paths[png]).read_bytes()
            rows = zlib.decompress(b"".join(d for t, d in _chunks(data, png)
                                            if t == b"IDAT"))
            ftype = np.frombuffer(rows, np.uint8)[::arr[0].size + 1]
            filters[png] = np.bincount(ftype, minlength=5).tolist()
    return paths, filters


def quiet(fn):
    """fn() with its stdout and stderr captured; (result, lines written)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn()
    return result, len(out.getvalue().splitlines()) + len(err.getvalue().splitlines())


def cli_calls(counters, cli, argv, reps):
    """`cli.main(argv)`, quiet, with every launch count set to 0 just
    before it, then `reps` more calls: its exit code, lines printed,
    seconds, launches (K5's and K5p's per group too), and the seconds
    per call of the reps, image IO included."""
    from tpuflow_torch.ops.warp import (warp_planes_batched,
                                        warp_planes_shift_batched)

    (rc, lines), seconds, launches = counted(
        counters, lambda: quiet(lambda: cli.main(argv)))
    groups = {k.__name__: group_launches(k)
              for k in (warp_planes_batched, warp_planes_shift_batched)}
    reps_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        quiet(lambda: cli.main(argv))
        torch.cuda.synchronize()
        reps_s.append(time.perf_counter() - t0)
    return {"rc": rc, "lines_printed": lines, "first_call_s": seconds,
            "seconds_per_call": sum(reps_s) / len(reps_s), "rep_s": reps_s,
            "launches": launches, "warp_group_launches": groups}


def sequence_clis(dev, counters, tmp, mains):
    """The two multi-frame CLIs at their defaults through the kernels:
    brox_temporal on `synth_sequence`'s TEMPORAL_FRAMES frames written as
    PFM (each dir/flowNN.flo against the direct call on the frames the
    CLI read, EPE <= 1e-5), and tvl1occflow on `occ_triplet` written as
    PFM (the .flo against the direct call, EPE <= 1e-5, and the
    occlusion PNG equal to its chi * 255).  Each CLI's launches, in all
    and per group, must equal its main path's in `mains`; seconds per
    call over SEQUENCE_CLI_REPS after the counted one, image IO
    included, and the IO's seconds alone (the inputs read as the CLI
    reads them, its outputs written)."""
    import tpuflow_torch.cli.brox_temporal as temporal_cli
    import tpuflow_torch.cli.tvl1occflow as occ_cli
    from tpuflow_torch import brox_temporal, tvl1occflow
    from tpuflow_torch.data import NX, NY, synth_sequence
    from tpuflow_torch.io import (read_flo, read_image, write_flo,
                                  write_image, write_pfm)

    def gray(path):
        return read_image(path, gray=True).astype(np.float32)

    frames = [str(tmp / f"F{k}.pfm") for k in range(TEMPORAL_FRAMES)]
    for path, im in zip(frames, synth_sequence(TEMPORAL_FRAMES, NY, NX,
                                               seed=SEED0)):
        write_pfm(path, im)
    outdir = tmp / "temporal"
    outdir.mkdir()
    names = [f"flow{k:02d}.flo" for k in range(TEMPORAL_FRAMES - 1)]
    argv = [str(TEMPORAL_FRAMES), *frames, "18", "7", "100", "0.75", "0.0001",
            "1", "15", str(outdir), "0"]
    res = cli_calls(counters, temporal_cli, argv, SEQUENCE_CLI_REPS)
    flows = [read_flo(str(outdir / n)) for n in names]
    t0 = time.perf_counter()
    vol = np.stack([gray(p) for p in frames])
    for u, v in flows:
        write_flo(str(tmp / "io.flo"), u, v)
    res["io_seconds_per_call"] = time.perf_counter() - t0
    du, dv = (t.cpu().numpy() for t in brox_temporal(vol))
    res.update(files=sorted(p.name for p in outdir.iterdir()) == names,
               epe_vs_direct_call=max(float(np.hypot(u - du[k], v - dv[k]).mean())
                                      for k, (u, v) in enumerate(flows)),
               finite=all(bool(np.isfinite(f).all()) for f in flows))
    out = {"brox_temporal": res}

    paths = [str(tmp / n) for n in ("Im1.pfm", "I0.pfm", "I1.pfm")]
    for path, im in zip(paths, occ_triplet(dev)):
        write_pfm(path, im.cpu().numpy())
    flo, png = str(tmp / "occ.flo"), str(tmp / "occ.png")
    res = cli_calls(counters, occ_cli, [*paths, paths[1], flo, png],
                    SEQUENCE_CLI_REPS)
    u, v = read_flo(flo)
    occ = read_image(png, gray=True)
    t0 = time.perf_counter()
    imgs = [gray(p) for p in (*paths, paths[1])]
    write_flo(str(tmp / "io.flo"), u, v)
    write_image(str(tmp / "io.png"), occ)
    res["io_seconds_per_call"] = time.perf_counter() - t0
    du, dv, dchi = (t.cpu().numpy() for t in tvl1occflow(*imgs))
    res.update(epe_vs_direct_call=float(np.hypot(u - du, v - dv).mean()),
               occlusion_png_equal=bool(np.array_equal(occ, dchi * 255.0)),
               finite=bool(np.isfinite(u).all() and np.isfinite(v).all()))
    out["tvl1occflow"] = res

    for name, res in out.items():
        main = mains[name]
        if not (res["rc"] == 0 and res["finite"] and res.get("files", True)
                and res.get("occlusion_png_equal", True)
                and res["epe_vs_direct_call"] <= 1e-5):
            raise AssertionError(f"CLI {name} failed or disagrees with its solver: {res}")
        if res["launches"] != main["launches"] or \
                res["warp_group_launches"] != main["warp_group_launches"]:
            raise AssertionError(f"CLI {name}: launches not those of its main "
                                 f"path {main['launches']}: {res}")
    return out


def main_path_cli(dev, counters, per_pair, mains):
    """The seven CLIs at 1024x436 through the kernels (`per_pair`: the
    launches of the brox_spatial and robust_expo CLIs by wrapper, under
    those names).  The five
    two-frame CLIs (tvl1flow and horn_schunck_pyramidal also verbose,
    tvl1flow also on gray PNG): per run the launches (counts set to 0
    just before it; K5's and K5p's per group too), the .flo against the
    direct solver call on the inputs the CLI read (EPE <= 1e-5), seconds
    per call, image IO included, over CLI_REPS calls after the counted
    one, and apart the seconds of the IO alone (both inputs read as the
    CLI reads them, the .flo written); then `sequence_clis`, held to the
    main paths `mains` of brox_temporal and tvl1occflow."""
    import tpuflow_torch.cli.brox_spatial as brox_cli
    import tpuflow_torch.cli.horn_schunck_classic as classic_cli
    import tpuflow_torch.cli.horn_schunck_pyramidal as hs_cli
    import tpuflow_torch.cli.robust_expo_methods as robust_cli
    import tpuflow_torch.cli.tvl1flow as tvl1_cli
    from tpuflow_torch import (brox_spatial, hs_classic, hs_pyramidal,
                               robust_expo, tvl1_multiscale)
    from tpuflow_torch.io import read_flow, read_image, write_flow
    from tpuflow_torch.ops.brox import brox_sor_error
    from tpuflow_torch.ops.hs import hs_sor_error
    from tpuflow_torch.ops.hs_classic import hs_classic_fused
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
    from tpuflow_torch.ops.warp import (warp_const_batched,
                                        warp_const_hs_batched,
                                        warp_planes_batched,
                                        warp_planes_shift_batched)

    K5, K5p = warp_planes_batched, warp_planes_shift_batched

    def rgb_planes(path):
        return np.moveaxis(read_image(path, gray=False).astype(np.float32), -1, 0)

    def gray(path):
        return read_image(path, gray=True).astype(np.float32)

    verbose_tvl1 = ["0", "0.25", "0.15", "0.3", "100", "0.5", "5", "0.01", "1"]
    verbose_hs = ["0", "7", "10", "0.5", "10", "0.0001", "150", "1"]
    # name: (CLI, argv before the output, input reader, direct call,
    #        {kernel: launches} (None: at least one))
    runs = {
        "tvl1flow": (tvl1_cli, ["I0.pfm", "I1.pfm"], gray,
                     lambda a, b: tvl1_multiscale(a, b)[:2],
                     {warp_const_batched: None, tvl1_iterate_error: None}),
        "tvl1flow_png": (tvl1_cli, ["I0g.png", "I1g.png"], gray,
                         lambda a, b: tvl1_multiscale(a, b)[:2],
                         {warp_const_batched: None, tvl1_iterate_error: None}),
        "tvl1flow_verbose": (tvl1_cli, ["I0.pfm", "I1.pfm"], gray,
                             lambda a, b: tvl1_multiscale(a, b, with_diag=True)[:2],
                             {K5: None, K5p: None, tvl1_iterate_error: None},
                             verbose_tvl1),
        "horn_schunck_pyramidal": (hs_cli, ["I0.pfm", "I1.pfm"], gray,
                                   lambda a, b: hs_pyramidal(a, b)[:2],
                                   {warp_const_hs_batched: None, hs_sor_error: None}),
        "horn_schunck_pyramidal_verbose": (
            hs_cli, ["I0.pfm", "I1.pfm"], gray,
            lambda a, b: hs_pyramidal(a, b, with_diag=True)[:2],
            {K5: None, K5p: None, hs_sor_error: None}, verbose_hs),
        "horn_schunck_classic": (classic_cli, [str(CLASSIC_NITER), str(CLASSIC_ALPHA),
                                               "I0.pfm", "I1.pfm"], gray,
                                 lambda a, b: hs_classic(a, b, CLASSIC_NITER,
                                                         CLASSIC_ALPHA),
                                 {hs_classic_fused: 1}),
        "brox_spatial": (brox_cli, ["I0.pfm", "I1.pfm"], gray,
                         lambda a, b: brox_spatial(a, b),
                         per_pair["brox_spatial"]),
        "robust_expo_methods": (robust_cli, ["I0.png", "I1.png"], rgb_planes,
                                lambda a, b: robust_expo(a, b),
                                per_pair["robust_expo"]),
    }
    groups_expected = pair_warp_groups()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, out["png_rows_per_filter"] = cli_files(Path(tmp))
        flo = str(Path(tmp) / "out.flo")
        for name, (cli, head, reader, direct, expect, *tail) in runs.items():
            argv = [paths.get(a, a) for a in head] + [flo] + (tail[0] if tail else [])
            res = cli_calls(counters, cli, argv, CLI_REPS)
            launches, warp_groups = res["launches"], res["warp_group_launches"]
            u, v = read_flow(flo)
            io_reps = []
            for _ in range(CLI_REPS):
                t0 = time.perf_counter()
                inputs = [reader(paths[a]) for a in head if a in paths]
                write_flow(str(Path(tmp) / "io.flo"), u, v)
                io_reps.append(time.perf_counter() - t0)
            du, dv = (t.float().cpu().numpy() for t in direct(*inputs))
            res.update(io_seconds_per_call=sum(io_reps) / len(io_reps),
                       epe_vs_direct_call=float(np.hypot(u - du, v - dv).mean()),
                       finite=bool(np.isfinite(u).all() and np.isfinite(v).all()),
                       shape=list(u.shape))
            out[name] = res
            wrong = {k.__name__: launches[k.__name__] for k, n in expect.items()
                     if (launches[k.__name__] == 0 if n is None
                         else launches[k.__name__] != n)}
            if res["rc"] != 0 or not res["finite"] or not res["epe_vs_direct_call"] <= 1e-5:
                raise AssertionError(f"CLI {name} failed or disagrees with its solver: {res}")
            if wrong:
                raise AssertionError(f"CLI {name}: launches {wrong} not as expected: {res}")
            # the Brox family's CLIs with the planes a thread warps at
            # each level: gray PFM six planes, robust_expo_methods' RGB
            # PNG 18
            if name in ("brox_spatial", "robust_expo_methods") and \
                    warp_groups != {k.__name__: g
                                    for k, g in groups_expected.items()}:
                raise AssertionError(f"CLI {name}: K5 / K5p groups not as "
                                     f"expected: {res}")
        out.update(sequence_clis(dev, counters, Path(tmp), mains))
    return out


# device kernels grouped by the part of an engine that launches them
K8_GROUP = ("pyramid_level_kernel", "K8 pyramid")
TVL1_GROUPS = (("warp_const", "K1 warp_const"), ("tvl1_primal", "K2 tvl1_iterate"),
               ("tvl1_dual", "K2 tvl1_iterate"), ("stop_finalize", "K2 tvl1_iterate"),
               K8_GROUP, ("gemm", "zoom_in matmul"))
HS_GROUPS = (("warp_const", "K3 warp_const_hs"), ("hs_sor_tiles", "K4 hs_sor"),
             ("hs_sor_level", "K4 hs_sor"), ("hs_sor_settle", "K4 hs_sor"),
             ("stop_finalize", "K4 hs_sor"), K8_GROUP,
             ("gemm", "zoom_in matmul"))
CLASSIC_GROUPS = (("hs_classic_block", "K6 hs_classic"),)
SEQUENCE_GROUPS = (("warp_planes_kernel", "K5/K5p warp_planes"), K8_GROUP,
                   ("gemm", "zoom_in matmul"))
BROX_GROUPS = (("warp_planes_kernel", "K5/K5p warp_planes"),
               ("brox_terms_kernel", "K9 brox_terms"),
               ("brox_sor_resident", "K7 brox_sor"),
               ("brox_sor_color", "K7 brox_sor"),
               ("stop_finalize", "K7 brox_sor"), K8_GROUP,
               ("gemm", "zoom_in matmul"))
# K7's device kernels: route "resident"'s, then route "stream"'s
K7_KERNELS = ("brox_sor_resident", "brox_sor_color", "stop_finalize")


def breakdown(run, groups, levels=True, name_parts=()):
    """Where one call of `run(level_callback)` spends its time:
    host-clock seconds up to the end of each pyramid level (synchronised
    in the level callback; the first interval also holds normalisation
    and the pyramid build), then one call under torch.profiler: device
    time by kernel group, the top kernels, the card's busy share of the
    call's wall time, and the recorded launches of the kernels whose
    names hold a part in `name_parts` (the profiler may miss a few)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    if levels:
        marks = []

        def mark(scale, state):
            torch.cuda.synchronize()
            marks.append((scale, time.perf_counter()))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(mark)
        starts = [t0] + [t for _, t in marks[:-1]]
        out["seconds_to_level_end"] = {str(s): t - t_prev for (s, t), t_prev
                                       in zip(marks, starts)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_end = time.perf_counter()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    out["profiler_processing_s"] = time.perf_counter() - t_end
    by_group = {}
    for name, ms, count in kernels:
        group = next((g for key, g in groups if key in name), "other")
        ms_sum, n_sum = by_group.get(group, (0.0, 0))
        by_group[group] = (ms_sum + ms, n_sum + count)
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    out.update(profiled_wall_ms=1e3 * wall,
               device_busy_ms=busy_ms if kernels else None,
               device_idle_share=1 - busy_ms / (1e3 * wall) if kernels else None,
               groups_ms_launches=by_group,
               top_kernels_ms_launches=[(n[:90], ms, c) for n, ms, c in top])
    if name_parts:
        out["recorded_launches"] = {
            part: sum(c for name, _, c in kernels if part in name)
            for part in name_parts}
    return out


def engine_timing(engine, I0, I1, counters, groups, pyramid=True, **kw):
    """fields/s of `engine` at B_TIME over 3 reps after one warm call,
    peak memory, launches per call and the breakdown of one call.  For a
    pyramid engine the warm call also gives, per level, the warps run
    and the inner iterations the batch ran (each warp's largest count)."""
    out = {"engine": engine.__name__, "batch": B_TIME,
           "shape": list(I0.shape[-2:])}
    if pyramid:
        its = engine(I0, I1, with_stats=True, **kw)[2]["iterations"]
        out["per_level_warps_inner"] = {
            str(s): [len(w), sum(max(n) for n in w)]
            for s, w in sorted(its.items())}
        if engine.__name__ == "hs_pyramidal_batched":
            out["sweeps_needed_launched"] = hs_sweeps(its, *I0.shape[-2:])
    else:
        engine(I0, I1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine(I0, I1, **kw)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per_call = {c.__name__: launch_count(c) / len(reps) for c in counters}
    if pyramid:
        where = breakdown(lambda cb: engine(I0, I1, level_callback=cb, **kw),
                          groups)
    else:
        where = breakdown(lambda cb: engine(I0, I1, **kw), groups, levels=False)
    out.update(fields_per_s=B_TIME * len(reps) / sum(reps), rep_s=reps,
               launches_per_call=per_call, max_memory_allocated_bytes=peak,
               breakdown=where)
    return out


def level0_kernels(dev, I0, I1):
    """Each kernel alone at level 0 of the B_TIME batch: ms per launch
    (CUDA events), plain ms, bound.  K2's and K4's unit is one wrapper
    call of one fixed iteration / sweep; K6's one call of the classic
    engine's 100 iterations."""
    from tpuflow_torch.models.hs_classic import _input_derivatives
    from tpuflow_torch.ops.hs import hs_sor_error, hs_sor_error_plain
    from tpuflow_torch.ops.hs_classic import (hs_classic_fused,
                                              hs_classic_fused_plain)
    from tpuflow_torch.ops.tvl1 import (tvl1_iterate_error,
                                        tvl1_iterate_error_plain)
    from tpuflow_torch.ops.warp import (warp_const_batched,
                                        warp_const_hs_batched,
                                        warp_const_plain)

    px = I0.numel()
    out = {}
    planes, state, aux, const = kernel_inputs(I0, I1, dev, 8)
    uv = state[:, :2]
    k = {"ms": time_ms(lambda: warp_const_batched(planes, uv, aux, 8), 20),
         "plain_ms": time_ms(lambda: warp_const_plain(planes, uv, aux, 8), 3)}
    k["bound_ms"], k["bound_by"] = bound_ms(px, K1_PLANES, K1_FLOPS_PX)
    out["warp_const_batched"] = k
    k = {"ms": time_ms(lambda: tvl1_iterate_error(
             state, const, -1.0, 1, *TVL1_PARAMS), 20),
         "plain_ms": time_ms(lambda: tvl1_iterate_error_plain(
             state, const, -1.0, 1, *TVL1_PARAMS), 3),
         "ms_per_iteration_in_16": time_ms(lambda: tvl1_iterate_error(
             state, const, -1.0, 16, *TVL1_PARAMS), 5) / 16}
    k["bound_ms"], k["bound_by"] = bound_ms(px, K2_PLANES, K2_FLOPS_PX)
    out["tvl1_iterate_error"] = k
    del planes, state, aux, const, uv

    planes, state, aux, const = kernel_inputs(I0, I1, dev, 8, "hs")
    k = {"ms": time_ms(lambda: warp_const_hs_batched(
             planes, state, aux, 8, HS_ALPHA2), 20),
         "plain_ms": time_ms(lambda: _warp_hs_plain(
             planes, state, aux, 8, HS_ALPHA2), 3)}
    k["bound_ms"], k["bound_by"] = bound_ms(px, K3_PLANES, K3_FLOPS_PX)
    out["warp_const_hs_batched"] = k
    k = {"ms": time_ms(lambda: hs_sor_error(
             state, const, -1.0, 1, HS_ALPHA2), 20),
         "plain_ms": time_ms(lambda: hs_sor_error_plain(
             state, const, -1.0, 1, HS_ALPHA2), 3),
         "ms_per_sweep_in_16": time_ms(lambda: hs_sor_error(
             state, const, -1.0, 16, HS_ALPHA2), 5) / 16}
    k["bound_ms"], k["bound_by"] = bound_ms(px, K4_PLANES, K4_FLOPS_PX)
    k["level_solve_55x128"] = level_solve(dev, I0.shape[0])
    out["hs_sor_error"] = k
    del planes, state, aux, const

    d = _input_derivatives(I0, I1)
    k = {"ms": time_ms(lambda: hs_classic_fused(
             *d, CLASSIC_ALPHA, CLASSIC_NITER), 5),
         "plain_ms": time_ms(lambda: hs_classic_fused_plain(
             *d, CLASSIC_ALPHA, CLASSIC_NITER), 2),
         "niter": CLASSIC_NITER}
    k["bound_ms"], k["bound_by"] = bound_ms(
        px, K6_PLANES, K6_FLOPS_PX_ITER * CLASSIC_NITER)
    k["ms_per_iteration"] = k["ms"] / CLASSIC_NITER
    # one iteration alone would move 7 planes (u, v, Ex, Ey, Et in; u, v out)
    k["bytes_bound_ms_per_iteration"] = bound_ms(px, 7, 0)[0]
    out["hs_classic_fused"] = k
    return out


def level_solve(dev, batch, ny=55, nx=128):
    """K4's route "level" alone: one warp's whole solve at (ny, nx) (level
    3 of 1024x436) for `batch` pairs from zero flow at the main path's
    threshold (tol 1e-4, at most 150 sweeps), ms per call (CUDA events)
    against its bound (the inputs read and u, v written once; the
    operations of the sweeps this run's samples needed) and the plain
    version's ms."""
    from tpuflow_torch.ops.hs import (device_route, hs_sor_error,
                                      hs_sor_error_plain)
    from tpuflow_torch.ops.warp import warp_const_plain

    planes, state, aux, _ = kernel_inputs(*pairs(batch, ny, nx, dev), dev, 3,
                                          "hs")
    state.zero_()
    const, _ = warp_const_plain(planes, state, aux, 3, "hs", HS_ALPHA2)
    thresh = float(np.float32(1e-4 * 1e-4) * np.float32(ny * nx))
    _, _, n = hs_sor_error(state.clone(), const, thresh, 150, HS_ALPHA2)
    _, _, n_ref = hs_sor_error_plain(state.clone(), const, thresh, 150, HS_ALPHA2)
    if not bool(((n - n_ref).abs() <= 1).all()):
        raise AssertionError("level solve: stopping counts differ by more than 1")
    k = {"shape": [batch, ny, nx], "route": device_route(ny, nx),
         "sweeps_max": int(n.max()), "sweeps_sum": int(n.sum()),
         "ms": time_ms(lambda: hs_sor_error(state.clone(), const, thresh, 150,
                                            HS_ALPHA2), 10),
         "plain_ms": time_ms(lambda: hs_sor_error_plain(
             state.clone(), const, thresh, 150, HS_ALPHA2), 2)}
    t_bytes = batch * ny * nx * K4_PLANES * 4 / HBM_BYTES_PER_S
    t_ops = ny * nx * K4_FLOPS_PX * int(n.sum()) / FP32_FLOPS
    k["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return k


# ---- the surface beyond the solvers: ops, dtype, warm-up, checkpoints,
# ---- and the lanes on torch.distributed

# warp coordinates in float32 near 1024 carry 6e-5 px of rounding: the
# card's float32 ops against the CPU's float64 within 1e-4 of each
# output's largest value (at least 1)
OPS_REL_TOL = 1e-4
ALL_METHODS = ("tvl1", "hs", "occflow", "robust_expo", "brox_spatial",
               "brox_temporal", "brox_batched")
WARMUP_GEOMETRY = (B_CHECK, 436, 1024)
# the tile lane's warp halo: TV-L1 from zero flow at level 0 moves the
# seed pair's flow (at most 2 px) well inside halo - 3
TILE_WARP_HALO = 8
TILE_EPE_TOL = 1e-5


# K8 against the plain pyramid at zfactor 0.75, on the [0, 255] scale:
# the Keys weights of 0.75 are summed in another order than the GEMM's
PYRAMID_TOL_075 = 1e-4


def check_pyramid(dev, I0, I1):
    """K8 (tpuflow_torch.ops.pyramid_level) at the batch geometry: the
    pyramid of (I0, I1) against `build_pyramid_plain` on the card, every
    level of both images, bit for bit at zfactor 0.5 and within
    PYRAMID_TOL_075 at 0.75 (the whole pyramid, and each level made from
    the plain level above), one launch a level; then its device time per
    level and per call (`graph_ms`, L2 not flushed: a level-0 image set
    is 4.6 times the L2) beside its bytes bound (each level read once and
    written once; the min/max reads both images once) and the plain
    pyramid's time.  A CUDA tensor K8 does not take (float64) raises a
    ValueError in `gaussian`, `zoom_out` and `build_pyramid`."""
    from tpuflow_torch.models.common import build_pyramid, build_pyramid_plain
    from tpuflow_torch.ops.gaussian import gaussian, gaussian_taps
    from tpuflow_torch.ops.normalize import joint_range
    from tpuflow_torch.ops.pyramid import (clamp_nscales, zoom_out,
                                           zoom_out_levels, zoom_out_plain)
    from tpuflow_torch.ops.pyramid_level import pyramid_level

    B, ny, nx = I0.shape
    nscales = clamp_nscales(nx, ny, 0.5, 100)   # tvl1flow's: 7
    out = {"batch": B, "shape": [ny, nx], "nscales": nscales}
    for z in (0.5, 0.75):
        reset()
        got, sizes = build_pyramid((I0, I1), nscales, z)
        torch.cuda.synchronize()
        launches = since_reset("launches.k8")
        want, _ = build_pyramid_plain((I0, I1), nscales, z)
        err = [[float((a - b).abs().max()) for a, b in zip(g, w)]
               for g, w in zip(got, want)]
        equal = all(torch.equal(a, b) for g, w in zip(got, want)
                    for a, b in zip(g, w))
        # each level alone: K8 and the plain zoom_out of the plain level above
        alone = [[float((a - zoom_out_plain(w, z, sizes[s])).abs().max())
                  for a, w in zip(zoom_out_levels(want[s - 1], z, sizes[s]),
                                  want[s - 1])] for s in range(1, nscales)]
        out[f"zfactor_{z}"] = {"sizes": sizes, "launches": launches,
                               "bit_equal": equal, "max_abs_err": err,
                               "level_alone_max_abs_err": alone}
        del got, want
        if launches != nscales:
            raise AssertionError(f"pyramid: {launches} K8 launches for "
                                 f"{nscales} levels: {out}")
        if z == 0.5 and not equal:
            raise AssertionError(f"pyramid: K8 not bit-equal to the plain "
                                 f"pyramid at zfactor 0.5: {out}")
        if not max(max(e) for e in err + alone) <= PYRAMID_TOL_075:
            raise AssertionError(f"pyramid: K8 far from the plain pyramid "
                                 f"at zfactor {z}: {out}")
    d = I0[:2].double()
    refused = {}
    for name, fn in (("gaussian", lambda: gaussian(d, 0.8)),
                     ("zoom_out", lambda: zoom_out(d, 0.5)),
                     ("build_pyramid", lambda: build_pyramid((d, d), 3, 0.5))):
        try:
            fn()
            refused[name] = False
        except ValueError:
            refused[name] = True
    out["float64_refused"] = refused
    if not all(refused.values()):
        raise AssertionError(f"pyramid: a CUDA float64 tensor ran: {out}")
    levels, sizes = build_pyramid((I0, I1), nscales, 0.5)
    norm = joint_range(I0, I1)
    taps = gaussian_taps(0.8, I0.dtype)
    steps = [("minmax", lambda: joint_range(I0, I1), 2 * B * ny * nx),
             ("level_0", lambda: pyramid_level((I0, I1), taps, norm=norm),
              4 * B * ny * nx)]
    for s in range(1, nscales):
        (px, py), (cx, cy) = sizes[s - 1], sizes[s]
        steps.append((f"level_{s}", lambda s=s: zoom_out_levels(
            levels[s - 1], 0.5, sizes[s]), 2 * B * (px * py + cx * cy)))
    per_level = {}
    for name, fn, floats in steps:
        ms = graph_ms(fn, 10, False)
        bound = 1e3 * 4 * floats / HBM_BYTES_PER_S
        per_level[name] = {"ms": ms, "bound_ms": bound, "x_bound": ms / bound}
    call_ms = graph_ms(lambda: build_pyramid((I0, I1), nscales, 0.5), 10,
                       False)
    bound = sum(v["bound_ms"] for v in per_level.values())
    out.update(per_level=per_level, k8_ms=sum(
                   v["ms"] for k, v in per_level.items() if k != "minmax"),
               call_ms=call_ms, bound_ms=bound, call_x_bound=call_ms / bound,
               plain_ms=graph_ms(lambda: build_pyramid_plain(
                   (I0, I1), nscales, 0.5), 2, False))
    if call_ms < bound:
        raise AssertionError(f"pyramid: K8 read below its bound: {out}")
    return out


def ops_checks(dev):
    """Each op that the solvers do not call, and `warp_stack`'s default
    and window, on `dev` in float32 against the same op on the CPU in
    float64, at 436x1024 (the seed-SEED0 image, its synthetic flow and
    random coordinates, filters and mask from the seed)."""
    from tpuflow_torch import ops
    from tpuflow_torch.data import NX, NY, synth_flow, synth_pair

    I0, I1 = synth_pair(NY, NX, seed=SEED0)
    u, v = synth_flow(NY, NX)
    rng = np.random.default_rng(SEED0)
    mask = rng.standard_normal(9)
    fx, fy = ops.sgauss_kernel(1.5, 9), ops.sgauss_kernel(1.0, 6)
    xx = rng.uniform(-3, NX + 3, (NY, NX))
    yy = rng.uniform(-3, NY + 3, (NY, NX))
    stack = np.stack([I0, I1, I0 - I1])
    gy, gx = np.mgrid[0:NY, 0:NX].astype(np.float64)
    # one window of the stack: a 109x256 tile at (109, 512) with a halo
    # of 8, warped by the synthetic flow; against the whole image's warp
    oy, ox, h, w, halo = NY // 4, NX // 2, NY // 4, NX // 4, 8
    win = stack[:, oy - halo:oy + h + halo, ox - halo:ox + w + halo]
    wx = (gx + u)[oy:oy + h, ox:ox + w]
    wy = (gy + v)[oy:oy + h, ox:ox + w]
    window = (oy - halo, ox - halo, NY, NX)
    cases = {
        "mask3x3": (lambda I: ops.mask3x3(I, mask), (I0,)),
        "sepconvol": (lambda I: ops.sepconvol(I, fx, fy), (I0,)),
        "bicubic_at": (ops.bicubic_at, (I0, xx, yy)),
        "warp": (ops.warp, (I0, u, v)),
        "warp_stack_shifted_grid": (ops.warp_stack,
                                    (stack, gx + 3.0, gy - 2.0)),
        "warp_stack_window": (
            lambda p, x, y: ops.warp_stack(p, x, y, True, window=window),
            (win, wx, wy)),
        "interpolate_bilinear": (
            ops.interpolate_bilinear,
            (I0, np.clip(xx, 0, NX - 1.001), np.clip(yy, 0, NY - 1.001))),
        "image_restriction": (lambda I: ops.image_restriction(
            I, (NX // 3, NY // 3)), (I0,)),
    }
    out = {}
    for name, (fn, args) in cases.items():
        got = fn(*(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                   for a in args))
        ref = fn(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args))
        if got.dtype != torch.float32 or ref.dtype != torch.float64:
            raise AssertionError(f"{name}: dtypes {got.dtype}, {ref.dtype}")
        err = float((got.cpu().double() - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        out[name] = {"shape": list(got.shape), "max_abs_err": err,
                     "max_rel_err": err / scale}
    whole = ops.warp_stack(torch.as_tensor(stack), torch.as_tensor(wx),
                           torch.as_tensor(wy), True)
    got = ops.warp_stack(torch.as_tensor(win), torch.as_tensor(wx),
                         torch.as_tensor(wy), True, window=window)
    out["warp_stack_window"]["window_vs_whole_f64"] = float(
        (got - whole).abs().max())
    bad = {k: c for k, c in out.items() if not c["max_rel_err"] <= OPS_REL_TOL}
    if bad or out["warp_stack_window"]["window_vs_whole_f64"] != 0:
        raise AssertionError(f"ops disagree with their float64 CPU run: {out}")
    return out


def dtype_check(dev, counters):
    """`tvl1_batched` on float64 inputs on the card: float32 results,
    one warning, bit-equal to the call on float32 inputs."""
    import warnings

    from tpuflow_torch import tvl1_batched
    from tpuflow_torch.data import NX, NY

    I0, I1 = (t.cpu().numpy() for t in pairs(B_CHECK, NY, NX, dev))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (u64, v64), seconds, launches = counted(
            counters, lambda: tvl1_batched(I0.astype(np.float64),
                                           I1.astype(np.float64)))
    u32, v32 = tvl1_batched(I0, I1)
    cast = [str(w.message) for w in caught if "float64" in str(w.message)]
    out = {"shape": [B_CHECK, NY, NX], "dtype": str(u64.dtype),
           "warnings": cast, "seconds": seconds, "launches": launches,
           "bit_equal_to_float32_inputs": bool(
               torch.equal(u64, u32) and torch.equal(v64, v32))}
    out["other_warnings"] = [str(w.message) for w in caught
                             if "float64" not in str(w.message)]
    if not (u64.dtype == v64.dtype == torch.float32 and len(cast) == 1
            and out["bit_equal_to_float32_inputs"]):
        raise AssertionError(f"float64 inputs on the card: {out}")
    return out


def warmup_check(dev):
    """`warmup` of all seven methods at (B_CHECK, 436, 1024) on the card,
    then one `tvl1_batched` call at that geometry (its seconds)."""
    from tpuflow_torch import tvl1_batched, warmup

    seconds = warmup([WARMUP_GEOMETRY], methods=ALL_METHODS)
    I0, I1 = pairs(*WARMUP_GEOMETRY, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, v = tvl1_batched(I0, I1)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if not bool(torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("tvl1_batched after warmup: flow not finite")
    return {"geometry": list(WARMUP_GEOMETRY), "methods": list(ALL_METHODS),
            "warmup_s": seconds, "first_tvl1_batched_call_s": first}


def checkpoint_check(dev):
    """`tvl1_batched` (B_CHECK pairs at 1024x436) with
    `checkpoint_callback` into a temporary directory, then resumed from
    the finest level written and from level 1: each equal to the
    uninterrupted run (the kernels sum in a fixed order)."""
    from tpuflow_torch import tvl1_batched
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.utils.checkpoint import (checkpoint_callback,
                                                load_level_checkpoint)
    from tpuflow_torch.utils.convert import resume_from_jax

    I0, I1 = pairs(B_CHECK, NY, NX, dev)
    u, v = tvl1_batched(I0, I1)
    with tempfile.TemporaryDirectory() as tmp:
        uc, vc = tvl1_batched(I0, I1, level_callback=checkpoint_callback(tmp))
        levels = sorted(os.listdir(tmp))
        scale, finest = load_level_checkpoint(tmp)
        uf, vf = tvl1_batched(I0, I1, resume=resume_from_jax(scale, finest))
        u1, v1 = tvl1_batched(I0, I1, resume=resume_from_jax(
            1, load_level_checkpoint(tmp, 1)))
    out = {"shape": [B_CHECK, NY, NX], "levels_written": levels,
           "finest": scale,
           "callback_run_equal": bool(torch.equal(uc, u) and torch.equal(vc, v)),
           "resumed_finest_equal": bool(torch.equal(uf, u) and torch.equal(vf, v)),
           "resumed_level1_equal": bool(torch.equal(u1, u) and torch.equal(v1, v))}
    if not (scale == 0 and out["callback_run_equal"]
            and out["resumed_finest_equal"] and out["resumed_level1_equal"]):
        raise AssertionError(f"checkpoint and resume: {out}")
    return out


# the frame-sharded lane against the single-device solver, both with the
# exact warp: the same arithmetic at world size 1
TEMPORAL_LANE_EPE_TOL = 1e-5
# tvl1_spatial against tvl1_multiscale(warp_mode="fast") on its per-level
# route (tvl1_scale at every level, K5 / K5p and K2 in float32); the
# plain call of tvl1_multiscale is the batched engine at B=1, whose warp
# early exit skips warps that would each move the flow by up to about
# epsilon = 0.01 px, so it is held only to the repo's fault bound;
# robust_expo_spatial and tvl1occflow_spatial against their untiled
# solvers with the fast warp at the same bound, the JAX package's own
# float32 bound for its lanes (tests/test_spatial.py)
SPATIAL_EPE_TOL = 1e-4
SPATIAL_BATCHED_EPE_TOL = 0.05


def temporal_lane(dev, counters):
    """`brox_temporal_multiscale_sharded` on mesh {"t": 1} on the
    TEMPORAL_FRAMES-frame 1024x436 volume of the timing phase (12 levels
    at the reference CLI defaults), against the single-device
    `brox_temporal(..., warp_mode="exact")`: EPE per field and the SOR
    sweeps of every level.  The lane warps with the exact gather (no
    kernel), and its 3-D SOR is plain PyTorch."""
    from tpuflow_torch import brox_temporal
    from tpuflow_torch.data import NX, NY, synth_sequence
    from tpuflow_torch.parallel.mesh import make_mesh
    from tpuflow_torch.parallel.temporal import (
        brox_temporal_multiscale_sharded)

    vol = torch.from_numpy(synth_sequence(TEMPORAL_FRAMES, NY, NX,
                                          seed=SEED0)).to(dev)
    mesh = make_mesh({"t": 1})
    (u, v, diags), seconds, launches = counted(
        counters, lambda: brox_temporal_multiscale_sharded(vol, mesh,
                                                           with_diag=True))
    (ur, vr, rdiags), rseconds, _ = counted(
        counters, lambda: brox_temporal(vol, warp_mode="exact",
                                        with_diag=True))
    sweeps = [int(d["iterations"].sum()) for d in diags]
    out = {"shape": [TEMPORAL_FRAMES, NY, NX], "mesh": {"t": 1},
           "levels": len(diags), "seconds": seconds,
           "seconds_per_frame_pair": seconds / (TEMPORAL_FRAMES - 1),
           "host_reads": sum(d["host_reads"] for d in diags),
           "sweeps_per_level": sweeps,
           "single_device_sweeps_per_level": [int(d["iterations"].sum())
                                              for d in rdiags],
           "single_device_exact_seconds": rseconds, "launches": launches,
           "epe_vs_single_device": epe(u, v, ur, vr),
           "bit_equal_to_single_device": bool(torch.equal(u, ur)
                                              and torch.equal(v, vr))}
    same_sweeps = [d["iterations"].tolist() for d in diags] == [
        d["iterations"].tolist() for d in rdiags]
    if not (same_sweeps and tuple(u.shape) == (TEMPORAL_FRAMES - 1, NY, NX)
            and max(out["epe_vs_single_device"]) <= TEMPORAL_LANE_EPE_TOL
            and bool(torch.isfinite(u).all() and torch.isfinite(v).all())
            and not any(launches.values())):
        raise AssertionError(f"temporal lane: {out}")
    return out


@contextlib.contextmanager
def first_warp(shape, first):
    """Keep in `first` the (planes, u, v, dmax, shift, border_out) of the
    first warp of a level of `shape` (ny, nx) inside the block."""
    import tpuflow_torch.ops.interp as interp

    inner = interp.warp_planes_uv

    def capture(planes, u, v, dmax, shift=False, border_out=True):
        if not first and tuple(planes.shape[-2:]) == tuple(shape):
            first.append((planes.clone(), u.clone(), v.clone(), dmax, shift,
                          border_out))
        return inner(planes, u, v, dmax, shift, border_out)

    with swapped([(interp, "warp_planes_uv", capture)]):
        yield


def warp_vs_plain(warp, shift, border_out=True):
    """K5 (shift False) or K5p on a warp `first_warp` kept, against its
    plain version on the same inputs."""
    import tpuflow_torch.ops.interp as interp
    from tpuflow_torch.ops.warp import warp_planes_uv_plain

    planes, u, v, dmax = warp[:4]
    got = interp.warp_planes_uv(planes, u, v, dmax, shift, border_out)
    ref = warp_planes_uv_plain(planes, u, v, dmax, shift, border_out)
    rel, err = rel_err(got[None], ref[None])
    return {"shape": list(planes.shape), "dmax": dmax,
            "border_out": border_out, "max_abs_err": err,
            "max_rel_err": rel, "bit_equal": bool(torch.equal(got, ref))}


def within_one(its, rits):
    """Whether two per-level lists of counts have the same shape and
    differ by at most one everywhere."""
    flat = [np.ravel(x).tolist() for x in its]
    rflat = [np.ravel(x).tolist() for x in rits]
    return len(flat) == len(rflat) and all(
        len(x) == len(y) and all(abs(p - q) <= 1 for p, q in zip(x, y))
        for x, y in zip(flat, rflat))


def spatial_lane(dev, counters, I0, I1):
    """`tvl1_spatial` on the mesh `make_spatial_mesh` gives one rank
    ({"y": 1, "x": 1}: every level tiles) on one 1024x436 timing pair at
    tvl1flow's defaults, against `tvl1_multiscale(warp_mode="fast",
    with_diag=True)`, which runs `tvl1_scale` at each level (EPE, and
    the iterations of every warp within one), and against its plain
    call, the batched engine at B=1 (EPE); K5 launched on each level of
    at least 96x96 px and K5p below, once a warp, and nothing else; then
    the K5 and K5p outputs of its first level-0 warp (P = 3) against
    their plain versions."""
    from tpuflow_torch import tvl1_multiscale
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS
    from tpuflow_torch.ops.pyramid import clamp_nscales, pyramid_sizes
    from tpuflow_torch.parallel.spatial import make_spatial_mesh, tvl1_spatial

    a, b = I0[0], I1[0]
    ny, nx = a.shape
    sizes = pyramid_sizes(nx, ny, 0.5, clamp_nscales(nx, ny, 0.5, 100))
    big = sum(w * h >= K5_MIN_PIXELS for w, h in sizes)
    mesh = make_spatial_mesh()
    first = []
    with first_warp((ny, nx), first):
        (u, v, diags), seconds, launches = counted(
            counters, lambda: tvl1_spatial(a, b, mesh, with_diag=True))
    (us, vs), plain_seconds, _ = counted(
        counters, lambda: tvl1_spatial(a, b, mesh))
    (ur, vr), rseconds, rlaunches = counted(
        counters, lambda: tvl1_multiscale(a, b, warp_mode="fast"))
    ud, vd, rdiags = tvl1_multiscale(a, b, warp_mode="fast", with_diag=True)
    its = [d["iterations"].tolist() for d in diags]
    rits = [d["iterations"].tolist() for d in rdiags]
    kernel_checks = {"warp_planes_batched": warp_vs_plain(first[0], False),
                     "warp_planes_shift_batched": warp_vs_plain(first[0],
                                                                True)}
    out = {"shape": [ny, nx], "mesh": dict(zip(mesh.mesh_dim_names,
                                               mesh.shape)),
           "levels": len(sizes), "tiled_levels": [d["tiled"] for d in diags],
           "seconds_with_diag": seconds, "seconds": plain_seconds,
           "host_reads": sum(d.get("host_reads", 0) for d in diags),
           "iterations": its, "tvl1_scale_iterations": rits,
           "batched_route_seconds": rseconds,
           "batched_route_launches": rlaunches,
           "launches": launches,
           "k5_launches_expected": 5 * big,
           "k5p_launches_expected": 5 * (len(sizes) - big),
           "epe_vs_tvl1_multiscale_fast": epe(u, v, ud, vd),
           "epe_vs_batched_route": epe(us, vs, ur, vr),
           "diag_call_equal_to_plain_call": bool(torch.equal(u, us)
                                                 and torch.equal(v, vs)),
           "level0_warp_vs_plain": kernel_checks}
    others = {k: n for k, n in launches.items()
              if k not in ("warp_planes_batched", "warp_planes_shift_batched")}
    k5, k5p = (kernel_checks[k] for k in ("warp_planes_batched",
                                          "warp_planes_shift_batched"))
    if not (within_one(its, rits) and all(out["tiled_levels"])
            and out["epe_vs_tvl1_multiscale_fast"] <= SPATIAL_EPE_TOL
            and out["epe_vs_batched_route"] <= SPATIAL_BATCHED_EPE_TOL
            and out["diag_call_equal_to_plain_call"]
            and launches["warp_planes_batched"] == 5 * big > 0
            and launches["warp_planes_shift_batched"] == 5 * (len(sizes) - big) > 0
            and not any(others.values())
            and k5["max_rel_err"] <= 1e-5 and k5p["bit_equal"]
            and k5p["max_abs_err"] <= 1e-4
            and bool(torch.isfinite(u).all() and torch.isfinite(v).all())):
        raise AssertionError(f"tvl1_spatial: {out}")
    return out


def robust_expo_lane(dev, counters, I0, I1):
    """`robust_expo_spatial` on the one-rank mesh (every level tiles) on
    one 1024x436 timing pair, gray, at robust_expo_methods' defaults
    (method 1, 5 levels, 15 outer iterations), against
    `robust_expo(warp_mode="fast", with_diag=True)`: EPE <=
    SPATIAL_EPE_TOL and the SOR sweeps of every solve within one; each
    level's warps recorded and held to what its size gives (15 K5
    launches on levels of at least 96x96 px, 15 K5p below, P = 6,
    border_out), one K7 launch a solve (the solve runs on the gathered
    level, 75 in all) and no other kernel launched; the first level-0
    warp's K5 output against its plain version (rel <= 1e-5); then one
    method-3 (DF-AUTO) call held the same way.  Seconds per call beside
    the untiled calls', levels tiled."""
    from tpuflow_torch import robust_expo
    from tpuflow_torch.models.robust_expo import DEFAULT_INNER, DEFAULT_OUTER
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS
    from tpuflow_torch.ops.warp import (warp_planes_batched,
                                        warp_planes_shift_batched)
    from tpuflow_torch.parallel.spatial import (make_spatial_mesh,
                                                robust_expo_spatial)

    a, b = I0[0], I1[0]
    ny, nx = a.shape
    mesh = make_spatial_mesh()
    levels = brox_levels()
    big = sum(lnx * lny >= K5_MIN_PIXELS for lnx, lny in levels)
    solves = DEFAULT_OUTER * DEFAULT_INNER * len(levels)

    def held(method, u, v, diags):
        """The checks of one tiled call against the untiled solver."""
        (ud, vd, rdiags), rseconds, rlaunches = counted(
            counters, lambda: robust_expo(a, b, method_type=method,
                                          warp_mode="fast", with_diag=True))
        its = [d["iterations"].tolist() for d in diags]
        rits = [d["iterations"].tolist() for d in rdiags]
        diffs = [abs(p - q) for x, y in zip(its, rits)
                 for p, q in zip(np.ravel(x), np.ravel(y))]
        return {"tiled_levels": [d["tiled"] for d in diags],
                "untiled_seconds_with_diag": rseconds,
                "untiled_launches": rlaunches,
                "sweeps": sum(int(d["iterations"].sum()) for d in diags),
                "sweeps_per_level": [int(d["iterations"].sum())
                                     for d in diags],
                "untiled_sweeps_per_level": [int(d["iterations"].sum())
                                             for d in rdiags],
                "sweeps_max_diff": int(max(diffs)),
                "sweeps_within_one": within_one(its, rits),
                "epe_vs_robust_expo_fast": epe(u, v, ud, vd),
                "equal_to_robust_expo_fast": bool(torch.equal(u, ud)
                                                  and torch.equal(v, vd)),
                "finite": bool(torch.isfinite(u).all()
                               and torch.isfinite(v).all())}

    calls, marks, first = [], [], []

    def run():
        return robust_expo_spatial(a, b, mesh, with_diag=True,
                                   level_callback=lambda s, _:
                                   marks.append((s, len(calls))))

    with recording_warps(calls), first_warp((ny, nx), first):
        (u, v, diags), seconds, launches = counted(counters, run)
    groups = {k.__name__: group_launches(k)
              for k in (warp_planes_batched, warp_planes_shift_batched)}
    (us, vs), plain_seconds, _ = counted(
        counters, lambda: robust_expo_spatial(a, b, mesh))
    _, plain_rseconds, _ = counted(counters, lambda: robust_expo(a, b))

    def expect(s, lnx, lny):
        kernel = "K5" if lnx * lny >= K5_MIN_PIXELS else "K5p"
        return [(kernel, True, 1, 6, lny, lnx, brox_dmax(s))] * DEFAULT_OUTER

    per_level, want_groups, wrong = level_warps(calls, marks, levels, expect)
    out = {"engine": "robust_expo_spatial", "shape": [ny, nx],
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "levels": len(diags), "seconds_with_diag": seconds,
           "seconds": plain_seconds, "untiled_seconds": plain_rseconds,
           **held(1, u, v, diags),
           "launches": launches, "warp_group_launches": groups,
           "per_level": per_level,
           "diag_call_equal_to_plain_call": bool(torch.equal(u, us)
                                                 and torch.equal(v, vs)),
           "level0_warp_vs_plain": warp_vs_plain(first[0], False)}
    (u3, v3, d3), seconds3, launches3 = counted(
        counters, lambda: robust_expo_spatial(a, b, mesh, method_type=3,
                                              with_diag=True))
    out["method3"] = {"seconds_with_diag": seconds3, "launches": launches3,
                      **held(3, u3, v3, d3)}
    # K7 launches once a solve, beside the warps that check counts
    check_sequence_launches(out, {k: n for k, n in launches.items()
                                  if k != "brox_sor_error"},
                            groups, want_groups, wrong)
    for o in (out, out["method3"]):
        others = {k: n for k, n in o["launches"].items()
                  if n and k not in ("warp_planes_batched",
                                     "warp_planes_shift_batched",
                                     "brox_sor_error")}
        if not (all(o["tiled_levels"]) and o["finite"]
                and o["sweeps_within_one"]
                and o["epe_vs_robust_expo_fast"] <= SPATIAL_EPE_TOL
                and o["launches"]["warp_planes_batched"]
                == DEFAULT_OUTER * big > 0
                and o["launches"]["warp_planes_shift_batched"]
                == DEFAULT_OUTER * (len(levels) - big) > 0
                and o["launches"]["brox_sor_error"] == solves
                and not others):
            raise AssertionError(f"robust_expo_spatial: {out}")
    if not (out["diag_call_equal_to_plain_call"]
            and out["level0_warp_vs_plain"]["max_rel_err"] <= 1e-5):
        raise AssertionError(f"robust_expo_spatial: {out}")
    return out


def occ_lane(dev, counters):
    """`tvl1occflow_spatial` on the one-rank mesh (every level tiles) on
    the timing phase's triplet (`occ_triplet`) at the reference CLI
    defaults (5 levels, 2 warps), against `tvl1occflow(warp_mode="fast",
    with_diag=True)`: the JAX package's float32 bounds
    (tests/test_spatial.py: EPE <= 1e-4, chi differing on fewer than 1%
    of the pixels) and the iterations of every warp within one; each
    level's warps recorded and held to what its size gives (two K5p
    launches a warp without border_out, P = 3: 20 in all) and no other
    kernel launched (the ROF, median and chi steps are plain PyTorch);
    the first level-0 warp's K5p output against its plain version.
    Seconds per call beside the untiled calls', host reads (one an
    iteration), levels tiled."""
    from tpuflow_torch import tvl1occflow
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.models.tvl1occflow import DEFAULT_WARPS
    from tpuflow_torch.ops.warp import (warp_planes_batched,
                                        warp_planes_shift_batched)
    from tpuflow_torch.parallel.spatial import (make_spatial_mesh,
                                                tvl1occflow_spatial)

    triplet = occ_triplet(dev)
    mesh = make_spatial_mesh()
    calls, marks, first = [], [], []

    def run():
        return tvl1occflow_spatial(*triplet, mesh=mesh, with_diag=True,
                                   level_callback=lambda s, _:
                                   marks.append((s, len(calls))))

    with recording_warps(calls), first_warp((NY, NX), first):
        (u1, u2, chi, diags), seconds, launches = counted(counters, run)
    groups = {k.__name__: group_launches(k)
              for k in (warp_planes_batched, warp_planes_shift_batched)}
    (p1, p2, pchi), plain_seconds, _ = counted(
        counters, lambda: tvl1occflow_spatial(*triplet, mesh=mesh))
    (r1, r2, rchi, rdiags), rseconds, rlaunches = counted(
        counters, lambda: tvl1occflow(*triplet, warp_mode="fast",
                                      with_diag=True))
    _, plain_rseconds, _ = counted(counters, lambda: tvl1occflow(*triplet))

    def expect(s, nx, ny):
        return [("K5p", False, 1, 3, ny, nx,
                 brox_dmax(s, OCC_ZFACTOR))] * (2 * DEFAULT_WARPS)

    per_level, want_groups, wrong = level_warps(
        calls, marks, brox_levels(OCC_ZFACTOR, 100), expect)
    its = [d["iterations"].tolist() for d in diags]
    rits = [d["iterations"].tolist() for d in rdiags]
    k5p = warp_vs_plain(first[0], True, border_out=False)
    out = {"engine": "tvl1occflow_spatial", "shape": [3, NY, NX],
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "levels": len(diags), "tiled_levels": [d["tiled"] for d in diags],
           "seconds_with_diag": seconds, "seconds": plain_seconds,
           "untiled_seconds_with_diag": rseconds,
           "untiled_seconds": plain_rseconds,
           "host_reads": sum(d["host_reads"] for d in diags),
           "iterations": its, "untiled_iterations": rits,
           "launches": launches, "warp_group_launches": groups,
           "untiled_launches": rlaunches, "per_level": per_level,
           "epe_vs_tvl1occflow_fast": epe(u1, u2, r1, r2),
           "chi_differing_share": float((chi != rchi).double().mean()),
           "occluded_share": float(chi.mean()),
           "diag_call_equal_to_plain_call": bool(
               torch.equal(u1, p1) and torch.equal(u2, p2)
               and torch.equal(chi, pchi)),
           "level0_warp_vs_plain": k5p,
           "iterations_within_one": within_one(its, rits)}
    check_sequence_launches(out, launches, groups, want_groups, wrong)
    if not (out["iterations_within_one"] and all(out["tiled_levels"])
            and launches["warp_planes_shift_batched"]
            == 2 * DEFAULT_WARPS * len(diags) > 0
            and out["epe_vs_tvl1occflow_fast"] <= SPATIAL_EPE_TOL
            and out["chi_differing_share"] < 0.01
            and out["diag_call_equal_to_plain_call"]
            and k5p["max_abs_err"] <= 1e-4
            and bool(torch.isfinite(u1).all() and torch.isfinite(u2).all())):
        raise AssertionError(f"tvl1occflow_spatial: {out}")
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_lanes(dev, counters, I0, I1):
    """The lanes of tpuflow_torch.parallel at world size 1: a one-rank
    process group (NCCL on the card; nothing falls back to gloo), the
    data-parallel lane (`dp_shard` and `tvl1_batched` on the pairs I0,
    I1 over mesh {"batch": 1}, then `dp_efficiency` at n = 1), the
    tile lane (`tvl1_scale_tiled` on mesh {"y": 1, "x": 1} at the full
    436x1024 against the port's `tvl1_scale`, which runs K2), the
    frame-sharded Brox temporal lane (`temporal_lane`) and the tiled
    multiscale TV-L1 (`spatial_lane`), robust-expo (`robust_expo_lane`)
    and TV-L1 with occlusions (`occ_lane`)."""
    import torch.distributed as dist

    from tpuflow_torch import tvl1_batched
    from tpuflow_torch.models.common import PRESMOOTHING_SIGMA
    from tpuflow_torch.models.tvl1 import tvl1_scale
    from tpuflow_torch.ops import gaussian, normalize_joint
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
    from tpuflow_torch.ops.warp import warp_const_batched
    from tpuflow_torch.parallel.distributed import (dp_efficiency, dp_shard,
                                                    initialize)
    from tpuflow_torch.parallel.mesh import (gather_batch, gather_spatial,
                                             make_mesh, spatial_block)
    from tpuflow_torch.parallel.tiled import TileGeom, tvl1_scale_tiled

    B, ny, nx = I0.shape
    if not initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev):
        raise AssertionError("initialize did not start a process group")
    try:
        backend = dist.get_backend()
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        out = {"backend": backend, "world_size": dist.get_world_size(),
               "all_reduce_ok": float(probe) == 1.0}
        want = "nccl" if torch.device(dev).type == "cuda" else "gloo"
        if backend != want or not out["all_reduce_ok"]:
            raise AssertionError(f"process group: {out}")

        mesh = make_mesh({"batch": 1})
        a, b = dp_shard((I0, I1), mesh, device=dev)
        (u, v), seconds, launches = counted(counters,
                                            lambda: tvl1_batched(a, b))
        u, v = gather_batch(u, mesh), gather_batch(v, mesh)
        ud, vd = tvl1_batched(I0, I1)
        out["dp"] = {"shape": [B, ny, nx], "seconds": seconds,
                     "fields_per_sec": B / seconds, "launches": launches,
                     "equal_to_direct_call": bool(torch.equal(u, ud)
                                                  and torch.equal(v, vd)),
                     "efficiency": dp_efficiency(
                         lambda x, y: tvl1_batched(x, y),
                         lambda n: (I0[:n], I1[:n]), B, device=dev)}
        if not (out["dp"]["equal_to_direct_call"]
                and launches["warp_const_batched"] > 0
                and launches["tvl1_iterate_error"] > 0):
            raise AssertionError(f"data-parallel lane: {out['dp']}")

        n0, n1 = (gaussian(t, PRESMOOTHING_SIGMA)
                  for t in normalize_joint(I0[0], I1[0]))
        mesh = make_mesh({"y": 1, "x": 1})
        geom = TileGeom(mesh, ny, nx)
        t0, t1 = spatial_block(n0, mesh), spatial_block(n1, mesh)
        zero = torch.zeros_like(t0)
        (ut, vt, diag), seconds, launches = counted(
            counters, lambda: tvl1_scale_tiled(t0, t1, zero, zero, geom,
                                               TILE_WARP_HALO,
                                               with_diag=True))
        ut, vt = gather_spatial(ut, mesh), gather_spatial(vt, mesh)
        (up, vp, pdiag), pseconds, plaunches = counted(
            counters, lambda: tvl1_scale(n0, n1, zero, zero, with_diag=True))
        out["tiles"] = {
            "shape": [ny, nx], "mesh": {"y": 1, "x": 1},
            "seconds": seconds, "host_reads": diag["host_reads"],
            "iterations": diag["iterations"],
            "tvl1_scale_iterations": pdiag["iterations"].tolist(),
            "tvl1_scale_seconds": pseconds,
            "tvl1_scale_k2_launches": plaunches["tvl1_iterate_error"],
            "launches": launches,
            "epe_vs_tvl1_scale": epe(ut, vt, up, vp)}
        if not (out["tiles"]["iterations"] == out["tiles"]["tvl1_scale_iterations"]
                and out["tiles"]["epe_vs_tvl1_scale"] <= TILE_EPE_TOL
                and bool(torch.isfinite(ut).all())):
            raise AssertionError(f"tile lane: {out['tiles']}")
        out["tvl1_spatial"] = spatial_lane(dev, counters, I0, I1)
        out["robust_expo_spatial"] = robust_expo_lane(dev, counters, I0, I1)
        out["tvl1occflow_spatial"] = occ_lane(dev, counters)
        out["temporal"] = temporal_lane(dev, counters)
    finally:
        dist.destroy_process_group()
    out["note"] = ("no multi-GPU exchange ran: the machine has one card, so "
                   "every lane ran at world size 1 (halo exchanges took "
                   "their fill-only path)")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpuflow_torch import (_build, brox_spatial, brox_spatial_batched,
                               brox_temporal, hs_classic_batched,
                               hs_pyramidal_batched, robust_expo,
                               robust_expo_batched, tvl1_batched, tvl1occflow)
    from tpuflow_torch.data import NX, NY, synth_sequence
    from tpuflow_torch.ops.brox import brox_sor_error
    from tpuflow_torch.ops.brox_terms import brox_terms, expo_terms
    from tpuflow_torch.ops.hs import hs_sor_error
    from tpuflow_torch.ops.hs_classic import hs_classic_fused
    from tpuflow_torch.ops.interp import K5_MIN_PIXELS
    from tpuflow_torch.ops.pyramid import clamp_nscales
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
    from tpuflow_torch.ops.warp import (warp_const_batched,
                                        warp_const_hs_batched,
                                        warp_planes_batched,
                                        warp_planes_shift_batched)

    for var in ("TPUFLOW_EXACT_WARP", "TPUFLOW_WARP_EXACT"):
        if os.environ.get(var):
            raise RuntimeError(f"{var} is set: the Brox paths would not run K5")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    emit(phase="setup", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=time.perf_counter() - t0,
         libs={k: str(v.name) for k, v in libs.items()})
    # in a process that has built its kernels but launched none yet
    emit(phase="warmup", **warmup_check(dev))

    checks = {
        "warp_const_batched": [check_warp(dev, 436, 1024, 8, "tvl1"),
                               check_warp(dev, 7, 16, 3, "tvl1")],
        "tvl1_iterate_error": [check_iterative(dev, 436, 1024, 8, "tvl1"),
                               check_iterative(dev, 7, 16, 3, "tvl1")],
        "warp_const_hs_batched": [check_warp(dev, 436, 1024, 8, "hs"),
                                  check_warp(dev, 55, 128, 3, "hs")],
        # route "tiles" at level 0 and at 109x256 and 218x512, sizes no
        # tile divides; route "level" at 55x128 and 7x16
        "hs_sor_error": [check_iterative(dev, 436, 1024, 8, "hs"),
                         check_iterative(dev, 218, 512, 4, "hs"),
                         check_iterative(dev, 109, 256, 3, "hs"),
                         check_iterative(dev, 55, 128, 3, "hs"),
                         check_iterative(dev, 7, 16, 3, "hs")],
        # niter not a multiple of the kernel's 8 per launch (100, 13), one
        # iteration, and a size no tile divides
        "hs_classic_fused": [check_classic(dev, 436, 1024),
                             check_classic(dev, 55, 128),
                             check_classic(dev, 436, 1024, 13),
                             check_classic(dev, 436, 1024, 1),
                             check_classic(dev, 109, 257)],
        # every level where the Brox paths launch K5 or K5p, and level 0
        # at tvl1occflow's P = 3 without border_out, each with 6 and 3
        # planes a thread; then Brox temporal's levels at B = 8 and
        # tvl1occflow's levels 1-4
        "warp_planes_batched": warp_planes_checks(dev, shift=False)
                               + sequence_warp_checks(dev, shift=False),
        "warp_planes_shift_batched": warp_planes_checks(dev, shift=True)
                                     + sequence_warp_checks(dev, shift=True),
        # route "resident" at the five Brox levels of 1024x436 (B=1),
        # route "stream" at B=2 x 436x1024
        "brox_sor_error": [check_brox_sor(dev, ny, nx, brox_dmax(s))
                           for s, (nx, ny) in enumerate(brox_levels())]
                          + [check_brox_sor(dev, NY, NX, BROX_DMAX0, 2)],
        # every Brox level at B_TIME and B=1, first and later inner
        # iteration
        "brox_terms": check_brox_terms(dev),
        # K10 likewise, bit for bit
        "expo_terms": check_expo_terms(dev),
    }
    for name, c in checks.items():
        emit(phase=f"{name}_vs_plain", checks=c)
    k7_routes = [c["route"] for c in checks["brox_sor_error"]]
    if k7_routes != ["resident"] * 5 + ["stream"]:
        raise AssertionError(f"brox_sor took routes {k7_routes}")
    emit(phase="brox_sor_stream_vs_resident", **check_brox_stream(dev))

    counters = (warp_const_batched, tvl1_iterate_error, warp_const_hs_batched,
                hs_sor_error, warp_planes_batched, warp_planes_shift_batched,
                hs_classic_fused, brox_sor_error, brox_terms, expo_terms)
    paths = {
        "tvl1": main_path(dev, counters, tvl1_batched,
                          (warp_const_batched, tvl1_iterate_error), 0.5,
                          stop="error", with_stats=True),
        # the card gave EPE 0.021 here on an H100; 0.1 leaves room for
        # other cards and CUDA versions, and a broken kernel lands far above
        "hs": main_path(dev, counters, hs_pyramidal_batched,
                        (warp_const_hs_batched, hs_sor_error), 0.1,
                        stop="error", with_stats=True),
        # classic HS has no pyramid: a 2 px flow is beyond its reach, so
        # its EPE against the synthetic flow is reported, not bounded
        "hs_classic": main_path(dev, counters, hs_classic_batched,
                                (hs_classic_fused,), None,
                                niter=CLASSIC_NITER, alpha=CLASSIC_ALPHA),
    }
    # one K8 launch a pyramid level: 7 at 1024x436 (tvl1flow's clamp)
    if paths["tvl1"]["k8_launches"] != clamp_nscales(NX, NY, 0.5, 100):
        raise AssertionError(f"tvl1: K8 not launched once a level: "
                             f"{paths['tvl1']}")
    if paths["hs"]["k8_launches"] != len(paths["hs"]["iterations"]):
        raise AssertionError(f"hs: K8 not launched once a level: "
                             f"{paths['hs']}")
    # the single-pair solvers at the reference CLI defaults: 5 levels at
    # 1024x436 (clamped on min(nx, ny)), 15 outer x 1 inner iterations,
    # one warp launch and one K7 call per outer iteration; the warp is K5
    # on levels of at least 96x96 px (0-2), K5p below (3-4): 45 + 30, 75;
    # Brox spatial's system is K9, one launch per K7 call (75), robust-
    # expo's pair forms its own (K10 is the batched path's)
    levels = brox_levels()
    big = sum(nx * ny >= K5_MIN_PIXELS for nx, ny in levels)
    per_pair = {warp_planes_batched: 15 * big,
                warp_planes_shift_batched: 15 * (len(levels) - big),
                brox_sor_error: 15 * len(levels)}
    per_pair = {"brox_spatial": {**per_pair, brox_terms: 15 * len(levels),
                                 expo_terms: 0},
                "robust_expo": {**per_pair, brox_terms: 0, expo_terms: 0}}
    # and each level's warps with the planes a thread of K5 or K5p warps
    # there
    warp_groups = pair_warp_groups()
    # the card gave EPE 0.0122 (Brox) and 0.0355 (robust-expo) against
    # the synthetic flow on an H100; 0.1 leaves room, as for HS
    paths["brox_spatial"] = pair_main_path(dev, counters, brox_spatial, 0.1,
                                           per_pair["brox_spatial"],
                                           warp_groups)
    paths["robust_expo"] = pair_main_path(dev, counters, robust_expo, 0.1,
                                          per_pair["robust_expo"],
                                          warp_groups, method_type=1)
    # the multi-frame solvers at the reference CLI defaults: Brox
    # temporal on 9 frames (8 fields, 12 levels at zfactor 0.75), TV-L1
    # with occlusions on one triplet (5 levels, 2 warps)
    paths["brox_temporal"] = temporal_main_path(dev, counters)
    paths["tvl1occflow"] = occ_main_path(dev, counters)
    goldens = {
        "hs_pyramidal": golden_epe(hs_pyramidal_batched, dev, "hs_pyramidal"),
        "hs_classic": golden_epe(hs_classic_batched, dev, "hs_classic",
                                 niter=100, alpha=20.0),
        "brox_spatial_s3": pair_golden_epe(brox_spatial, dev, "brox",
                                           "spatial_s3"),
        "robust_expo_gray_m1": pair_golden_epe(robust_expo, dev,
                                               "robust_expo", "gray_m1"),
        **sequence_goldens(dev),
    }
    for name, out in paths.items():
        emit(phase=f"main_path_{name}", **out)
    emit(phase="goldens_epe", **goldens)
    emit(phase="main_path_cli", shape=[NY, NX], seed=SEED0,
         runs=main_path_cli(dev, counters, per_pair,
                            {k: paths[k] for k in ("brox_temporal",
                                                   "tvl1occflow")}))
    # the bounds the JAX package's tests hold its fast warp to
    # (tests/test_brox_temporal.py, tests/test_tvl1occflow.py)
    if not (goldens["hs_pyramidal"] <= 0.05 and goldens["hs_classic"] <= 1e-4
            and goldens["brox_spatial_s3"] <= 0.05
            and goldens["robust_expo_gray_m1"] <= 0.05
            and goldens["brox_temporal_s2"] <= 1e-2
            and goldens["tvl1occ_m3"] <= 0.05
            and goldens["tvl1occ_m3_chi_mean_diff"] < 0.08):
        raise AssertionError(f"solvers disagree with the goldens: {goldens}")
    emit(phase="ops_vs_float64_cpu", shape=[NY, NX], ops=ops_checks(dev))
    emit(phase="dtype_float64_inputs", **dtype_check(dev, counters))
    emit(phase="checkpoint", **checkpoint_check(dev))

    I0, I1 = pairs(B_TIME, NY, NX, dev)
    emit(phase="main_path_brox_spatial_batched",
         **batched_brox_path(dev, counters, I0, I1, brox_spatial_batched,
                             brox_spatial, brox_terms))
    # robust-expo's cell: DF-AUTO, the diffusivity of each sample's own
    # gradient histogram
    paths["robust_expo_batched"] = batched_brox_path(
        dev, counters, I0, I1, robust_expo_batched, robust_expo, expo_terms,
        method_type=3)
    emit(phase="main_path_robust_expo_batched",
         **paths["robust_expo_batched"])
    timings = [
        engine_timing(tvl1_batched, I0, I1, counters, TVL1_GROUPS,
                      stop="error"),
        engine_timing(hs_pyramidal_batched, I0, I1, counters, HS_GROUPS,
                      stop="error"),
        engine_timing(hs_classic_batched, I0, I1, counters, CLASSIC_GROUPS,
                      pyramid=False, niter=CLASSIC_NITER, alpha=CLASSIC_ALPHA),
        pair_timing(brox_spatial, I0[0], I1[0], counters, BROX_GROUPS,
                    levels_via_callback=False),
        pair_timing(robust_expo, I0[0], I1[0], counters, BROX_GROUPS,
                    levels_via_callback=True),
    ]
    for t in timings:
        emit(phase="timing", **t)
    emit(phase="pyramid_vs_plain", **check_pyramid(dev, I0, I1))
    emit(phase="parallel", **parallel_lanes(dev, counters, I0, I1))
    lvl0 = level0_kernels(dev, I0, I1)
    emit(phase="level0_kernels", batch=B_TIME, shape=[NY, NX], **lvl0)
    del I0, I1
    lvl0_pair = level0_brox(dev)
    emit(phase="level0_kernels", batch=1, shape=[NY, NX], **lvl0_pair)
    emit(phase="brox_sor_stream_timing", **levels_brox_stream(dev))
    lvl0.update(lvl0_pair)
    lvl0["brox_terms"] = brox_terms_timing(dev)
    emit(phase="brox_terms_timing", **lvl0["brox_terms"])
    lvl0["expo_terms"] = expo_terms_timing(dev)
    emit(phase="expo_terms_timing", **lvl0["expo_terms"])
    warps = warp_timing(dev)
    emit(phase="warp_planes_timing", **warps)
    lvl0.update(warps)
    # the multi-frame solvers' timing last: a profiled Brox temporal call
    # records about 474,000 kernels, and in a run that timed it before
    # K7's 300-sweep solve the profiler then recorded none of that
    # solve's kernels in three windows
    vol = torch.from_numpy(synth_sequence(TEMPORAL_FRAMES, NY, NX,
                                          seed=SEED0)).to(dev)
    t = solver_timing("brox_temporal",
                      lambda cb: brox_temporal(vol, level_callback=cb),
                      counters, SEQUENCE_GROUPS)
    t["seconds_per_frame_pair"] = t["seconds_per_call"] / (TEMPORAL_FRAMES - 1)
    emit(phase="timing", **t)
    del vol
    triplet = occ_triplet(dev)
    emit(phase="timing", **solver_timing(
        "tvl1occflow", lambda cb: tvl1occflow(*triplet, level_callback=cb),
        counters, SEQUENCE_GROUPS))

    path_of = {"warp_const_batched": "tvl1", "tvl1_iterate_error": "tvl1",
               "warp_const_hs_batched": "hs", "hs_sor_error": "hs",
               "hs_classic_fused": "hs_classic",
               "warp_planes_batched": "brox_spatial",
               "warp_planes_shift_batched": "brox_spatial",
               "brox_sor_error": "brox_spatial", "brox_terms": "brox_spatial",
               "expo_terms": "robust_expo_batched"}
    sources = {
        "warp_const_batched": ("warp_const.cu", "warp_pallas.py:90", "max_abs_err"),
        "tvl1_iterate_error": ("tvl1_iterate.cu", "tvl1_pallas.py:61",
                               "fixed8_max_abs_err"),
        "warp_const_hs_batched": ("warp_const.cu", "warp_pallas.py:90",
                                  "max_abs_err"),
        "hs_sor_error": ("hs_sor.cu", "hs_pallas.py:77", "fixed8_max_abs_err"),
        "hs_classic_fused": ("hs_classic.cu", "hs_classic_pallas.py:27",
                             "max_abs_err"),
        "warp_planes_batched": ("warp_planes.cu", "warp_pallas.py:90",
                                "max_abs_err"),
        "warp_planes_shift_batched": ("warp_planes.cu", "warp_pallas.py:90",
                                      "max_abs_err"),
        "brox_sor_error": ("brox_sor.cu", "brox_pallas.py:50",
                           "fixed8_max_abs_err"),
        # K9 replaces no Pallas kernel: the JAX package leaves the
        # system's assembly to XLA
        "brox_terms": ("brox_terms.cu", None, "max_abs_err"),
        "expo_terms": ("brox_terms.cu", None, "max_abs_err"),
    }
    kernels, below = [], []
    for fn in counters:
        name = fn.__name__
        src, tpu, err_key = sources[name]
        k = lvl0[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpuflow_torch/csrc/{src}",
            "replaces": tpu and f"tpuflow/ops/{tpu}",
            "launches": paths[path_of[name]]["launches"][name],
            "max_abs_err": max(c[err_key] for c in checks[name]
                               if err_key in c),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no single PyTorch call computes any of these functions
            # (grid_sample's bicubic has a = -0.75 and other border rules)
            "library_ms": None})
        if k["ms"] < k["bound_ms"]:
            below.append(name)
        # K5's and K5p's graph readings from device memory at every shape
        below += [f"{name} {c['shape']} {key}"
                  for c in k.get("shapes", []) if "l2_flushed" in c
                  for key, v in c["l2_flushed"].items()
                  if key.endswith("ms") and key != "profiler_ms"
                  and v < c["bound_ms"]]
    emit(phase="wall", seconds=time.perf_counter() - T_START)
    emit(kernels=kernels)
    if below:
        raise AssertionError(f"device times below their bound: {below}")
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
