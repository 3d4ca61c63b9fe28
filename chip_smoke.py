#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py      # from the root of a checkout; needs one card

Builds tpuflow_torch/csrc/*.cu with nvcc (sm_90a) into build/tpuflow_torch/,
then runs these phases, each printing one JSON line:

  1. card, torch and CUDA versions, and the kernels' build time;
  2. each kernel against its plain version, at the level-0 shape
     (B=4, 436x1024, synth_pair's flow) and a small level:
     K1 (warp_const) and K2 (tvl1_iterate) at 7x16; K3 (warp_const_hs),
     K4 (hs_sor) and K6 (hs_classic) at 55x128, whose odd height puts
     the last row at the even parity.  The iterative kernels run a
     fixed count (K2, K4: 8; K6: 100), then K2 and K4 stop="error"
     from a zero flow (n equal or off by one);
  3. the three main paths on 4 pairs at 1024x436, each run with every
     launch count set to 0 just before it and read just after:
     `tvl1_batched` and `hs_pyramidal_batched` (stop="error") and
     `hs_classic_batched` (100 iterations, alpha 7), kernels against
     plain versions (both on the card), the flow against the pairs'
     synthetic ground truth, and the two HS engines against the
     reference binary's goldens (tests/goldens/solvers.npz);
  4. timing at the benchmark geometry, B=128, for each engine: fields/s
     over 3 reps after one warm call, peak device memory, where one
     call's time goes (per pyramid level, and by kernel under
     torch.profiler), and each kernel's time at level 0 against its
     bound and its plain version.

Then the {"kernels": [...]} line, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}.  Every
check raises on failure, so any failed phase exits non-zero.  Without a
card, or outside a checkout, it exits non-zero and prints no result.
"""

import contextlib
import json
import subprocess
import sys
import time
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
K1_PLANES = 6 + 4   # reads I1, I1x, I1y, u, v, I0; writes 4 constants
K2_PLANES = 10 + 6  # reads 6 state + 4 constant planes; writes 6 state
K3_PLANES = 6 + 5   # reads I2, I2x, I2y, u, v, I1; writes 5 constants
K4_PLANES = 7 + 2   # reads u, v + 5 constant planes; writes u, v
K6_PLANES = 3 + 2   # one call reads Ex, Ey, Et; writes u, v
B_CHECK, B_TIME = 4, 128
SEED0 = 100
# TV-L1 (l_t, theta, taut) at the CLI defaults; HS and classic alpha
TVL1_PARAMS = (0.15 * 0.3, 0.3, 0.25 / 0.3)
HS_ALPHA2 = 7.0 * 7.0
CLASSIC_NITER, CLASSIC_ALPHA = 100, 7.0  # tools/bench_all7.py:83
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens" / "solvers.npz"


def emit(**fields):
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
    from tpuflow_torch.ops.warp import warp_const_batched, warp_const_plain

    planes, state, aux, _ = kernel_inputs(*pairs(B_CHECK, ny, nx, dev), dev,
                                          dmax, mode)
    uv = state[:, :2]
    got, oflow = warp_const_batched(planes, uv, aux, dmax, mode, HS_ALPHA2)
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


def check_classic(dev, ny, nx):
    """K6 against its plain version, 100 iterations from zero flow."""
    from tpuflow_torch.models.hs_classic import _input_derivatives
    from tpuflow_torch.ops.hs_classic import (hs_classic_fused,
                                              hs_classic_fused_plain)

    d = _input_derivatives(*pairs(B_CHECK, ny, nx, dev))
    got = torch.stack(hs_classic_fused(*d, CLASSIC_ALPHA, CLASSIC_NITER), 1)
    ref = torch.stack(hs_classic_fused_plain(*d, CLASSIC_ALPHA, CLASSIC_NITER), 1)
    torch.cuda.synchronize()
    out = {"shape": [B_CHECK, ny, nx], "niter": CLASSIC_NITER,
           "max_abs_err": float((got - ref).abs().max())}
    # f32 Jacobi, FMA-contracted on the card, on flows of about 3 px
    if not out["max_abs_err"] <= 1e-4:
        raise AssertionError(f"hs_classic disagrees with its plain version: {out}")
    return out


def _warp_hs_plain(planes, uv, aux, dmax, alpha2):
    from tpuflow_torch.ops.warp import warp_const_plain

    return warp_const_plain(planes, uv, aux, dmax, "hs", alpha2)


@contextlib.contextmanager
def plain_versions():
    """Run the engines through the kernels' plain versions (on whatever
    device the tensors lie on) inside the block."""
    import tpuflow_torch.models.batch as batch
    import tpuflow_torch.models.hs_classic as classic
    from tpuflow_torch.ops.hs import hs_sor_error_plain
    from tpuflow_torch.ops.hs_classic import hs_classic_fused_plain
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error_plain
    from tpuflow_torch.ops.warp import warp_const_plain

    swaps = [(batch, "warp_const_batched", warp_const_plain),
             (batch, "tvl1_iterate_error", tvl1_iterate_error_plain),
             (batch, "warp_const_hs_batched", _warp_hs_plain),
             (batch, "hs_sor_error", hs_sor_error_plain),
             (classic, "hs_classic_fused", hs_classic_fused_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def epe(u, v, ru, rv):
    """Mean endpoint error per sample."""
    return torch.hypot(u - ru, v - rv).mean(dim=(-2, -1)).tolist()


def counted(counters, fn):
    """Run fn() with every launch count set to 0 just before it; returns
    (fn's result, seconds, {wrapper: launches in that run})."""
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, seconds, {c.__name__: c.launches for c in counters}


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
    with plain_versions():
        pu, pv, *_ = engine(I0, I1, **{k: a for k, a in kw.items()
                                       if k != "with_stats"})
    if tuple(u.shape) != (B_CHECK, NY, NX) or not bool(
            torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("main path: flow of the wrong shape or not finite")
    tu, tv = (torch.as_tensor(f, dtype=torch.float32, device=dev)
              for f in synth_flow(NY, NX))
    out = {"engine": engine.__name__, "shape": [B_CHECK, NY, NX],
           "seconds": seconds, "launches": launches,
           "epe_kernels_vs_plain": epe(u, v, pu, pv),
           "epe_vs_synthetic_flow": epe(u, v, -tu, -tv)}
    if stats:
        out["iterations"] = {str(s): w for s, w in
                             sorted(stats[0]["iterations"].items())}
    if not all(e <= 0.01 for e in out["epe_kernels_vs_plain"]):
        raise AssertionError(f"main path: kernels vs plain EPE > 0.01: {out}")
    if not all(launches[k.__name__] > 0 for k in kernels_used):
        raise AssertionError(f"main path did not launch every kernel: {out}")
    if synth_bound is not None and not all(
            e <= synth_bound for e in out["epe_vs_synthetic_flow"]):
        raise AssertionError(f"main path: flow far from the truth: {out}")
    return out


# device kernels grouped by the part of an engine that launches them
TVL1_GROUPS = (("warp_const", "K1 warp_const"), ("tvl1_primal", "K2 tvl1_iterate"),
               ("tvl1_dual", "K2 tvl1_iterate"), ("stop_finalize", "K2 tvl1_iterate"),
               ("gemm", "zoom matmul"))
HS_GROUPS = (("warp_const", "K3 warp_const_hs"), ("hs_sor_color", "K4 hs_sor"),
             ("stop_finalize", "K4 hs_sor"), ("gemm", "zoom matmul"))
CLASSIC_GROUPS = (("hs_classic_iteration", "K6 hs_classic"),)


def breakdown(run, groups, levels=True):
    """Where one call of `run(level_callback)` spends its time:
    host-clock seconds up to the end of each pyramid level (synchronised
    in the level callback; the first interval also holds normalisation
    and the pyramid build), then one call under torch.profiler: device
    time by kernel group, the top kernels, and the card's busy share of
    the call's wall time."""
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
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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
    else:
        engine(I0, I1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine(I0, I1, **kw)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per_call = {c.__name__: c.launches / len(reps) for c in counters}
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpuflow_torch import (_build, hs_classic_batched,
                               hs_pyramidal_batched, tvl1_batched)
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.ops.hs import hs_sor_error
    from tpuflow_torch.ops.hs_classic import hs_classic_fused
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
    from tpuflow_torch.ops.warp import warp_const_batched, warp_const_hs_batched

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

    checks = {
        "warp_const_batched": [check_warp(dev, 436, 1024, 8, "tvl1"),
                               check_warp(dev, 7, 16, 3, "tvl1")],
        "tvl1_iterate_error": [check_iterative(dev, 436, 1024, 8, "tvl1"),
                               check_iterative(dev, 7, 16, 3, "tvl1")],
        "warp_const_hs_batched": [check_warp(dev, 436, 1024, 8, "hs"),
                                  check_warp(dev, 55, 128, 3, "hs")],
        "hs_sor_error": [check_iterative(dev, 436, 1024, 8, "hs"),
                         check_iterative(dev, 55, 128, 3, "hs")],
        "hs_classic_fused": [check_classic(dev, 436, 1024),
                             check_classic(dev, 55, 128)],
    }
    for name, c in checks.items():
        emit(phase=f"{name}_vs_plain", checks=c)

    counters = (warp_const_batched, tvl1_iterate_error, warp_const_hs_batched,
                hs_sor_error, hs_classic_fused)
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
    goldens = {
        "hs_pyramidal": golden_epe(hs_pyramidal_batched, dev, "hs_pyramidal"),
        "hs_classic": golden_epe(hs_classic_batched, dev, "hs_classic",
                                 niter=100, alpha=20.0),
    }
    for name, out in paths.items():
        emit(phase=f"main_path_{name}", **out)
    emit(phase="goldens_epe", **goldens)
    if not (goldens["hs_pyramidal"] <= 0.05 and goldens["hs_classic"] <= 1e-4):
        raise AssertionError(f"engines disagree with the goldens: {goldens}")

    I0, I1 = pairs(B_TIME, NY, NX, dev)
    timings = [
        engine_timing(tvl1_batched, I0, I1, counters, TVL1_GROUPS,
                      stop="error"),
        engine_timing(hs_pyramidal_batched, I0, I1, counters, HS_GROUPS,
                      stop="error"),
        engine_timing(hs_classic_batched, I0, I1, counters, CLASSIC_GROUPS,
                      pyramid=False, niter=CLASSIC_NITER, alpha=CLASSIC_ALPHA),
    ]
    for t in timings:
        emit(phase="timing", **t)
    lvl0 = level0_kernels(dev, I0, I1)
    emit(phase="level0_kernels", batch=B_TIME, shape=[NY, NX], **lvl0)

    path_of = {"warp_const_batched": "tvl1", "tvl1_iterate_error": "tvl1",
               "warp_const_hs_batched": "hs", "hs_sor_error": "hs",
               "hs_classic_fused": "hs_classic"}
    sources = {
        "warp_const_batched": ("warp_const.cu", "warp_pallas.py:90", "max_abs_err"),
        "tvl1_iterate_error": ("tvl1_iterate.cu", "tvl1_pallas.py:61",
                               "fixed8_max_abs_err"),
        "warp_const_hs_batched": ("warp_const.cu", "warp_pallas.py:90",
                                  "max_abs_err"),
        "hs_sor_error": ("hs_sor.cu", "hs_pallas.py:77", "fixed8_max_abs_err"),
        "hs_classic_fused": ("hs_classic.cu", "hs_classic_pallas.py:27",
                             "max_abs_err"),
    }
    kernels = []
    for fn in counters:
        name = fn.__name__
        src, tpu, err_key = sources[name]
        k = lvl0[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpuflow_torch/csrc/{src}",
            "replaces": f"tpuflow/ops/{tpu}",
            "launches": paths[path_of[name]]["launches"][name],
            "max_abs_err": max(c[err_key] for c in checks[name]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None})
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
