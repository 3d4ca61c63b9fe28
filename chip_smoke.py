#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py      # from the root of a checkout; needs one card

Builds tpuflow_torch/csrc/*.cu with nvcc (sm_90a) into build/tpuflow_torch/,
then runs these phases, each printing one JSON line:

  1. card, torch and CUDA versions, and the kernels' build time;
  2. K1 (warp_const) against its plain version at the level-0 shape
     (B=4, 436x1024, dmax=8, synth_pair's flow) and the coarsest (7x16);
  3. K2 (tvl1_iterate) against its plain version at the same shapes:
     8 fixed iterations, then stop="error" (n equal or off by one);
  4. the main path, `tvl1_batched` on 4 pairs at 1024x436,
     stop="error": kernels against plain versions (both on the card),
     the kernels' launch counts in that run, and the flow against the
     pairs' synthetic ground truth;
  5. timing at the benchmark geometry, B=128: fields/s over 3 reps after
     one warm call, peak device memory, where one call's time goes (per
     pyramid level, and by kernel under torch.profiler), and each
     kernel's time per launch at level 0 against its bound and its
     plain version.

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

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# f32 operations per pixel, counted from the CUDA sources: K1 for one
# in-domain pixel (two Keys weight sets, 16 tap weights, 48 tap FMAs,
# the constants); K2 for one iteration (primal + dual)
K1_FLOPS_PX = 170
K2_FLOPS_PX = 60
K1_PLANES = 6 + 4   # reads I1, I1x, I1y, u, v, I0; writes 4 constants
K2_PLANES = 10 + 6  # reads 6 state + 4 constant planes; writes 6 state
B_CHECK, B_TIME = 4, 128
SEED0 = 100


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


def kernel_inputs(I0, I1, dev, dmax):
    """(planes, state, aux, const) of K1 and K2 for raw pairs: I1 with
    its centred gradient, the pairs' synthetic flow, I0, and the
    constants that flow gives."""
    from tpuflow_torch.data import synth_flow
    from tpuflow_torch.ops.gradients import centered_gradient
    from tpuflow_torch.ops.warp import warp_const_plain

    B, ny, nx = I0.shape
    planes = torch.stack([I1, *centered_gradient(I1)], dim=1).contiguous()
    u, v = (torch.as_tensor(f, dtype=torch.float32, device=dev)
            for f in synth_flow(ny, nx))
    state = torch.zeros((B, 6, ny, nx), device=dev)
    state[:, 0] = -u  # the flow that takes I0 to I1 (synth_pair warps by +u)
    state[:, 1] = -v
    const, _ = warp_const_plain(planes, state[:, :2], I0, dmax)
    return planes, state, I0.contiguous(), const


def check_k1(dev, ny, nx, dmax):
    from tpuflow_torch.ops.warp import warp_const_batched, warp_const_plain

    planes, state, aux, _ = kernel_inputs(*pairs(B_CHECK, ny, nx, dev), dev,
                                          dmax)
    got, oflow = warp_const_batched(planes, state[:, :2], aux, dmax)
    ref, _ = warp_const_plain(planes, state[:, :2], aux, dmax)
    torch.cuda.synchronize()
    err = (got - ref).abs().amax(dim=(0, 2, 3))
    scale = ref.abs().amax(dim=(0, 2, 3)).clamp(min=1.0)
    rel = float((err / scale).max())
    out = {"shape": [B_CHECK, ny, nx], "dmax": dmax,
           "max_abs_err": float(err.max()), "max_rel_err": rel,
           "in_domain": float((ref[:, 3] > 0).float().mean()),
           "overflow": oflow}
    # f32 sums of 16 taps, contracted to FMAs on the card: a few ulp of
    # each plane's largest value
    if not rel <= 1e-5 or oflow != 0:
        raise AssertionError(f"K1 disagrees with its plain version: {out}")
    return out


def check_k2(dev, ny, nx, dmax):
    from tpuflow_torch.ops.tvl1 import (tvl1_iterate_error,
                                        tvl1_iterate_error_plain)

    from tpuflow_torch.ops.warp import warp_const_plain

    planes, state, aux, const = kernel_inputs(*pairs(B_CHECK, ny, nx, dev),
                                              dev, dmax)
    l_t, theta, taut = 0.15 * 0.3, 0.3, 0.25 / 0.3
    out = {"shape": [B_CHECK, ny, nx]}
    # fixed count: the same 8 iterations on both sides
    got, _, n = tvl1_iterate_error(state.clone(), const, -1.0, 8, l_t, theta,
                                   taut)
    ref, _, n_ref = tvl1_iterate_error_plain(state.clone(), const, -1.0, 8,
                                             l_t, theta, taut)
    torch.cuda.synchronize()
    out["fixed8_max_abs_err"] = float((got - ref).abs().max())
    if not (out["fixed8_max_abs_err"] <= 2e-4 and n.tolist() == [8] * B_CHECK
            and n_ref.tolist() == [8] * B_CHECK):
        raise AssertionError(f"K2 (8 iterations) disagrees: {out}")
    # stop="error" at the main path's threshold, from a zero flow (a
    # level's first warp, its longest fixed point): the kernel sums err
    # in another order, so where err lands next to thresh n may move by one
    state.zero_()
    const, _ = warp_const_plain(planes, state[:, :2], aux, dmax)
    thresh = float(np.float32(1e-4) * np.float32(ny * nx))
    got, err, n = tvl1_iterate_error(state.clone(), const, thresh, 300, l_t,
                                     theta, taut)
    ref, err_ref, n_ref = tvl1_iterate_error_plain(state.clone(), const,
                                                   thresh, 300, l_t, theta,
                                                   taut)
    out.update(n=n.tolist(), n_plain=n_ref.tolist(), err=err.tolist(),
               err_plain=err_ref.tolist())
    same = n == n_ref
    out["error_max_abs_err_where_n_equal"] = (
        float((got - ref)[same].abs().max()) if bool(same.any()) else None)
    if not bool(((n - n_ref).abs() <= 1).all()):
        raise AssertionError(f"K2 stopping counts differ by more than 1: {out}")
    return out


@contextlib.contextmanager
def plain_versions():
    """Run the engine through the kernels' plain versions (on whatever
    device the tensors lie on) inside the block."""
    import tpuflow_torch.models.batch as engine
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error_plain
    from tpuflow_torch.ops.warp import warp_const_plain

    saved = engine.warp_const_batched, engine.tvl1_iterate_error
    engine.warp_const_batched = warp_const_plain
    engine.tvl1_iterate_error = tvl1_iterate_error_plain
    try:
        yield
    finally:
        engine.warp_const_batched, engine.tvl1_iterate_error = saved


def epe(u, v, ru, rv):
    """Mean endpoint error per sample."""
    return torch.hypot(u - ru, v - rv).mean(dim=(-2, -1)).tolist()


def main_path(dev, counters):
    from tpuflow_torch import tvl1_batched
    from tpuflow_torch.data import NX, NY, synth_flow

    I0, I1 = pairs(B_CHECK, NY, NX, dev)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, v, stats = tvl1_batched(I0, I1, stop="error", with_stats=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    with plain_versions():
        pu, pv = tvl1_batched(I0, I1, stop="error")
    if tuple(u.shape) != (B_CHECK, NY, NX) or not bool(
            torch.isfinite(u).all() and torch.isfinite(v).all()):
        raise AssertionError("main path: flow of the wrong shape or not finite")
    tu, tv = (torch.as_tensor(f, dtype=torch.float32, device=dev)
              for f in synth_flow(NY, NX))
    out = {"shape": [B_CHECK, NY, NX], "seconds": seconds,
           "launches": launches,
           "epe_kernels_vs_plain": epe(u, v, pu, pv),
           "epe_vs_synthetic_flow": epe(u, v, -tu, -tv),
           "iterations": {str(s): w for s, w in
                          sorted(stats["iterations"].items())}}
    if not all(e <= 0.01 for e in out["epe_kernels_vs_plain"]):
        raise AssertionError(f"main path: kernels vs plain EPE > 0.01: {out}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"main path did not launch every kernel: {out}")
    if not all(e <= 0.5 for e in out["epe_vs_synthetic_flow"]):
        raise AssertionError(f"main path: flow far from the truth: {out}")
    return out


def timing(dev, counters):
    from tpuflow_torch import tvl1_batched
    from tpuflow_torch.data import NX, NY
    from tpuflow_torch.ops.tvl1 import (tvl1_iterate_error,
                                        tvl1_iterate_error_plain)
    from tpuflow_torch.ops.warp import warp_const_batched, warp_const_plain

    I0, I1 = pairs(B_TIME, NY, NX, dev)
    tvl1_batched(I0, I1, stop="error")  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        tvl1_batched(I0, I1, stop="error")
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per_call = {c.__name__: c.launches / len(reps) for c in counters}
    where = breakdown(tvl1_batched, I0, I1)

    # each kernel alone at level 0 of the same batch
    planes, state, aux, const = kernel_inputs(I0, I1, dev, 8)
    del I0, I1
    px = B_TIME * NY * NX
    l_t, theta, taut = 0.15 * 0.3, 0.3, 0.25 / 0.3
    uv = state[:, :2]
    k1 = {"ms": time_ms(lambda: warp_const_batched(planes, uv, aux, 8), 20),
          "plain_ms": time_ms(lambda: warp_const_plain(planes, uv, aux, 8), 3)}
    k1["bound_ms"], k1["bound_by"] = bound_ms(px, K1_PLANES, K1_FLOPS_PX)
    # K2's unit of work: one wrapper call of one fixed iteration
    k2 = {"ms": time_ms(lambda: tvl1_iterate_error(
              state, const, -1.0, 1, l_t, theta, taut), 20),
          "plain_ms": time_ms(lambda: tvl1_iterate_error_plain(
              state, const, -1.0, 1, l_t, theta, taut), 3),
          "ms_per_iteration_in_16": time_ms(lambda: tvl1_iterate_error(
              state, const, -1.0, 16, l_t, theta, taut), 5) / 16}
    k2["bound_ms"], k2["bound_by"] = bound_ms(px, K2_PLANES, K2_FLOPS_PX)
    return {"batch": B_TIME, "shape": [NY, NX],
            "fields_per_s": B_TIME * len(reps) / sum(reps),
            "rep_s": reps, "launches_per_call": per_call,
            "max_memory_allocated_bytes": peak, "breakdown": where,
            "level0_warp_const": k1, "level0_tvl1_iterate": k2}


# device kernels grouped by the part of the engine that launches them
KERNEL_GROUPS = (("warp_const", "warp_const"), ("tvl1_primal", "tvl1_iterate"),
                 ("tvl1_dual", "tvl1_iterate"), ("tvl1_finalize", "tvl1_iterate"),
                 ("gemm", "zoom matmul"))


def breakdown(tvl1_batched, I0, I1):
    """Where one call spends its time: host-clock seconds up to the end
    of each pyramid level (synchronised in the level callback; the first
    interval also holds normalisation and the pyramid build), then one
    call under torch.profiler: device time by kernel group, the top
    kernels, and the card's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = []

    def mark(scale, state):
        torch.cuda.synchronize()
        marks.append((scale, time.perf_counter()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tvl1_batched(I0, I1, stop="error", level_callback=mark)
    starts = [t0] + [t for _, t in marks[:-1]]
    levels_s = {str(s): t - t_prev for (s, t), t_prev in zip(marks, starts)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tvl1_batched(I0, I1, stop="error")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    groups = {}
    for name, ms, count in kernels:
        group = next((g for key, g in KERNEL_GROUPS if key in name), "other")
        ms_sum, n_sum = groups.get(group, (0.0, 0))
        groups[group] = (ms_sum + ms, n_sum + count)
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"seconds_to_level_end": levels_s, "profiled_wall_ms": 1e3 * wall,
            "device_busy_ms": busy_ms if kernels else None,
            "device_idle_share": 1 - busy_ms / (1e3 * wall) if kernels else None,
            "groups_ms_launches": groups,
            "top_kernels_ms_launches": [(n[:90], ms, c) for n, ms, c in top]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpuflow_torch import _build
    from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
    from tpuflow_torch.ops.warp import warp_const_batched

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

    k1 = [check_k1(dev, 436, 1024, 8), check_k1(dev, 7, 16, 3)]
    emit(phase="warp_const_vs_plain", checks=k1)
    k2 = [check_k2(dev, 436, 1024, 8), check_k2(dev, 7, 16, 3)]
    emit(phase="tvl1_iterate_vs_plain", checks=k2)

    counters = (warp_const_batched, tvl1_iterate_error)
    main = main_path(dev, counters)
    emit(phase="main_path", **main)
    t = timing(dev, counters)
    emit(phase="timing", **t)

    kernels = []
    for fn, src, tpu, checks, err_key, lvl0 in (
            (warp_const_batched, "tpuflow_torch/csrc/warp_const.cu",
             "tpuflow/ops/warp_pallas.py:90", k1, "max_abs_err",
             t["level0_warp_const"]),
            (tvl1_iterate_error, "tpuflow_torch/csrc/tvl1_iterate.cu",
             "tpuflow/ops/tvl1_pallas.py:61", k2, "fixed8_max_abs_err",
             t["level0_tvl1_iterate"])):
        kernels.append({
            "name": fn.__name__, "route": "cuda", "source": src,
            "replaces": tpu, "launches": main["launches"][fn.__name__],
            "max_abs_err": max(c[err_key] for c in checks),
            "ms": lvl0["ms"], "plain_ms": lvl0["plain_ms"],
            "bound_ms": lvl0["bound_ms"], "bound_by": lvl0["bound_by"],
            # no single PyTorch call computes either function
            "library_ms": None})
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
