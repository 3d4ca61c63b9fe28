"""Warm-up: build every kernel and run each solver once.

Counterpart of tpuflow/utils/warmup.py.  There the cost of a cold
process is the compile of each whole-pyramid program, so it
AOT-compiles them in parallel subprocesses into the persistent cache.
Here the kernels are built once per checkout into `build/tpuflow_torch/`
(named by a hash of their sources, so any later process loads them at
once), and what remains for a process is loading them and its first
launches.  `warmup` therefore runs `_build.build_all()` (one `nvcc` per
source, all started together) and then one call per (method, geometry)
in this process, on the card, at the CLI defaults.  A failed build or
call raises: nothing is printed and skipped, since that would hide a
failed kernel.  `timeout` is a wall budget, as the JAX package's is for
its subprocesses: a call in progress runs to its end, and once the
budget is spent the calls not yet started are skipped and reported on
stderr, as the JAX package reports its failed jobs.
"""

import sys
import time

import numpy as np
import torch

from tpuflow_torch import _build
from tpuflow_torch._device import resolve_device
from tpuflow_torch.data import synth_pair, synth_sequence

METHODS = ("tvl1", "hs", "occflow", "robust_expo", "brox_spatial",
           "brox_temporal", "brox_batched")


def _pairs(B, ny, nx):
    I0, I1 = zip(*(synth_pair(ny, nx, seed=b) for b in range(B)))
    return np.stack(I0), np.stack(I1)


def _run(method, B, ny, nx, device):
    """One call of `method` at the CLI defaults on B pairs (tvl1, hs,
    brox_batched), B frames (brox_temporal) or one pair or triplet (the
    others)."""
    import tpuflow_torch as T

    if method == "tvl1":
        return T.tvl1_batched(*_pairs(B, ny, nx), device=device)
    if method == "hs":
        return T.hs_pyramidal_batched(*_pairs(B, ny, nx), device=device)
    if method == "brox_batched":
        return T.brox_spatial_batched(*_pairs(B, ny, nx), device=device)
    if method == "brox_temporal":
        return T.brox_temporal(synth_sequence(B, ny, nx), device=device)
    I0, I1 = synth_pair(ny, nx)
    if method == "occflow":
        return T.tvl1occflow(np.roll(I0, 1, axis=1), I0, I1, device=device)
    if method == "robust_expo":
        return T.robust_expo(I0, I1, device=device)
    if method == "brox_spatial":
        return T.brox_spatial(I0, I1, device=device)
    raise ValueError(f"unknown method {method!r}; one of {METHODS}")


def warmup(geometries=((16, 436, 1024),), methods=("tvl1", "hs"),
           timeout=600, verbose=False, device=None):
    """Build the kernels and run each of `methods` once per (B, H, W)
    geometry; returns the wall seconds spent.

    methods: any of "tvl1", "hs" and "brox_batched" (the batched
    engines, B pairs), "occflow", "robust_expo" and "brox_spatial" (one
    pair or triplet, B ignored) and "brox_temporal" (the geometry's B
    slot is the FRAME count).  `timeout`: the wall seconds after which
    no further call starts; each skipped (method, B, H, W) job is
    printed on stderr, then their count, and nothing raises.  `device`
    defaults to the card; with no card the call raises.  `verbose`
    prints each call's seconds.

        import tpuflow_torch
        tpuflow_torch.warmup([(16, 436, 1024), (1, 436, 1024)])
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    for method in methods:
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if dev.type == "cuda":
        _build.build_all()
    jobs = [(method, int(B), int(ny), int(nx))
            for method in methods for B, ny, nx in geometries]
    skipped = 0
    for job in jobs:
        if time.perf_counter() - t0 >= timeout:
            skipped += 1
            print(f"warmup: job {job} skipped: the timeout of {timeout} s "
                  "was spent", file=sys.stderr)
            continue
        t = time.perf_counter()
        out = _run(*job, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if verbose:
            print(f"warmup: {job[0]} {job[1:]} "
                  f"{time.perf_counter() - t:.3f} s", flush=True)
        del out
    if skipped:
        print(f"warmup: {skipped}/{len(jobs)} jobs skipped (timeout "
              f"{timeout} s)", file=sys.stderr)
    return time.perf_counter() - t0
