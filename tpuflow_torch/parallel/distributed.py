"""Process-group entry point and data-parallel scaling helpers.

Counterpart of tpuflow/parallel/distributed.py.  PyTorch runs one
process per device: every process calls `initialize(...)` (a thin
wrapper over `torch.distributed.init_process_group`, NCCL for the card
and gloo for the CPU, a no-op for one process with no coordinator),
builds the same mesh (tpuflow_torch.parallel.mesh.make_mesh), and takes
its block of each batch (`dp_shard`).  Each frame pair's solve is
independent, so a data-parallel run moves no data between ranks but the
final gather; `dp_efficiency` measures how far the throughput of n
ranks falls short of n times one rank's.
"""

import time

import torch
import torch.distributed as dist

from tpuflow_torch._device import resolve_device
from tpuflow_torch.parallel.mesh import batch_block, block


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None):
    """Join the process group: call once per process before any
    collective.  Returns True if a group was initialised.

    A no-op (False) for a single process with no coordinator, as the
    JAX package's.  `coordinator_address` is "host:port" (a TCP
    rendezvous) or an init-method URL ("tcp://...", "file://...").
    The backend is NCCL on the card (the default; this process takes
    device `process_id` modulo the device count unless `device` names
    one) and gloo for device="cpu".  NCCL that cannot initialise raises:
    nothing falls back to gloo."""
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    dev = resolve_device(device)
    rank = int(process_id or 0)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes or 1), rank=rank)
    return True


def dp_shard(tensors, mesh, axis="batch", device=None):
    """This rank's block of each global (B, ...) tensor or array, split
    over mesh dimension `axis`, on `device` (default: the card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return tuple(batch_block(torch.as_tensor(t), mesh, axis).to(dev)
                 for t in tensors)


def _elapsed(step, args, repeats, dev):
    """Seconds per call of step(*args) after one warm call: CUDA events
    on the card, the host clock on the CPU."""
    step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            step(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        step(*args)
    return (time.perf_counter() - t0) / repeats


def dp_efficiency(step, make_batch, per_device_batch, repeats=3, device=None):
    """Data-parallel scaling of `step`, called on every rank.

    step(I0, I1) runs one batch; make_batch(B) -> (I0, I1) global host
    arrays (the same on every rank).  For n = 1, 2, 4, ... up to the
    world size the first n ranks each run their block of
    a batch of per_device_batch * n; a rank's time per call comes from
    CUDA events on the card, the slowest rank's time is the wall time.
    Returns {n: {"fields_per_sec", "efficiency", "seconds"}} on every
    rank, efficiency relative to n times the one-rank throughput."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    results = {}
    base_fps = None
    n = 1
    while n <= world:
        B = per_device_batch * n
        dt = torch.zeros((), dtype=torch.float64, device=dev)
        if rank < n:
            args = tuple(block(torch.as_tensor(a), rank, n, 0).to(dev)
                         for a in make_batch(B))
            dt.fill_(_elapsed(step, args, repeats, dev))
        if world > 1:
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        seconds = float(dt)
        fps = B / seconds
        if base_fps is None:
            base_fps = fps
        results[n] = {"fields_per_sec": fps,
                      "efficiency": fps / (base_fps * n),
                      "seconds": seconds}
        n *= 2
    return results
