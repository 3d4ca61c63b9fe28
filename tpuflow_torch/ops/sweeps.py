"""Host side of the iterative kernels' per-sample stopping, where the
stop is read on the host: K2 (csrc/tvl1_iterate.cu), K4's route "tiles"
(ops/hs.py) and K7's route "stream" (ops/brox.py).  K4's route "level"
and K7's route "resident" test the stop on the device and need none of
this.

K2 and K7 each export two C entry points: `<run>(state, const, partial,
partial_len, err, n, active, B, ny, nx, thresh, max_iter, <scalars>,
count, stream)`, which launches `count` iterations or sweeps, each
ending in common.cuh's `stop_finalize`, and `<partial_len>(B, ny, nx)`,
the length of their scratch; `run_until_stopped` drives them.
`launch_until_stopped` is the loop it shares with K4's route "tiles": it
launches CHECK_EVERY iterations at a time and reads the per-sample
`active` flags on the host between launches, so a solve ends at most
CHECK_EVERY - 1 iterations after its last sample stopped (those launches
return at once for inactive samples).  The loop is a span `solve`, each
read a span `host_read` counted in `host_reads`
(tpuflow_torch.utils.trace).
"""

import torch

from tpuflow_torch import _build
from tpuflow_torch._device import check_dtype
from tpuflow_torch.utils.trace import count, span

# iterations or sweeps launched between two host reads of `active`
CHECK_EVERY = 16


def check_state_const(state, const, n_state, n_const):
    """Raise unless state is (B, n_state, ny, nx) and const (B, n_const,
    ny, nx), both of one dtype (float32 on the card; float32 or float64
    on the CPU), contiguous and on one device."""
    if state.ndim != 4 or state.shape[1] != n_state:
        raise ValueError(f"state must be (B, {n_state}, ny, nx), got "
                         f"{tuple(state.shape)}")
    B, _, ny, nx = state.shape
    if tuple(const.shape) != (B, n_const, ny, nx):
        raise ValueError(f"const must be {(B, n_const, ny, nx)}, got "
                         f"{tuple(const.shape)}")
    for name, t in (("state", state), ("const", const)):
        check_dtype(name, t, state)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if const.device != state.device:
        raise ValueError(f"const is on {const.device}, state on {state.device}")


def run_until_stopped(calls, kernel, library, signatures, run, partial_len,
                      state, const, thresh, max_iter, scalars):
    """Run kernel library `library`'s entry point `run` on CUDA tensors
    until every sample stopped (err <= thresh) or ran max_iter
    iterations, counting the call in `calls.<calls>` and each launch's
    iterations in `iters.<kernel>`; `scalars` are the kernel's float
    parameters.  Updates `state` in place and returns (state, err (B,)
    float32, n (B,) int32)."""
    B, _, ny, nx = state.shape
    dev = state.device
    err = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    n = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.full((B,), int(max_iter > 0), dtype=torch.int32,
                        device=dev)
    if state.numel() == 0 or max_iter <= 0:
        return state, err, n
    lib = _build.load(library, signatures)
    partial = torch.empty(getattr(lib, partial_len)(B, ny, nx),
                          dtype=torch.float32, device=dev)
    entry = getattr(lib, run)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        count(f"calls.{calls}")

        def launch(iters):
            status = entry(state.data_ptr(), const.data_ptr(),
                           partial.data_ptr(), partial.numel(), err.data_ptr(),
                           n.data_ptr(), active.data_ptr(), B, ny, nx,
                           float(thresh), int(max_iter),
                           *(float(s) for s in scalars), iters, stream)
            count(f"iters.{kernel}", iters)
            _build.check(status, run)

        launch_until_stopped(launch, active, max_iter)
    return state, err, n


def launch_until_stopped(launch, active, max_iter):
    """Call launch(count) for CHECK_EVERY iterations at a time, up to
    max_iter in all, until the device flags `active` are all 0."""
    done = 0
    with span("solve"):
        while done < max_iter:
            chunk = min(CHECK_EVERY, max_iter - done)
            launch(chunk)
            done += chunk
            if done < max_iter:
                with span("host_read"):
                    count("host_reads")
                    if not bool(active.any()):
                        break
