"""Host side of the iterative kernels' per-sample stopping, where the
stop is read on the host: K2 (csrc/tvl1_iterate.cu), K4's route "tiles"
(ops/hs.py) and K7's route "stream" (ops/brox.py).  K4's route "level"
and K7's route "resident" test the stop on the device and need none of
this.

K2 exports two C entry points: `<run>(state, const, partial,
partial_len, err, n, active, B, ny, nx, thresh, max_iter, <scalars>,
count, stream)`, which launches `count` iterations, each ending in
common.cuh's `stop_finalize`, and `<partial_len>(B, ny, nx)`, the length
of its scratch; `run_until_stopped` drives them.  `launch_until_stopped`
is the loop it shares with K4's route "tiles" and K7's route "stream"
(ops/brox.py): it launches CHECK_EVERY iterations at a time and reads
the per-sample `active` flags on the host between launches, so a solve
ends at most CHECK_EVERY - 1 iterations after its last sample stopped
(those launches return at once for inactive samples).  The loop is a span `solve`, each
read a span `host_read` counted in `host_reads`
(tpuflow_torch.utils.trace).  `unsolved` is every card route's result
before its first sweep (K7's route "resident" and K4's routes too).
"""

import torch

from tpuflow_torch import _build
from tpuflow_torch.utils.trace import count, span

# iterations or sweeps launched between two host reads of `active`
CHECK_EVERY = 16


def unsolved(state):
    """(state, err, n) of a solve before its first sweep: err = inf (B,)
    float32 and n = 0 (B,) int32 on state's device, which the kernels
    update in place.  It is the result of a solve with nothing to run (an
    empty system, or max_iter <= 0)."""
    B, dev = state.shape[0], state.device
    return (state,
            torch.full((B,), float("inf"), dtype=torch.float32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev))


def run_until_stopped(calls, kernel, library, signatures, run, partial_len,
                      state, const, thresh, max_iter, scalars):
    """Run kernel library `library`'s entry point `run` on CUDA tensors
    until every sample stopped (err <= thresh) or ran max_iter
    iterations, counting the call in `calls.<calls>` and each launch's
    iterations in `iters.<kernel>`; `scalars` are the kernel's float
    parameters.  Updates `state` in place and returns (state, err (B,)
    float32, n (B,) int32)."""
    state, err, n = unsolved(state)
    if state.numel() == 0 or max_iter <= 0:
        return state, err, n
    B, _, ny, nx = state.shape
    active = torch.ones((B,), dtype=torch.int32, device=state.device)
    lib = _build.load(library, signatures)
    partial = torch.empty(getattr(lib, partial_len)(B, ny, nx),
                          dtype=torch.float32, device=state.device)
    count(f"calls.{calls}")

    def launch(iters):
        _build.launch(lib, run, state, const, partial, partial.numel(), err,
                      n, active, B, ny, nx, float(thresh), int(max_iter),
                      *(float(s) for s in scalars), iters,
                      device=state.device)
        count(f"iters.{kernel}", iters)

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
