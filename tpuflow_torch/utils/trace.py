"""Profiling hooks.

Solver phases are wrapped in named NVTX ranges when they run on the
card, so a device timeline shows pyramid levels by name.  On the CPU
the scope is a no-op.

The JAX package's `start_server` (an on-demand XProf profiler server)
has no PyTorch counterpart.  Trace a call with `torch.profiler` instead
(`torch.profiler.profile(activities=[ProfilerActivity.CUDA])`, whose
`key_averages()` and Chrome trace show the kernels), or with Nsight
Systems, which draws the NVTX ranges of `trace_scope` beside them.  Nor
is there a compile cache to configure (the JAX package's
`utils/cache.py` and the CLIs' `enable_persistent_cache`): the kernels'
libraries are built once into `build/tpuflow_torch/`, named by a hash of
their sources, and that directory is the cache.
"""

import contextlib

import torch


def trace_scope(name, device=None):
    """NVTX range `name` around a solver phase on `device` (None: on
    the card where there is one)."""
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    if on_card:
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()
