"""Profiling hooks.

Solver phases are wrapped in named NVTX ranges when they run on the
card, so a device timeline (torch.profiler, Nsight) shows pyramid levels
by name.  On the CPU the scope is a no-op.
"""

import contextlib

import torch


def trace_scope(name, device):
    """NVTX range `name` around a solver phase on `device`."""
    if torch.device(device).type == "cuda":
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()
