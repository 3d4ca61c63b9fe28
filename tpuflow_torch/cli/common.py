"""Shared CLI plumbing for the solver drivers.

Counterpart of tpuflow/cli/common.py.  The reference CLIs all use the
same idiom (e.g. src/tvl1flow_main.cpp:96-167): positional optional
arguments, invalid values clamped back to the compile-time default with
a warning when verbose, and the flow saved as float32 `.flo`.  The
argument order, defaults, clamping and messages are the JAX CLIs', so
shell scripts written for the reference binaries keep working.  `nproc`
is accepted for compatibility and ignored.

Each CLI's `main(argv=None, device=None)` runs on the card unless
`device="cpu"` is given; the kernels build once into `build/`, so there
is no compile cache to set up (the JAX CLIs' `enable_persistent_cache`
has no counterpart).
"""

import sys

import numpy as np
import torch

from tpuflow_torch.io import read_image, write_flow


class Args:
    """Positional-argument cursor over argv with typed defaults."""

    def __init__(self, argv):
        self.argv = argv
        self.i = 0

    def next(self, default, cast=str):
        v = self.argv[self.i] if self.i < len(self.argv) else None
        self.i += 1
        if v is None:
            return default
        try:
            return cast(v)
        except ValueError:
            return default


def clamp(value, ok, default, name, verbose):
    """Reset `value` to `default` unless ok(value); warn when verbose."""
    if ok(value):
        return value
    if verbose:
        print(f"warning: {name} changed to {default}", file=sys.stderr)
    return default


def load_pair(path0, path1, dtype=np.float32):
    """Two images read as gray, float64 then cast to `dtype`; exits with
    the JAX CLI's message when their sizes differ."""
    I0 = read_image(path0, gray=True, dtype=np.float64).astype(dtype)
    I1 = read_image(path1, gray=True, dtype=np.float64).astype(dtype)
    if I0.shape != I1.shape:
        print(f"ERROR: input images size mismatch {I0.shape} != {I1.shape}",
              file=sys.stderr)
        raise SystemExit(1)
    return I0, I1


def host_array(a):
    """A tensor on any device, or an array, as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_flow(outfile, u, v):
    """Write (u, v), tensors on any device or arrays, by extension (.uv
    -> JUV, else .flo; reference src/iio.cpp:3655-3675)."""
    write_flow(outfile, host_array(u), host_array(v))
