"""Global numeric configuration (counterpart of tpuflow/config.py).

The reference computes in C ``double`` (src/of.h:4-10) but always writes
float32 ``.flo`` files.  On the card every kernel computes in float32;
on the CPU the plain versions compute in the inputs' dtype, so float64
inputs give float64 results there (the oracle-validation path, as the
JAX package's CPU path with x64 on).  `default_dtype` is what inputs of
any other type (uint8 images, ints) become, and what new tensors made
from Python scalars take.
"""

import numpy as np
import torch

default_dtype = torch.float32


def result_dtype(*tensors):
    """Common floating dtype of the inputs, falling back to
    `default_dtype` (also for integer inputs)."""
    floats = [d for d in (torch.as_tensor(t).dtype for t in tensors
                          if hasattr(t, "dtype")) if d.is_floating_point]
    if not floats:
        return default_dtype
    out = floats[0]
    for d in floats[1:]:
        out = torch.promote_types(out, d)
    return out


def numpy_dtype(dtype):
    """The numpy scalar type of torch float dtype `dtype`: the stopping
    thresholds are computed in it, as the stopping tests compare in it."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
