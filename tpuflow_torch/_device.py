"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: there is
no silent fallback, so a run that meant to measure the card cannot end
up timing PyTorch's CPU kernels.
"""

import warnings

import torch

from tpuflow_torch.config import default_dtype, result_dtype


def resolve_device(device=None):
    """`device` as a `torch.device`; None means "cuda".

    Raises RuntimeError when a CUDA device is asked for (explicitly or
    by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpuflow_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev


def compute_inputs(device, *arrays):
    """Each of `arrays` (tensors or arrays) as a tensor on
    `resolve_device(device)` in the dtype that device computes in.

    On the CPU float64 and float32 inputs keep their common dtype and
    anything else (uint8 images, ints) becomes `default_dtype`.  On the
    card every kernel computes in float32, so the inputs become float32;
    float64 inputs are cast with one warning that says so."""
    dev = resolve_device(device)
    tensors = [torch.as_tensor(a, device=dev) for a in arrays]
    dtype = result_dtype(*tensors)
    if dev.type == "cuda" and dtype == torch.float64:
        warnings.warn("tpuflow_torch: float64 inputs are cast to float32 on "
                      "the card, where every kernel computes in float32",
                      stacklevel=3)
    if dev.type == "cuda" or dtype not in (torch.float32, torch.float64):
        dtype = default_dtype
    return tuple(t.to(dtype) for t in tensors)


def check_dtype(name, t, ref):
    """Raise unless tensor `t` has the dtype of `ref`: float32 where
    `ref` lies on the card (every kernel computes in float32), float32
    or float64 on the CPU (the plain versions follow their inputs)."""
    allowed = ((torch.float32,) if ref.device.type == "cuda"
               else (torch.float32, torch.float64))
    if t.dtype not in allowed or t.dtype != ref.dtype:
        raise TypeError(f"{name} must be {ref.dtype} and one of {allowed} on "
                        f"{ref.device.type}, got {t.dtype}")
