"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: there is
no silent fallback, so a run that meant to measure the card cannot end
up timing PyTorch's CPU kernels.
"""

import torch


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


def float32_inputs(device, *arrays):
    """Each of `arrays` (tensors or arrays) as a float32 tensor on
    `resolve_device(device)`."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(a, device=dev).to(torch.float32)
                 for a in arrays)
