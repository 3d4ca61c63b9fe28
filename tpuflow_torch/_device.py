"""Device selection for the port's entry points, and what the
hand-written kernels take.

The port runs on the card unless the caller asks for the CPU: there is
no silent fallback, so a run that meant to measure the card cannot end
up timing PyTorch's CPU kernels.  A kernel's wrapper runs its plain
version for a CPU tensor and its kernel for any other (`on_card`), after
`check_inputs` has held its inputs to what the two take.
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


def on_card(t):
    """The one rule for kernel or plain version: False for a CPU tensor,
    which runs the plain version; True for any other, whose kernel runs
    once `check_inputs` has refused every device but CUDA."""
    return not t.is_cpu


class KernelInputError(TypeError, ValueError):
    """Inputs a kernel or its plain version does not take.  It is both a
    TypeError (a dtype) and a ValueError (a shape, layout or device), as
    numpy's AxisError is both a ValueError and an IndexError."""


def check_inputs(what, *, views=(), cpu=True, **tensors):
    """Raise KernelInputError unless `tensors`, each name=(tensor, shape),
    are what kernel entry `what` takes, or on the CPU its plain version.

    A shape entry is a size or the name of one, alike wherever it recurs
    (e.g. ("B", 2, "ny", "nx")).  The dtype is float32 off the CPU (every
    kernel computes in float32) and float32 or float64 on the CPU, all
    alike.  Each tensor is contiguous; those named in `views` only within
    each sample, samples at least one apart (a view of some planes of a
    larger buffer).  All lie on the first tensor's device: the CPU
    (unless not `cpu`, for an entry with no plain version) or one CUDA
    device.  It runs on every launch, so it reads each tensor's metadata
    once and builds a message only to raise it."""
    ref = None
    dims = {}
    for name, (t, shape) in tensors.items():
        if ref is None:
            first, ref, dev = name, t, t.device
            allowed = _CPU_DTYPES if t.is_cpu else _CARD_DTYPES
        size = t.shape
        fits = len(size) == len(shape)
        for d, n in zip(shape, size):
            if (dims.setdefault(d, n) if d.__class__ is str else d) != n:
                fits = False
        if not fits:
            want = ", ".join(str(dims.get(d, d)) for d in shape)
            raise KernelInputError(f"{what}: {name} must be ({want}), not "
                                   f"{tuple(size)}")
        if t.dtype not in allowed or t.dtype != ref.dtype:
            raise KernelInputError(
                f"{what}: {name} is {t.dtype}, {first} {ref.dtype}; a kernel "
                f"takes float32, its plain version float32 or float64, all "
                f"alike")
        if not (t.is_contiguous() or name in views and _samples_dense(t)):
            raise KernelInputError(f"{what}: {name} is not contiguous")
        if t.device != dev:
            raise KernelInputError(
                f"{what}: {name} is on {t.device}, {first} on {dev}; a "
                f"kernel takes one CUDA device, its plain version the CPU")
    if not (ref.is_cuda or ref.is_cpu and cpu):
        raise KernelInputError(
            f"{what}: unsupported device {dev}; the kernel runs on CUDA "
            f"tensors only, all on one CUDA device")


_CPU_DTYPES = (torch.float32, torch.float64)
_CARD_DTYPES = (torch.float32,)


def _samples_dense(t):
    """Whether each sample (index of the first axis) of `t` is contiguous,
    and the samples lie at least a sample apart."""
    size, stride = t.shape, t.stride()
    n = 1
    for d, s in zip(reversed(size[1:]), reversed(stride[1:])):
        if d != 1 and s != n:
            return False
        n *= d
    return size[0] <= 1 or stride[0] >= n
