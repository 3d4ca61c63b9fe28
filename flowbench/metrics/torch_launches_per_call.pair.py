"""Kernels launched under a PyTorch op, per call, in the traced window;
the port's own kernels, launched through ctypes, are not counted."""

from flowbench.metrics._common import torch_launches


def read(record):
    n = torch_launches(record)
    return None if n is None or not record.calls else n / record.calls
