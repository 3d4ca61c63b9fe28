"""Kernels launched under a PyTorch op (the entry's and the plain ops'
work: pyramid, gradients, zoom, stacking), per field, in the traced
window; the port's own kernels, launched through ctypes, are not
counted."""

from flowbench.metrics._common import torch_launches


def read(record):
    n = torch_launches(record)
    return None if n is None or not record.fields else n / record.fields
