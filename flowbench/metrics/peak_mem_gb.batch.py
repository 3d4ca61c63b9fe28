"""`torch.cuda.max_memory_allocated` over warm-up and window, in GB
(1e9 bytes)."""

from flowbench.metrics._common import peak_gb


def read(record):
    return peak_gb(record)
