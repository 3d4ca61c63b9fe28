"""What several readers share."""

import sys

from flowbench import roofline


def roofline_share(record, kernel, work_key):
    """100 x the least time of the traced calls' work for `kernel` over
    the kernel's device time in the window; None where the window holds
    none of its kernels.  Where the profiler recorded fewer launches
    than the calls made, the time is scaled by made over recorded."""
    mod = record.roofline(kernel)
    seconds, recorded = record.trace.kernel_time(mod.KERNELS)
    if not recorded or not record.work:
        return None
    made = sum(w["launches"][kernel] for w in record.work) * len(mod.KERNELS)
    print(f"flowbench: {kernel} kernels recorded {recorded} of {made}",
          file=sys.stderr)
    if recorded < made:
        seconds *= made / recorded
    peaks = roofline.peaks(record.device_name)
    need = sum(mod.bound_s(w[work_key], peaks) for w in record.work)
    return 100.0 * need / seconds


def idle_share(record):
    if record.trace.window_s <= 0 or not record.trace.device:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)


def torch_launches(record):
    kernels = record.trace.kernels()
    if not kernels or not record.trace.linked():
        return None
    return sum(1 for k in kernels if k[3])


def peak_gb(record):
    return record.peak_bytes / 1e9 if record.peak_bytes else None
