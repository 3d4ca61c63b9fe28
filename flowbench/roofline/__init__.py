"""The operations and bytes that the algorithm needs for one kernel's
work, one module per kernel, computed from shapes and from the
iterations or sweeps these inputs needed (never the most they could
need).  Each module gives `KERNELS`, the device kernels whose time the
work is held against, and `bound_s(work, peaks)`, the least time the
work could take on a card with `peaks`: its bytes, each counted once,
over the memory rate, or its float32 operations over the float32 rate,
whichever is larger."""

import json
from pathlib import Path


def peaks(device_name):
    """The entry of peaks.json whose key `device_name` contains."""
    table = json.loads((Path(__file__).resolve().parent.parent
                        / "peaks.json").read_text())
    for key, entry in table.items():
        if not key.startswith("_") and key in device_name:
            return entry
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")


def least_s(bytes_, flops, peaks):
    return max(bytes_ / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flops_per_s"])
