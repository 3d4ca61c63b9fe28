"""Carry a solver state across from the JAX package.

The solvers have no weights: what carries across between the two
packages is the coarse-to-fine state of a pyramid level, as the JAX
engines' `level_callback` hands it out or as a level checkpoint holds
it (numpy arrays `u1`, `u2` (B, ny, nx) and the int32 counter `oflow`
for the batched engines; `u1`, `u2` (ny, nx) for robust-expo; `u1`,
`u2` (T-1, ny, nx) for Brox temporal; `u1`, `u2` and the occlusion map
`chi` (ny, nx) for TV-L1 with occlusions).
`resume_from_jax` turns such a state into the `resume=(scale, state)`
argument of the port's engines, so a run started under JAX can finish
on the card.  Brox spatial has no resume hook in either package, and no
other state or weights to carry.
"""

import numpy as np
import torch

from tpuflow_torch._device import compute_inputs, resolve_device


def resume_from_jax(scale, state_np, device=None):
    """`(scale, state)` for `tvl1_batched(..., resume=...)`,
    `hs_pyramidal_batched`, `robust_expo`, `brox_temporal` or
    `tvl1occflow`, from a level state of the JAX function of the same
    name (the batched engines hand out {"u1", "u2", "oflow"},
    robust-expo {"u1", "u2"}, Brox temporal {"u1", "u2"} each (T-1, h,
    w), TV-L1 with occlusions {"u1", "u2", "chi"}).

    Float fields become tensors on `device` (default: the card) in the
    dtype the device computes in (`compute_inputs`: float32 on the card,
    float32 or float64 on the CPU); integer fields stay integer."""
    dev = resolve_device(device)
    state = {}
    for key, value in state_np.items():
        value = np.array(value)  # a copy the state owns
        if np.issubdtype(value.dtype, np.floating):
            (state[key],) = compute_inputs(dev, value)
        else:
            state[key] = torch.as_tensor(value, device=dev)
    return int(scale), state
