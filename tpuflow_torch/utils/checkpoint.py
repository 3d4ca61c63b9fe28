"""Per-pyramid-level checkpoint and resume.

The port's own copy of tpuflow/utils/checkpoint.py, with the same
`<dir>/level_NN.npz` layout, so a checkpoint written by either package
resumes in the other (`tpuflow_torch.utils.convert.resume_from_jax`
here, `resume=(scale, state)` there).  Multiscale solvers take a
`level_callback(scale, state)` hook (`run_pyramid_state`);
`checkpoint_callback` is the standard one: it writes each level's state
so that a killed run restarts from its last finished level.
"""

import os

import numpy as np
import torch


def _host(value):
    """`value` (a tensor on any device, or an array) as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_level_checkpoint(directory, scale, **state):
    """Write one pyramid level's solver state to
    `<directory>/level_<scale:02d>.npz` (copied to the host here)."""
    os.makedirs(directory, exist_ok=True)
    np.savez_compressed(os.path.join(directory, f"level_{scale:02d}.npz"),
                        **{k: _host(v) for k, v in state.items()})


def load_level_checkpoint(directory, scale=None):
    """Load a level checkpoint as numpy arrays.  With scale=None, the
    FINEST (lowest-numbered) level present, as (scale, state dict);
    otherwise the state dict of that scale."""
    if scale is None:
        levels = sorted(f for f in os.listdir(directory)
                        if f.startswith("level_") and f.endswith(".npz"))
        if not levels:
            raise FileNotFoundError(f"no level checkpoints in {directory}")
        scale = int(levels[0][6:8])
        return scale, dict(np.load(os.path.join(directory, levels[0])))
    return dict(np.load(os.path.join(directory, f"level_{scale:02d}.npz")))


def checkpoint_callback(directory):
    """A `level_callback` that writes each solved level to npz."""
    def cb(scale, state):
        save_level_checkpoint(directory, scale, **state)
    return cb
