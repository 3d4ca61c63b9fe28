"""Level checkpoints (tpuflow_torch.utils.checkpoint) on the CPU.

The four tests of tests/test_utils.py mirrored on the port (TV-L1, TV-L1
with occlusions, Brox temporal, the batched engine): a run with
`checkpoint_callback` writes one `level_NN.npz` per level, and a run
resumed from a written level equals the uninterrupted one.  Then the
layout is shared with the JAX package: a checkpoint that JAX wrote
resumes in the port through `resume_from_jax`, and one that the port
wrote resumes in JAX, each within 1e-9 of the other package's
uninterrupted run (float64, the two packages' level solves agree to
rounding).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.tvl1 import tvl1_multiscale as jax_tvl1_multiscale
from tpuflow.utils.checkpoint import checkpoint_callback as jax_callback
from tpuflow.utils.checkpoint import load_level_checkpoint as jax_load
from tpuflow_torch import (brox_temporal, tvl1_batched, tvl1_multiscale,
                           tvl1occflow)
from tpuflow_torch.utils.checkpoint import (checkpoint_callback,
                                            load_level_checkpoint,
                                            save_level_checkpoint)
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

CROSS_ATOL = 1e-9


def _close(a, b, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def pair(solver_goldens):
    g = solver_goldens
    return np.asarray(g["I0"], np.float64), np.asarray(g["I1"], np.float64)


def test_checkpoint_and_resume(pair, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(nscales=3, clamp_scales=False, device="cpu")
    u_full, v_full = tvl1_multiscale(*pair, level_callback=checkpoint_callback(ckpt),
                                     **kw)
    assert sorted(os.listdir(ckpt)) == [
        "level_00.npz", "level_01.npz", "level_02.npz"]
    state = load_level_checkpoint(ckpt, 2)
    u_res, v_res = tvl1_multiscale(*pair, resume=(2, state["u1"], state["u2"]),
                                   **kw)
    _close(u_res, u_full)
    _close(v_res, v_full)
    scale, st = load_level_checkpoint(ckpt)  # the finest level present
    assert scale == 0
    _close(st["u1"], u_full)


def test_checkpoint_resume_occflow(pair, tmp_path):
    I0, I1 = pair
    Im1 = np.roll(I0, -1, axis=1)
    kw = dict(nscales=2, clamp_scales=False, warps=1, max_iterations=3,
              stop="fixed", device="cpu")
    ckpt = str(tmp_path / "occ")
    u_f, v_f, chi_f = tvl1occflow(Im1, I0, I1,
                                  level_callback=checkpoint_callback(ckpt), **kw)
    assert sorted(os.listdir(ckpt)) == ["level_00.npz", "level_01.npz"]
    state = load_level_checkpoint(ckpt, 1)
    assert set(state) == {"u1", "u2", "chi"}
    u_r, v_r, chi_r = tvl1occflow(Im1, I0, I1,
                                  resume=resume_from_jax(1, state, "cpu"), **kw)
    _close(u_r, u_f)
    _close(v_r, v_f)
    _close(chi_r, chi_f)


def test_checkpoint_resume_brox_temporal(pair, tmp_path):
    vol = np.stack([np.roll(pair[0], k, axis=1) for k in range(3)])
    kw = dict(nscales=2, clamp_scales=False, outer_iter=1, stop="fixed",
              maxiter=3, device="cpu")
    ckpt = str(tmp_path / "bt")
    u_f, v_f = brox_temporal(vol, level_callback=checkpoint_callback(ckpt),
                             **kw)
    state = load_level_checkpoint(ckpt, 1)
    u_r, v_r = brox_temporal(vol, resume=resume_from_jax(1, state, "cpu"),
                             **kw)
    _close(u_r, u_f)
    _close(v_r, v_f)


def test_checkpoint_resume_batched(pair, tmp_path):
    I0 = np.stack([pair[0]] * 2).astype(np.float32)
    I1 = np.stack([pair[1]] * 2).astype(np.float32)
    kw = dict(nscales=2, stop="fixed", iter_schedule=(4, 2), device="cpu")
    u_plain, v_plain = tvl1_batched(I0, I1, **kw)
    ckpt = str(tmp_path / "bat")
    u_f, v_f = tvl1_batched(I0, I1, level_callback=checkpoint_callback(ckpt),
                            **kw)
    # the port's pyramid loop is the same with or without the hook
    assert torch.equal(u_f, u_plain) and torch.equal(v_f, v_plain)
    state = load_level_checkpoint(ckpt, 1)
    assert state["oflow"].dtype == np.int32 and state["u1"].dtype == np.float32
    u_r, v_r = tvl1_batched(I0, I1, resume=resume_from_jax(1, state, "cpu"),
                            **kw)
    assert torch.equal(u_r, u_f) and torch.equal(v_r, v_f)


def test_checkpoint_takes_tensors_on_any_device(tmp_path):
    u = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    save_level_checkpoint(str(tmp_path), 4, u1=u, oflow=torch.tensor(3))
    state = load_level_checkpoint(str(tmp_path), 4)
    _close(state["u1"], u.numpy(), atol=0)
    assert int(state["oflow"]) == 3


KW = dict(nscales=2, clamp_scales=False)


def test_jax_checkpoint_resumes_in_port(pair, tmp_path):
    ckpt = str(tmp_path / "jax")
    ju, jv = jax_tvl1_multiscale(*map(jnp.asarray, pair),
                                 level_callback=jax_callback(ckpt), **KW)
    scale, state = load_level_checkpoint(ckpt)  # level 0 and 1 written
    assert scale == 0
    state = load_level_checkpoint(ckpt, 1)
    assert state["u1"].dtype == np.float64
    u, v = tvl1_multiscale(*pair, resume=resume_from_jax(1, state, "cpu"),
                           device="cpu", **KW)
    assert u.dtype == torch.float64
    _close(u, ju, CROSS_ATOL)
    _close(v, jv, CROSS_ATOL)


def test_port_checkpoint_resumes_in_jax(pair, tmp_path):
    ckpt = str(tmp_path / "port")
    u, v = tvl1_multiscale(*pair, level_callback=checkpoint_callback(ckpt),
                           device="cpu", **KW)
    state = jax_load(ckpt, 1)
    ju, jv = jax_tvl1_multiscale(*map(jnp.asarray, pair),
                                 resume=(1, jnp.asarray(state["u1"]),
                                         jnp.asarray(state["u2"])), **KW)
    _close(ju, u, CROSS_ATOL)
    _close(jv, v, CROSS_ATOL)
