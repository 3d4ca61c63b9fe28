"""The port's batched TV-L1 engine against the JAX package's and the
reference binary's goldens.

One JAX `tvl1_batched` call (B=2, 64x96, the golden pair and its
reverse, float32) is shared by the module: it runs under one `jax.jit`
with a `level_callback`, so the same compile also yields the per-level
states that the resume test carries across.  `max_motion=3` keeps the
JAX CPU path's shift-select warp at (2*3+4)^2 terms (its compile time
grows with the bound); the pair's flow stays under 3 px, so the bound
never clips it.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.batch import tvl1_batched as jax_tvl1_batched
from tpuflow.models.batch import tvl1_iter_schedule
from tpuflow_torch import tvl1_batched
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

MAX_MOTION = 3
REPO = Path(__file__).resolve().parent.parent


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


@pytest.fixture(scope="module")
def pair(solver_goldens):
    g = solver_goldens
    I0 = np.stack([g["I0"], g["I1"]]).astype(np.float32)
    I1 = np.stack([g["I1"], g["I0"]]).astype(np.float32)
    return I0, I1


@pytest.fixture(scope="module")
def jax_run(pair):
    """(u, v, {scale: level state}) of one JAX tvl1_batched call."""

    @jax.jit
    def run(I0, I1):
        states = {}
        u, v = jax_tvl1_batched(I0, I1, max_motion=MAX_MOTION,
                                level_callback=states.__setitem__)
        return u, v, states

    u, v, states = jax.device_get(run(*map(jnp.asarray, pair)))
    return u, v, states


def test_matches_jax_and_reference(pair, jax_run, solver_goldens):
    ju, jv, _ = jax_run
    u, v, stats = tvl1_batched(*pair, max_motion=MAX_MOTION, device="cpu",
                               with_stats=True)
    assert u.dtype == torch.float32 and u.shape == pair[0].shape
    for b in range(2):
        assert _epe(u[b], v[b], ju[b], jv[b]) <= 0.01
    g = solver_goldens
    assert _epe(u[0], v[0], g["tvl1_multi_u"], g["tvl1_multi_v"]) <= 0.05
    assert int(stats["warp_overflow_tiles"]) == 0
    # 3 levels (clamp_nscales at 64x96), per warp one count per sample
    its = stats["iterations"]
    assert sorted(its) == [0, 1, 2]
    assert all(1 <= len(w) <= 5 and all(len(n) == 2 for n in w)
               for w in its.values())
    assert all(1 <= k <= 300 for w in its.values() for n in w for k in n)


def test_resume_from_jax_level_state(pair, jax_run):
    ju, jv, states = jax_run
    state = states[1]
    assert state["oflow"].dtype == np.int32
    resume = resume_from_jax(1, state, device="cpu")
    assert resume[1]["oflow"].dtype == torch.int32
    assert resume[1]["u1"].dtype == torch.float32
    u, v = tvl1_batched(*pair, max_motion=MAX_MOTION, device="cpu",
                        resume=resume)
    for b in range(2):
        assert _epe(u[b], v[b], ju[b], jv[b]) <= 0.01


def test_fixed_schedule_runs(pair):
    u, v, stats = tvl1_batched(*pair, stop="fixed", max_motion=MAX_MOTION,
                               device="cpu", with_stats=True)
    assert u.shape == v.shape == pair[0].shape
    assert torch.isfinite(u).all() and torch.isfinite(v).all()
    # the JAX package's calibrated schedule of each level, every warp in full
    for scale, (ny, nx) in enumerate([(64, 96), (32, 48), (16, 24)]):
        assert ([n[0] for n in stats["iterations"][scale]]
                == list(tvl1_iter_schedule(ny, nx)))


def test_no_silent_cpu_fallback(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvl1_batched(*pair)


def test_port_imports_neither_jax_nor_tpuflow():
    code = (
        "import importlib, pkgutil, sys, tpuflow_torch\n"
        "for m in pkgutil.walk_packages(tpuflow_torch.__path__, 'tpuflow_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'tpuflow')\n"
        "       or m.startswith(('jax.', 'tpuflow.'))]\n"
        "assert not bad, bad\n"
        "print(sum(m.startswith('tpuflow_torch.') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15  # every module of the port was imported
