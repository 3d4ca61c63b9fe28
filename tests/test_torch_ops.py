"""The port's plain operators against the JAX package and the
reference-C goldens, in float64.

Inputs come from the goldens (numpy) and go to both sides as numpy
arrays.  Port vs JAX: <= 1e-10 (the same arithmetic in the same
precision; only the summation order of the resampling matmuls may
differ).  Port vs goldens: the tolerances of tests/test_ops.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow import ops as jops
from tpuflow.models.batch import _normalize_pair_batched as j_normalize_pair
from tpuflow_torch.ops import gradients as tgrad
from tpuflow_torch.ops import interp as tinterp
from tpuflow_torch.ops import normalize as tnorm
from tpuflow_torch.ops import pyramid as tpyr

# the module: tpuflow_torch.ops exports the function `gaussian` by that name
tgauss = importlib.import_module("tpuflow_torch.ops.gaussian")

torch.set_num_threads(2)

TAGS = ["a", "b"]
ZOOM_SIGMA = 0.6 * np.sqrt(1 / 0.25 - 1)  # zoom_out's presmoothing at 0.5


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def test_normalize_joint(solver_goldens):
    g = solver_goldens
    n0, n1 = tnorm.normalize_joint(_t(g["I0"]), _t(g["I1"]))
    j0, j1 = jops.normalize_joint(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]))
    _close(n0, j0, 1e-10)
    _close(n1, j1, 1e-10)
    _close(n0, g["n0"], 1e-12)
    _close(n1, g["n1"], 1e-12)


def test_normalize_pair_batched(solver_goldens):
    g = solver_goldens
    a = np.stack([g["I0"], 3.0 * g["I1"] - 7.0, np.full_like(g["I0"], 5.0)])
    b = np.stack([g["I1"], 0.5 * g["I0"], np.full_like(g["I0"], 5.0)])
    # normalize_joint of (B, H, W) stacks: each pair jointly (the batched
    # engines' preprocessing)
    p0, p1 = tnorm.normalize_joint(_t(a), _t(b))
    j0, j1 = j_normalize_pair(jnp.asarray(a), jnp.asarray(b))
    _close(p0, j0, 1e-10)
    _close(p1, j1, 1e-10)
    _close(p0[0], g["n0"], 1e-12)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("sigma", [0.8, ZOOM_SIGMA, 3.0],
                         ids=["s0.8", "zoom", "s3.0"])
@pytest.mark.parametrize("bc", ["dirichlet", "reflecting"])
def test_gaussian(ops_goldens, tag, sigma, bc):
    g = ops_goldens[tag]
    out = tgauss.gaussian(_t(g["I"]), sigma, bc=bc)
    _close(out, jops.gaussian(jnp.asarray(g["I"]), sigma, bc=bc), 1e-10)
    key = f"gaussian_{sigma:.4f}_bc{int(bc == 'reflecting')}"
    _close(out, g[key], 1e-10)


@pytest.mark.parametrize("tag", TAGS)
def test_gradients_and_divergence(ops_goldens, tag):
    g = ops_goldens[tag]
    I, V1, V2 = (g[k] for k in ("I", "V1", "V2"))
    dx, dy = tgrad.centered_gradient(_t(I))
    jx, jy = jops.centered_gradient(jnp.asarray(I))
    _close(dx, jx, 1e-10)
    _close(dy, jy, 1e-10)
    _close(dx, g["centered_dx"], 1e-12)
    _close(dy, g["centered_dy"], 1e-12)
    fx, fy = tgrad.forward_gradient(_t(I))
    jx, jy = jops.forward_gradient(jnp.asarray(I))
    _close(fx, jx, 1e-10)
    _close(fy, jy, 1e-10)
    _close(fx, g["forward_dx"], 1e-12)
    _close(fy, g["forward_dy"], 1e-12)
    div = tgrad.divergence(_t(V1), _t(V2))
    _close(div, jops.divergence(jnp.asarray(V1), jnp.asarray(V2)), 1e-10)
    _close(div, g["divergence"], 1e-12)


@pytest.mark.parametrize("tag", TAGS)
def test_zoom_out_and_in(ops_goldens, tag):
    g = ops_goldens[tag]
    ny, nx = g["I"].shape
    out = tpyr.zoom_out(_t(g["I"]), 0.5)
    assert tuple(out.shape) == g["zoom_out_05"].shape
    _close(out, jops.zoom_out(jnp.asarray(g["I"]), 0.5), 1e-10)
    _close(out, g["zoom_out_05"], 1e-10)
    back = tpyr.zoom_in(_t(g["zoom_out_05"]), (nx, ny))
    _close(back, jops.zoom_in(jnp.asarray(g["zoom_out_05"]), (nx, ny)), 1e-10)
    _close(back, g["zoom_in_back"], 1e-10)


def test_pyramid_sizes_and_clamp():
    from tpuflow.ops.pyramid import clamp_nscales, pyramid_sizes

    for nx, ny in ((1024, 436), (96, 64), (77, 53)):
        assert tpyr.clamp_nscales(nx, ny, 0.5, 100) == clamp_nscales(
            nx, ny, 0.5, 100)
        assert tpyr.pyramid_sizes(nx, ny, 0.5, 7) == pyramid_sizes(
            nx, ny, 0.5, 7)
    assert tpyr.clamp_nscales(1024, 436, 0.5, 100) == 7


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", ["b0", "b1", "big_b1"])
def test_warp_planes(ops_goldens, tag, case):
    g = ops_goldens[tag]
    scale = 8.0 if case == "big_b1" else 1.0
    border_out = case != "b0"
    planes = np.stack([g["I"], g["V1"]])
    u, v = g["U"] * scale, g["V"] * scale
    out = tinterp.warp_planes(_t(planes), _t(u), _t(v), border_out=border_out)
    ref = jops.warp_planes(jnp.asarray(planes), jnp.asarray(u),
                           jnp.asarray(v), border_out=border_out)
    _close(out, ref, 1e-10)
    _close(out[0], g[f"warp_{case}"], 1e-10)
