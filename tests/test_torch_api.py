"""The port's operator surface against the JAX package's, in float64.

The ops that the solvers do not call (`mask3x3`, `sgauss_kernel`,
`sepconvol`, `bicubic_at`, `warp`, `interpolate_bilinear`,
`image_restriction`) and `warp_stack`'s default and `window` are held to
their JAX counterparts at atol 1e-12 on the same numpy inputs; `warp`
to the reference goldens as tests/test_ops.py holds the JAX package's;
the bilinear ops to the reference loops of tests/test_ops.py.  Then the
public names: every name that `tpuflow` and `tpuflow.{ops,parallel,
utils,models,io}` export is in the matching `tpuflow_torch` package,
every public function of each ported module is in the port's module,
but those listed in NO_COUNTERPART, and takes every argument of JAX's,
but those listed in NO_COUNTERPART_ARGS.  `warmup` takes JAX's
arguments in JAX's order, its `timeout` a wall budget.  The solvers'
`scale_solver` hook left at None is the plain call.
"""

import ast
import importlib
import inspect
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow_torch
from tpuflow import ops as jops
from tpuflow_torch import ops

torch.set_num_threads(2)

TAGS = ["a", "b"]
# public functions of the JAX package with no counterpart in the port,
# and why (ROADMAP.md lists them too)
NO_COUNTERPART = {
    "utils.trace": {"start_server"},  # XProf server: use torch.profiler
    # shardings of global arrays: the port's ranks hold blocks instead
    # (batch_block, spatial_block, gather_batch, gather_spatial)
    "parallel.mesh": {"batch_sharding", "spatial_sharding"},
    # a jit of hs_classic: the port compiles no program
    "models": {"hs_classic_jit"},
}
PORTED_MODULES = ("config", "ops.gradients", "ops.gaussian", "ops.interp",
                  "ops.median", "ops.normalize", "ops.pyramid",
                  "utils.checkpoint", "utils.warmup", "utils.trace",
                  "parallel.mesh", "parallel.distributed", "parallel.halo",
                  "parallel.tiled", "parallel.temporal", "parallel.spatial")
# arguments of ported public functions with no counterpart, and why
# (ROADMAP.md lists them too)
NO_COUNTERPART_ARGS = {
    # each of the port's ranks is a process that holds its block, and its
    # mesh carries the process groups: the devices and the axis sizes
    # come from the mesh
    "parallel.mesh.make_mesh": {"devices"},
    "parallel.spatial.make_spatial_mesh": {"devices"},
    "parallel.distributed.dp_efficiency": {"devices"},
    "parallel.halo.exchange_1d": {"axis_size"},
    "parallel.halo.exchange_2d": {"x_size", "y_size"},
    "parallel.temporal.brox_temporal_scale_sharded": {"axis_size"},
    # JAX's coordinator keywords pass through to jax.distributed
    "parallel.distributed.initialize": {"kw"},
    # Pallas's interpret mode, and the TPU warp's residual windows
    "ops.interp.warp_planes_bounded": {"interpret", "rbud"},
    # the same inputs under another name: tensors or arrays
    "config.result_dtype": {"arrays"},
    "parallel.distributed.dp_shard": {"arrays"},
}


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, atol=1e-12):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _rng(seed):
    return np.random.default_rng(seed)


def _flow(seed, shape, amp):
    rng = _rng(seed)
    return amp * rng.standard_normal(shape), amp * rng.standard_normal(shape)


@pytest.mark.parametrize("mask", ["random", "laplacian"])
def test_mask3x3_matches_jax(mask):
    I = _rng(0).standard_normal((11, 17))
    m = (_rng(1).standard_normal(9) if mask == "random"
         else np.array([0, 1, 0, 1, -4, 1, 0, 1, 0], np.float64))
    _close(ops.mask3x3(_t(I), m), jops.mask3x3(jnp.asarray(I), m))
    # dxx, dyy and dxy are mask3x3 with their masks
    _close(ops.dxx(_t(I)), ops.mask3x3(_t(I), [0, 0, 0, 1, -2, 1, 0, 0, 0]))
    _close(ops.dyy(_t(I)), ops.mask3x3(_t(I), [0, 1, 0, 0, -2, 0, 0, 1, 0]))
    _close(ops.dxy(_t(I)), ops.mask3x3(
        _t(I), [0.25, 0, -0.25, 0, 0, 0, -0.25, 0, 0.25]))


@pytest.mark.parametrize("std,n", [(1.0, 1), (0.8, 5), (2.0, 7), (1.5, 8)])
def test_sgauss_kernel_matches_jax(std, n):
    np.testing.assert_allclose(ops.sgauss_kernel(std, n),
                               jops.sgauss_kernel(std, n), rtol=0, atol=1e-15)


@pytest.mark.parametrize("nx,ny", [(5, 5), (4, 7), (9, 3), (1, 3)])
def test_sepconvol_matches_jax(nx, ny):
    I = _rng(2).standard_normal((3, 13, 19))
    fx, fy = ops.sgauss_kernel(1.2, nx), ops.sgauss_kernel(0.9, ny)
    _close(ops.sepconvol(_t(I), fx, fy), jops.sepconvol(jnp.asarray(I), fx, fy))


@pytest.mark.parametrize("border_out", [False, True])
def test_bicubic_at_matches_jax(border_out):
    img = _rng(3).standard_normal((12, 15)) * 50
    rng = _rng(4)
    xx = rng.uniform(-3, 17, (5, 7, 3))
    yy = rng.uniform(-3, 14, (5, 7, 3))
    _close(ops.bicubic_at(_t(img), _t(xx), _t(yy), border_out),
           jops.bicubic_at(jnp.asarray(img), jnp.asarray(xx),
                           jnp.asarray(yy), border_out))


@pytest.mark.parametrize("stack", [False, True], ids=["image", "stack"])
@pytest.mark.parametrize("border_out", [None, False, True])
def test_warp_matches_jax(stack, border_out):
    img = _rng(5).standard_normal((3, 16, 20) if stack else (16, 20)) * 100
    u, v = _flow(6, (16, 20), 4.0)
    kw = {} if border_out is None else {"border_out": border_out}
    _close(ops.warp(_t(img), _t(u), _t(v), **kw),
           jops.warp(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), **kw))


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", ["b0", "b1", "big_b1"])
def test_warp_matches_reference_goldens(ops_goldens, tag, case):
    g = ops_goldens[tag]
    scale = 8 if case == "big_b1" else 1
    out = ops.warp(_t(g["I"]), _t(g["U"] * scale), _t(g["V"] * scale),
                   border_out=case != "b0")
    _close(out, g[f"warp_{case}"], atol=1e-10)


def test_warp_stack_default_keeps_out_of_domain_values():
    """JAX's default is border_out=False: pixels whose taps leave the
    image keep their clamped bicubic value (a grid shifted by (+3, -2)
    puts a third of them out of the domain)."""
    planes = _rng(7).standard_normal((2, 16, 20))
    yy, xx = np.mgrid[0:16, 0:20].astype(np.float64)
    xx, yy = xx + 3.0, yy - 2.0
    got = ops.warp_stack(_t(planes), _t(xx), _t(yy))
    want = jops.warp_stack(jnp.asarray(planes), jnp.asarray(xx),
                           jnp.asarray(yy))
    _close(got, want)
    zeroed = ops.warp_stack(_t(planes), _t(xx), _t(yy), border_out=True)
    assert int((zeroed == 0).sum()) > 200 and int((got == 0).sum()) == 0


@pytest.mark.parametrize("border_out", [False, True])
def test_warp_stack_window_matches_jax_and_whole_image(border_out):
    """A window of the planes at a global origin, with a halo that
    covers the displacement: equal to JAX's window and to the warp of
    the whole image."""
    ny, nx, halo = 24, 30, 6
    planes = _rng(8).standard_normal((3, ny, nx)) * 10
    u, v = (np.clip(f, -3, 3) for f in _flow(9, (ny, nx), 2.0))
    oy, ox, h, w = 8, 10, 8, 12
    win = planes[:, oy - halo:oy + h + halo, ox - halo:ox + w + halo]
    yy, xx = np.mgrid[oy:oy + h, ox:ox + w].astype(np.float64)
    xx = xx + u[oy:oy + h, ox:ox + w]
    yy = yy + v[oy:oy + h, ox:ox + w]
    window = (oy - halo, ox - halo, ny, nx)
    got = ops.warp_stack(_t(win), _t(xx), _t(yy), border_out, window=window)
    _close(got, jops.warp_stack(jnp.asarray(win), jnp.asarray(xx),
                                jnp.asarray(yy), border_out, window=window))
    whole = ops.warp_stack(_t(planes), _t(xx), _t(yy), border_out)
    _close(got, whole)


def test_interpolate_bilinear_matches_jax_and_reference_loop():
    """The loop transcription of me_interpolate_bilinear
    (src/bicubic_interpolation.cpp:407-446) of tests/test_ops.py."""
    rng = _rng(4)
    img = rng.standard_normal((9, 13))
    xs = rng.uniform(0, 11.9, 40)
    ys = rng.uniform(0, 7.9, 40)
    xs[:5] = np.round(xs[:5])  # the exact-integer branches
    ys[2:7] = np.round(ys[2:7])

    def oracle(x, y):
        l, k = int(np.floor(x)), int(np.floor(y))
        a, b = x - l, y - k
        x0 = img[k, l]
        x1 = img[k, min(l + 1, 12)]
        x2 = img[min(k + 1, 8), l]
        x3 = img[min(k + 1, 8), min(l + 1, 12)]
        if a == 0 and b == 0:
            return x0
        if a == 0:
            return (1 - b) * x0 + b * x2
        if b == 0:
            return (1 - a) * x0 + a * x1
        return (1 - b) * ((1 - a) * x0 + a * x1) + b * ((1 - a) * x2 + a * x3)

    got = ops.interpolate_bilinear(_t(img), _t(xs), _t(ys))
    _close(got, [oracle(x, y) for x, y in zip(xs, ys)])
    _close(got, jops.interpolate_bilinear(jnp.asarray(img), jnp.asarray(xs),
                                          jnp.asarray(ys)))


@pytest.mark.parametrize("size", [(9, 5), (20, 12), (7, 11)])
def test_image_restriction_matches_jax_and_reference_loop(size):
    """me_image_restriction (src/bicubic_interpolation.cpp:653-688)."""
    img = _rng(5).standard_normal((12, 20))
    new_nx, new_ny = size
    got = ops.image_restriction(_t(img), size)
    gx, gy = 20 / new_nx, 12 / new_ny
    want = np.array([[float(ops.interpolate_bilinear(
        _t(img), _t(gx / 2 - 0.5 + j * gx), _t(gy / 2 - 0.5 + i * gy)))
        for j in range(new_nx)] for i in range(new_ny)])
    _close(got, want)
    _close(got, jops.image_restriction(jnp.asarray(img), size))


def _exported(package):
    """The names a package's __init__ imports, by parsing it."""
    tree = ast.parse(inspect.getsource(package))
    return {alias.asname or alias.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for alias in node.names}


@pytest.mark.parametrize("package", ["", "ops", "parallel", "utils",
                                     "models", "io"])
def test_package_exports(package):
    jax_pkg = importlib.import_module(".".join(filter(None, ["tpuflow",
                                                             package])))
    port_pkg = importlib.import_module(".".join(filter(None, [
        "tpuflow_torch", package])))
    names = _exported(jax_pkg) - NO_COUNTERPART.get(package, set())
    assert names, package
    missing = sorted(n for n in names if not hasattr(port_pkg, n))
    assert missing == [], missing


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_ported_module_surface(module):
    jax_mod = importlib.import_module(f"tpuflow.{module}")
    port_mod = importlib.import_module(f"tpuflow_torch.{module}")
    public = {n for n, f in vars(jax_mod).items() if not n.startswith("_")
              and (inspect.isfunction(f) or inspect.isclass(f))
              and f.__module__ == jax_mod.__name__}
    missing = public - set(vars(port_mod)) - NO_COUNTERPART.get(module, set())
    assert missing == set(), sorted(missing)


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_ported_arguments(module):
    """Every argument of a ported function is an argument of the port's,
    but those listed in NO_COUNTERPART_ARGS, and the listed ones really
    are absent."""
    jax_mod = importlib.import_module(f"tpuflow.{module}")
    port_mod = importlib.import_module(f"tpuflow_torch.{module}")
    for name, fn in vars(jax_mod).items():
        if (name.startswith("_") or not inspect.isfunction(fn)
                or fn.__module__ != jax_mod.__name__
                or not hasattr(port_mod, name)):
            continue
        want = set(inspect.signature(fn).parameters)
        have = set(inspect.signature(getattr(port_mod, name)).parameters)
        listed = NO_COUNTERPART_ARGS.get(f"{module}.{name}", set())
        assert want - have == listed, (name, sorted(want - have))


def test_no_counterpart_names_are_absent():
    """The listed names really have no counterpart (the list stays true)."""
    for module, names in NO_COUNTERPART.items():
        port_mod = importlib.import_module(f"tpuflow_torch.{module}")
        assert not any(hasattr(port_mod, n) for n in names), module
    assert tpuflow_torch.default_dtype == torch.float32


def test_warmup_runs_every_method_on_the_cpu():
    seconds = tpuflow_torch.warmup([(3, 24, 32)], methods=(
        "tvl1", "hs", "occflow", "robust_expo", "brox_spatial",
        "brox_temporal", "brox_batched"), device="cpu")
    assert seconds > 0
    with pytest.raises(ValueError, match="unknown method"):
        tpuflow_torch.warmup([(1, 24, 32)], methods=("tvl2",), device="cpu")


def test_warmup_takes_jax_arguments():
    """JAX's order (geometries, methods, timeout, verbose), the port's
    `device` after them: a third positional argument is the timeout."""
    from tpuflow.utils.warmup import warmup as jax_warmup

    jax_args = list(inspect.signature(jax_warmup).parameters)
    assert list(inspect.signature(tpuflow_torch.warmup).parameters) == (
        jax_args + ["device"])
    assert tpuflow_torch.warmup([(1, 24, 32)], ("tvl1",), 5,
                                device="cpu") > 0
    assert tpuflow_torch.warmup([(1, 24, 32)], methods=("hs",), timeout=5,
                                verbose=True, device="cpu") > 0


def test_warmup_budget_skips_the_rest_on_stderr(monkeypatch, capsys):
    """Once the budget is spent no further job starts: each skipped one
    is reported on stderr, as JAX reports its failed jobs, and the call
    returns its seconds without raising."""
    mod = importlib.import_module("tpuflow_torch.utils.warmup")
    ran = []

    def slow(*job):
        ran.append(job[:4])
        time.sleep(0.05)

    monkeypatch.setattr(mod, "_run", slow)
    seconds = tpuflow_torch.warmup([(1, 24, 32), (2, 16, 16)],
                                   ("tvl1", "hs"), timeout=0.01,
                                   device="cpu")
    assert seconds >= 0.05 and ran == [("tvl1", 1, 24, 32)]
    err = capsys.readouterr().err.splitlines()
    assert err == [
        "warmup: job ('tvl1', 2, 16, 16) skipped: the timeout of 0.01 s "
        "was spent",
        "warmup: job ('hs', 1, 24, 32) skipped: the timeout of 0.01 s "
        "was spent",
        "warmup: job ('hs', 2, 16, 16) skipped: the timeout of 0.01 s "
        "was spent",
        "warmup: 3/4 jobs skipped (timeout 0.01 s)"]
    assert tpuflow_torch.warmup([(1, 24, 32)], ("tvl1",), 0,
                                device="cpu") < 0.05 and len(ran) == 1


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a card, warm-up and a card process group raise instead of
    running on the CPU or under gloo."""
    from tpuflow_torch.parallel.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpuflow_torch.warmup([(1, 24, 32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("127.0.0.1:1", 2, 0)
    assert initialize() is False  # one process, no coordinator: a no-op


@pytest.mark.parametrize("solver", ["robust_expo", "tvl1occflow"])
def test_scale_solver_none_is_the_plain_call(solver):
    """`scale_solver=None` and the model's own per-level solver given
    explicitly both give the plain call's result bit for bit, the given
    solver called once a level."""
    mod = importlib.import_module(f"tpuflow_torch.models.{solver}")
    scale = getattr(mod, {"robust_expo": "robust_expo_scale",
                          "tvl1occflow": "tvl1occ_scale"}[solver])
    rng = _rng(10)
    base = rng.standard_normal((36, 52)).cumsum(0).cumsum(1)
    frames = [np.roll(base, k, axis=1) for k in (-1, 0, 1)]
    images = frames[1:] if solver == "robust_expo" else frames
    levels = []

    def recording(*args, **kw):
        levels.append(args[0].shape)
        return scale(*args, **kw)

    fn = getattr(mod, solver)
    kw = dict(nscales=2, warp_mode="fast", with_diag=True, device="cpu")
    if solver == "robust_expo":
        kw["outer_iter"] = 2
    want = fn(*images, **kw)
    for given in (None, recording):
        got = fn(*images, scale_solver=given, **kw)
        n = len(want) - 1
        assert all(torch.equal(a, b) for a, b in zip(got[:n], want[:n]))
        assert [d["iterations"].tolist() for d in got[n]] == [
            d["iterations"].tolist() for d in want[n]]
    assert len(levels) == 2
