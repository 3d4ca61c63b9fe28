"""`robust_expo_spatial` and `tvl1occflow_spatial`
(tpuflow_torch.parallel.spatial) on the CPU with gloo, against the
port's untiled solvers and the JAX package, in float64, and in float32
at the JAX package's own bounds (tests/test_spatial.py).

Four gloo ranks are spawned once for the module, with a timeout, on a
2x2 mesh, on tests/test_spatial.py's `_synth` inputs at 48x96 (2
levels, both split over the mesh) and at 46x96, whose level 1 (23 rows)
does not split and runs replicated.  In float64 each lane is held to
the port's untiled fast-warp solver at atol 1e-8 with the same SOR
sweeps at every solve (robust-expo) or the same iterations at every
warp and an equal chi (TV-L1 with occlusions).  Against JAX, computed
in threads of the test process while the ranks run: one level of
`robust_expo_spatial` against `robust_expo_scale(...,
warp_mode="fast")` run eagerly (`jax.disable_jit`) on the same
normalised inputs (compiling it, or JAX's multiscale fast-warp
`robust_expo`, takes minutes here, and neither is done),
and `tvl1occflow_spatial` against `tvl1occflow(..., nscales=2,
warp_mode="fast")`, both at atol 1e-8 with the same sweeps or an equal
chi.

Nothing of JAX is imported at module level: the spawned ranks import
this module to find their entry point.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SPAWN_TIMEOUT = 240  # seconds, rank start-up included
NSCALES = 2
RE_OUTER = {1: 3, 3: 2}  # outer iterations of method 1 and DF-AUTO
# (ny, nx, seed) of tests/test_spatial.py's cases; "odd" has a level 1
# of 23 rows
SHAPES = {"re1": (48, 96, 7), "re3": (48, 96, 9), "occ": (48, 96, 5),
          "odd": (46, 96, 7), "re1_f32": (48, 96, 13),
          "occ_f32": (48, 96, 11)}
ATOL = 1e-8


def _synth(ny, nx, seed, shift=(1, 1)):
    """tests/test_spatial.py's triplet (I-1, I0, I1): a smooth texture
    and its copies shifted by -`shift` and `shift` pixels."""
    rng = np.random.default_rng(seed)
    pad = 4
    base = 128 + 50 * np.real(np.fft.ifft2(
        np.fft.fft2(rng.standard_normal((ny + 2 * pad, nx + 2 * pad)))
        * np.exp(-((np.fft.fftfreq(nx + 2 * pad)[None, :] ** 2
                    + np.fft.fftfreq(ny + 2 * pad)[:, None] ** 2)) * 500)))
    sy, sx = shift
    I0 = base[pad:pad + ny, pad:pad + nx]
    I1 = base[pad + sy:pad + sy + ny, pad + sx:pad + sx + nx]
    Im1 = base[pad - sy:pad - sy + ny, pad - sx:pad - sx + nx]
    return Im1, I0, I1


def _inputs(name, dtype=np.float64):
    return tuple(a.astype(dtype) for a in _synth(*SHAPES[name]))


def _calls(re, occ):
    """{name: the call} of both lanes, `re` and `occ` the multiscale
    robust-expo and TV-L1-with-occlusions entry points (tiled or not),
    each with its keywords."""
    def robust(name, method=1, dtype=np.float64, **kw):
        _, I0, I1 = _inputs(name, dtype)
        return lambda **more: re(I0, I1, method_type=method,
                                 outer_iter=RE_OUTER[method], **kw, **more)

    def occflow(name, dtype=np.float64, **kw):
        return lambda **more: occ(*_inputs(name, dtype), **kw, **more)

    return {
        "re1": robust("re1", nscales=NSCALES, with_diag=True),
        "re3": robust("re3", 3, nscales=NSCALES, with_diag=True),
        "re_level": robust("re1", nscales=1, with_diag=True),
        "re_odd": robust("odd", nscales=NSCALES, with_diag=True),
        "occ": occflow("occ", nscales=NSCALES, with_diag=True),
        "occ_fixed": occflow("occ", nscales=NSCALES, stop="fixed",
                             max_iterations=3, with_diag=True),
        "occ_odd": occflow("odd", nscales=NSCALES, with_diag=True),
        "re1_f32": robust("re1_f32", dtype=np.float32, nscales=NSCALES),
        "occ_f32": occflow("occ_f32", dtype=np.float32, nscales=NSCALES),
    }


def _rank(rank, world, url, out_dir):
    torch.set_num_threads(1)
    from tpuflow_torch.parallel import robust_expo_spatial, tvl1occflow_spatial
    from tpuflow_torch.parallel.distributed import initialize
    from tpuflow_torch.parallel.spatial import make_spatial_mesh

    assert initialize(url, world, rank, device="cpu")
    mesh = make_spatial_mesh()
    out = {"mesh": tuple(mesh.shape)}
    calls = _calls(lambda *a, **kw: robust_expo_spatial(*a, mesh=mesh, **kw),
                   lambda *a, **kw: tvl1occflow_spatial(*a, mesh=mesh, **kw))
    for name, call in calls.items():
        out[name] = call(device="cpu")
    # the default mesh, and a call without diag
    _, I0, I1 = _inputs("re1")
    out["re1_plain"] = robust_expo_spatial(I0, I1, nscales=NSCALES,
                                           outer_iter=RE_OUTER[1],
                                           device="cpu")
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    # leave the group before exiting: a gloo group torn down at exit can
    # abort the process
    dist.barrier()
    dist.destroy_process_group()


def _jax_references():
    import jax
    import jax.numpy as jnp

    from tpuflow.models.robust_expo import (_presmooth_reference,
                                            robust_expo_scale)
    from tpuflow.models.tvl1occflow import tvl1occflow
    from tpuflow.ops.normalize import normalize_joint

    def one_level():
        # robust_expo's level 0 at nscales=1: the joint normalisation
        # and the reference presmooth, then the scale from zero flow
        # with alpha int(50 * 1), dmax max(3, ceil(8 * 0.5**0)); eager,
        # since compiling its scan takes minutes here
        _, I0, I1 = (jnp.asarray(a)[None] for a in _inputs("re1"))
        with jax.disable_jit():
            a, b = (_presmooth_reference(t) for t in normalize_joint(I0, I1))
            zero = jnp.zeros(a.shape[1:], a.dtype)
            return robust_expo_scale(a, b, zero, zero, 1, 50.0,
                                     outer_iter=RE_OUTER[1], with_diag=True,
                                     warp_mode="fast", dmax=8)

    jobs = {"re_level": one_level,
            "occ": lambda: tvl1occflow(*(jnp.asarray(a)
                                         for a in _inputs("occ")),
                                       nscales=NSCALES, warp_mode="fast")}
    with ThreadPoolExecutor(2) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """(the ranks' saved results, the JAX package's results)."""
    tmp = tmp_path_factory.mktemp("spatial_methods")
    ctx = mp.spawn(_rank, args=(WORLD, f"file://{tmp}/rendezvous", str(tmp)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        jax_out = _jax_references()
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{WORLD} gloo ranks still ran after "
                            f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    return ranks, jax_out


@pytest.fixture(scope="module")
def untiled():
    """The port's untiled fast-warp solvers on the same calls."""
    from tpuflow_torch import robust_expo, tvl1occflow

    calls = _calls(robust_expo, tvl1occflow)
    return {name: call(warp_mode="fast", device="cpu")
            for name, call in calls.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _result(ranks, name):
    """Rank 0's result of `name`, after checking every rank has it."""
    first = ranks[0][name]
    fields = 3 if name.startswith("occ") else 2
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r[name][:fields],
                                                      first[:fields]))
    return first


def _epe(u, v, ur, vr):
    return float(np.hypot(np.asarray(u, np.float64) - np.asarray(ur),
                          np.asarray(v, np.float64) - np.asarray(vr)).mean())


def test_mesh_is_two_by_two(lane):
    ranks, _ = lane
    assert [r["mesh"] for r in ranks] == [(2, 2)] * WORLD


@pytest.mark.parametrize("name", ["re1", "re3", "re_odd"])
def test_robust_expo_spatial_matches_untiled(lane, untiled, name):
    """atol 1e-8, the same SOR sweeps at every solve; the levels that
    split ran on tiles, with the untiled diag plus "tiled"."""
    ranks, _ = lane
    u, v, diags = _result(ranks, name)
    ur, vr, rdiags = untiled[name]
    assert u.dtype == torch.float64 and u.shape == ur.shape
    _close(u, ur)
    _close(v, vr)
    assert [d["iterations"].tolist() for d in diags] == [
        d["iterations"].tolist() for d in rdiags]
    assert [d["tiled"] for d in diags] == (
        [True, False] if name == "re_odd" else [True, True])
    for d, rd in zip(diags, rdiags):
        assert set(d) == set(rd) | {"tiled"}
    if name == "re1":
        plain = ranks[0]["re1_plain"]
        assert torch.equal(plain[0], u) and torch.equal(plain[1], v)


@pytest.mark.parametrize("name", ["occ", "occ_fixed", "occ_odd"])
def test_tvl1occflow_spatial_matches_untiled(lane, untiled, name):
    """atol 1e-8, chi equal, the same iterations at every warp of every
    level; one host read an iteration with stop="error"."""
    ranks, _ = lane
    u1, u2, chi, diags = _result(ranks, name)
    ru1, ru2, rchi, rdiags = untiled[name]
    assert u1.dtype == torch.float64 and u1.shape == ru1.shape
    _close(u1, ru1)
    _close(u2, ru2)
    assert torch.equal(chi, rchi)
    assert [d["iterations"].tolist() for d in diags] == [
        d["iterations"].tolist() for d in rdiags]
    assert [d["tiled"] for d in diags] == (
        [True, False] if name == "occ_odd" else [True, True])
    fixed = name == "occ_fixed"
    for d in diags:
        assert d["host_reads"] == (0 if fixed else int(d["iterations"].sum()))
        if fixed:
            assert d["iterations"].tolist() == [3, 3]


@pytest.mark.parametrize("name", ["re1_f32", "occ_f32"])
def test_float32_within_jax_bounds(lane, untiled, name):
    """tests/test_spatial.py's float32 bounds: EPE < 1e-4, chi differing
    on fewer than 1% of the pixels."""
    ranks, _ = lane
    got, want = _result(ranks, name), untiled[name]
    assert got[0].dtype == torch.float32
    assert _epe(got[0], got[1], want[0], want[1]) < 1e-4
    if name == "occ_f32":
        assert float((got[2] != want[2]).double().mean()) < 0.01


def test_robust_expo_level_matches_jax(lane):
    """One level from zero flow against JAX's eager
    `robust_expo_scale(warp_mode="fast")`: atol 1e-8, the same sweeps."""
    ranks, jax_out = lane
    u, v, diags = _result(ranks, "re_level")
    ju, jv, jdiag = jax_out["re_level"]
    assert diags[0]["tiled"]
    _close(u, ju)
    _close(v, jv)
    assert diags[0]["iterations"].tolist() == np.asarray(
        jdiag["iterations"]).tolist()


def test_tvl1occflow_spatial_matches_jax(lane):
    """Two levels against JAX's `tvl1occflow(warp_mode="fast")`: atol
    1e-8, chi equal."""
    ranks, jax_out = lane
    u1, u2, chi, _ = _result(ranks, "occ")
    ju1, ju2, jchi = jax_out["occ"]
    _close(u1, ju1)
    _close(u2, ju2)
    np.testing.assert_array_equal(chi.numpy(), np.asarray(jchi))
