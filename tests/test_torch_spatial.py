"""The (y, x)-tiled multiscale TV-L1 (tpuflow_torch.parallel.spatial) on
the CPU with gloo, against the JAX package's GSPMD lane and the untiled
solvers, in float64.

Four gloo ranks are spawned once for the module, with a timeout, on the
2x2 mesh that `make_spatial_mesh` gives them.  At 64x128 with
nscales=3 (tests/test_spatial.py's case) every level splits over the
mesh and runs on tiles; at 44x128 level 2 has 11 rows and runs
replicated.  `tvl1_spatial` is held to JAX's `tvl1_spatial` and
`tvl1_multiscale(warp_mode="fast")` at atol 1e-8, JAX's own tolerance
(tests/test_spatial.py), and to the port's untiled
`tvl1_multiscale(warp_mode="fast")`, with the same iteration count for
every warp of every level.  The JAX package's calls run in the test
process while the ranks run.

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
SPAWN_TIMEOUT = 180  # seconds, rank start-up included
NSCALES = 3
# (ny, nx, seed): every level tiles; level 2 (11 rows) replicated
SHAPES = {"even": (64, 128, 3), "odd_level": (44, 128, 5)}


def _synth(ny, nx, seed, shift=(1, 1)):
    """tests/test_spatial.py's pair: a smooth texture and its copy
    shifted by `shift` pixels."""
    rng = np.random.default_rng(seed)
    pad = 4
    base = 128 + 50 * np.real(np.fft.ifft2(
        np.fft.fft2(rng.standard_normal((ny + 2 * pad, nx + 2 * pad)))
        * np.exp(-((np.fft.fftfreq(nx + 2 * pad)[None, :] ** 2
                    + np.fft.fftfreq(ny + 2 * pad)[:, None] ** 2)) * 500)))
    sy, sx = shift
    I0 = base[pad:pad + ny, pad:pad + nx]
    I1 = base[pad + sy:pad + sy + ny, pad + sx:pad + sx + nx]
    return I0, I1


def _rank(rank, world, url, out_dir):
    torch.set_num_threads(1)
    from tpuflow_torch.parallel.distributed import initialize
    from tpuflow_torch.parallel.spatial import (make_spatial_mesh,
                                                shard_spatial, tvl1_spatial)

    assert initialize(url, world, rank, device="cpu")
    mesh = make_spatial_mesh()
    out = {"mesh": (mesh.mesh_dim_names, tuple(mesh.shape)),
           "row_mesh": tuple(make_spatial_mesh(1, 4).shape)}
    I0, I1 = _synth(*SHAPES["even"])
    out["tile"] = shard_spatial((I0,), mesh)[0]
    out["even"] = tvl1_spatial(I0, I1, mesh, nscales=NSCALES, device="cpu")
    out["even_diag"] = tvl1_spatial(I0, I1, mesh, nscales=NSCALES,
                                    with_diag=True, device="cpu")
    out["odd_level"] = tvl1_spatial(*_synth(*SHAPES["odd_level"]), mesh,
                                    nscales=NSCALES, with_diag=True,
                                    device="cpu")
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    # leave the group before exiting: a gloo group torn down at exit can
    # abort the process
    dist.barrier()
    dist.destroy_process_group()


def _jax_references():
    import jax.numpy as jnp

    from tpuflow.models.tvl1 import tvl1_multiscale
    from tpuflow.parallel.spatial import make_spatial_mesh, tvl1_spatial

    I0, I1 = (jnp.asarray(a) for a in _synth(*SHAPES["even"]))
    jobs = {"spatial": lambda: tvl1_spatial(
                I0, I1, mesh=make_spatial_mesh(2, 2), nscales=NSCALES),
            "multiscale": lambda: tvl1_multiscale(
                I0, I1, nscales=NSCALES, warp_mode="fast")}
    with ThreadPoolExecutor(2) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: tuple(np.asarray(a) for a in f.result())
                for k, f in futures.items()}


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """(the ranks' saved results, the JAX package's results)."""
    tmp = tmp_path_factory.mktemp("spatial")
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


def _untiled(name):
    from tpuflow_torch import tvl1_multiscale

    ny, nx, seed = SHAPES[name]
    return tvl1_multiscale(*_synth(ny, nx, seed), nscales=NSCALES,
                           warp_mode="fast", with_diag=True, device="cpu")


def _close(got, want, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _same_on_every_rank(ranks, name):
    u, v = ranks[0][name][:2]
    for r in ranks[1:]:
        assert torch.equal(r[name][0], u) and torch.equal(r[name][1], v)
    return u, v


def test_mesh_factorization(lane):
    ranks, _ = lane
    for r in ranks:
        assert r["mesh"] == (("y", "x"), (2, 2))
        assert r["row_mesh"] == (1, 4)
    I0, _ = _synth(*SHAPES["even"])
    # rank r holds tile (r // 2, r % 2) of the 2x2 mesh
    for k, r in enumerate(ranks):
        oy, ox = (k // 2) * 32, (k % 2) * 64
        assert np.array_equal(r["tile"].numpy(), I0[oy:oy + 32, ox:ox + 64])


def test_tvl1_spatial_matches_jax(lane):
    ranks, jax_out = lane
    u, v = _same_on_every_rank(ranks, "even")
    assert u.dtype == torch.float64 and tuple(u.shape) == (64, 128)
    for key in ("spatial", "multiscale"):
        _close(u, jax_out[key][0])
        _close(v, jax_out[key][1])


@pytest.mark.parametrize("name", ["even", "odd_level"])
def test_tvl1_spatial_matches_untiled_counts(lane, name):
    """The untiled solver's result and iteration count at every warp of
    every level; the levels that split over the mesh ran on tiles."""
    ranks, _ = lane
    key = "even_diag" if name == "even" else name
    u, v = _same_on_every_rank(ranks, key)
    ur, vr, dr = _untiled(name)
    _close(u, ur)
    _close(v, vr)
    diags = ranks[0][key][2]
    assert [d["iterations"].tolist() for d in diags] == [
        d["iterations"].tolist() for d in dr]
    want_tiled = [True, True, True] if name == "even" else [True, True, False]
    assert [d["tiled"] for d in diags] == want_tiled
    for d in diags:
        if d["tiled"]:  # one stop read a tiled iteration
            assert d["host_reads"] == int(d["iterations"].sum())
    if name == "even":
        _close(u, ranks[0]["even"][0], atol=0)
        _close(v, ranks[0]["even"][1], atol=0)


def test_make_spatial_mesh_needs_a_process_group():
    from tpuflow_torch.parallel.spatial import make_spatial_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_spatial_mesh()
