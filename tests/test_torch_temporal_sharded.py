"""The frame-sharded Brox temporal lane (tpuflow_torch.parallel.temporal)
on the CPU with gloo, against the JAX package's lane and the single-
device solvers of both packages, in float64.

Four gloo ranks are spawned once for the module, with a timeout: mesh
{"t": 2, "rest": 2} runs 2 shards (the "rest" ranks repeat them) and
mesh {"t": 4} runs 4.  Each rank saves every case's result with
`torch.save`; while the ranks run, the test process computes the JAX
package's results (tests/test_temporal_sharded.py's cases: 5 frames of
24x32 at 2 and 4 shards, uneven frame counts 4, 6 and 7 on 4 shards, the
error stop, and the multiscale solver on 5 frames of 40x48 on 4
shards).  The odd case, 7 frames on 2 shards (3 fields a rank), fails
if the red-black colours follow the local field index instead of the
global one.

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
NY, NX = 24, 32
FIXED = dict(outer_iter=3, inner_iter=1, stop="fixed", maxiter=12)
UNEVEN = dict(outer_iter=2, inner_iter=1, stop="fixed", maxiter=8)
# a tol at which the four solves stop at different sweeps, below the cap
ERROR = dict(outer_iter=4, inner_iter=1, stop="error", tol=1.5e-3)
MULTI = dict(nscales=2, outer_iter=2, inner_iter=1, stop="fixed", maxiter=8)
MULTI_SHAPE = (40, 48)
# name: (frames, shards, keywords)
CASES = {
    "even_2": (5, 2, FIXED),
    "even_4": (5, 4, FIXED),
    "uneven_4": (4, 4, UNEVEN),
    "uneven_6": (6, 4, UNEVEN),
    "uneven_7": (7, 4, UNEVEN),
    "odd_tl_2": (7, 2, UNEVEN),
    "error_2": (5, 2, ERROR),
    "error_4": (6, 4, ERROR),
}


def _volume(frames=5, ny=NY, nx=NX, seed=3):
    """tests/test_temporal_sharded.py's volume: a smooth texture rolled
    one column a frame."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((ny, nx))
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    base = np.real(np.fft.ifft2(np.fft.fft2(noise)
                                * np.exp(-(fx ** 2 + fy ** 2) * 500.0)))
    base = 128 + 90 * base / np.abs(base).max()
    return np.stack([np.roll(base, f, axis=1) for f in range(frames)])


def _rank(rank, world, url, out_dir):
    """One rank: every case on its mesh, and the multiscale solver."""
    torch.set_num_threads(1)
    from tpuflow_torch.parallel.distributed import initialize
    from tpuflow_torch.parallel.mesh import make_mesh
    from tpuflow_torch.parallel.temporal import (
        brox_temporal_multiscale_sharded, brox_temporal_sharded)

    assert initialize(url, world, rank, device="cpu")
    meshes = {2: make_mesh({"t": 2, "rest": 2}), 4: make_mesh({"t": 4})}
    out = {}
    for name, (frames, shards, kw) in CASES.items():
        out[name] = brox_temporal_sharded(_volume(frames), meshes[shards],
                                          with_diag=True, device="cpu", **kw)
    out["multi"] = brox_temporal_multiscale_sharded(
        _volume(5, *MULTI_SHAPE), meshes[4], with_diag=True, device="cpu",
        **MULTI)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    # leave the group before exiting: a gloo group torn down at exit can
    # abort the process
    dist.barrier()
    dist.destroy_process_group()


def _jax_references():
    """The JAX package's results: its lane at 2 and 4 shards and its
    multiscale lane, and its single-device solver on each volume."""
    import jax.numpy as jnp

    from tpuflow.models.brox_temporal import brox_temporal_scale
    from tpuflow.parallel.mesh import make_mesh
    from tpuflow.parallel.temporal import (brox_temporal_multiscale_sharded,
                                           brox_temporal_sharded)

    def scale(frames, kw):
        z = jnp.zeros((frames - 1, NY, NX), jnp.float64)
        return brox_temporal_scale(jnp.asarray(_volume(frames)), z, z, **kw)

    jobs = {
        "sharded_2": lambda: brox_temporal_sharded(
            jnp.asarray(_volume(5)), make_mesh({"t": 2, "rest": -1}), **FIXED),
        "sharded_4": lambda: brox_temporal_sharded(
            jnp.asarray(_volume(5)), make_mesh({"t": 4, "rest": -1}), **FIXED),
        "scale_5": lambda: scale(5, FIXED),
        "multi": lambda: brox_temporal_multiscale_sharded(
            jnp.asarray(_volume(5, *MULTI_SHAPE)),
            make_mesh({"t": 4, "rest": -1}), **MULTI),
        **{f"scale_{f}_uneven": (lambda f=f: scale(f, UNEVEN))
           for f in (4, 6, 7)},
    }
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: tuple(np.asarray(a) for a in f.result())
                for k, f in futures.items()}


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """(the ranks' saved results, the JAX package's results)."""
    tmp = tmp_path_factory.mktemp("temporal")
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


def _port_scale(frames, kw):
    from tpuflow_torch.models.brox_temporal import brox_temporal_scale

    z = torch.zeros((frames - 1, NY, NX), dtype=torch.float64)
    return brox_temporal_scale(torch.as_tensor(_volume(frames)), z, z,
                               with_diag=True, **kw)


def _close(got, want, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _same_on_every_rank(ranks, name):
    u, v = ranks[0][name][:2]
    for r in ranks[1:]:
        assert torch.equal(r[name][0], u) and torch.equal(r[name][1], v)
    return u, v


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_matches_jax_lane_and_single_device(lane, shards):
    ranks, jax_out = lane
    u, v = _same_on_every_rank(ranks, f"even_{shards}")
    assert u.dtype == torch.float64 and tuple(u.shape) == (4, NY, NX)
    for ref in (jax_out[f"sharded_{shards}"], jax_out["scale_5"],
                _port_scale(5, FIXED)):
        _close(u, ref[0])
        _close(v, ref[1])


@pytest.mark.parametrize("frames", [4, 6, 7])
def test_uneven_fields(lane, frames):
    """(T-1) fields that do not divide by 4 shards: padded fields are
    frozen and real ones clamp by global index, so the result is the
    single-device one, of shape (T-1, H, W)."""
    ranks, jax_out = lane
    u, v = _same_on_every_rank(ranks, f"uneven_{frames}")
    assert tuple(u.shape) == tuple(v.shape) == (frames - 1, NY, NX)
    for ref in (jax_out[f"scale_{frames}_uneven"], _port_scale(frames, UNEVEN)):
        _close(u, ref[0])
        _close(v, ref[1])


def test_odd_fields_per_rank_take_global_colours(lane):
    """7 frames on 2 shards: 3 fields a rank, so rank 1's first field
    has global index 3 and the other colour than its local index 0."""
    ranks, jax_out = lane
    u, v = _same_on_every_rank(ranks, "odd_tl_2")
    for ref in (jax_out["scale_7_uneven"], _port_scale(7, UNEVEN)):
        _close(u, ref[0])
        _close(v, ref[1])


@pytest.mark.parametrize("name", ["error_2", "error_4"])
def test_error_stop_sweeps_equal_single_device(lane, name):
    """The stop error summed over the ranks: every solve stops at the
    single-device solver's sweep, one host read a sweep."""
    ranks, _ = lane
    frames = CASES[name][0]
    u, v = _same_on_every_rank(ranks, name)
    ur, vr, dr = _port_scale(frames, ERROR)
    its = dr["iterations"].tolist()
    assert len(set(sum(its, []))) > 2 and max(sum(its, [])) < 300
    for r in ranks:
        assert r[name][2]["iterations"].tolist() == its
        assert r[name][2]["host_reads"] == dr["host_reads"]
    _close(u, ur)
    _close(v, vr)


def test_multiscale_matches_jax_lane_and_single_device(lane):
    from tpuflow_torch import brox_temporal

    ranks, jax_out = lane
    u, v = _same_on_every_rank(ranks, "multi")
    diags = ranks[0]["multi"][2]
    assert len(diags) == MULTI["nscales"]
    assert all(d["iterations"].tolist() == [[8]] * 2 for d in diags)
    ur, vr = brox_temporal(_volume(5, *MULTI_SHAPE), warp_mode="exact",
                           device="cpu", **MULTI)
    for ref in (jax_out["multi"], (ur, vr)):
        _close(u, ref[0])
        _close(v, ref[1])


def test_two_frames_refused():
    from tpuflow_torch.parallel.temporal import brox_temporal_multiscale_sharded

    with pytest.raises(ValueError, match="more than two frames"):
        brox_temporal_multiscale_sharded(_volume(2), None, device="cpu")
