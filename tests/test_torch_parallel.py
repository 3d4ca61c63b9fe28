"""The port's lanes on `torch.distributed` (tpuflow_torch.parallel) on
the CPU with gloo, against the port's full-image ops and the JAX
package.

Ranks are spawned by `torch.multiprocessing` once per module per lane,
each spawn with its own timeout, so a hung rank fails the test instead
of hanging the suite; each rank writes its results with `torch.save`
for the test process to read.  The tile lane runs on a 2x4 mesh ("y",
"x") of 8 ranks at 64x96 in float64 (32x24 tiles), as
tests/test_parallel.py does for the JAX package: every tiled op equals
the full-image op at atol 1e-12, each halo fill equals the matching
`np.pad`, and `tvl1_scale_tiled` is within EPE 1e-12 of the port's and
the JAX package's `tvl1_scale`.  The data-parallel lane runs 2 ranks on
mesh {"batch": 2}: each rank's `tvl1_batched` of its sample equals the
single-process call on that sample, as tests/test_distributed.py checks
for the JAX package.

Nothing of JAX is imported at module level: the spawned ranks import
this module to find their entry point.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NY, NX = 64, 96
MESH = {"y": 2, "x": 4}
TILE = (NY // 2, NX // 4)
FILL_HALO = 3
WARP_HALO = 8
TVL1_WARPS = 3
SIGMAS = (0.8, 1.5)
SPAWN_TIMEOUT = 180  # seconds per spawn, rank start-up included
DP_MAX_MOTION = 3


def _field(seed, amp=1.0):
    return amp * np.random.default_rng(seed).standard_normal((NY, NX))


def _tile_inputs(goldens):
    # |flow| stays <= WARP_HALO - 3 so the tiled warp is exact
    return {"I": _field(0), "f": _field(1), "v1": _field(2), "v2": _field(3),
            "img": _field(4, 100.0), "wimg": _field(5, 100.0),
            "u": np.clip(_field(6, 3.0), -5.0, 5.0),
            "v": np.clip(_field(7, 3.0), -5.0, 5.0),
            "n0": goldens["n0"], "n1": goldens["n1"]}


def _tile_rank(rank, world, url, out_dir, inputs):
    """One rank of the tile lane: its padded tiles per fill, and (rank
    0) every tiled op's gathered result."""
    torch.set_num_threads(1)
    from tpuflow_torch.parallel.distributed import initialize
    from tpuflow_torch.parallel.halo import FILLS, exchange_2d
    from tpuflow_torch.parallel.mesh import (gather_spatial, make_mesh,
                                             spatial_block)
    from tpuflow_torch.parallel.tiled import (TileGeom,
                                              centered_gradient_tiled,
                                              divergence_tiled,
                                              forward_gradient_tiled,
                                              gaussian_tiled,
                                              tvl1_scale_tiled,
                                              warp_planes_tiled)

    assert initialize(url, world, rank, device="cpu")
    mesh = make_mesh(MESH)
    geom = TileGeom(mesh, *TILE)
    t = {k: spatial_block(torch.as_tensor(v), mesh) for k, v in inputs.items()}

    def whole(*tiles):
        return [gather_spatial(x, mesh) for x in tiles]

    out = {"origin": list(geom.origins()),
           "padded": {fill: exchange_2d(t["I"], FILL_HALO, mesh, fill=fill)
                      for fill in FILLS}}
    ops = {
        "centered_gradient": whole(*centered_gradient_tiled(t["I"], geom)),
        "forward_gradient": whole(*forward_gradient_tiled(t["f"], geom)),
        "divergence": whole(divergence_tiled(t["v1"], t["v2"], geom)),
        "warp": whole(warp_planes_tiled(t["wimg"][None], t["u"], t["v"],
                                        geom, WARP_HALO)[0]),
    }
    for sigma in SIGMAS:
        ops[f"gaussian_{sigma}"] = whole(gaussian_tiled(t["img"], sigma, geom))
    zero = torch.zeros_like(t["n0"])
    u1, u2, diag = tvl1_scale_tiled(t["n0"], t["n1"], zero, zero, geom,
                                    WARP_HALO, warps=TVL1_WARPS,
                                    with_diag=True)
    ops["tvl1_scale"] = whole(u1, u2)
    out["tvl1_diag"] = diag
    if rank == 0:
        out["ops"] = ops
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    # leave the group before exiting: a gloo group torn down at exit can
    # abort the process
    dist.barrier()
    dist.destroy_process_group()


def _dp_step(I0, I1):
    from tpuflow_torch import tvl1_batched

    return tvl1_batched(I0, I1, max_motion=DP_MAX_MOTION, device="cpu")


def _dp_batch(B):
    rng = np.random.default_rng(B)
    base = rng.uniform(0, 255, (B, 16, 24))
    return base, np.roll(base, 1, axis=-1)


def _dp_rank(rank, world, url, out_dir, I0, I1):
    """One rank of the data-parallel lane: its sample's flow, gathered,
    and the scaling measurement at n = 1, 2."""
    torch.set_num_threads(1)
    from tpuflow_torch.parallel.distributed import (dp_efficiency, dp_shard,
                                                    initialize)
    from tpuflow_torch.parallel.mesh import gather_batch, make_mesh

    assert initialize(url, world, rank, device="cpu")
    mesh = make_mesh({"batch": -1})
    a, b = dp_shard((I0, I1), mesh, device="cpu")
    u, v = _dp_step(a, b)
    out = {"local_shape": list(a.shape),
           "u": gather_batch(u, mesh), "v": gather_batch(v, mesh),
           "scaling": dp_efficiency(_dp_step, _dp_batch, 1, repeats=1,
                                    device="cpu")}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    # leave the group before exiting: a gloo group torn down at exit can
    # abort the process
    dist.barrier()
    dist.destroy_process_group()


def _spawn(fn, world, tmp_path, *args):
    """Run fn(rank, world, url, out_dir, *args) on `world` gloo ranks;
    their saved results, by rank.  Fails the test if a rank raises or
    the ranks outlive SPAWN_TIMEOUT."""
    url = f"file://{tmp_path}/rendezvous"
    ctx = mp.spawn(fn, args=(world, url, str(tmp_path), *args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks still ran after {SPAWN_TIMEOUT} s")
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def tile_lane(solver_goldens, tmp_path_factory):
    inputs = _tile_inputs(solver_goldens)
    ranks = _spawn(_tile_rank, 8, tmp_path_factory.mktemp("tiles"), inputs)
    return inputs, ranks


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_mesh_origins(tile_lane):
    _, ranks = tile_lane
    # rank r sits at (r // 4, r % 4) of the 2x4 mesh
    assert [r["origin"] for r in ranks] == [
        [(r // 4) * TILE[0], (r % 4) * TILE[1]] for r in range(8)]


def _np_pad(a, halo, fill):
    if fill == "edge":
        return np.pad(a, halo, "edge")
    if fill == "zero":
        return np.pad(a, halo, "constant")
    if fill == "symmetric":
        return np.pad(a, halo, "symmetric")
    # the reference Gaussian's pad: mirror without the edge on the
    # leading sides, with it on the trailing sides
    lead = np.pad(a, ((halo, 0), (halo, 0)), "reflect")
    return np.pad(lead, ((0, halo), (0, halo)), "symmetric")


@pytest.mark.parametrize("fill", ["edge", "zero", "gaussian", "symmetric"])
def test_halo_fill_matches_np_pad(tile_lane, fill):
    inputs, ranks = tile_lane
    want = _np_pad(inputs["I"], FILL_HALO, fill)
    h, w = TILE
    for r in ranks:
        oy, ox = r["origin"]
        win = want[oy:oy + h + 2 * FILL_HALO, ox:ox + w + 2 * FILL_HALO]
        _close(r["padded"][fill], win, atol=0)


def test_tiled_stencils_match_full_image_ops(tile_lane):
    from tpuflow_torch import ops

    inputs, ranks = tile_lane
    got = ranks[0]["ops"]
    for g, w in zip(got["centered_gradient"],
                    ops.centered_gradient(_t(inputs["I"]))):
        _close(g, w)
    for g, w in zip(got["forward_gradient"],
                    ops.forward_gradient(_t(inputs["f"]))):
        _close(g, w)
    _close(got["divergence"][0],
           ops.divergence(_t(inputs["v1"]), _t(inputs["v2"])))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_gaussian_tiled(tile_lane, sigma):
    from tpuflow_torch import ops

    inputs, ranks = tile_lane
    _close(ranks[0]["ops"][f"gaussian_{sigma}"][0],
           ops.gaussian(_t(inputs["img"]), sigma))


def test_warp_tiled(tile_lane):
    from tpuflow_torch import ops

    inputs, ranks = tile_lane
    _close(ranks[0]["ops"]["warp"][0],
           ops.warp(_t(inputs["wimg"]), _t(inputs["u"]), _t(inputs["v"]),
                    border_out=True))


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


def test_tvl1_scale_tiled_matches_both_tvl1_scales(tile_lane):
    import jax.numpy as jnp

    from tpuflow.models.tvl1 import tvl1_scale as jax_tvl1_scale
    from tpuflow_torch.models.tvl1 import tvl1_scale

    inputs, ranks = tile_lane
    u_t, v_t = ranks[0]["ops"]["tvl1_scale"]
    n0, n1 = _t(inputs["n0"]), _t(inputs["n1"])
    zero = torch.zeros_like(n0)
    u_p, v_p, diag = tvl1_scale(n0, n1, zero, zero, warps=TVL1_WARPS,
                                with_diag=True)
    assert _epe(u_t, v_t, u_p, v_p) <= 1e-12
    # every tile stopped together, at the full-image solve's counts
    its = [r["tvl1_diag"]["iterations"] for r in ranks]
    assert its == [diag["iterations"].tolist()] * 8
    assert ranks[0]["tvl1_diag"]["host_reads"] == sum(its[0])
    jz = jnp.zeros((NY, NX), jnp.float64)
    ju, jv = jax_tvl1_scale(jnp.asarray(inputs["n0"]),
                            jnp.asarray(inputs["n1"]), jz, jz,
                            warps=TVL1_WARPS)
    assert _epe(u_t, v_t, ju, jv) <= 1e-12


def test_data_parallel_equals_single_process(tmp_path):
    from tpuflow_torch import tvl1_batched

    I0, I1 = _dp_batch(2)
    ranks = _spawn(_dp_rank, 2, tmp_path, I0, I1)
    assert [r["local_shape"] for r in ranks] == [[1, 16, 24]] * 2
    for b in range(2):
        u, v = tvl1_batched(I0[b:b + 1], I1[b:b + 1],
                            max_motion=DP_MAX_MOTION, device="cpu")
        for r in ranks:
            assert torch.equal(r["u"][b], u[0]) and torch.equal(r["v"][b], v[0])
    scaling = ranks[0]["scaling"]
    assert sorted(scaling) == [1, 2] and scaling[1]["efficiency"] == 1.0
    assert all(s["fields_per_sec"] > 0 for s in scaling.values())
    assert ranks[1]["scaling"] == scaling  # the slowest rank's time, on all
