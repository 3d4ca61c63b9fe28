"""Spatial (y, x) tiling of the multiscale solvers over a 2-D mesh.

Counterpart of tpuflow/parallel/spatial.py.  The JAX package places the
images with a (y, x) sharding and lets XLA's partitioner (GSPMD) split
the unmodified multiscale solver.  PyTorch has no partitioner, so here
each level is tiled by hand on tpuflow_torch.parallel.tiled:

  * the pyramid (joint normalisation, presmoothing, `zoom_out`) and the
    between-level `zoom_in` run replicated on every rank, as the JAX
    package's temporal lane runs its pyramid: no level has to split
    evenly for the pyramid to be right, and no min / max is reduced;
  * a level whose (ny, nx) splits evenly over the mesh's (y, x) is
    solved on tiles: the warp loop of `tvl1_warps_tiled`, whose inner
    iterations run the halo-exchanged divergence and forward gradient
    with the convergence error summed over all tiles, so every tile
    stops at the untiled solver's iteration;
  * any other level is solved replicated, by the untiled solver, on
    every rank.  At 1024x436 on a mesh of 2 rows, levels 0-1 (436 and
    218 rows) tile and level 2 (109 rows) and those below do not.

The warp of a tiled level gathers the flow's tiles and warps the whole
level on every rank (`warp_by_mode`: `warp_planes_bounded` for
warp_mode="fast", the default here as in the JAX package), then keeps
this rank's tile.  That is what the JAX package's Pallas warp amounts to
on sharded inputs, since XLA cannot split a `pallas_call`: on the card
each rank launches K5 on levels of at least 96x96 px and K5p below, the
route chosen by the whole level's size as the untiled solver chooses it.

`robust_expo_spatial` and `tvl1occflow_spatial` are not ported yet.
"""

from functools import partial

import torch
import torch.distributed as dist

from tpuflow_torch.models.tvl1 import tvl1_multiscale, tvl1_scale
from tpuflow_torch.ops.gradients import centered_gradient
from tpuflow_torch.ops.interp import warp_by_mode
from tpuflow_torch.parallel.mesh import (axis_size, gather_spatial,
                                         make_mesh, spatial_block)
from tpuflow_torch.parallel.tiled import TileGeom, tvl1_warps_tiled


def make_spatial_mesh(y=None, x=None):
    """A (y, x) mesh over the process group's ranks; by default the most
    nearly square factorisation of the world size (y <= x).  y * x must
    be the world size."""
    if y is None or x is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        y = max(c for c in range(1, int(n ** 0.5) + 1) if n % c == 0)
        x = n // y
    return make_mesh({"y": y, "x": x})


def shard_spatial(arrays, mesh):
    """This rank's tile of each global (..., H, W) tensor or array over
    mesh dimensions ("y", "x")."""
    return tuple(spatial_block(torch.as_tensor(a), mesh) for a in arrays)


def tvl1_scale_spatial(I0, I1, u1, u2, tau, lam, theta, warps, epsilon,
                       max_iterations, stop, with_diag=False,
                       warp_mode="fast", dmax=8, mesh=None):
    """`tpuflow_torch.models.tvl1.tvl1_scale` on the whole (ny, nx)
    level, the same on every rank, solved on tiles of `mesh` when both
    sizes split evenly over its "y" and "x", replicated otherwise.
    Returns the whole level's (u1, u2) on every rank; with
    `with_diag=True` also {"iterations": (warps,) int32, "error":
    (warps,), "tiled": bool}, with "host_reads" on a tiled level."""
    ny, nx = I0.shape[-2:]
    rows, cols = axis_size(mesh, "y"), axis_size(mesh, "x")
    if ny % rows or nx % cols:
        out = tvl1_scale(I0, I1, u1, u2, tau, lam, theta, warps, epsilon,
                         max_iterations, stop, with_diag=with_diag,
                         warp_mode=warp_mode, dmax=dmax)
        if with_diag:
            out[2]["tiled"] = False
        return out
    geom = TileGeom(mesh, ny // rows, nx // cols)
    planes = torch.stack([I1, *centered_gradient(I1)])

    def warp(u, v):
        whole = warp_by_mode(planes, gather_spatial(u, mesh),
                             gather_spatial(v, mesh), warp_mode, dmax)
        return spatial_block(whole, mesh).unbind(0)

    t0, tu, tv = shard_spatial((I0, u1, u2), mesh)
    tu, tv, diag = tvl1_warps_tiled(t0, tu, tv, geom, warp, tau, lam, theta,
                                    warps, epsilon, max_iterations, stop)
    u1, u2 = gather_spatial(tu, mesh), gather_spatial(tv, mesh)
    if with_diag:
        return u1, u2, {
            "iterations": torch.tensor(diag["iterations"], dtype=torch.int32),
            "error": torch.tensor(diag["error"], dtype=I0.dtype),
            "host_reads": diag["host_reads"], "tiled": True}
    return u1, u2


def tvl1_spatial(I0, I1, mesh=None, **kwargs):
    """Multiscale TV-L1 tiled over a (y, x) mesh: the arguments and the
    result of `tpuflow_torch.models.tvl1.tvl1_multiscale` (whose
    warp_mode defaults here to "fast", as the JAX package's does), with
    the (H, W) images the same on every rank of `mesh` (default
    `make_spatial_mesh()`) and the whole (H, W) flow returned on every
    rank.  Each level runs `tvl1_scale_spatial`: on tiles where it
    splits evenly over the mesh, replicated where it does not; with
    `with_diag=True` each level's diag says which ("tiled")."""
    mesh = make_spatial_mesh() if mesh is None else mesh
    kwargs.setdefault("warp_mode", "fast")
    return tvl1_multiscale(I0, I1,
                           scale_solver=partial(tvl1_scale_spatial, mesh=mesh),
                           **kwargs)
