"""Spatial (y, x) tiling of the multiscale solvers over a 2-D mesh.

Counterpart of tpuflow/parallel/spatial.py.  The JAX package places the
images with a (y, x) sharding and lets XLA's partitioner (GSPMD) split
the unmodified multiscale solvers.  PyTorch has no partitioner, so here
each level is tiled by hand on tpuflow_torch.parallel.tiled, for the
three solvers the JAX module splits, `tvl1_spatial`,
`robust_expo_spatial` and `tvl1occflow_spatial`:

  * the pyramid (normalisation, presmoothing, `zoom_out`) and the
    between-level `zoom_in` run replicated on every rank, as the JAX
    package's temporal lane runs its pyramid: no level has to split
    evenly for the pyramid to be right, and no min / max is reduced;
  * a level whose (ny, nx) splits evenly over the mesh's (y, x) is
    solved on tiles: each solver's own iteration (`tvl1_warps_tiled`,
    `robust_expo.outer_iterations`, `tvl1occflow.warp_iterations`) runs
    on this rank's tiles with the halo-exchanged stencils, and its
    stop error is summed over all tiles before each test, so every
    tile stops at the untiled solver's iteration or sweep;
  * any other level is solved replicated, by the untiled solver, on
    every rank.  At 1024x436 on a mesh of 2 rows, levels 0-1 (436 and
    218 rows) tile and level 2 (109 rows) and those below do not.

What a level computes once from its images is computed on the whole,
replicated level and then cut to the tile: robust-expo's derivative
planes, image-1 gradients and diffusivity, so DF-AUTO's percentile is
taken over the whole level with no gather (the JAX module's "one
all-gather per scale", free here since every rank holds the level);
TV-L1 with occlusions' edge indicator g.

The warp of a tiled level gathers the flow's tiles and warps the whole
level on every rank (`warp_by_mode`: `warp_planes_bounded` for
warp_mode="fast", the default here as in the JAX package), then keeps
this rank's tile.  That is what the JAX package's Pallas warp amounts to
on sharded inputs, since XLA cannot split a `pallas_call`: on the card
each rank launches K5 on levels of at least 96x96 px and K5p below (TV-L1
with occlusions: K5p without border_out at every level), the route
chosen by the whole level's size as the untiled solver chooses it.
Robust-expo's SOR solve is treated the same way: the JAX package sends
it to its Pallas SOR, which XLA cannot split either, so each solve
gathers the tiles of (du, dv) and of the 9 constant planes, runs
`brox_sor_error` (K7 on the card) on the whole level on every rank and
keeps this rank's tile; it thus stops at the untiled solver's sweep.
The tiled ROF, median and chi steps are plain PyTorch, as the JAX
package's partitioned ones are plain XLA.
"""

from functools import partial

import torch
import torch.distributed as dist

from tpuflow_torch.models.brox_spatial import _sor_solve
from tpuflow_torch.models.robust_expo import (derivative_planes,
                                              exponential_diffusivity,
                                              outer_iterations, robust_expo,
                                              robust_expo_scale)
from tpuflow_torch.models.tvl1 import tvl1_multiscale, tvl1_scale
from tpuflow_torch.models.tvl1occflow import (edge_indicator, tvl1occ_scale,
                                              tvl1occflow, warp_iterations)
from tpuflow_torch.ops.gradients import centered_gradient
from tpuflow_torch.ops.interp import warp_by_mode
from tpuflow_torch.parallel.mesh import (axis_size, gather_spatial,
                                         make_mesh, spatial_block)
from tpuflow_torch.parallel.tiled import (TileGeom, centered_gradient_tiled,
                                          divergence_tiled,
                                          forward_gradient_tiled,
                                          median_filter_tiled,
                                          psi_divergence_tiled,
                                          psi_weighted_divergence_tiled,
                                          rof_box_tiled, tvl1_warps_tiled)


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


def _tile_geom(mesh, ny, nx):
    """The TileGeom of an (ny, nx) level on `mesh`, or None where the
    level does not split evenly over the mesh's "y" and "x"."""
    rows, cols = axis_size(mesh, "y"), axis_size(mesh, "x")
    if ny % rows or nx % cols:
        return None
    return TileGeom(mesh, ny // rows, nx // cols)


def _replicated(out, with_diag):
    """An untiled solver's result, its diag marked "tiled": False."""
    if with_diag:
        out[-1]["tiled"] = False
    return out


def tvl1_scale_spatial(I0, I1, u1, u2, tau, lam, theta, warps, epsilon,
                       max_iterations, stop, with_diag=False,
                       warp_mode="fast", dmax=8, mesh=None):
    """`tpuflow_torch.models.tvl1.tvl1_scale` on the whole (ny, nx)
    level, the same on every rank, solved on tiles of `mesh` when both
    sizes split evenly over its "y" and "x", replicated otherwise.
    Returns the whole level's (u1, u2) on every rank; with
    `with_diag=True` also {"iterations": (warps,) int32, "error":
    (warps,), "tiled": bool}, with "host_reads" on a tiled level."""
    geom = _tile_geom(mesh, *I0.shape[-2:])
    if geom is None:
        return _replicated(tvl1_scale(
            I0, I1, u1, u2, tau, lam, theta, warps, epsilon, max_iterations,
            stop, with_diag=with_diag, warp_mode=warp_mode, dmax=dmax),
            with_diag)
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


def robust_expo_scale_spatial(I1, I2, u, v, method_type, alpha, gamma, lam,
                              tol, inner_iter, outer_iter, stop, maxiter,
                              with_diag=False, warp_mode="fast", dmax=8,
                              mesh=None):
    """`tpuflow_torch.models.robust_expo.robust_expo_scale` on the whole
    (C, ny, nx) level, the same on every rank, solved on tiles of `mesh`
    when (ny, nx) splits evenly over its "y" and "x", replicated
    otherwise.  A tiled level computes the derivative planes of I2, the
    gradients of I1 and the diffusivity on the whole level (DF-AUTO's
    percentile over the whole level, no gather), then keeps this rank's
    tiles; each outer iteration gathers the flow, warps the whole level
    and keeps the tile, builds the system's constants on the tile, and
    each solve gathers (du, dv) and the constants, runs `brox_sor_error`
    (K7) on the whole level and keeps the tile.  Returns the whole
    level's (u, v) on every rank; with `with_diag=True` also the untiled
    diag plus "tiled"."""
    nz, ny, nx = I1.shape
    geom = _tile_geom(mesh, ny, nx)
    if geom is None:
        return _replicated(robust_expo_scale(
            I1, I2, u, v, method_type, alpha, gamma, lam, tol, inner_iter,
            outer_iter, stop, maxiter, with_diag=with_diag,
            warp_mode=warp_mode, dmax=dmax), with_diag)
    size = nx * ny * nz  # the whole level's, as the untiled solver's
    I1x, I1y = centered_gradient(I1)
    planes = derivative_planes(I2)
    expo = exponential_diffusivity(I1x, I1y, method_type, alpha, lam)

    def warp(tu, tv):
        return spatial_block(warp_by_mode(
            planes, gather_spatial(tu, mesh), gather_spatial(tv, mesh),
            warp_mode, dmax), mesh)

    def sor(du, dv, Au, Av, Du, Dv, D, psis):
        whole = gather_spatial(torch.stack([du, dv, Au, Av, Du, Dv, D,
                                            *psis]), mesh).unbind(0)
        du, dv, nsor, err = _sor_solve(*whole[:7], alpha, whole[7:], None,
                                       tol, size, stop, maxiter)
        return (*spatial_block(torch.stack([du, dv]), mesh).unbind(0), nsor,
                err)

    t1, t1x, t1y, texpo, tu, tv = shard_spatial((I1, I1x, I1y, expo, u, v),
                                                mesh)
    tu, tv, nsors, errs = outer_iterations(
        t1, t1x, t1y, texpo, tu, tv, warp, sor, alpha, gamma, inner_iter,
        outer_iter, gradient=partial(centered_gradient_tiled, geom=geom),
        psi_div=partial(psi_divergence_tiled, geom=geom),
        psi_wdiv=partial(psi_weighted_divergence_tiled, geom=geom))
    u, v = gather_spatial(tu, mesh), gather_spatial(tv, mesh)
    if with_diag:
        return u, v, {
            "iterations": torch.stack(nsors).reshape(outer_iter, inner_iter),
            "error": torch.stack(errs).reshape(outer_iter, inner_iter),
            "warp_overflow_tiles": torch.zeros((), dtype=torch.int32,
                                               device=u.device),
            "tiled": True}
    return u, v


def robust_expo_spatial(I1, I2, mesh=None, **kwargs):
    """Multiscale robust-expo tiled over a (y, x) mesh: the arguments
    and the result of `tpuflow_torch.models.robust_expo.robust_expo`
    (whose warp_mode defaults here to "fast", as the JAX package's
    does), with the images the same on every rank of `mesh` (default
    `make_spatial_mesh()`) and the whole flow returned on every rank.
    Each level runs `robust_expo_scale_spatial`; with `with_diag=True`
    each level's diag says whether it ran on tiles ("tiled")."""
    mesh = make_spatial_mesh() if mesh is None else mesh
    kwargs.setdefault("warp_mode", "fast")
    return robust_expo(
        I1, I2, scale_solver=partial(robust_expo_scale_spatial, mesh=mesh),
        **kwargs)


def tvl1occ_scale_spatial(Im1, I0, I1, filt_i0, u1, u2, chi, lam, alpha,
                          beta, theta, warps, epsilon, stop, max_iterations,
                          with_diag=False, warp_mode="fast", dmax=8,
                          mesh=None):
    """`tpuflow_torch.models.tvl1occflow.tvl1occ_scale` on the whole
    (ny, nx) level, the same on every rank, solved on tiles of `mesh`
    when it splits evenly over its "y" and "x", replicated otherwise.
    A tiled level computes the edge indicator g on the whole level and
    keeps its tile; each warp gathers the flow, warps the whole level by
    +u and -u (border_out off) and keeps the tiles; the iterations run
    `solver_wrt_v` on the tiles, the ROF box relaxation, the 3x3 median
    and the chi loop on the halo-exchanged stencils, and sum the stop
    error over all tiles before each test (one host read an iteration).
    The ROF and chi duals start at 0 and stay tiles.  Returns the whole
    level's (u1, u2, chi) on every rank; with `with_diag=True` also the
    untiled diag plus "tiled"."""
    ny, nx = I0.shape[-2:]
    geom = _tile_geom(mesh, ny, nx)
    if geom is None:
        return _replicated(tvl1occ_scale(
            Im1, I0, I1, filt_i0, u1, u2, chi, lam, alpha, beta, theta,
            warps, epsilon, stop, max_iterations, with_diag=with_diag,
            warp_mode=warp_mode, dmax=dmax), with_diag)
    fwd_planes = torch.stack([I1, *centered_gradient(I1)])
    bck_planes = torch.stack([Im1, *centered_gradient(Im1)])

    def warp(tu1, tu2):
        a, b = gather_spatial(tu1, mesh), gather_spatial(tu2, mesh)
        both = torch.cat([
            warp_by_mode(fwd_planes, a, b, warp_mode, dmax, border_out=False),
            warp_by_mode(bck_planes, -a, -b, warp_mode, dmax,
                         border_out=False)])
        return spatial_block(both, mesh).unbind(0)

    def rof(u, f, p1, p2, g, lam, omega, n_iter):
        return rof_box_tiled(u, f, p1, p2, g, lam, geom, omega, n_iter)

    t0, tg, tu1, tu2, tchi = shard_spatial(
        (I0, edge_indicator(filt_i0), u1, u2, chi), mesh)
    tu1, tu2, tchi, ns, errs, host_reads = warp_iterations(
        t0, tu1, tu2, tchi, tg, warp, lam, alpha, beta, theta, warps,
        epsilon, stop, max_iterations, ny * nx,
        forward_gradient=partial(forward_gradient_tiled, geom=geom),
        divergence=partial(divergence_tiled, geom=geom), rof=rof,
        median=lambda I, wsize: median_filter_tiled(I, geom, wsize),
        total=geom.psum)
    u1, u2, chi = (gather_spatial(t, mesh) for t in (tu1, tu2, tchi))
    if with_diag:
        return u1, u2, chi, {
            "iterations": torch.tensor(ns, dtype=torch.int32,
                                       device=I0.device),
            "error": torch.stack(errs), "host_reads": host_reads,
            "tiled": True}
    return u1, u2, chi


def tvl1occflow_spatial(Im1, I0, I1, filt_i0=None, mesh=None, **kwargs):
    """Multiscale TV-L1 with occlusions tiled over a (y, x) mesh: the
    arguments and the result (u1, u2, chi) of
    `tpuflow_torch.models.tvl1occflow.tvl1occflow` (whose warp_mode
    defaults here to "fast", as the JAX package's does), with the
    images the same on every rank of `mesh` (default
    `make_spatial_mesh()`) and the whole fields returned on every rank.
    Each level runs `tvl1occ_scale_spatial`; with `with_diag=True` each
    level's diag says whether it ran on tiles ("tiled")."""
    mesh = make_spatial_mesh() if mesh is None else mesh
    kwargs.setdefault("warp_mode", "fast")
    return tvl1occflow(
        Im1, I0, I1, filt_i0,
        scale_solver=partial(tvl1occ_scale_spatial, mesh=mesh), **kwargs)
