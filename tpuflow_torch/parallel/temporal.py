"""Brox temporal with the frame axis split over a "t" mesh dimension.

Counterpart of tpuflow/parallel/temporal.py.  The reference couples
each flow field only to its two frame neighbours (psi5 / psi6,
src/brox_temporal_mask.cpp:108-133), so the (T-1, H, W) flow volume
splits over the ranks of mesh dimension "t" with a ONE-FIELD halo: every
frame-neighbour read goes through `exchange_1d(..., fill="edge",
axis=0)`, one exchange per unknown per SOR half-sweep.
Each rank holds its `tl` fields and a (tl + 1, H, W) frame slab, which
includes the first frame of the next rank's slab.

The arithmetic is tpuflow_torch.models.brox_temporal's (`solve_scale`,
which the single-device solver runs too) with the JAX package's
global-index rules, so an n-rank run equals the single-process solver:
  * the red-black colours are (f + i + j) % 2 with f the GLOBAL field
    index (rank * tl + local);
  * when (T - 1) does not divide by the ranks, the last rank's field
    axis is padded with copies of the last frame; the padded fields are
    frozen (their colour masks are AND-ed with `valid`), and only the
    flow gradient clamps its temporal neighbours at the global first and
    last field, while psi5 and psi6 are zero there;
  * the stop error is summed over the ranks (one `all_reduce` per
    sweep) and read once on the host, against tol * sqrt(global size).

The warp is JAX's exact one, `warp_planes(..., border_out=True)` field by
field: this lane has no `warp_mode`, in JAX or here.  The pyramid of the
multiscale solver, and its between-level upsample, run replicated on
every rank, as the JAX package runs them.  No kernel lies on this lane:
the 3-D SOR is plain PyTorch, as it is in the single-device solver.
"""

import torch
import torch.distributed as dist

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.models.brox_spatial import MAXITER_SOR
from tpuflow_torch.models.brox_temporal import (DEFAULT_ALPHA,
                                                DEFAULT_GAMMA, DEFAULT_INNER,
                                                DEFAULT_OUTER, DEFAULT_TOL,
                                                preprocess_volume,
                                                red_black_3d, solve_scale)
from tpuflow_torch.models.common import run_pyramid_state
from tpuflow_torch.ops.pyramid import clamp_nscales
from tpuflow_torch.parallel.halo import exchange_1d
from tpuflow_torch.parallel.mesh import axis_size, gather_batch
from tpuflow_torch.utils.trace import traced


def brox_temporal_scale_sharded(I, u, v, mesh, axis_name="t",
                                alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                                tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                                outer_iter=DEFAULT_OUTER, maxiter=MAXITER_SOR,
                                total_fields=None, stop="error",
                                with_diag=False):
    """tpuflow_torch.models.brox_temporal.brox_temporal_scale with the
    field axis split over mesh dimension `axis_name`; every rank of the
    dimension calls it on its block.

    I: this rank's (tl + 1, H, W) frame slab, its lookahead frame
    included (the last rank's is a copy of its final frame, unused);
    u, v: its (tl, H, W) flow fields.  `total_fields` is the global
    field count (default tl times the ranks); fields past it are
    padding.  Returns this rank's (u, v); with `with_diag=True` also
    {"iterations": (outer, inner) int32 sweep counts, the same on every
    rank, "host_reads": the stop reads made}."""
    if stop not in ("error", "fixed"):
        raise ValueError(f"unknown stop mode {stop!r}")
    tl, ny, nx = u.shape
    ranks = axis_size(mesh, axis_name)
    nz = total_fields if total_fields is not None else ranks * tl
    fields = (mesh.get_local_rank(axis_name) * tl
              + torch.arange(tl, device=u.device)[:, None, None])
    first, last = fields == 0, fields == nz - 1

    def frame_shifts(f, clamp):
        # the ring's neighbours, edge-clamped at its ends; with `clamp`,
        # at the volume's first and last field, so that a real field
        # never reads a padded one
        padded = exchange_1d(f, 1, mesh, axis_name, fill="edge", axis=0)
        prev, nxt = padded[:-2], padded[2:]
        if clamp:
            prev, nxt = torch.where(first, f, prev), torch.where(last, f, nxt)
        return prev, nxt

    def sum_ranks(err):
        dist.all_reduce(err, group=mesh.get_group(axis_name))

    u, v, nsors, host_reads = solve_scale(
        I, u, v, frame_shifts, first, last,
        red_black_3d(fields, ny, nx, valid=fields < nz), nz * ny * nx,
        alpha, gamma, tol, inner_iter, outer_iter, stop, maxiter, "exact",
        None, sum_ranks if ranks > 1 else None)
    if with_diag:
        its = torch.tensor(nsors, dtype=torch.int32, device=u.device)
        return u, v, {"iterations": its.reshape(outer_iter, inner_iter),
                      "host_reads": host_reads}
    return u, v


def brox_temporal_sharded(I, mesh, axis_name="t", u0=None, v0=None,
                          device=None, **kw):
    """Single-scale Brox temporal with the field axis split over mesh
    dimension `axis_name`; every rank of the mesh calls it with the same
    arguments.  I: the global (T, H, W) frames, T >= 3; `u0`, `v0`: the
    global (T-1, H, W) flow to start from (default zeros).  Each rank
    cuts its frame slab and fields, runs `brox_temporal_scale_sharded`
    (`kw`: its keywords) and gathers the fields over `axis_name`:
    returns the global (T-1, H, W) u and v on every rank, and with
    with_diag=True also the diag.

    When (T-1) does not divide by the ranks, the frames are padded with
    copies of the last one, and the padded fields stay frozen at zero,
    so the result is the even case's.  Inputs are moved to `device` as
    the single-device solvers move them (`compute_inputs`; default the
    card)."""
    (I,) = compute_inputs(device, I)
    frames, ny, nx = I.shape
    nz = frames - 1
    ranks = axis_size(mesh, axis_name)
    index = mesh.get_local_rank(axis_name)
    tl = -(-nz // ranks)
    pad = tl * ranks + 1 - frames
    if pad:
        I = torch.cat([I, I[-1:].expand(pad, ny, nx)])
    slab = I[index * tl:(index + 1) * tl + 1]

    def local(f):
        if f is None:
            return I.new_zeros((tl, ny, nx))
        f = torch.as_tensor(f, device=I.device).to(I.dtype)
        if tl * ranks > nz:
            f = torch.cat([f, f.new_zeros((tl * ranks - nz, ny, nx))])
        return f[index * tl:(index + 1) * tl]

    out = brox_temporal_scale_sharded(slab, local(u0), local(v0), mesh,
                                      axis_name, total_fields=nz, **kw)
    u, v = (gather_batch(f, mesh, axis_name)[:nz] for f in out[:2])
    return (u, v) + tuple(out[2:])


@traced
def brox_temporal_multiscale_sharded(I, mesh, axis_name="t",
                                     alpha=DEFAULT_ALPHA,
                                     gamma=DEFAULT_GAMMA, nscales=100,
                                     zfactor=0.75, tol=DEFAULT_TOL,
                                     inner_iter=DEFAULT_INNER,
                                     outer_iter=DEFAULT_OUTER,
                                     maxiter=MAXITER_SOR, stop="error",
                                     clamp_scales=True, with_diag=False,
                                     device=None):
    """Multiscale Brox temporal with every scale solved by
    `brox_temporal_sharded`: the pyramid of
    tpuflow_torch.models.brox_temporal.brox_temporal (one [0, 255]
    normalisation of the volume, sigma 0.8, scales clamped on
    min(nx, ny) >= 16), built and upsampled on every rank.  I: the
    global (T, H, W) frames, T >= 3, the same on every rank.  Returns
    the global (T-1, H, W) u and v on every rank; with `with_diag=True`
    also diags[s], each scale's `brox_temporal_scale_sharded` diag,
    finest first."""
    (I,) = compute_inputs(device, I)
    frames, ny, nx = I.shape
    if frames <= 2:
        raise ValueError("The method needs more than two frames "
                         "(src/brox_optic_flow_temporal.cpp:537)")
    if clamp_scales:
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)
    diags = [None] * nscales

    def state_init(size, dtype):
        cnx, cny = size
        z = torch.zeros((frames - 1, cny, cnx), dtype=dtype, device=I.device)
        return {"u1": z, "u2": z}

    def solve(level_images, state, scale):
        out = brox_temporal_sharded(
            level_images[0], mesh, axis_name, u0=state["u1"], v0=state["u2"],
            device=I.device, alpha=alpha, gamma=gamma, tol=tol,
            inner_iter=inner_iter, outer_iter=outer_iter, maxiter=maxiter,
            stop=stop, with_diag=with_diag)
        if with_diag:
            diags[scale] = out[2]
        return {"u1": out[0], "u2": out[1]}

    state = run_pyramid_state(
        (I,), nscales, zfactor, solve, presmooth=None,
        preprocess=preprocess_volume, state_init=state_init)
    if with_diag:
        return state["u1"], state["u2"], diags
    return state["u1"], state["u2"]
