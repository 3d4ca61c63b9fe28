"""Halo exchange for spatially tiled stencils.

Counterpart of tpuflow/parallel/halo.py.  Each rank holds one (h, w)
tile of a global image; `exchange_1d` and `exchange_2d` pad the tile
with `halo` cells from its ring neighbours along a mesh dimension (the
dimension's process group, point-to-point by `dist.batch_isend_irecv`),
while a tile at the global boundary fills its outward halo with the
op's boundary condition:

  * "edge"      — replicate the boundary cell (Neumann clamp);
  * "zero"      — zeros (the backward-difference divergence, see
                  tiled.divergence_tiled);
  * "gaussian"  — the reference Gaussian's asymmetric reflecting pad:
                  mirror WITHOUT the edge cell on the leading side, WITH
                  it on the trailing side (reference
                  src/operators.cpp:557-561);
  * "symmetric" — mirror with the edge on both sides (reference
                  src/utils.cpp:79-87,178-192).

The full-image ops of tpuflow_torch.ops then run on the padded tile and
`crop` removes the halo, so a tiled result equals the full-image one.
A mesh dimension of size 1 (or no mesh) takes the fill-only path and
communicates nothing.
"""

import torch
import torch.distributed as dist

from tpuflow_torch.parallel.mesh import axis_size

FILLS = ("edge", "zero", "gaussian", "symmetric")


def _fill(block, halo, axis, mode, side):
    """The outward halo of a tile at the global edge; `side` is "lead"
    (the low-index side) or "trail"."""
    n = block.shape[axis]
    if mode == "zero":
        shape = list(block.shape)
        shape[axis] = halo
        return block.new_zeros(shape)
    if mode == "edge":
        cell = block.narrow(axis, 0 if side == "lead" else n - 1, 1)
        return torch.cat([cell] * halo, dim=axis)
    if mode in ("gaussian", "symmetric"):
        if side == "lead":
            # gaussian: cells halo..1 (no edge repeat); symmetric: halo-1..0
            start = 1 if mode == "gaussian" else 0
            return torch.flip(block.narrow(axis, start, halo), (axis,))
        return torch.flip(block.narrow(axis, n - halo, halo), (axis,))
    raise ValueError(f"unknown fill mode {mode!r}; one of {FILLS}")


def exchange_1d(block, halo, mesh, axis_name, fill="edge", axis=-1):
    """Pad `block` with `halo` cells on both sides of `axis`: interior
    halos from the ring neighbours along mesh dimension `axis_name`,
    boundary halos by `fill`.  Every rank of the dimension's group must
    call it."""
    size = axis_size(mesh, axis_name)
    n = block.shape[axis]
    if halo > n:
        raise ValueError(f"halo {halo} exceeds the tile's {n} cells")
    lead = _fill(block, halo, axis, fill, "lead")
    trail = _fill(block, halo, axis, fill, "trail")
    if size > 1:
        group = mesh.get_group(axis_name)
        idx = mesh.get_local_rank(axis_name)
        ops = []
        if idx > 0:  # my leading strip is my predecessor's trailing halo
            prev = dist.get_global_rank(group, idx - 1)
            lead = torch.empty_like(lead)
            ops += [dist.P2POp(dist.isend,
                               block.narrow(axis, 0, halo).contiguous(),
                               prev, group),
                    dist.P2POp(dist.irecv, lead, prev, group)]
        if idx < size - 1:
            nxt = dist.get_global_rank(group, idx + 1)
            trail = torch.empty_like(trail)
            ops += [dist.P2POp(dist.isend,
                               block.narrow(axis, n - halo, halo).contiguous(),
                               nxt, group),
                    dist.P2POp(dist.irecv, trail, nxt, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([lead, block, trail], dim=axis)


def exchange_2d(block, halo, mesh, x_axis_name="x", y_axis_name="y",
                fill="edge"):
    """2-D halo pad: along x (the last axis), then along y on the
    x-padded block, so the corners come from the diagonal neighbour in
    two hops."""
    padded = exchange_1d(block, halo, mesh, x_axis_name, fill, axis=-1)
    return exchange_1d(padded, halo, mesh, y_axis_name, fill, axis=-2)


def crop(padded, halo, axes=(-2, -1)):
    """Remove `halo` cells from both ends of each axis in `axes`."""
    for ax in axes:
        padded = padded.narrow(ax, halo, padded.shape[ax] - 2 * halo)
    return padded
