"""Device meshes over the ranks of a `torch.distributed` process group.

Counterpart of tpuflow/parallel/mesh.py.  PyTorch runs one process per
device, so a mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the process group's ranks, with the JAX package's canonical dimension
names:

  * "batch" — data parallel over frame pairs (the throughput axis);
  * "y", "x" — spatial tiling of one frame with halo exchange
    (tpuflow_torch.parallel.halo, .tiled).

Where the JAX package places a global array with a sharding
(`batch_sharding`, `spatial_sharding`), each rank here holds its block
of the global tensor: `batch_block` and `spatial_block` cut it, and
`gather_batch` and `gather_spatial` put the blocks back together on
every rank.
"""

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(axes):
    """A DeviceMesh from {"name": size, ...} over the process group's
    ranks (the sizes must multiply to the world size; -1 once means the
    remaining ranks), on "cuda" under NCCL and on "cpu" under gloo.
    Without a process group the world is one rank, and this raises
    after checking the sizes."""
    names = tuple(axes)
    sizes = [int(s) for s in axes.values()]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axes}: -1 may stand for one dimension only")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, have {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group; call "
                           "tpuflow_torch.parallel.distributed.initialize")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def block(t, index, count, dim):
    """Block `index` of `count` equal blocks of `t` along `dim`."""
    n = t.shape[dim]
    if n % count:
        raise ValueError(f"dimension {dim} of size {n} does not split into "
                         f"{count} blocks")
    size = n // count
    return t.narrow(dim, index * size, size)


def batch_block(t, mesh, axis="batch"):
    """This rank's block of a global (B, ...) tensor split over mesh
    dimension `axis` (counterpart of `batch_sharding`)."""
    return block(t, mesh.get_local_rank(axis), axis_size(mesh, axis), 0)


def spatial_block(t, mesh, y_axis="y", x_axis="x"):
    """This rank's tile of a global (..., H, W) tensor tiled over mesh
    dimensions (y_axis, x_axis) (counterpart of `spatial_sharding`)."""
    t = block(t, mesh.get_local_rank(y_axis), axis_size(mesh, y_axis), -2)
    return block(t, mesh.get_local_rank(x_axis), axis_size(mesh, x_axis), -1)


def axis_size(mesh, axis):
    """The number of ranks along mesh dimension `axis` (1 for no mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh_dim=mesh.mesh_dim_names.index(axis))


def _all_gather(t, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def gather_batch(t, mesh, axis="batch"):
    """The global (B, ...) tensor from each rank's `batch_block`, on
    every rank."""
    return torch.cat(_all_gather(t, mesh.get_group(axis)), dim=0)


def gather_spatial(t, mesh, y_axis="y", x_axis="x"):
    """The global (..., H, W) tensor from each rank's `spatial_block`,
    on every rank."""
    row = torch.cat(_all_gather(t, mesh.get_group(x_axis)), dim=-1)
    return torch.cat(_all_gather(row, mesh.get_group(y_axis)), dim=-2)
