"""Multi-process lanes on `torch.distributed`, one process per device:
the batch data-parallel lane (`mesh`, `distributed`) and the explicit
halo-exchange tile lane (`halo`, `tiled`)."""

from tpuflow_torch.parallel.halo import exchange_1d, exchange_2d
from tpuflow_torch.parallel.mesh import make_mesh
