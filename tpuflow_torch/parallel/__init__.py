"""Multi-process lanes on `torch.distributed`, one process per device:
the batch data-parallel lane (`mesh`, `distributed`), the explicit
halo-exchange tile lane (`halo`, `tiled`), Brox temporal with its frame
axis split over the ranks (`temporal`) and the multiscale TV-L1,
robust-expo and TV-L1 with occlusions tiled over a (y, x) mesh
(`spatial`)."""

from tpuflow_torch.parallel.halo import exchange_1d, exchange_2d
from tpuflow_torch.parallel.mesh import make_mesh
from tpuflow_torch.parallel.spatial import (make_spatial_mesh,
                                            robust_expo_spatial, shard_spatial,
                                            tvl1_spatial, tvl1occflow_spatial)
from tpuflow_torch.parallel.temporal import (brox_temporal_multiscale_sharded,
                                             brox_temporal_scale_sharded,
                                             brox_temporal_sharded)
