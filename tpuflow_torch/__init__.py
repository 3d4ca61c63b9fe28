"""tpuflow_torch — the PyTorch / CUDA port of tpuflow for one NVIDIA H100.

The JAX package `tpuflow` stays the reference; this package imports
neither it nor JAX.  Plain tensor code is PyTorch; each Pallas kernel
of the JAX package on a ported path becomes a CUDA C++ kernel for
sm_90a under `tpuflow_torch/csrc/`, built with nvcc at first use
(tpuflow_torch._build), with a plain PyTorch version beside it that
runs when the tensors lie on the CPU.

Ported so far: the batched engines `tvl1_batched`,
`hs_pyramidal_batched`, `brox_spatial_batched` and
`robust_expo_batched` (gray)
(tpuflow_torch.models.batch) and
`hs_classic_batched` (tpuflow_torch.models.hs_classic); the single-pair
solvers `tvl1_multiscale`, `hs_pyramidal`, `hs_classic`,
`brox_spatial`, `robust_expo`, `brox_temporal` (a frame sequence) and
`tvl1occflow` (a triplet, with occlusions); the operators
(tpuflow_torch.ops); image and flow IO (tpuflow_torch.io); the seven
reference CLIs, run as `python -m tpuflow_torch.cli.<name>`
(tpuflow_torch.cli); level checkpoints, `warmup` and tracing
(tpuflow_torch.utils); and, on `torch.distributed`
(tpuflow_torch.parallel), the data-parallel and halo-exchange tile
lanes, Brox temporal with its frames split over the ranks, and the
multiscale TV-L1 tiled over a (y, x) mesh (`tvl1_spatial`).

Inputs are computed in float32 on the card and in their own dtype
(float32 or float64) on the CPU (tpuflow_torch.config).
"""

__version__ = "0.1.0"

from tpuflow_torch.config import default_dtype
from tpuflow_torch.models.batch import (brox_spatial_batched,
                                       hs_pyramidal_batched,
                                       robust_expo_batched, tvl1_batched)
from tpuflow_torch.models.brox_spatial import brox_spatial
from tpuflow_torch.models.brox_temporal import brox_temporal
from tpuflow_torch.models.hs_classic import hs_classic, hs_classic_batched
from tpuflow_torch.models.hs_pyramidal import hs_pyramidal
from tpuflow_torch.models.robust_expo import robust_expo
from tpuflow_torch.models.tvl1 import tvl1_multiscale
from tpuflow_torch.models.tvl1occflow import tvl1occflow
from tpuflow_torch.utils.warmup import warmup

__all__ = ["brox_spatial", "brox_spatial_batched", "brox_temporal",
           "default_dtype", "hs_classic", "hs_classic_batched", "hs_pyramidal",
           "hs_pyramidal_batched", "robust_expo", "robust_expo_batched",
           "tvl1_batched",
           "tvl1_multiscale", "tvl1occflow", "warmup"]
