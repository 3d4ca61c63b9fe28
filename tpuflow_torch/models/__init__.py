"""Solvers: the single-pair and multi-frame methods and their per-scale
solvers, the names tpuflow.models exports.  Its `hs_classic_jit` (a jit
of `hs_classic`) has no counterpart: the port compiles no program, so
`hs_classic` is the call."""

from tpuflow_torch.models.brox_spatial import brox_scale, brox_spatial
from tpuflow_torch.models.brox_temporal import (brox_temporal,
                                                brox_temporal_scale)
from tpuflow_torch.models.hs_classic import hs_classic
from tpuflow_torch.models.hs_pyramidal import hs_pyramidal, hs_scale
from tpuflow_torch.models.robust_expo import robust_expo, robust_expo_scale
from tpuflow_torch.models.tvl1 import tvl1_multiscale, tvl1_scale
from tpuflow_torch.models.tvl1occflow import tvl1occ_scale, tvl1occflow
