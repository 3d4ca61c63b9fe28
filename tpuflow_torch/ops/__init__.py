"""Tensor operators and the hand-written kernels' wrappers.

The package exports the names of `tpuflow.ops`: the stencils, the two
Gaussians, the bicubic and bilinear samplers, the median filter, the
joint normalisation and the pyramid resampling.  The kernels' wrappers
live in their modules (`ops.warp`, `ops.tvl1`, `ops.hs`, `ops.hs_classic`,
`ops.brox`).
"""

from tpuflow_torch.ops.gaussian import (gaussian, gaussian_kernel_1d,
                                        sepconvol, sgauss_kernel)
from tpuflow_torch.ops.gradients import (centered_gradient,
                                         centered_gradient3, divergence, dxx,
                                         dxy, dyy, forward_gradient, mask3x3)
from tpuflow_torch.ops.interp import (bicubic_at, image_restriction,
                                      interpolate_bilinear, warp, warp_planes,
                                      warp_stack)
from tpuflow_torch.ops.median import median_filter
from tpuflow_torch.ops.normalize import normalize_joint
from tpuflow_torch.ops.pyramid import (clamp_nscales, pyramid_sizes, zoom_in,
                                       zoom_out, zoom_size)
