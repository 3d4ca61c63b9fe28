"""K2, TV-L1's fixed point (`tpuflow_torch/csrc/tvl1_iterate.cu`).

One iteration of one sample at a level of `px` pixels reads the state
(u1, u2 and four dual planes) and the four constants and writes the
state: 16 float32 planes, 64 bytes a pixel, against 60 operations a
pixel (thresholding, primal step, the squared update, dual ascent).
`work` lists, per warp, the level's pixels and the iterations that the
samples needed, summed over the samples.  The kernel is three launches
an iteration: `tvl1_primal`, `tvl1_dual` and `stop_finalize`, which no
other kernel of a TV-L1 cell launches."""

from flowbench.roofline import least_s

KERNELS = ("tvl1_primal", "tvl1_dual", "stop_finalize")
BYTES_PX = 4 * (6 + 4 + 6)
FLOPS_PX = 60


def bound_s(work, peaks):
    """`work`: [(px, sample-iterations), ...]."""
    return sum(least_s(px * n * BYTES_PX, px * n * FLOPS_PX, peaks)
               for px, n in work)
