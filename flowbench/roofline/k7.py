"""K7, Brox's red-black SOR (`tpuflow_torch/csrc/brox_sor.cu`), route
"resident": one launch solves one system with the level held in shared
memory.

A solve at a level of `px` pixels reads (du, dv) and the nine
constants and writes (du, dv) once, 13 float32 planes, 52 bytes a
pixel, whatever the sweeps; each sweep costs 40 operations a pixel (two
divergences, two reciprocal updates, the squared update).  `work` lists
each solve's pixels and the sweeps it needed."""

from flowbench.roofline import least_s

KERNELS = ("brox_sor_resident",)
BYTES_PX = 4 * (11 + 2)
FLOPS_PX_SWEEP = 40


def bound_s(work, peaks):
    """`work`: [(px, sweeps), ...], one entry a solve."""
    return sum(least_s(px * BYTES_PX, px * sweeps * FLOPS_PX_SWEEP, peaks)
               for px, sweeps in work)
