"""K10, robust-expo's system of one inner iteration
(`tpuflow_torch/csrc/brox_terms.cu`, `expo_terms_kernel`).

A launch over `px` pixels (its samples' pixels together) reads u, v,
expo, I1, I1x, I1y and the six warped planes of the second image and
writes the nine constants of K7: 21 float32 planes, 84 bytes a pixel;
after an outer iteration's first inner iteration it also reads the
increment (du, dv), 23 planes, 92 bytes.  Its float32 operations, 118 a
pixel, lie far below the bytes' time.  `work` lists each launch's
pixels and whether it was a first inner iteration."""

from flowbench.roofline import least_s

KERNELS = ("expo_terms",)
BYTES_PX_FIRST = 4 * 21
BYTES_PX_LATER = 4 * 23
FLOPS_PX = 118


def bound_s(work, peaks):
    """`work`: [(px, first), ...], one entry a launch."""
    return sum(least_s(px * (BYTES_PX_FIRST if first else BYTES_PX_LATER),
                       px * FLOPS_PX, peaks)
               for px, first in work)
