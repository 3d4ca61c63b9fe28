"""K7, Brox's red-black SOR (`tpuflow_torch/csrc/brox_sor.cu`), over a
batch: the same work as roofline/k7.py, whichever route runs it.

Each solve of each sample at a level of `px` pixels needs (du, dv) and
the nine constants read and (du, dv) written once, 13 float32 planes,
52 bytes a pixel, whatever the sweeps; and 40 operations a pixel for
each sweep that sample needed.  Route "resident" (`brox_sor_resident`)
comes near that; route "stream" (two `brox_sor_color` launches and
`stop_finalize` a sweep) moves the 13 planes every sweep, and is held
to the same count, so that a route that keeps the planes on chip is
judged against it too.  `work` lists each sample's pixels and sweeps,
one entry a sample a solve."""

from flowbench.roofline import k7, least_s

KERNELS = ("brox_sor_resident", "brox_sor_color", "stop_finalize")


def bound_s(work, peaks):
    """`work`: [(px, sweeps), ...], one entry a sample a solve."""
    return sum(least_s(px * k7.BYTES_PX, px * sweeps * k7.FLOPS_PX_SWEEP,
                       peaks)
               for px, sweeps in work)
