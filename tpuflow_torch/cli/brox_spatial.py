"""`brox_spatial` CLI — mirrors reference src/brox_spatial_main.cpp, as
tpuflow/cli/brox_spatial.py does; runs `brox_spatial` on the card unless
`device="cpu"` is given.

Usage: python -m tpuflow_torch.cli.brox_spatial I1 I2 [out nproc alpha gamma
        nscales zfactor TOL inner outer verbose]
"""

import sys

from tpuflow_torch.cli.common import Args, clamp, load_pair, save_flow
from tpuflow_torch.models.brox_spatial import (
    DEFAULT_ALPHA,
    DEFAULT_GAMMA,
    DEFAULT_INNER,
    DEFAULT_NSCALES,
    DEFAULT_OUTER,
    DEFAULT_TOL,
    DEFAULT_ZFACTOR,
    brox_spatial,
)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage: brox_spatial I1 I2 [out nproc alpha gamma nscales "
              "zfactor TOL inner outer verbose]", file=sys.stderr)
        return 1
    a = Args(argv)
    image1 = a.next(None)
    image2 = a.next(None)
    outfile = a.next("flow.flo")
    _nproc = a.next(0, int)
    alpha = a.next(DEFAULT_ALPHA, float)
    gamma = a.next(DEFAULT_GAMMA, float)
    nscales = a.next(DEFAULT_NSCALES, int)
    zfactor = a.next(DEFAULT_ZFACTOR, float)
    tol = a.next(DEFAULT_TOL, float)
    inner = a.next(DEFAULT_INNER, int)
    outer = a.next(DEFAULT_OUTER, int)
    verbose = bool(a.next(0, int))

    # clamping rules per reference src/brox_spatial_main.cpp:100-149
    alpha = clamp(alpha, lambda x: x > 0, DEFAULT_ALPHA, "alpha", verbose)
    gamma = clamp(gamma, lambda x: x >= 0, DEFAULT_GAMMA, "gamma", verbose)
    nscales = clamp(nscales, lambda x: x > 0, DEFAULT_NSCALES, "nscales", verbose)
    zfactor = clamp(zfactor, lambda x: 0 < x < 1, DEFAULT_ZFACTOR, "zfactor", verbose)
    tol = clamp(tol, lambda x: x > 0, DEFAULT_TOL, "TOL", verbose)
    inner = clamp(inner, lambda x: x > 0, DEFAULT_INNER, "inner_iter", verbose)
    outer = clamp(outer, lambda x: x > 0, DEFAULT_OUTER, "outer_iter", verbose)

    I1, I2 = load_pair(image1, image2)
    if verbose:
        # parameter header after the nscales auto-clamp
        # (reference src/brox_spatial_main.cpp:151-164)
        from tpuflow_torch.ops.pyramid import clamp_nscales

        ns = clamp_nscales(I1.shape[-1], I1.shape[-2], zfactor, nscales,
                           use_hypot=False)
        print(f"\n alpha:{alpha:g} gamma:{gamma:g} scales:{ns}"
              f" nu:{zfactor:g} TOL:{tol:g} inner:{inner} outer:{outer}")
    u, v = brox_spatial(I1, I2, alpha=alpha, gamma=gamma, nscales=nscales,
                        zfactor=zfactor, tol=tol, inner_iter=inner,
                        outer_iter=outer, verbose=verbose, device=device)
    save_flow(outfile, u, v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
