"""`horn_schunck_pyramidal` CLI — mirrors reference
src/horn_schunck_pyramidal_main.cpp, as tpuflow/cli/horn_schunck_pyramidal.py
does; runs `hs_pyramidal` on the card unless `device="cpu"` is given.

Usage: python -m tpuflow_torch.cli.horn_schunck_pyramidal I1 I2 [out nproc
        alpha nscales zfactor nwarps TOL maxiter verbose]
"""

import sys

from tpuflow_torch.cli.common import Args, clamp, load_pair, save_flow
from tpuflow_torch.models.hs_pyramidal import (
    DEFAULT_ALPHA,
    DEFAULT_MAXITER,
    DEFAULT_NSCALES,
    DEFAULT_TOL,
    DEFAULT_WARPS,
    DEFAULT_ZFACTOR,
    hs_pyramidal,
)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage: horn_schunck_pyramidal I1 I2 [out nproc alpha nscales "
              "zfactor nwarps TOL maxiter verbose]", file=sys.stderr)
        return 1
    a = Args(argv)
    image1 = a.next(None)
    image2 = a.next(None)
    outfile = a.next("flow.flo")
    _nproc = a.next(0, int)
    alpha = a.next(DEFAULT_ALPHA, float)
    nscales = a.next(DEFAULT_NSCALES, int)
    zfactor = a.next(DEFAULT_ZFACTOR, float)
    nwarps = a.next(DEFAULT_WARPS, int)
    tol = a.next(DEFAULT_TOL, float)
    maxiter = a.next(DEFAULT_MAXITER, int)
    verbose = bool(a.next(0, int))

    # clamping per reference src/horn_schunck_pyramidal_main.cpp:104-133
    alpha = clamp(alpha, lambda x: x > 0, DEFAULT_ALPHA, "alpha", verbose)
    nscales = clamp(nscales, lambda x: x > 0, DEFAULT_NSCALES, "nscales", verbose)
    zfactor = clamp(zfactor, lambda x: 0 < x < 1, DEFAULT_ZFACTOR, "zfactor", verbose)
    nwarps = clamp(nwarps, lambda x: x > 0, DEFAULT_WARPS, "nwarps", verbose)
    tol = clamp(tol, lambda x: x > 0, DEFAULT_TOL, "TOL", verbose)
    maxiter = clamp(maxiter, lambda x: x > 0, DEFAULT_MAXITER, "maxiter", verbose)

    I0, I1 = load_pair(image1, image2)
    u, v = hs_pyramidal(I0, I1, alpha=alpha, nscales=nscales,
                        zfactor=zfactor, warps=nwarps, tol=tol,
                        maxiter=maxiter, verbose=verbose, device=device)
    save_flow(outfile, u, v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
