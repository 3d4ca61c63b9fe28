"""`robust_expo_methods` CLI — mirrors reference
src/robust_expo_methods_main.cpp (CR-encoded source; defaults
PAR_DEFAULT_*), as tpuflow/cli/robust_expo_methods.py does; runs
`robust_expo` on the card unless `device="cpu"` is given.  Reads
MULTICHANNEL images (the reference uses iio_read_image_double_vec).

Usage: python -m tpuflow_torch.cli.robust_expo_methods I1 I2 [out nproc
        method_type alpha gamma lambda nscales zfactor TOL inner outer
        verbose]
"""

import sys

import numpy as np

from tpuflow_torch.cli.common import Args, clamp, save_flow
from tpuflow_torch.io import read_image
from tpuflow_torch.models.robust_expo import (
    DEFAULT_ALPHA,
    DEFAULT_GAMMA,
    DEFAULT_INNER,
    DEFAULT_LAMBDA,
    DEFAULT_METHOD,
    DEFAULT_NSCALES,
    DEFAULT_OUTER,
    DEFAULT_TOL,
    DEFAULT_ZFACTOR,
    robust_expo,
)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage: robust_expo_methods I1 I2 [out_file processors "
              "method_type alpha gamma lambda nscales zoom_factor TOL "
              "inner_iter outer_iter verbose]", file=sys.stderr)
        return 1
    a = Args(argv)
    image1 = a.next(None)
    image2 = a.next(None)
    outfile = a.next("flow.flo")
    _nproc = a.next(0, int)
    method = a.next(DEFAULT_METHOD, int)
    alpha = a.next(DEFAULT_ALPHA, float)
    gamma = a.next(DEFAULT_GAMMA, float)
    lam = a.next(DEFAULT_LAMBDA, float)
    nscales = a.next(DEFAULT_NSCALES, int)
    zfactor = a.next(DEFAULT_ZFACTOR, float)
    tol = a.next(DEFAULT_TOL, float)
    inner = a.next(DEFAULT_INNER, int)
    outer = a.next(DEFAULT_OUTER, int)
    verbose = bool(a.next(0, int))

    method = clamp(method, lambda x: 1 <= x <= 3, DEFAULT_METHOD, "method_type", verbose)
    alpha = clamp(alpha, lambda x: x > 0, DEFAULT_ALPHA, "alpha", verbose)
    gamma = clamp(gamma, lambda x: x >= 0, DEFAULT_GAMMA, "gamma", verbose)
    lam = clamp(lam, lambda x: x >= 0, DEFAULT_LAMBDA, "lambda", verbose)
    nscales = clamp(nscales, lambda x: x > 0, DEFAULT_NSCALES, "nscales", verbose)
    zfactor = clamp(zfactor, lambda x: 0 < x < 1, DEFAULT_ZFACTOR, "zfactor", verbose)
    tol = clamp(tol, lambda x: x > 0, DEFAULT_TOL, "TOL", verbose)
    inner = clamp(inner, lambda x: x > 0, DEFAULT_INNER, "inner_iter", verbose)
    outer = clamp(outer, lambda x: x > 0, DEFAULT_OUTER, "outer_iter", verbose)

    I1 = read_image(image1, gray=False, dtype=np.float64).astype(np.float32)
    I2 = read_image(image2, gray=False, dtype=np.float64).astype(np.float32)
    if I1.shape != I2.shape:
        print("Cannot read the images or the size of the images are not equal",
              file=sys.stderr)
        return 1
    # the reference prints this header UNCONDITIONALLY (not gated on
    # verbose; robust_expo_methods_main.cpp after the nscales clamp)
    from tpuflow_torch.ops.pyramid import clamp_nscales

    # images are (H, W) or (H, W, C) at this point
    ns = clamp_nscales(I1.shape[1], I1.shape[0], zfactor, nscales,
                       use_hypot=False)
    print(f"\n ncores:{_nproc} method_type:{method} alpha:{alpha:g}"
          f" gamma:{gamma:g} lambda:{lam:g} scales:{ns} nu:{zfactor:g}"
          f" TOL:{tol:g} inner:{inner} outer:{outer}")
    if I1.ndim == 3:  # (H, W, C) -> (C, H, W) planes
        I1 = np.moveaxis(I1, -1, 0)
        I2 = np.moveaxis(I2, -1, 0)

    u, v = robust_expo(I1, I2, method_type=method, alpha=alpha, gamma=gamma,
                       lam=lam, nscales=nscales, zfactor=zfactor, tol=tol,
                       inner_iter=inner, outer_iter=outer, verbose=verbose,
                       device=device)
    save_flow(outfile, u, v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
