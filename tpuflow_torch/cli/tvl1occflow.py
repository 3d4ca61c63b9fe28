"""`tvl1occflow` CLI — mirrors reference src/tvl1occflow_main.cpp, as
tpuflow/cli/tvl1occflow.py does; runs `tvl1occflow` on the card unless
`device="cpu"` is given.

Usage: python -m tpuflow_torch.cli.tvl1occflow I_1 I0 I1 [I0_Smoothed out
        outOcc nproc lambda alpha beta theta nscales zfactor nwarps
        epsilon verbose]

Writes the flow (.flo) and the occlusion map chi*255 as an image (PNG
by default; reference src/tvl1occflow_main.cpp:226-258).
"""

import sys

import numpy as np

from tpuflow_torch.cli.common import Args, clamp, host_array, save_flow
from tpuflow_torch.io import read_image, write_image
from tpuflow_torch.models.tvl1occflow import (
    DEFAULT_ALPHA,
    DEFAULT_BETA,
    DEFAULT_EPSILON,
    DEFAULT_LAMBDA,
    DEFAULT_NSCALES,
    DEFAULT_THETA,
    DEFAULT_WARPS,
    DEFAULT_ZFACTOR,
    tvl1occflow,
)
from tpuflow_torch.ops.pyramid import clamp_nscales


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print("Usage: tvl1occflow I_1 I0 I1 [I0_Smoothed out outOcc nproc "
              "lambda alpha beta theta nscales zfactor nwarps epsilon "
              "verbose]", file=sys.stderr)
        return 1
    a = Args(argv)
    image_m1 = a.next(None)
    image_0 = a.next(None)
    image_1 = a.next(None)
    # falls back to I0 when no smoothed image is given (main.cpp:110)
    image_filt = a.next(image_0)
    outfile = a.next("flow.flo")
    out_occ = a.next("occlusions.png")
    _nproc = a.next(0, int)
    lam = a.next(DEFAULT_LAMBDA, float)
    alpha = a.next(DEFAULT_ALPHA, float)
    beta = a.next(DEFAULT_BETA, float)
    theta = a.next(DEFAULT_THETA, float)
    nscales = a.next(DEFAULT_NSCALES, int)
    zfactor = a.next(DEFAULT_ZFACTOR, float)
    nwarps = a.next(DEFAULT_WARPS, int)
    epsilon = a.next(DEFAULT_EPSILON, float)
    verbose = bool(a.next(0, int))

    lam = clamp(lam, lambda x: x > 0, DEFAULT_LAMBDA, "lambda", verbose)
    alpha = clamp(alpha, lambda x: x > 0, DEFAULT_ALPHA, "alpha", verbose)
    beta = clamp(beta, lambda x: x > 0, DEFAULT_BETA, "beta", verbose)
    theta = clamp(theta, lambda x: x > 0, DEFAULT_THETA, "theta", verbose)
    nscales = clamp(nscales, lambda x: x > 0, DEFAULT_NSCALES, "nscales", verbose)
    zfactor = clamp(zfactor, lambda x: 0 < x < 1, DEFAULT_ZFACTOR, "zfactor", verbose)
    nwarps = clamp(nwarps, lambda x: x > 0, DEFAULT_WARPS, "nwarps", verbose)
    epsilon = clamp(epsilon, lambda x: x > 0, DEFAULT_EPSILON, "epsilon", verbose)

    imgs = [read_image(p, gray=True, dtype=np.float64).astype(np.float32)
            for p in (image_m1, image_0, image_1, image_filt)]
    if any(im.shape != imgs[0].shape for im in imgs):
        print("ERROR: input image sizes are not equal", file=sys.stderr)
        return 1
    if verbose:
        # stderr parameter header after the nscales clamp
        # (reference src/tvl1occflow_main.cpp:192-204)
        ns = clamp_nscales(imgs[0].shape[-1], imgs[0].shape[-2], zfactor,
                           nscales, use_hypot=False)
        sys.stderr.write(
            f" nproc={_nproc}   \n lambda={lam:f} \n alpha={alpha:f} \n"
            f" beta={beta:f} \n theta={theta:f} \n nscales={ns} \n"
            f" zfactor={zfactor:f}\n nwarps={nwarps} \n"
            f" epsilon={epsilon:g}\n")
    u1, u2, chi = tvl1occflow(*imgs, lam=lam, alpha=alpha, beta=beta,
                              theta=theta, nscales=nscales, zfactor=zfactor,
                              warps=nwarps, epsilon=epsilon, verbose=verbose,
                              device=device)
    save_flow(outfile, u1, u2)
    write_image(out_occ, host_array(chi) * 255.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
