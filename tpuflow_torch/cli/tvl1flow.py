"""`tvl1flow` CLI — mirrors reference src/tvl1flow_main.cpp, as
tpuflow/cli/tvl1flow.py does; runs `tvl1_multiscale` on the card unless
`device="cpu"` is given.

Usage: python -m tpuflow_torch.cli.tvl1flow I0 I1 [out nproc tau lambda theta
        nscales zfactor nwarps epsilon verbose]
"""

import sys

from tpuflow_torch.cli.common import Args, clamp, load_pair, save_flow
from tpuflow_torch.models.tvl1 import (
    DEFAULT_EPSILON,
    DEFAULT_LAMBDA,
    DEFAULT_NSCALES,
    DEFAULT_TAU,
    DEFAULT_THETA,
    DEFAULT_WARPS,
    DEFAULT_ZFACTOR,
    tvl1_multiscale,
)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: tvl1flow I0 I1 [out nproc tau lambda theta nscales "
              f"zfactor nwarps epsilon verbose]", file=sys.stderr)
        return 1
    a = Args(argv)
    image1 = a.next(None)
    image2 = a.next(None)
    outfile = a.next("flow.flo")
    _nproc = a.next(0, int)
    tau = a.next(DEFAULT_TAU, float)
    lam = a.next(DEFAULT_LAMBDA, float)
    theta = a.next(DEFAULT_THETA, float)
    nscales = a.next(DEFAULT_NSCALES, int)
    zfactor = a.next(DEFAULT_ZFACTOR, float)
    nwarps = a.next(DEFAULT_WARPS, int)
    epsilon = a.next(DEFAULT_EPSILON, float)
    verbose = bool(a.next(0, int))

    # clamping rules per reference src/tvl1flow_main.cpp:111-167
    tau = clamp(tau, lambda t: 0 < t <= 0.25, DEFAULT_TAU, "tau", verbose)
    lam = clamp(lam, lambda x: x > 0, DEFAULT_LAMBDA, "lambda", verbose)
    theta = clamp(theta, lambda x: x > 0, DEFAULT_THETA, "theta", verbose)
    nscales = clamp(nscales, lambda x: x > 0, DEFAULT_NSCALES, "nscales", verbose)
    zfactor = clamp(zfactor, lambda x: 0 < x < 1, DEFAULT_ZFACTOR, "zfactor", verbose)
    nwarps = clamp(nwarps, lambda x: x > 0, DEFAULT_WARPS, "nwarps", verbose)
    epsilon = clamp(epsilon, lambda x: x > 0, DEFAULT_EPSILON, "epsilon", verbose)

    I0, I1 = load_pair(image1, image2)
    if verbose:
        # params header after the nscales auto-clamp, reference
        # src/tvl1flow_main.cpp:185-196
        from tpuflow_torch.ops.pyramid import clamp_nscales

        ny, nx = I0.shape[-2:]
        ns = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=True)
        print(f"nproc={_nproc} tau={tau:f} lambda={lam:f} theta={theta:f} "
              f"nscales={ns} zfactor={zfactor:f} nwarps={nwarps} "
              f"epsilon={epsilon:g}", file=sys.stderr)
    u, v = tvl1_multiscale(I0, I1, tau=tau, lam=lam, theta=theta,
                           nscales=nscales, zfactor=zfactor, warps=nwarps,
                           epsilon=epsilon, verbose=verbose, device=device)
    save_flow(outfile, u, v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
