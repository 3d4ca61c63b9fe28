"""`brox_temporal` CLI — mirrors reference src/brox_temporal_main.cpp, as
tpuflow/cli/brox_temporal.py does; runs `brox_temporal` on the card
unless `device="cpu"` is given.

Usage: python -m tpuflow_torch.cli.brox_temporal nimages I1...In [alpha
        gamma nscales zoom_factor TOL inner_iter outer_iter dir verbose]

Writes one flow per frame pair: dir/flow00.flo ... dir/flowNN.flo
(reference src/brox_temporal_main.cpp:206-217).
"""

import os
import sys

import numpy as np

from tpuflow_torch.cli.common import Args, clamp, save_flow
from tpuflow_torch.io import read_image
from tpuflow_torch.models.brox_temporal import (
    DEFAULT_ALPHA,
    DEFAULT_GAMMA,
    DEFAULT_INNER,
    DEFAULT_NSCALES,
    DEFAULT_OUTER,
    DEFAULT_TOL,
    DEFAULT_ZFACTOR,
    brox_temporal,
)
from tpuflow_torch.ops.pyramid import clamp_nscales


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage: brox_temporal nimages I1...In [alpha gamma nscales "
              "zoom_factor TOL inner_iter outer_iter dir verbose]",
              file=sys.stderr)
        return 1
    frames = int(argv[0])
    paths = argv[1 : 1 + frames]
    a = Args(argv[1 + frames :])
    alpha = a.next(DEFAULT_ALPHA, float)
    gamma = a.next(DEFAULT_GAMMA, float)
    nscales = a.next(DEFAULT_NSCALES, int)
    zfactor = a.next(DEFAULT_ZFACTOR, float)
    tol = a.next(DEFAULT_TOL, float)
    inner = a.next(DEFAULT_INNER, int)
    outer = a.next(DEFAULT_OUTER, int)
    outdir = a.next("./")
    verbose = bool(a.next(0, int))

    # the JAX CLI's clamping rules
    alpha = clamp(alpha, lambda x: x > 0, DEFAULT_ALPHA, "alpha", verbose)
    gamma = clamp(gamma, lambda x: x >= 0, DEFAULT_GAMMA, "gamma", verbose)
    nscales = clamp(nscales, lambda x: x > 0, DEFAULT_NSCALES, "nscales", verbose)
    zfactor = clamp(zfactor, lambda x: 0 < x < 1, DEFAULT_ZFACTOR, "zfactor", verbose)
    tol = clamp(tol, lambda x: x > 0, DEFAULT_TOL, "TOL", verbose)
    inner = clamp(inner, lambda x: x > 0, DEFAULT_INNER, "inner_iter", verbose)
    outer = clamp(outer, lambda x: x > 0, DEFAULT_OUTER, "outer_iter", verbose)

    imgs = [read_image(p, gray=True, dtype=np.float64).astype(np.float32)
            for p in paths]
    if any(im.shape != imgs[0].shape for im in imgs):
        print("Cannot read the images or the size of the images are not equal",
              file=sys.stderr)
        return 1
    vol = np.stack(imgs)
    if verbose:
        # parameter header after the nscales auto-clamp
        # (reference src/brox_temporal_main.cpp:181-193)
        ns = clamp_nscales(vol.shape[-1], vol.shape[-2], zfactor, nscales,
                           use_hypot=False)
        print(f"\n alpha:{alpha:g} gamma:{gamma:g} scales:{ns}"
              f" nu:{zfactor:g} TOL:{tol:g} inner:{inner} outer:{outer}")
    u, v = brox_temporal(vol, alpha=alpha, gamma=gamma, nscales=nscales,
                         zfactor=zfactor, tol=tol, inner_iter=inner,
                         outer_iter=outer, verbose=verbose, device=device)
    for i in range(frames - 1):
        save_flow(os.path.join(outdir, f"flow{i:02d}.flo"), u[i], v[i])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
