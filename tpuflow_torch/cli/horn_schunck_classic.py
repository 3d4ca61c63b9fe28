"""`horn_schunck_classic` CLI — mirrors reference
src/horn_schunck_classic_main.cpp, as tpuflow/cli/horn_schunck_classic.py
does; runs `hs_classic` (K6 at B=1) on the card unless `device="cpu"` is
given.

Usage: python -m tpuflow_torch.cli.horn_schunck_classic niter alpha a b f
"""

import sys

from tpuflow_torch.cli.common import load_pair, save_flow
from tpuflow_torch.models.hs_classic import hs_classic


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 5:
        print("usage:\n\thorn_schunck_classic niter alpha a b f", file=sys.stderr)
        return 1
    niter = int(argv[0])
    alpha = float(argv[1])
    I0, I1 = load_pair(argv[2], argv[3])
    u, v = hs_classic(I0, I1, niter=niter, alpha=alpha, device=device)
    save_flow(argv[4], u, v)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
