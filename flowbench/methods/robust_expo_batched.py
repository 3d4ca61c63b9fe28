"""Robust-expo as a batch job: `tpuflow_torch.robust_expo_batched` on
(B, ny, nx) gray stacks.  Importing this module fails on a program
without that entry."""

from tpuflow_torch import robust_expo_batched
from tpuflow_torch.utils.trace import counters
from flowbench.reference import _ops

KEYS = ("method_type", "alpha", "gamma", "lam", "nscales", "zfactor", "tol",
        "inner_iter", "outer_iter", "stop", "presmooth_mode", "warp_mode",
        "max_motion")


def _kwargs(p):
    return {k: p[k] for k in KEYS}


def call(I0, I1, params, device):
    if I0.ndim != 3:
        raise ValueError("robust_expo_batched takes (B, ny, nx) stacks")
    return robust_expo_batched(I0, I1, device=device, **_kwargs(params))


def work(I0, I1, params, device):
    """The call's work, from `robust_expo_batched(with_stats=True)` and
    the program's counters over the call:
      - "k7_batch": for every solve of every level, each sample's
        (pixels, sweeps it needed), whichever route of K7 ran it;
      - "k10": each K10 launch's (samples x pixels, whether it is an
        outer iteration's first inner iteration), one entry a launch;
      - "launches": K7's kernels as the program launches them over the
        call, two a sweep of route "stream" (`iters.k7`:
        `brox_sor_colors` and `stop_finalize`), one settle a solve of
        that route and one launch a solve of route "resident", given
        over the three kernel names of roofline/k7_batch.py as
        metrics/_common.py's `roofline_share` counts them; and K10's
        launches (`calls.expo_terms`)."""
    before = counters()
    _, _, stats = robust_expo_batched(I0, I1, device=device, with_stats=True,
                                      **_kwargs(params))
    after = counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    B = I0.shape[0]
    ny, nx = I0.shape[-2:]
    sizes = _ops.pyramid_sizes(nx, ny, params["zfactor"],
                               len(stats["iterations"]))
    k7, k10 = [], []
    for scale, solves in stats["iterations"].items():
        px = sizes[scale][0] * sizes[scale][1]
        k7 += [(px, n) for per_sample in solves for n in per_sample]
        k10 += [(B * px, k % params["inner_iter"] == 0)
                for k in range(len(solves))]
    k7_kernels = (2 * delta("iters.k7") + delta("calls.brox_sor_error.stream")
                  + delta("calls.brox_sor_error.resident"))
    return {"solver_iters": sum(n for _, n in k7), "k7_batch": k7, "k10": k10,
            "launches": {"k7_batch": k7_kernels / 3,
                         "k10": delta("calls.expo_terms")}}
