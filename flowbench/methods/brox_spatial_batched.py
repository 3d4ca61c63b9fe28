"""Brox spatial as a batch job: `tpuflow_torch.brox_spatial_batched` on
(B, ny, nx) stacks; the method has no single-pair cell (that is
methods/brox_spatial.py's)."""

from tpuflow_torch import brox_spatial_batched
from tpuflow_torch.utils.trace import counters
from flowbench.reference import _ops


def _kwargs(p):
    return dict(alpha=p["alpha"], gamma=p["gamma"], nscales=p["nscales"],
                zfactor=p["zfactor"], tol=p["tol"], inner_iter=p["inner_iter"],
                outer_iter=p["outer_iter"], stop=p["stop"],
                warp_mode=p["warp_mode"], max_motion=p["max_motion"])


def call(I0, I1, params, device):
    if I0.ndim != 3:
        raise ValueError("brox_spatial_batched takes (B, ny, nx) stacks")
    return brox_spatial_batched(I0, I1, device=device, **_kwargs(params))


def work(I0, I1, params, device):
    """The call's SOR sweeps, from `brox_spatial_batched(with_stats=True)`:
    for every solve of every level, each sample's (pixels, sweeps it
    needed), whichever route of K7 ran it.  The launches are K7's
    kernels as the program counts them over the call: three a sweep of
    route "stream" (`iters.k7`: two colours and `stop_finalize`) and
    one a solve of route "resident", given over the three kernel names
    of roofline/k7_batch.py as metrics/_common.py's `roofline_share`
    counts them."""
    before = counters()
    _, _, stats = brox_spatial_batched(I0, I1, device=device, with_stats=True,
                                       **_kwargs(params))
    after = counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    ny, nx = I0.shape[-2:]
    sizes = _ops.pyramid_sizes(nx, ny, params["zfactor"],
                               len(stats["iterations"]))
    k7 = []
    for scale, solves in stats["iterations"].items():
        px = sizes[scale][0] * sizes[scale][1]
        k7 += [(px, n) for per_sample in solves for n in per_sample]
    kernels = 3 * delta("iters.k7") + delta("calls.brox_sor_error.resident")
    return {"solver_iters": sum(n for _, n in k7), "k7_batch": k7,
            "launches": {"k7_batch": kernels / 3}}
