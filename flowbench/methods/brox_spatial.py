"""Brox spatial: `tpuflow_torch.brox_spatial`, single pairs only."""

import tpuflow_torch
from flowbench.reference import _ops


def _kwargs(p):
    return dict(alpha=p["alpha"], gamma=p["gamma"], nscales=p["nscales"],
                zfactor=p["zfactor"], tol=p["tol"], inner_iter=p["inner_iter"],
                outer_iter=p["outer_iter"], warp_mode=p["warp_mode"],
                max_motion=p["max_motion"])


def call(I0, I1, params, device):
    if I0.ndim != 2:
        raise ValueError("brox_spatial takes one pair a call")
    return tpuflow_torch.brox_spatial(I0, I1, device=device, **_kwargs(params))


def work(I0, I1, params, device):
    """The call's SOR sweeps, from `brox_spatial(with_diag=True)`: one
    K7 solve per outer and inner iteration of each level."""
    _, _, diags = tpuflow_torch.brox_spatial(I0, I1, device=device,
                                             with_diag=True, **_kwargs(params))
    ny, nx = I0.shape[-2:]
    sizes = _ops.pyramid_sizes(nx, ny, params["zfactor"], len(diags))
    k7 = []
    for (lnx, lny), diag in zip(sizes, diags):
        k7 += [(lnx * lny, int(n)) for n in diag["iterations"].flatten().tolist()]
    return {"solver_iters": sum(n for _, n in k7), "k7": k7,
            "launches": {"k7": len(k7)}}
