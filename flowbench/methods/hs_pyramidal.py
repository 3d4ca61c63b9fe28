"""Pyramidal Horn-Schunck: `tpuflow_torch.hs_pyramidal_batched` on
(B, ny, nx) stacks; the method has no single-pair cell."""

import tpuflow_torch
from flowbench.reference import _ops


def _kwargs(p, shape):
    """`hs_pyramidal_batched`'s arguments; nscales clamped by the
    horn_schunck_pyramidal CLI's rule (coarsest diagonal >= 16 px)."""
    ny, nx = shape[-2:]
    return dict(alpha=p["alpha"],
                nscales=_ops.clamp_nscales(nx, ny, p["zfactor"], p["nscales"],
                                           True),
                zfactor=p["zfactor"], warps=p["warps"], tol=p["tol"],
                maxiter=p["maxiter"], max_motion=p["max_motion"],
                stop=p["stop"], warp_early_exit=p["warp_early_exit"])


def call(I0, I1, params, device):
    if I0.ndim != 3:
        raise ValueError("hs_pyramidal_batched takes (B, ny, nx) stacks")
    return tpuflow_torch.hs_pyramidal_batched(I0, I1, device=device,
                                              **_kwargs(params, I0.shape))


def work(I0, I1, params, device):
    """The call's SOR sweeps, from `hs_pyramidal_batched(with_stats=True)`:
    per warp the sweeps its slowest sample needed, summed."""
    _, _, stats = tpuflow_torch.hs_pyramidal_batched(
        I0, I1, device=device, with_stats=True, **_kwargs(params, I0.shape))
    return {"solver_iters": sum(max(n) for level in stats["iterations"].values()
                                for n in level)}
