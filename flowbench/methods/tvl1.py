"""TV-L1: `tpuflow_torch.tvl1_batched` on stacks, `tvl1_multiscale` (the
tvl1flow CLI's entry, the batched engine at B=1 on the card) on single
pairs."""

import math

import tpuflow_torch
from flowbench.reference import _ops

CHECK_EVERY = 16   # iterations K2 launches between two host reads


def _pair_kwargs(p):
    return dict(tau=p["tau"], lam=p["lam"], theta=p["theta"],
                nscales=p["nscales"], zfactor=p["zfactor"], warps=p["warps"],
                epsilon=p["epsilon"], max_iterations=p["max_iterations"],
                stop=p["stop"], warp_mode=p["warp_mode"],
                max_motion=p["max_motion"])


def _batch_kwargs(p, shape):
    """`tvl1_batched`'s arguments; nscales clamped by the tvl1flow CLI's
    rule, as `tvl1_multiscale` clamps it before it calls the engine."""
    ny, nx = shape[-2:]
    return dict(tau=p["tau"], lam=p["lam"], theta=p["theta"],
                nscales=_ops.clamp_nscales(nx, ny, p["zfactor"], p["nscales"],
                                           True),
                zfactor=p["zfactor"], warps=p["warps"], epsilon=p["epsilon"],
                max_iterations=p["max_iterations"], stop=p["stop"],
                max_motion=p["max_motion"],
                warp_early_exit=p["warp_early_exit"])


def call(I0, I1, params, device):
    if I0.ndim == 2:
        return tpuflow_torch.tvl1_multiscale(I0, I1, device=device,
                                             **_pair_kwargs(params))
    return tpuflow_torch.tvl1_batched(I0, I1, device=device,
                                      **_batch_kwargs(params, I0.shape))


def work(I0, I1, params, device):
    """The call's iterations, from `tvl1_batched(with_stats=True)`; a
    single pair runs it at B=1 with the arguments `tvl1_multiscale`
    hands it."""
    a, b = (I0[None], I1[None]) if I0.ndim == 2 else (I0, I1)
    ny, nx = a.shape[-2:]
    kw = _batch_kwargs(params, a.shape)
    _, _, stats = tpuflow_torch.tvl1_batched(a, b, device=device,
                                             with_stats=True, **kw)
    sizes = _ops.pyramid_sizes(nx, ny, params["zfactor"], kw["nscales"])
    k2, launched = [], 0
    for scale, warps in stats["iterations"].items():
        px = sizes[scale][0] * sizes[scale][1]
        for n in warps:
            k2.append((px, sum(n)))
            chunks = math.ceil(max(n) / CHECK_EVERY) * CHECK_EVERY
            launched += min(params["max_iterations"], chunks)
    return {"solver_iters": launched, "k2": k2,
            "launches": {"k2": launched}}
