"""Plain reference of multiscale TV-L1 as the port's batched engine
runs it (IPOL 2013.26 tvl1flow, src/tvl1flow.cpp), on (B, ny, nx) pairs.

Per level, coarse to fine: each warp samples (I1, I1x, I1y) with the
strict bounded bicubic warp at dmax = max(3, ceil(max_motion *
zfactor^s)) and forms (I1wx, I1wy, rho_c, grad); the fixed point
(thresholding, primal step through Chambolle's divergence, dual ascent)
runs per sample until the summed squared update is at most
epsilon^2 * level size or max_iterations ran.  A level's warp loop ends
once every solve of the warp converged within 2 iterations (the
engine's warp early exit): over the whole batch when `joint_exit`, as
one batched call decides it, else for each sample alone, as B
single-pair calls decide it.  The flow is upsampled bicubically and
scaled by 1/zfactor between levels.
"""

import math

import torch

from flowbench.reference import _ops

GRAD_IS_ZERO = 1e-10   # src/tvl1flow.cpp:24
EARLY_EXIT = 2         # the engine's warp early exit, in iterations


def _fixed_point(state, const, active, thresh, max_iter, l_t, theta, taut):
    """Iterate every sample of `state` (B, 6, ny, nx) that is `active`
    until it stops; returns (state, n)."""
    iwx, iwy, rho_c, grad = const.unbind(1)
    fi = -1.0 / torch.clamp(grad, min=GRAD_IS_ZERO)
    n = torch.zeros(state.shape[0], dtype=torch.int32, device=state.device)
    while bool(active.any()):
        u1, u2, p11, p12, p21, p22 = state.unbind(1)
        rho = rho_c + iwx * u1 + iwy * u2
        zero = torch.zeros_like(rho)
        mul = torch.where(rho < -l_t * grad, l_t,
                          torch.where(rho > l_t * grad, -l_t,
                                      torch.where(grad < GRAD_IS_ZERO, zero,
                                                  rho * fi)))
        u1n = u1 + mul * iwx + theta * _ops.divergence(p11, p12)
        u2n = u2 + mul * iwy + theta * _ops.divergence(p21, p22)
        du = u1n - u1
        dv = u2n - u2
        err = torch.sum(du * du + dv * dv, dim=(-2, -1))
        u1x, u1y = _ops.forward_gradient(u1n)
        u2x, u2y = _ops.forward_gradient(u2n)
        ng1 = 1.0 / (1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y))
        ng2 = 1.0 / (1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y))
        new = torch.stack([u1n, u2n, (p11 + taut * u1x) * ng1,
                           (p12 + taut * u1y) * ng1, (p21 + taut * u2x) * ng2,
                           (p22 + taut * u2y) * ng2], dim=1)
        state = torch.where(active[:, None, None, None], new, state)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    return state, n


def _level(I0, I1, u, v, dmax, thresh, p, joint_exit, counts):
    l_t = p["lam"] * p["theta"]
    taut = p["tau"] / p["theta"]
    planes = torch.stack([I1, *_ops.centered_gradient(I1)], dim=1)
    state = I0.new_zeros((I0.shape[0], 6) + tuple(I0.shape[-2:]))
    state[:, 0] = u
    state[:, 1] = v
    done = torch.zeros(I0.shape[0], dtype=torch.bool, device=I0.device)
    for _ in range(p["warps"]):
        uw, vw = state[:, 0], state[:, 1]
        iw, iwx, iwy = _ops.bounded_warp(planes, uw, vw, dmax, True).unbind(1)
        const = torch.stack([iwx, iwy, iw - iwx * uw - iwy * vw - I0,
                             iwx * iwx + iwy * iwy], dim=1)
        state, n = _fixed_point(state, const, ~done, thresh,
                                p["max_iterations"], l_t, p["theta"], taut)
        if counts is not None:
            counts.append(n.tolist())
        if not p["warp_early_exit"]:
            continue
        if joint_exit:
            if int(n.max()) <= EARLY_EXIT:
                break
        else:
            done = done | (n <= EARLY_EXIT)
            if bool(done.all()):
                break
    return state[:, 0], state[:, 1]


def flow(I0, I1, params, joint_exit=True, prec=_ops.FLOAT32, counts=None):
    """(u, v) float32, each (B, ny, nx), of the pairs (I0[b], I1[b]).
    `counts`, a dict, receives {scale: per-warp lists of per-sample
    iterations}, as the engine's `with_stats` gives them."""
    I0 = I0.to(prec.dtype)
    I1 = I1.to(prec.dtype)
    ny, nx = I0.shape[-2:]
    z = params["zfactor"]
    nscales = _ops.clamp_nscales(nx, ny, z, params["nscales"], use_hypot=True)
    levels, sizes = _ops.pyramid(I0, I1, nscales, z, prec)
    f = _ops.scalar_dtype(prec.dtype)
    eps2 = f(params["epsilon"] * params["epsilon"])
    cnx, cny = sizes[-1]
    u = v = I0.new_zeros((I0.shape[0], cny, cnx))
    for s in range(nscales - 1, -1, -1):
        dmax = max(3, math.ceil(params["max_motion"] * z ** s))
        cnx, cny = sizes[s]
        thresh = float(eps2 * f(cnx * cny))
        u, v = _level(*levels[s], u, v, dmax, thresh, params, joint_exit,
                      None if counts is None else counts.setdefault(s, []))
        if s > 0:
            u = _ops.zoom_in(u, sizes[s - 1], prec) * (1.0 / z)
            v = _ops.zoom_in(v, sizes[s - 1], prec) * (1.0 / z)
    return u.float(), v.float()
