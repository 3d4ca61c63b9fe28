"""Plain reference of pyramidal Horn-Schunck as the port's batched engine
runs it (IPOL 2013.20 horn_schunck_pyramidal,
src/horn_schunck_pyramidal.cpp), on (B, ny, nx) pairs.

Per level, coarse to fine: each warp samples (I2, I2x, I2y) with the
strict bounded bicubic warp at dmax = max(3, ceil(max_motion *
zfactor^s)) and forms the linearised system (Au, Av, Du, Dv, D) of
alpha^2; SOR (omega 1.9) sweeps the 2x2 parity colours in the order
(0,0), (0,1), (1,0), (1,1), u then v with that pixel's new u, the
Laplacian weighing the direct neighbours 1/6 and the diagonal ones
1/12, until per sample the summed squared update of the last sweep is
at most tol^2 * level size or maxiter sweeps ran.  A level's warp loop
ends once every solve of the warp, over the whole batch, converged
within 2 sweeps (the engine's warp early exit).  The flow is upsampled
bicubically and scaled by 1/zfactor between levels.
"""

import math

import torch

from flowbench.reference import _ops

SOR_OMEGA = 1.9        # src/horn_schunck_pyramidal.cpp:21
D_FLOOR = 1e-30        # the engine's guard on Du, Dv
EARLY_EXIT = 2         # the engine's warp early exit, in sweeps


def _laplacian(f):
    """(hu + hd) / 12 + (h + up + dn) / 6 over the clamped 3x3
    neighbourhood: h the row's pair, hu and hd the pairs above and
    below, up and dn the pixels above and below."""
    h = _ops.shift_clamp(f, -1, -1) + _ops.shift_clamp(f, 1, -1)
    hu, hd = _ops.shift_clamp(h, -1, -2), _ops.shift_clamp(h, 1, -2)
    up, dn = _ops.shift_clamp(f, -1, -2), _ops.shift_clamp(f, 1, -2)
    return (hu + hd) * (1.0 / 12.0) + (h + up + dn) * (1.0 / 6.0)


def _sweep(u, v, au, av, rdu, rdv, dd, alpha2):
    """One 4-colour sweep of every sample; (u, v, summed squared update)."""
    w = SOR_OMEGA
    u0, v0 = u, v
    u, v = u.clone(), v.clone()
    for r in (0, 1):
        for c in (0, 1):
            q = (..., slice(r, None, 2), slice(c, None, 2))
            ula = _laplacian(u)[q]
            u[q] = ((1.0 - w) * u[q]
                    + w * (au[q] - dd[q] * v[q] + alpha2 * ula) * rdu[q])
            vla = _laplacian(v)[q]
            v[q] = ((1.0 - w) * v[q]
                    + w * (av[q] - dd[q] * u[q] + alpha2 * vla) * rdv[q])
    du = u - u0
    dv = v - v0
    return u, v, torch.sum(du * du + dv * dv, dim=(-2, -1))


def _sor(u, v, const, thresh, max_iter, alpha2):
    """Sweep every sample of (u, v) until it stops; returns (u, v, n)."""
    au, av, du, dv, dd = const.unbind(1)
    rdu = 1.0 / torch.clamp(du, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv, min=D_FLOOR)
    n = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    active = torch.full_like(n, max_iter > 0, dtype=torch.bool)
    while bool(active.any()):
        un, vn, err = _sweep(u, v, au, av, rdu, rdv, dd, alpha2)
        keep = active[:, None, None]
        u = torch.where(keep, un, u)
        v = torch.where(keep, vn, v)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    return u, v, n


def _level(I1, I2, u, v, dmax, thresh, p):
    alpha2 = p["alpha"] * p["alpha"]
    planes = torch.stack([I2, *_ops.centered_gradient(I2)], dim=1)
    for _ in range(p["warps"]):
        iw, iwx, iwy = _ops.bounded_warp(planes, u, v, dmax, True).unbind(1)
        dif = I1 - iw + iwx * u + iwy * v
        const = torch.stack([dif * iwx, dif * iwy, iwx * iwx + alpha2,
                             iwy * iwy + alpha2, iwx * iwy], dim=1)
        u, v, n = _sor(u, v, const, thresh, p["maxiter"], alpha2)
        if p["warp_early_exit"] and int(n.max()) <= EARLY_EXIT:
            break
    return u, v


def flow(I0, I1, params, joint_exit=True, prec=_ops.FLOAT32):
    """(u, v) float32, each (B, ny, nx), of the pairs (I0[b], I1[b]),
    given as one batch (`joint_exit`; the method has no single-pair
    traffic)."""
    if not joint_exit:
        raise ValueError("pyramidal Horn-Schunck is run on batches only")
    I0 = I0.to(prec.dtype)
    I1 = I1.to(prec.dtype)
    ny, nx = I0.shape[-2:]
    z = params["zfactor"]
    nscales = _ops.clamp_nscales(nx, ny, z, params["nscales"], use_hypot=True)
    levels, sizes = _ops.pyramid(I0, I1, nscales, z, prec)
    f = _ops.scalar_dtype(prec.dtype)
    tol2 = f(params["tol"] * params["tol"])
    cnx, cny = sizes[-1]
    u = v = I0.new_zeros((I0.shape[0], cny, cnx))
    for s in range(nscales - 1, -1, -1):
        dmax = max(3, math.ceil(params["max_motion"] * z ** s))
        cnx, cny = sizes[s]
        thresh = float(tol2 * f(cnx * cny))
        u, v = _level(*levels[s], u, v, dmax, thresh, params)
        if s > 0:
            u = _ops.zoom_in(u, sizes[s - 1], prec) * (1.0 / z)
            v = _ops.zoom_in(v, sizes[s - 1], prec) * (1.0 / z)
    return u.float(), v.float()
