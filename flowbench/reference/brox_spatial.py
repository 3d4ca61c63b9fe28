"""Plain reference of multiscale Brox spatial flow as the port runs it
(IPOL 2013.21, src/brox_optic_flow_spatial.cpp), on (B, ny, nx) pairs.

Per level, coarse to fine, `outer` times: the six planes (I2, I2x,
I2y, I2xx, I2xy, I2yy) are warped by the flow, with the strict bounded
bicubic warp on levels of at least 96x96 px and the shift-window warp
below, at dmax = max(3, ceil(max_motion * zfactor^s)); the smoothness
weights psi_1..psi_4 and the weighted divergences are formed; then
`inner` times the robust data and gradient weights and the coupled
5-point system on (du, dv), solved by red-black SOR (omega 1.9) per
sample until sqrt(err / size) <= tol or 300 sweeps; u += du.  The
flow is upsampled bicubically and scaled by 1/zfactor between levels.
"""

import math

import torch
import torch.nn.functional as F

from flowbench.reference import _ops

EPSILON = 0.001     # src/brox_optic_flow_spatial.cpp:23
MAXITER_SOR = 300   # :24
SOR_OMEGA = 1.9     # :25
D_FLOOR = 1e-30     # guard on Du, Dv


def psi_divergence(psi):
    s = _ops.shift_clamp
    p1 = 0.5 * (s(psi, 1, -2) + psi)
    p1[..., -1, :] = 0.0
    p2 = 0.5 * (s(psi, -1, -2) + psi)
    p2[..., 0, :] = 0.0
    p3 = 0.5 * (s(psi, 1, -1) + psi)
    p3[..., :, -1] = 0.0
    p4 = 0.5 * (s(psi, -1, -1) + psi)
    p4[..., :, 0] = 0.0
    return p1, p2, p3, p4


def weighted_divergence(f, p1, p2, p3, p4):
    s = _ops.shift_clamp
    return (p1 * (s(f, 1, -2) - f) + p2 * (s(f, -1, -2) - f)
            + p3 * (s(f, 1, -1) - f) + p4 * (s(f, -1, -1) - f))


def _sor(s, const, thresh, alpha):
    """Red-black SOR on (B, 2, ny, nx) `s` = (du, dv) per sample until
    err <= thresh or MAXITER_SOR sweeps; returns s."""
    B, _, ny, nx = s.shape
    au, av, du_c, dv_c, dd = const[:, :5].unbind(1)
    p1, p2, p3, p4 = const[:, 5:, None].unbind(1)
    rdu = 1.0 / torch.clamp(du_c, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv_c, min=D_FLOOR)
    ii = torch.arange(ny, device=s.device)[:, None]
    jj = torch.arange(nx, device=s.device)
    red = (ii + jj) % 2 == 0
    n = torch.zeros(B, dtype=torch.int32, device=s.device)
    active = torch.ones(B, dtype=torch.bool, device=s.device)
    w = SOR_OMEGA
    while bool(active.any()):
        s0 = s.clone()
        du, dv = s[:, 0], s[:, 1]
        for mask in (red, ~red):
            fp = F.pad(s, (1, 1, 1, 1), mode="replicate")
            dp = (p1 * fp[..., 2:, 1:-1] + p2 * fp[..., :-2, 1:-1]
                  + p3 * fp[..., 1:-1, 2:] + p4 * fp[..., 1:-1, :-2])
            new = (1.0 - w) * du + w * (au - dd * dv + alpha * dp[:, 0]) * rdu
            torch.where(mask, new, du, out=du)
            new = (1.0 - w) * dv + w * (av - dd * du + alpha * dp[:, 1]) * rdv
            torch.where(mask, new, dv, out=dv)
        if not bool(active.all()):
            s = torch.where(active[:, None, None, None], s, s0)
        d = s - s0
        err = torch.sum(d * d, dim=(1, 2, 3))
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < MAXITER_SOR)
    return s


def _level(I1, I2, u, v, dmax, p):
    ny, nx = I1.shape[-2:]
    size = ny * nx
    alpha, gamma = p["alpha"], p["gamma"]
    eps2 = EPSILON * EPSILON
    thresh = float(_ops.scalar_dtype(I1.dtype)(p["tol"] * p["tol"] * size))
    I1x, I1y = _ops.centered_gradient(I1)
    I2x, I2y = _ops.centered_gradient(I2)
    planes = torch.stack([I2, I2x, I2y, _ops.dxx(I2), _ops.dxy(I2),
                          _ops.dyy(I2)], dim=1)
    strict = size >= _ops.K5_MIN_PIXELS
    for _ in range(p["outer_iter"]):
        I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = _ops.bounded_warp(
            planes, u, v, dmax, strict).unbind(1)
        ux, uy = _ops.centered_gradient(u)
        vx, vy = _ops.centered_gradient(v)
        psis = psi_divergence(1.0 / torch.sqrt(ux * ux + uy * uy + vx * vx
                                               + vy * vy + eps2))
        div_u = weighted_divergence(u, *psis)
        div_v = weighted_divergence(v, *psis)
        div_d = alpha * (psis[0] + psis[1] + psis[2] + psis[3])
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _ in range(p["inner_iter"]):
            dI = I2w - I1 + I2wx * du + I2wy * dv
            psid = 1.0 / torch.sqrt(dI * dI + eps2)
            dIx = I2wx - I1x + I2wxx * du + I2wxy * dv
            dIy = I2wy - I1y + I2wxy * du + I2wyy * dv
            psig = 1.0 / torch.sqrt(dIx * dIx + dIy * dIy + eps2)
            g = gamma * psig
            dif = I2w - I1
            dx = I2wx - I1x
            dy = I2wy - I1y
            Au = -psid * dif * I2wx - g * (dx * I2wxx + dy * I2wxy) + alpha * div_u
            Av = -psid * dif * I2wy - g * (dx * I2wxy + dy * I2wyy) + alpha * div_v
            Du = psid * I2wx * I2wx + g * (I2wxx * I2wxx + I2wxy * I2wxy) + div_d
            Dv = psid * I2wy * I2wy + g * (I2wyy * I2wyy + I2wxy * I2wxy) + div_d
            D = psid * I2wy * I2wx + g * (I2wxx + I2wyy) * I2wxy
            s = _sor(torch.stack([du, dv], dim=1),
                     torch.stack([Au, Av, Du, Dv, D, *psis], dim=1),
                     thresh, alpha)
            du, dv = s[:, 0], s[:, 1]
        u = u + du
        v = v + dv
    return u, v


def flow(I1, I2, params, joint_exit=True, prec=_ops.FLOAT32):
    """(u, v) float32, each (B, ny, nx), of the pairs (I1[b], I2[b]);
    the samples never interact, so `joint_exit` changes nothing."""
    I1 = I1.to(prec.dtype)
    I2 = I2.to(prec.dtype)
    ny, nx = I1.shape[-2:]
    z = params["zfactor"]
    nscales = _ops.clamp_nscales(nx, ny, z, params["nscales"], use_hypot=False)
    levels, sizes = _ops.pyramid(I1, I2, nscales, z, prec)
    cnx, cny = sizes[-1]
    u = v = I1.new_zeros((I1.shape[0], cny, cnx))
    for s in range(nscales - 1, -1, -1):
        dmax = max(3, math.ceil(params["max_motion"] * z ** s))
        u, v = _level(*levels[s], u, v, dmax, params)
        if s > 0:
            u = _ops.zoom_in(u, sizes[s - 1], prec) * (1.0 / z)
            v = _ops.zoom_in(v, sizes[s - 1], prec) * (1.0 / z)
    return u.float(), v.float()
