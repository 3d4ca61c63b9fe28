"""Plain reference of robust-expo flow on gray pairs as the port runs it
(Monzon, Salgado and Sanchez, IEEE TIP 25(4), 2016;
src/robust_expo_methods.cpp, src/robust_expo_smoothness.cpp), on
(B, ny, nx) pairs.

Per pair: both frames normalised jointly to [0, 255]; the reference's
presmooth, which on a gray image is a Gaussian of sigma 1 with a zero
(Dirichlet) pad (presmooth_mode "reference"; "clean" is the other
methods' sigma 0.8 reflecting one); the pyramid zoomed out from that
level with no further presmooth.  At each level, from image 1's
centred gradient magnitude |grad I1| = sqrt(I1x^2 + I1y^2), the
exponential diffusivity expo = exp(-lambda |grad I1|) (+ 0.001 for
method 2); method 3 (DF-AUTO) takes lambda per pixel as min(lambda_w,
c / |grad I1|), c = -log(0.05) + log(alpha), lambda_w = c over the
sample's gradient magnitude at the position of the 0.94 percentile, or
past it at the first magnitude of at least c / 2, 0 where that is the
last pixel (src/robust_expo_smoothness.cpp:79-186).  Then, `outer`
times: the six planes (I2, I2x, I2y, I2xx, I2xy, I2yy) are warped as in
reference/brox_spatial.py; psi_s = expo / sqrt(expo |grad w|^2 + eps^2)
gives psi_1..psi_4 and the weighted divergences; `inner` times the
robust data and gradient weights and the 5-point system, solved by
reference/brox_spatial.py's red-black SOR per sample until
sqrt(err / (ny nx)) <= tol or 300 sweeps; u += du.  alpha is
int(alpha x channels), the channels one.  The flow is upsampled
bicubically and scaled by 1/zfactor between levels.

Departures from src/robust_expo_methods.cpp, all the port's: the warp
is the bounded bicubic warp of reference/brox_spatial.py (strict at
levels of at least 96x96 px, the shift window below) where the
reference's is unbounded; DF-AUTO's search for the percentile's
position is a count of the magnitudes below c / 2, where the reference
steps from the 0.94 percentile one pixel at a time (the same position);
Du and Dv are floored at 1e-30 before their reciprocal, as in
reference/brox_spatial.py; the reference's images are interleaved
colour buffers, here gray planes only.
"""

import math

import numpy as np
import torch

from flowbench.reference import _ops
from flowbench.reference.brox_spatial import (_sor, psi_divergence,
                                              weighted_divergence)

EPSILON = 0.001     # src/robust_expo_smoothness.h:16
XI = 0.05           # src/robust_expo_smoothness.cpp:17
TAU = 0.94          # :18
BETA = 0.001        # :19
REFERENCE_SIGMA = 1.0   # the presmooth's sigma: the channel count, one


def gaussian_zero(f, sigma):
    """Separable Gaussian, rows first, with a zero pad: the reference's
    `gaussian` with its Dirichlet boundary (src/operators.cpp:506-624)."""
    size = int(_ops.GAUSSIAN_WINDOW * sigma) + 1
    j = np.arange(size, dtype=np.float64)
    w = np.exp(-(j * j) / (2.0 * sigma * sigma))
    w = torch.tensor(w / (2.0 * w.sum() - w[0]), dtype=f.dtype).tolist()
    for dim in (-1, -2):
        n = f.shape[dim]
        pad = list(f.shape)
        pad[dim] = size
        z = f.new_zeros(pad)
        p = torch.cat([z, f, z], dim=dim)
        out = w[0] * p.narrow(dim, size, n)
        for k in range(1, size):
            out = out + w[k] * (p.narrow(dim, size - k, n)
                                + p.narrow(dim, size + k, n))
        f = out
    return f


def diffusivity(I1x, I1y, p, alpha):
    """Each sample's exponential diffusivity (B, ny, nx)."""
    grad = torch.sqrt(I1x * I1x + I1y * I1y)
    method = p["method_type"]
    if method in (1, 2):
        return torch.exp(-p["lam"] * grad) + (BETA if method == 2 else 0.0)
    B, ny, nx = grad.shape
    size = ny * nx
    c = -math.log(XI) + math.log(alpha)
    ordered = torch.sort(grad.reshape(B, size), dim=1).values
    below = (ordered < torch.tensor(c / 2.0, dtype=grad.dtype,
                                    device=grad.device)).sum(dim=1)
    pos = torch.clamp(below + 1, min=int(TAU * size), max=size)
    at = ordered.gather(1, (pos - 1)[:, None])[:, 0]
    lam_w = torch.where(pos == size, torch.zeros_like(at), c / at)
    lam = torch.minimum(lam_w[:, None, None], c / grad)
    return torch.exp(-lam * grad)


def _level(I1, I2, u, v, dmax, p, alpha):
    ny, nx = I1.shape[-2:]
    size = ny * nx
    gamma = p["gamma"]
    eps2 = EPSILON * EPSILON
    thresh = float(_ops.scalar_dtype(I1.dtype)(p["tol"] * p["tol"] * size))
    I1x, I1y = _ops.centered_gradient(I1)
    expo = diffusivity(I1x, I1y, p, alpha)
    I2x, I2y = _ops.centered_gradient(I2)
    planes = torch.stack([I2, I2x, I2y, _ops.dxx(I2), _ops.dxy(I2),
                          _ops.dyy(I2)], dim=1)
    strict = size >= _ops.K5_MIN_PIXELS
    for _ in range(p["outer_iter"]):
        I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = _ops.bounded_warp(
            planes, u, v, dmax, strict).unbind(1)
        ux, uy = _ops.centered_gradient(u)
        vx, vy = _ops.centered_gradient(v)
        norm = expo * (ux * ux + uy * uy + vx * vx + vy * vy)
        psis = psi_divergence(expo / torch.sqrt(norm + eps2))
        div_u = weighted_divergence(u, *psis)
        div_v = weighted_divergence(v, *psis)
        div_d = alpha * (psis[0] + psis[1] + psis[2] + psis[3])
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _ in range(p["inner_iter"]):
            dI = I2w + I2wx * du + I2wy * dv - I1
            psid = 1.0 / torch.sqrt(dI * dI + eps2)
            dIx = I2wx + I2wxx * du + I2wxy * dv - I1x
            dIy = I2wy + I2wxy * du + I2wyy * dv - I1y
            psig = 1.0 / torch.sqrt(dIx * dIx + dIy * dIy + eps2)
            g = gamma * psig
            dif = I2w - I1
            dx = I2wx - I1x
            dy = I2wy - I1y
            Au = (-psid * (dif * I2wx) - g * (dx * I2wxx + dy * I2wxy)
                  + alpha * div_u)
            Av = (-psid * (dif * I2wy) - g * (dx * I2wxy + dy * I2wyy)
                  + alpha * div_v)
            Du = psid * (I2wx * I2wx) + g * (I2wxx * I2wxx + I2wxy * I2wxy) + div_d
            Dv = psid * (I2wy * I2wy) + g * (I2wyy * I2wyy + I2wxy * I2wxy) + div_d
            D = psid * (I2wy * I2wx) + g * ((I2wxx + I2wyy) * I2wxy)
            s = _sor(torch.stack([du, dv], dim=1),
                     torch.stack([Au, Av, Du, Dv, D, *psis], dim=1),
                     thresh, alpha)
            du, dv = s[:, 0], s[:, 1]
        u = u + du
        v = v + dv
    return u, v


def _presmooth(f, mode):
    if mode == "reference":
        return gaussian_zero(f, REFERENCE_SIGMA)
    if mode == "clean":
        return _ops.gaussian(f, _ops.PRESMOOTHING_SIGMA)
    raise ValueError(f"unknown presmooth_mode {mode!r}")


def flow(I1, I2, params, joint_exit=True, prec=_ops.FLOAT32):
    """(u, v) float32, each (B, ny, nx), of the gray pairs (I1[b],
    I2[b]); the samples never interact, so `joint_exit` changes
    nothing."""
    I1 = I1.to(prec.dtype)
    I2 = I2.to(prec.dtype)
    ny, nx = I1.shape[-2:]
    z = params["zfactor"]
    nscales = _ops.clamp_nscales(nx, ny, z, params["nscales"], use_hypot=False)
    a, b = _ops.normalize_pair(I1, I2)
    levels = [tuple(_presmooth(f, params["presmooth_mode"]) for f in (a, b))]
    sizes = _ops.pyramid_sizes(nx, ny, z, nscales)
    for s in range(1, nscales):
        levels.append(tuple(_ops.zoom_out(f, z, sizes[s], prec)
                            for f in levels[-1]))
    alpha = float(int(params["alpha"]))
    cnx, cny = sizes[-1]
    u = v = I1.new_zeros((I1.shape[0], cny, cnx))
    for s in range(nscales - 1, -1, -1):
        dmax = max(3, math.ceil(params["max_motion"] * z ** s))
        u, v = _level(*levels[s], u, v, dmax, params, alpha)
        if s > 0:
            u = _ops.zoom_in(u, sizes[s - 1], prec) * (1.0 / z)
            v = _ops.zoom_in(v, sizes[s - 1], prec) * (1.0 / z)
    return u.float(), v.float()
