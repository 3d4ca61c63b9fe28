"""K9 and K10: the Brox spatial and the robust-expo system of one inner
iteration: kernels and plain versions.

`brox_terms` forms, from the flow (u, v), the first image with its
centred gradient, the six warped planes of the second image and the
current increment (du, dv), the nine constants that K7
(`ops.brox.brox_sor_error`) solves, and writes them into `const` (B, 9,
ny, nx) in K7's order Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4
(reference src/brox_optic_flow_spatial.cpp:246-309,
src/brox_spatial_mask.cpp).  `first` says that (du, dv) is zero, as at
an outer iteration's first inner iteration: the state is then not read.

After `check_inputs`, the wrapper launches csrc/brox_terms.cu on a
CUDA tensor (one launch, counted in `calls.brox_terms`) and runs
`brox_terms_plain` on a CPU tensor.  The kernel rounds every operation
as the plain version does, in its order, so the two agree bit for bit
on the card.
`psi_divergence` and `psi_weighted_divergence` are the plain version's
smoothness stencils, which the other Brox-family solvers share.

`expo_terms` (K10) does the same for robust-expo's system on gray
stacks (reference src/robust_expo_methods.cpp:161-455): the smoothness
weight is expo / sqrt(expo * |grad w|^2 + eps^2), expo the per-pixel
exponential diffusivity (`models.robust_expo.exponential_diffusivity`),
and the data terms keep robust-expo's own order of operations.  Its
plain version `expo_terms_plain` is robust-expo's assembly,
`expo_smoothness` and `expo_data_terms`, which the single-pair solver
and its tiled lane run on (C, H, W) channel planes.  K10 is a second
kernel of csrc/brox_terms.cu, on K9's tiles, with `expo` read over a
halo of 1; its launches are counted in `calls.expo_terms`.
"""

import ctypes

import torch

from tpuflow_torch import _build
from tpuflow_torch._device import check_inputs, on_card
from tpuflow_torch.ops.gradients import _shift_clamp, centered_gradient
from tpuflow_torch.utils.trace import count

EPSILON = 0.001     # reference src/brox_optic_flow_spatial.cpp:23; robust-
                    # expo's too (src/robust_expo_smoothness.h:16)

# the kernel's geometry, as csrc/brox_terms.cu states it (checked when
# the library loads): tile rows and columns, the halo of u and v, the
# threads of a block
TILE = (16, 32)
HALO = 2
THREADS = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "brox_terms": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                   _I, _P],
    "expo_terms": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                   _F, _I, _P],
    "brox_terms_geometry": [_I],
}


def _library():
    return _build.load("brox_terms", _SIGNATURES,
                       ("brox_terms_geometry", (*TILE, HALO, THREADS)))


def psi_divergence(psi):
    """Half-sum divergence coefficients psi1..psi4 of the robustness
    weight, zeroed across the image boundary (reference
    src/brox_spatial_mask.cpp:16-93: psi1 down, psi2 up, psi3 right,
    psi4 left)."""
    psi1 = 0.5 * (_shift_clamp(psi, 1, -2) + psi)
    psi1[..., -1, :] = 0.0
    psi2 = 0.5 * (_shift_clamp(psi, -1, -2) + psi)
    psi2[..., 0, :] = 0.0
    psi3 = 0.5 * (_shift_clamp(psi, 1, -1) + psi)
    psi3[..., :, -1] = 0.0
    psi4 = 0.5 * (_shift_clamp(psi, -1, -1) + psi)
    psi4[..., :, 0] = 0.0
    return psi1, psi2, psi3, psi4


def psi_weighted_divergence(f, psi1, psi2, psi3, psi4):
    """sum_i psi_i * (f[neighbor_i] - f): the psi-weighted graph
    Laplacian (reference src/brox_spatial_mask.cpp:100-171).  The psi_i
    are already zero across the boundary, so clamped neighbour shifts
    reproduce the reference's boundary cases exactly."""
    return (psi1 * (_shift_clamp(f, 1, -2) - f)
            + psi2 * (_shift_clamp(f, -1, -2) - f)
            + psi3 * (_shift_clamp(f, 1, -1) - f)
            + psi4 * (_shift_clamp(f, -1, -1) - f))


def brox_terms_plain(u, v, I1, I1x, I1y, warped, state, const, alpha, gamma,
                     first):
    """Plain PyTorch version of the kernel; same contract as
    `brox_terms`."""
    eps2 = EPSILON * EPSILON
    I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = warped.unbind(1)
    ux, uy = centered_gradient(u)
    vx, vy = centered_gradient(v)
    psis_s = 1.0 / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + eps2)
    psis = psi_divergence(psis_s)
    div_u = psi_weighted_divergence(u, *psis)
    div_v = psi_weighted_divergence(v, *psis)
    div_d = alpha * (psis[0] + psis[1] + psis[2] + psis[3])
    if first:
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
    else:
        du, dv = state[:, 0], state[:, 1]

    dI = I2w - I1 + I2wx * du + I2wy * dv
    psid = 1.0 / torch.sqrt(dI * dI + eps2)
    dIx = I2wx - I1x + I2wxx * du + I2wxy * dv
    dIy = I2wy - I1y + I2wxy * du + I2wyy * dv
    psig = 1.0 / torch.sqrt(dIx * dIx + dIy * dIy + eps2)

    g = gamma * psig
    dif = I2w - I1
    dx = I2wx - I1x
    dy = I2wy - I1y
    Au = (-psid * dif * I2wx - g * (dx * I2wxx + dy * I2wxy)
          + alpha * div_u)
    Av = (-psid * dif * I2wy - g * (dx * I2wxy + dy * I2wyy)
          + alpha * div_v)
    Du = (psid * I2wx * I2wx + g * (I2wxx * I2wxx + I2wxy * I2wxy)
          + div_d)
    Dv = (psid * I2wy * I2wy + g * (I2wyy * I2wyy + I2wxy * I2wxy)
          + div_d)
    D = psid * I2wy * I2wx + g * (I2wxx + I2wyy) * I2wxy
    for k, plane in enumerate((Au, Av, Du, Dv, D, *psis)):
        const[:, k] = plane
    return const


def brox_terms(u, v, I1, I1x, I1y, warped, state, const, alpha, gamma,
               first):
    """Write one inner iteration's Brox system into `const` in place.

    u, v, I1, I1x, I1y: (B, ny, nx); warped: (B, 6, ny, nx) = the second
    image and its derivatives (x, y, xx, xy, yy) at the flow; state: (B,
    2, ny, nx) = (du, dv), not read where `first` is set (du = dv = 0);
    const: (B, 9, ny, nx) = (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4),
    written whole; alpha, gamma: Python scalars.  Returns `const`."""
    planes = ("B", "ny", "nx")
    check_inputs("brox_terms", u=(u, planes), v=(v, planes), I1=(I1, planes),
                 I1x=(I1x, planes), I1y=(I1y, planes),
                 warped=(warped, ("B", 6, "ny", "nx")),
                 state=(state, ("B", 2, "ny", "nx")),
                 const=(const, ("B", 9, "ny", "nx")))
    if not on_card(const):
        return brox_terms_plain(u, v, I1, I1x, I1y, warped, state, const,
                                alpha, gamma, first)
    B, ny, nx = u.shape
    _build.launch(_library(), "brox_terms", u, v, I1, I1x, I1y, warped, state, const,
                  B, ny, nx, float(alpha), float(gamma), EPSILON * EPSILON,
                  int(bool(first)), device=u.device)
    count("calls.brox_terms")
    return const


def expo_smoothness(u, v, expo, alpha, gradient=centered_gradient,
                    psi_div=psi_divergence,
                    psi_wdiv=psi_weighted_divergence):
    """Robust-expo's smoothness terms of the flow (u, v) under the
    diffusivity `expo`: (psis, div_u, div_v, div_d), psi_s = expo /
    sqrt(expo * |grad w|^2 + eps^2) (robust_expo_psi_smooth,
    src/robust_expo_smoothness.cpp:28-47).  The stencils default to the
    whole image's (the tiled lane, tpuflow_torch.parallel.spatial, gives
    their halo-exchanged twins)."""
    eps2 = EPSILON * EPSILON
    ux, uy = gradient(u)
    vx, vy = gradient(v)
    norm_flow = expo * (ux * ux + uy * uy + vx * vx + vy * vy)
    psis = psi_div(expo / torch.sqrt(norm_flow + eps2))
    div_u = psi_wdiv(u, *psis)
    div_v = psi_wdiv(v, *psis)
    div_d = alpha * (psis[0] + psis[1] + psis[2] + psis[3])
    return psis, div_u, div_v, div_d


def expo_data_terms(I1, I1x, I1y, warped, du, dv, div_u, div_v, div_d,
                    alpha, gamma):
    """Robust-expo's (Au, Av, Du, Dv, D) at the increment (du, dv): I1,
    I1x, I1y and the six `warped` planes (I2w, I2wx, I2wy, I2wxx, I2wxy,
    I2wyy) are (C, ...) channel planes, the weights and sums taken over
    the channels, axis 0 (psi_data/psi_gradient and the system,
    src/robust_expo_methods.cpp:36-105, 273-318)."""
    eps2 = EPSILON * EPSILON
    I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = warped
    dI = I2w + I2wx * du + I2wy * dv - I1
    psid = 1.0 / torch.sqrt(torch.sum(dI * dI, dim=0) + eps2)
    dIx = I2wx + I2wxx * du + I2wxy * dv - I1x
    dIy = I2wy + I2wxy * du + I2wyy * dv - I1y
    psig = 1.0 / torch.sqrt(torch.sum(dIx * dIx + dIy * dIy, dim=0) + eps2)

    g = gamma * psig
    dif = I2w - I1
    dx = I2wx - I1x
    dy = I2wy - I1y
    Au = (-psid * torch.sum(dif * I2wx, dim=0)
          - g * torch.sum(dx * I2wxx + dy * I2wxy, dim=0)
          + alpha * div_u)
    Av = (-psid * torch.sum(dif * I2wy, dim=0)
          - g * torch.sum(dx * I2wxy + dy * I2wyy, dim=0)
          + alpha * div_v)
    Du = (psid * torch.sum(I2wx * I2wx, dim=0)
          + g * torch.sum(I2wxx * I2wxx + I2wxy * I2wxy, dim=0)
          + div_d)
    Dv = (psid * torch.sum(I2wy * I2wy, dim=0)
          + g * torch.sum(I2wyy * I2wyy + I2wxy * I2wxy, dim=0)
          + div_d)
    D = (psid * torch.sum(I2wy * I2wx, dim=0)
         + g * torch.sum((I2wxx + I2wyy) * I2wxy, dim=0))
    return Au, Av, Du, Dv, D


def expo_terms_plain(u, v, expo, I1, I1x, I1y, warped, state, const, alpha,
                     gamma, first):
    """Plain PyTorch version of K10; same contract as `expo_terms`: the
    gray samples are one channel of robust-expo's assembly."""
    psis, div_u, div_v, div_d = expo_smoothness(u, v, expo, alpha)
    if first:
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
    else:
        du, dv = state[:, 0], state[:, 1]
    terms = expo_data_terms(I1[None], I1x[None], I1y[None],
                            warped.transpose(0, 1)[:, None], du, dv, div_u,
                            div_v, div_d, alpha, gamma)
    for k, plane in enumerate((*terms, *psis)):
        const[:, k] = plane
    return const


def expo_terms(u, v, expo, I1, I1x, I1y, warped, state, const, alpha, gamma,
               first):
    """Write one inner iteration's robust-expo system of B gray samples
    into `const` in place: `brox_terms`' contract, and `expo` (B, ny, nx)
    the exponential diffusivity of each sample's level.  Returns
    `const`."""
    planes = ("B", "ny", "nx")
    check_inputs("expo_terms", u=(u, planes), v=(v, planes),
                 expo=(expo, planes), I1=(I1, planes), I1x=(I1x, planes),
                 I1y=(I1y, planes), warped=(warped, ("B", 6, "ny", "nx")),
                 state=(state, ("B", 2, "ny", "nx")),
                 const=(const, ("B", 9, "ny", "nx")))
    if not on_card(const):
        return expo_terms_plain(u, v, expo, I1, I1x, I1y, warped, state,
                                const, alpha, gamma, first)
    B, ny, nx = u.shape
    _build.launch(_library(), "expo_terms", u, v, expo, I1, I1x, I1y,
                  warped, state, const, B, ny, nx, float(alpha),
                  float(gamma), EPSILON * EPSILON, int(bool(first)),
                  device=u.device)
    count("calls.expo_terms")
    return const
