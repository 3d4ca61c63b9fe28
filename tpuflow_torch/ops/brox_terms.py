"""K9: the Brox spatial system of one inner iteration: kernel and plain
version.

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
"""

import ctypes

import torch

from tpuflow_torch import _build
from tpuflow_torch._device import check_inputs, on_card
from tpuflow_torch.ops.gradients import _shift_clamp, centered_gradient
from tpuflow_torch.utils.trace import count

EPSILON = 0.001     # reference src/brox_optic_flow_spatial.cpp:23

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
    "brox_terms_geometry": [_I],
}


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
    lib = _build.load("brox_terms", _SIGNATURES,
                      ("brox_terms_geometry", (*TILE, HALO, THREADS)))
    _build.launch(lib, "brox_terms", u, v, I1, I1x, I1y, warped, state, const,
                  B, ny, nx, float(alpha), float(gamma), EPSILON * EPSILON,
                  int(bool(first)), device=u.device)
    count("calls.brox_terms")
    return const
