"""Robust discontinuity-preserving TV methods with exponential
regularization (Monzón/Salgado/Sánchez, IEEE TIP 2016).

Counterpart of tpuflow/models/robust_expo.py (reference
src/robust_expo_methods.cpp, src/robust_expo_smoothness.cpp,
src/robust_expo_generic_tensor.cpp).  Same skeleton as Brox spatial
(warp + lagged nonlinearity + SOR on the increment), with three changes:

  * multichannel (RGB) data/gradient psi terms are SUMMED over channels
    (src/robust_expo_methods.cpp:36-105, 273-318); images are (C, H, W)
    planes here (the reference is interleaved row-major);
  * the smoothness weight is modulated by a per-pixel EXPONENTIAL
    diffusivity computed once per scale from image-1 gradients:
    expo = exp(-lambda * max_c |grad I1_c|) (+ beta), with
    method_type 1 = DF, 2 = DF-BETA (beta = 0.001), 3 = DF-AUTO
    (per-pixel lambda from the gradient histogram, xi = 0.05,
    tau = 0.94 percentile; src/robust_expo_smoothness.cpp:17-19,79-186);
    psi_smooth = expo / sqrt(expo*|grad w|^2 + eps^2) (:28-47);
  * alpha is scaled by the channel count before use and TRUNCATED TO
    INT, and the SOR error is normalized by nx*ny*nz
    (src/robust_expo_methods.cpp:527, :400).

It runs the same kernels as Brox spatial: the warp of the 6 * C
derivative planes (`warp_planes_bounded`: K5 on levels of at least
96x96 px, K5p below, as the JAX package splits it), and K7 for each
inner iteration at every level
(`tpuflow_torch.models.brox_spatial._sor_solve`).  `outer_iterations`
takes the warp, the solve and the stencils as arguments, so the tiled
lane (tpuflow_torch.parallel.spatial.robust_expo_spatial) runs the same
body on tiles.  Its system is `expo_smoothness` and `expo_data_terms`
(tpuflow_torch.ops.brox_terms), the plain version of K10, which forms
it on the card for the gray batch engine
(tpuflow_torch.models.batch.robust_expo_batched).

The documented divergences of the JAX package from the reference are
kept: the reference's buggy presmooth is replicated by
`presmooth_mode="reference"` (sigma = channel count, Dirichlet BC, on
the first ny*nx values of the interleaved buffer); multichannel
pyramids downsample each channel with the grayscale zoom; the
multichannel second derivatives use the clean per-channel stencil.
"""

import math

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.models.brox_spatial import (MAXITER_SOR, _red_black,
                                               _sor_solve, print_iterations,
                                               psi_divergence,
                                               psi_weighted_divergence)
from tpuflow_torch.models.common import PRESMOOTHING_SIGMA, run_pyramid_state
from tpuflow_torch.ops.brox_terms import expo_data_terms, expo_smoothness
from tpuflow_torch.ops.gaussian import gaussian
from tpuflow_torch.ops.gradients import centered_gradient, dxx, dxy, dyy
from tpuflow_torch.ops.interp import resolve_warp_mode, warp_by_mode
from tpuflow_torch.ops.normalize import normalize_joint
from tpuflow_torch.ops.pyramid import clamp_nscales
from tpuflow_torch.utils.trace import traced

EPSILON = 0.001   # ROBUST_EXPO_EPSILON, src/robust_expo_smoothness.h:16
XI = 0.05         # src/robust_expo_smoothness.cpp:17
TAU = 0.94        # :18
BETA = 0.001      # :19

# CLI defaults, src/robust_expo_methods_main.cpp PAR_DEFAULT_*
DEFAULT_METHOD = 1
DEFAULT_ALPHA = 50.0
DEFAULT_GAMMA = 10.0
DEFAULT_LAMBDA = 0.2
DEFAULT_NSCALES = 10
DEFAULT_ZFACTOR = 0.5
DEFAULT_TOL = 1e-4
DEFAULT_INNER = 1
DEFAULT_OUTER = 15


def exponential_diffusivity(I1x, I1y, method_type, alpha, lam,
                            channel_dim=0):
    """Per-pixel diffusivity from image-1 gradients
    (robust_expo_exponential_calculation,
    src/robust_expo_smoothness.cpp:136-186).  I1x/I1y are (C, H, W)
    channel planes, their gradient magnitude's maximum over the channels
    taken; or, with `channel_dim=None`, (..., H, W) gray samples, each
    with a diffusivity of its own (DF-AUTO's percentile over each
    sample's H * W pixels).  `alpha` is the channel-adapted integer
    alpha (used only by DF-AUTO)."""
    maxgrad = torch.sqrt(I1x * I1x + I1y * I1y)
    if channel_dim is not None:
        maxgrad = torch.amax(maxgrad, dim=channel_dim)
    if method_type in (1, 2):
        beta = BETA if method_type == 2 else 0.0
        return torch.exp(-lam * maxgrad) + beta
    if method_type != 3:
        raise ValueError(f"method_type must be 1, 2 or 3, got {method_type}")
    # DF-AUTO: lambda_omega from the tau-percentile of the sorted
    # gradient histogram (lambda_optimum_using_maximum_gradient_per_pixel,
    # src/robust_expo_smoothness.cpp:79-130), per sample
    ny, nx = maxgrad.shape[-2:]
    size_flow = ny * nx
    c = -math.log(XI) + math.log(alpha)
    lambda_per_pixel = c / maxgrad
    sorted_g = torch.sort(maxgrad.flatten(-2)).values
    pos_ref0 = int(TAU * size_flow)
    # the reference advances pos_ref while sorted[pos_ref-1] < c/2; the
    # first stopping index is searchsorted(c/2) + 1 (JAX side="left")
    half = torch.full((*sorted_g.shape[:-1], 1), c / 2.0,
                      dtype=sorted_g.dtype, device=sorted_g.device)
    idx = torch.searchsorted(sorted_g, half, right=False)
    pos_ref = torch.clamp(idx + 1, min=pos_ref0, max=size_flow)
    lambda_omega = torch.where(pos_ref == size_flow,
                               torch.zeros_like(half),
                               c / sorted_g.gather(-1, pos_ref - 1))
    lambda_pi = torch.minimum(lambda_omega[..., None], lambda_per_pixel)
    return torch.exp(-lambda_pi * maxgrad)


def derivative_planes(I2):
    """The (6 * C, H, W) planes of image 2 that each outer iteration
    warps together: I2, I2x, I2y, I2xx, I2xy, I2yy."""
    I2x, I2y = centered_gradient(I2)
    return torch.cat([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)])


def outer_iterations(I1, I1x, I1y, expo, u, v, warp, sor, alpha, gamma,
                     inner_iter, outer_iter, gradient=centered_gradient,
                     psi_div=psi_divergence,
                     psi_wdiv=psi_weighted_divergence):
    """The outer iterations of `robust_expo_scale` on (C, H, W) image
    planes and (H, W) flow: `warp(u, v)` gives the `derivative_planes`
    warped by the flow, `sor(du, dv, Au, Av, Du, Dv, D, psis)` runs one
    inner iteration's solve and returns (du, dv, nsor, err), and the
    stencils default to the whole image's (the tiled lane,
    tpuflow_torch.parallel.spatial, gives their halo-exchanged twins).
    Returns (u, v, [nsor], [err]), one of each per inner iteration."""
    nsors, errs = [], []
    for _ in range(outer_iter):
        warped = warp(u, v).reshape(6, *I1.shape)
        psis, div_u, div_v, div_d = expo_smoothness(
            u, v, expo, alpha, gradient, psi_div, psi_wdiv)

        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _ in range(inner_iter):
            Au, Av, Du, Dv, D = expo_data_terms(I1, I1x, I1y, warped, du, dv,
                                                div_u, div_v, div_d, alpha,
                                                gamma)
            du, dv, nsor, err = sor(du, dv, Au, Av, Du, Dv, D, psis)
            nsors.append(nsor)
            errs.append(err)
        u = u + du
        v = v + dv
    return u, v, nsors, errs


def robust_expo_scale(I1, I2, u, v, method_type=DEFAULT_METHOD,
                      alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                      lam=DEFAULT_LAMBDA, tol=DEFAULT_TOL,
                      inner_iter=DEFAULT_INNER, outer_iter=DEFAULT_OUTER,
                      stop="error", maxiter=MAXITER_SOR, with_diag=False,
                      warp_mode="exact", dmax=8):
    """Single-scale robust-expo flow on (C, H, W) image planes
    (reference robust_expo_methods single-scale overload,
    src/robust_expo_methods.cpp:161-455).  `alpha` must already be
    channel-adapted (int(alpha * nz)), as `robust_expo` passes it.

    `with_diag=True` also returns {"iterations": (outer, inner) int32,
    "error": (outer, inner), "warp_overflow_tiles": 0}: the SOR scalars
    the reference prints when verbose (src/robust_expo_methods.cpp:402-404)."""
    nz, ny, nx = I1.shape
    size = nx * ny * nz  # SOR error norm, src/robust_expo_methods.cpp:400
    colors = _red_black(I1.shape, I1.device)

    I1x, I1y = centered_gradient(I1)
    planes = derivative_planes(I2)
    expo = exponential_diffusivity(I1x, I1y, method_type, alpha, lam)

    def sor(du, dv, Au, Av, Du, Dv, D, psis):
        return _sor_solve(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors,
                          tol, size, stop, maxiter)

    u, v, nsors, errs = outer_iterations(
        I1, I1x, I1y, expo, u, v,
        lambda u, v: warp_by_mode(planes, u, v, warp_mode, dmax), sor,
        alpha, gamma, inner_iter, outer_iter)
    if with_diag:
        return u, v, {
            "iterations": torch.stack(nsors).reshape(outer_iter, inner_iter),
            "error": torch.stack(errs).reshape(outer_iter, inner_iter),
            "warp_overflow_tiles": torch.zeros((), dtype=torch.int32,
                                               device=u.device)}
    return u, v


def _presmooth_reference(im):
    """Replicate the reference's buggy presmooth
    (src/robust_expo_methods.cpp:497-498): Gaussian with sigma = channel
    count and DIRICHLET boundary, applied to the first ny*nx values of
    the INTERLEAVED (H, W, C) buffer viewed as an (H, W) image.  For
    grayscale this is an ordinary sigma=1.0 Dirichlet smooth."""
    nz, ny, nx = im.shape
    if nz == 1:
        return gaussian(im, float(nz), bc="dirichlet")
    inter = im.permute(1, 2, 0).reshape(-1).clone()  # interleaved row-major
    inter[: ny * nx] = gaussian(inter[: ny * nx].reshape(ny, nx), float(nz),
                                bc="dirichlet").reshape(-1)
    return inter.reshape(ny, nx, nz).permute(2, 0, 1).contiguous()


def preprocess(images, presmooth_mode, gray_samples=False):
    """The pair normalised jointly to [0, 255], per channel of (C, H, W)
    planes (image_normalization_2_color, src/utils.cpp:334-404) or per
    sample of (B, H, W) gray samples (`gray_samples`), then presmoothed:
    "reference" replicates the reference's presmooth
    (`_presmooth_reference`; for gray images a sigma = 1.0 Dirichlet
    Gaussian), "clean" is the other methods' sigma = 0.8 reflecting
    one."""
    I1n, I2n = normalize_joint(*images)
    if presmooth_mode == "reference":
        if gray_samples:
            return tuple(gaussian(im, 1.0, bc="dirichlet")
                         for im in (I1n, I2n))
        return _presmooth_reference(I1n), _presmooth_reference(I2n)
    if presmooth_mode == "clean":
        return (gaussian(I1n, PRESMOOTHING_SIGMA),
                gaussian(I2n, PRESMOOTHING_SIGMA))
    raise ValueError(f"unknown presmooth_mode {presmooth_mode!r}")


@traced
def robust_expo(I1, I2, method_type=DEFAULT_METHOD, alpha=DEFAULT_ALPHA,
                gamma=DEFAULT_GAMMA, lam=DEFAULT_LAMBDA,
                nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                outer_iter=DEFAULT_OUTER, stop="error",
                maxiter=MAXITER_SOR, clamp_scales=True,
                presmooth_mode="reference", level_callback=None,
                resume=None, verbose=False, with_diag=False,
                warp_mode="auto", max_motion=8, device=None,
                scale_solver=None):
    """Multiscale robust-expo flow (reference robust_expo_methods
    multiscale overload, src/robust_expo_methods.cpp:462-566).

    I1/I2: (H, W) grayscale or (C, H, W) channel planes, tensors or
    arrays, moved to `device` in the dtype it computes in
    (`compute_inputs`: float32 on the card, float32 or float64 on the
    CPU; default: the card, and with no
    card present the call raises unless device="cpu" is given).

    `level_callback(scale, {"u1", "u2"})` runs after each level;
    `resume=(scale, state)` restarts below an already-solved level (see
    tpuflow_torch.utils.convert.resume_from_jax).  The levels run in a
    host loop: the JAX package's whole-pyramid jit
    (`_robust_expo_whole`, TPU only) has no counterpart here.

    `verbose` prints the reference's stdout lines: `Scale: %d` per
    level (src/robust_expo_methods.cpp:534-536) and
    `Iterations: %d Error: %g` per outer*inner iteration (:402-404).
    `with_diag=True` returns (u, v, diags), diags[s] = {"iterations":
    (outer, inner), "error": (outer, inner), "warp_overflow_tiles": 0},
    finest first.

    `scale_solver` replaces `robust_expo_scale` as the per-level solver,
    called with its arguments
    (tpuflow_torch.parallel.spatial.robust_expo_spatial gives its tiled
    solver)."""
    I1, I2 = compute_inputs(device, I1, I2)
    warp_mode = resolve_warp_mode(warp_mode, I1.device)
    if I1.ndim == 2:
        I1 = I1[None]
        I2 = I2[None]
    nz, ny, nx = I1.shape
    if clamp_scales:
        # reference main clamps on min(nx, ny) >= 16
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    # alpha adapted for channels and truncated to int
    # (src/robust_expo_methods.cpp:527)
    alpha_adapted = float(int(alpha * nz))

    diag = with_diag or verbose
    diags = [None] * nscales
    solver = robust_expo_scale if scale_solver is None else scale_solver

    def solve(level_images, state, scale):
        l1, l2 = level_images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = solver(l1, l2, state["u1"], state["u2"], method_type,
                     alpha_adapted, gamma, lam, tol, inner_iter, outer_iter,
                     stop, maxiter, with_diag=diag, warp_mode=warp_mode,
                     dmax=dmax)
        if diag:
            diags[scale] = out[2]
            if verbose:
                print_iterations(scale, out[2], outer_iter, inner_iter,
                                 with_error=True)
        return {"u1": out[0], "u2": out[1]}

    state = run_pyramid_state(
        (I1, I2), nscales, zfactor, solve, presmooth=None,
        preprocess=lambda images: preprocess(images, presmooth_mode),
        level_callback=level_callback, resume=resume)
    if with_diag:
        return state["u1"], state["u2"], diags
    return state["u1"], state["u2"]
