"""Joint TV-L1 optical flow and occlusion estimation (Ballester,
Garrido, Lazcano, Caselles 2012; Garamendi's IPOL implementation).

Counterpart of tpuflow/models/tvl1occflow.py (reference
src/tvl1occflow.cpp, src/tvl1occflow_solvers.cpp,
src/tvl1occflow_constants.h).  Three frames (I-1, I0, I1) and a
smoothed copy of I0 for the edge indicator g = 1/(1 + 0.05*|grad
filtI0|) (choosed_g, src/tvl1occflow.cpp:102-136).  Per warp
(src/tvl1occflow.cpp:217-297): warp (I1, I1x, I1y) by +u and (I-1,
I-1x, I-1y) by -u, border_out off, then alternate until the mean
squared flow change drops to epsilon or 20 iterations:

  1. `solver_wrt_v`: closed-form thresholding, forward (non-occluded)
     and backward (occluded) branches, chosen per pixel by chi >= 0.75;
  2. `solver_wrt_u`: two scalar ROF problems by the staggered box
     scheme (tpuflow_torch.models.tvl1occ_rof), 10 sweeps each, then a
     3x3 median of u;
  3. `solver_wrt_chi`: 100 primal-dual iterations on the occlusion map.

The ROF duals p11..p22 and the chi duals eta1, eta2 start at 0 at each
scale and carry across iterations and warps within it (the reference
keeps them in function-static buffers, solvers.cpp:164,243, and reads
eta uninitialised at first; zero is what a fresh allocation gives).

The multiscale solve (src/tvl1occflow.cpp:335-481): no normalisation (the
reference overwrites the normalised buffers with the raw images,
:383-397), presmoothing sigma 0.8 of all four images, zoom_out pyramid,
flow upsampled with the 1/zfactor rescale, chi without it, chi
thresholded at 0.75 only at the finest scale (:458-460).

On the card each warp is two launches of K5p (`warp_planes_bounded(...,
border_out=False)` -> `warp_planes_shift_batched`) at every level, as
"auto" resolves to "fast" for CUDA tensors.  Nothing else has a
kernel, in JAX or here: the ROF box solve, the chi primal-dual and the
median are plain PyTorch, and the stop is read on the host after every
iteration (`host_reads` in the diag).  `warp_iterations` takes the warp,
the stencils, the median and the error sum as arguments, so the tiled
lane (tpuflow_torch.parallel.spatial.tvl1occflow_spatial) runs the same
body on tiles.  The JAX package's whole-pyramid
jit (`_tvl1occflow_whole`, TPU only) has no counterpart: the levels run
in a host loop.
"""

import math
import sys

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.models.common import run_pyramid_state, upsample_flow
from tpuflow_torch.models.tvl1occ_rof import rof_box_cell_centered
from tpuflow_torch.ops.gradients import centered_gradient, divergence, forward_gradient
from tpuflow_torch.ops.interp import resolve_warp_mode, warp_by_mode
from tpuflow_torch.ops.median import median_filter
from tpuflow_torch.ops.pyramid import clamp_nscales, zoom_in
from tpuflow_torch.utils.trace import traced

# src/tvl1occflow_constants.h
DEFAULT_LAMBDA = 0.15
DEFAULT_ALPHA = 0.01
DEFAULT_BETA = 0.15
DEFAULT_THETA = 0.3
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 2
DEFAULT_EPSILON = 0.01
EXT_MAX_ITERATIONS = 20
OMEGA = 1.25
IS_ZERO = 1e-10
THR_CHI = 0.75
MAX_ITERATIONS_CHI = 100
MAX_ITERATIONS_U = 10
PRESMOOTHING_SIGMA = 0.8
G_FACTOR = 0.05
TAU_ETA = 0.15
TAU_CHI = 0.15


def edge_indicator(filt_i0):
    """g = 1/(1 + G_FACTOR*|grad filtI0|) (choosed_g with G_CHOICE=2,
    src/tvl1occflow.cpp:122-132)."""
    ix, iy = centered_gradient(filt_i0)
    return 1.0 / (1.0 + G_FACTOR * torch.sqrt(ix * ix + iy * iy))


def _threshold(rho, Iwx, Iwy, grad, lo, hi, step, sign):
    """One branch's thresholding step (d1, d2): `sign * step * Iw` where
    `lo`, `-sign * step * Iw` where `hi`, else `-sign * rho * Iw / grad`
    (0 where grad < IS_ZERO)."""
    mid_zero = grad < IS_ZERO
    safe = torch.where(mid_zero, 1.0, grad)
    return tuple(torch.where(lo, sign * step * Iw,
                             torch.where(hi, -sign * step * Iw,
                                         torch.where(mid_zero, 0.0,
                                                     -sign * rho * Iw / safe)))
                 for Iw in (Iwx, Iwy))


def solver_wrt_v(u1, u2, chi, I1wx, I1wy, Im1wx, Im1wy, rho1_c, rho3_c,
                 grad1, grad3, alpha, theta, lam):
    """Closed-form minimisation in the auxiliary variable v
    (Solver_wrt_v, src/tvl1occflow_solvers.cpp:55-147).  Returns (v1, v2,
    vfwd1, vfwd2, vbck1, vbck2)."""
    l_t = lam * theta
    one_pat = 1.0 + alpha * theta
    at_d = alpha * theta / one_pat
    lt_d = 2.0 * lam * theta / one_pat

    # forward (non-occluded) branch: TV-L1 thresholding
    rho1 = rho1_c + I1wx * u1 + I1wy * u2
    d1, d2 = _threshold(rho1, I1wx, I1wy, grad1, rho1 < -l_t * grad1,
                        rho1 > l_t * grad1, l_t, 1.0)
    vfwd1 = u1 + d1
    vfwd2 = u2 + d2

    # backward (occluded) branch against I_{-1}
    rho3 = rho3_c - (Im1wx * u1 + Im1wy * u2)
    A = rho3 + at_d * (Im1wx * u1 + Im1wy * u2)
    lo = A < -lt_d * grad3
    hi = A > lt_d * grad3
    b1, b2 = _threshold(rho3, Im1wx, Im1wy, grad3, lo, hi, lt_d, -1.0)
    # saturated branches start from u/(1+alpha*theta), the middle one
    # from u (solvers.cpp:114-136)
    sat = lo | hi
    vbck1 = torch.where(sat, u1 / one_pat, u1) + b1
    vbck2 = torch.where(sat, u2 / one_pat, u2) + b2

    occluded = chi >= THR_CHI
    v1 = torch.where(occluded, vbck1, vfwd1)
    v2 = torch.where(occluded, vbck2, vfwd2)
    return v1, v2, vfwd1, vfwd2, vbck1, vbck2


def solver_wrt_u(v1, v2, chi, g, theta, beta, p11, p12, p21, p22,
                 forward_gradient=forward_gradient,
                 rof=rof_box_cell_centered):
    """Minimisation in the flow u: two modified ROF problems by the
    staggered box scheme (Solver_wrt_u, src/tvl1occflow_solvers.cpp
    :149-215).  Returns (u1, u2, p11, p12, p21, p22).  The tiled lane
    gives `forward_gradient` and `rof` their tiled twins."""
    chix, chiy = forward_gradient(chi)
    f1 = v1 / theta + beta * chix
    f2 = v2 / theta + beta * chiy
    u1 = v1 + theta * beta * chix
    u2 = v2 + theta * beta * chiy
    u1, p11, p12 = rof(u1, f1, p11, p12, g, theta, OMEGA, MAX_ITERATIONS_U)
    u2, p21, p22 = rof(u2, f2, p21, p22, g, theta, OMEGA, MAX_ITERATIONS_U)
    return u1, u2, p11, p12, p21, p22


def solver_wrt_chi(u1, u2, chi, I1wx, I1wy, Im1wx, Im1wy, rho1_c, rho3_c,
                   vfwd1, vfwd2, vbck1, vbck2, g, lam, theta, alpha, beta,
                   eta1, eta2, forward_gradient=forward_gradient,
                   divergence=divergence):
    """100 primal-dual iterations on the occlusion map chi
    (Solver_wrt_chi, src/tvl1occflow_solvers.cpp:217-337); returns
    (chi, eta1, eta2).  The tiled lane gives the stencils their tiled
    twins."""
    rho1 = rho1_c + I1wx * vfwd1 + I1wy * vfwd2
    rho3 = rho3_c - (Im1wx * vbck1 + Im1wy * vbck2)
    div_u = divergence(u1, u2)
    # the two branches of F and G, fixed within the call
    F_fwd = -lam * torch.abs(rho1)
    F_bck = lam * torch.abs(rho3)
    G_fwd = -(0.5 / theta) * ((vfwd1 - u1) ** 2 + (vfwd2 - u2) ** 2)
    G_bck = ((0.5 / theta) * ((vbck1 - u1) ** 2 + (vbck2 - u2) ** 2)
             + alpha * theta * (vbck1 * vbck1 + vbck2 * vbck2))
    tau_g = TAU_ETA * g
    for _ in range(MAX_ITERATIONS_CHI):
        chix, chiy = forward_gradient(chi)
        eta1 = eta1 + tau_g * chix
        eta2 = eta2 + tau_g * chiy
        norm2 = eta1 * eta1 + eta2 * eta2
        small = norm2 < IS_ZERO
        norm = torch.sqrt(torch.where(small, 1.0, norm2))
        eta1 = torch.where(small, 0.0, eta1 / norm)
        eta2 = torch.where(small, 0.0, eta2 / norm)

        div_eta = divergence(g * eta1, g * eta2)
        non_occ = chi < 0.5
        F = torch.where(non_occ, F_fwd, F_bck)
        G = torch.where(non_occ, G_fwd, G_bck)
        chi = torch.clamp(chi + TAU_CHI * (div_eta - F - G - beta * div_u),
                          0.0, 1.0)
    return chi, eta1, eta2


def warp_iterations(I0, u1, u2, chi, g, warp, lam, alpha, beta, theta,
                    warps, epsilon, stop, max_iterations, size,
                    forward_gradient=forward_gradient, divergence=divergence,
                    rof=rof_box_cell_centered, median=median_filter,
                    total=lambda e: e):
    """The warps of `tvl1occ_scale` on (H, W) fields: `warp(u1, u2)`
    gives (I1w, I1wx, I1wy, Im1w, Im1wx, Im1wy), the two warps, and the
    stencils, the 3x3 median and `total` (the squared flow change summed
    over the image, given this image's sum) default to the whole
    image's; the tiled lane (tpuflow_torch.parallel.spatial) gives their
    tiled twins and the sum over the tiles.  `size` is the whole image's
    pixel count.  Returns (u1, u2, chi, [iterations], [error], host
    reads)."""
    if stop not in ("error", "fixed"):
        raise ValueError(f"unknown stop mode {stop!r}")
    eps_t = torch.tensor(epsilon, dtype=I0.dtype, device=I0.device)
    zero = torch.zeros_like(u1)
    st = dict(u1=u1, u2=u2, chi=chi, p11=zero, p12=zero, p21=zero, p22=zero,
              eta1=zero, eta2=zero)
    u1prev, u2prev = u1, u2
    ns, errs, host_reads = [], [], 0
    for _ in range(warps):
        I1w, I1wx, I1wy, Im1w, Im1wx, Im1wy = warp(st["u1"], st["u2"])
        grad1 = I1wx * I1wx + I1wy * I1wy
        grad3 = Im1wx * Im1wx + Im1wy * Im1wy
        rho1_c = I1w - I1wx * st["u1"] - I1wy * st["u2"] - I0
        rho3_c = Im1w + Im1wx * st["u1"] + Im1wy * st["u2"] - I0

        n = 0
        err = torch.tensor(math.inf, dtype=I0.dtype, device=I0.device)
        while n < max_iterations:
            v1, v2, vf1, vf2, vb1, vb2 = solver_wrt_v(
                st["u1"], st["u2"], st["chi"], I1wx, I1wy, Im1wx, Im1wy,
                rho1_c, rho3_c, grad1, grad3, alpha, theta, lam)
            nu1, nu2, p11, p12, p21, p22 = solver_wrt_u(
                v1, v2, st["chi"], g, theta, beta,
                st["p11"], st["p12"], st["p21"], st["p22"],
                forward_gradient, rof)
            nu1 = median(nu1, 3)
            nu2 = median(nu2, 3)
            chi, eta1, eta2 = solver_wrt_chi(
                nu1, nu2, st["chi"], I1wx, I1wy, Im1wx, Im1wy, rho1_c,
                rho3_c, vf1, vf2, vb1, vb2, g, lam, theta, alpha, beta,
                st["eta1"], st["eta2"], forward_gradient, divergence)
            err = total(torch.sum((nu1 - u1prev) ** 2
                                  + (nu2 - u2prev) ** 2)) / size
            st = dict(u1=nu1, u2=nu2, chi=chi, p11=p11, p12=p12, p21=p21,
                      p22=p22, eta1=eta1, eta2=eta2)
            u1prev, u2prev = nu1, nu2
            n += 1
            if stop == "error":
                host_reads += 1
                if not bool(err > eps_t):
                    break
        ns.append(n)
        errs.append(err)
    return st["u1"], st["u2"], st["chi"], ns, errs, host_reads


def tvl1occ_scale(Im1, I0, I1, filt_i0, u1, u2, chi, lam=DEFAULT_LAMBDA,
                  alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA, theta=DEFAULT_THETA,
                  warps=DEFAULT_WARPS, epsilon=DEFAULT_EPSILON, stop="error",
                  max_iterations=EXT_MAX_ITERATIONS, with_diag=False,
                  warp_mode="exact", dmax=8):
    """Single-scale joint flow and occlusion solver (Dual_TVL1_optic_flow,
    src/tvl1occflow.cpp:143-328) on (H, W) images.

    stop="error" ends a warp's iterations when the summed squared flow
    change over the pixels is <= epsilon (or after `max_iterations`),
    tested on the host after every iteration; stop="fixed" runs
    `max_iterations`.  `with_diag=True` also returns {"iterations":
    (warps,) int32, "error": (warps,), "host_reads": the stop reads
    made}: the per-warp scalars the reference prints to stderr when
    verbose (src/tvl1occflow.cpp:292-296)."""
    fwd_planes = torch.stack([I1, *centered_gradient(I1)])
    bck_planes = torch.stack([Im1, *centered_gradient(Im1)])

    def warp(u1, u2):
        return (*warp_by_mode(fwd_planes, u1, u2, warp_mode, dmax,
                              border_out=False),
                *warp_by_mode(bck_planes, -u1, -u2, warp_mode, dmax,
                              border_out=False))

    u1, u2, chi, ns, errs, host_reads = warp_iterations(
        I0, u1, u2, chi, edge_indicator(filt_i0), warp, lam, alpha, beta,
        theta, warps, epsilon, stop, max_iterations, I0.numel())
    if with_diag:
        return u1, u2, chi, {
            "iterations": torch.tensor(ns, dtype=torch.int32,
                                       device=I0.device),
            "error": torch.stack(errs), "host_reads": host_reads}
    return u1, u2, chi


@traced
def tvl1occflow(Im1, I0, I1, filt_i0=None, lam=DEFAULT_LAMBDA,
                alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA, theta=DEFAULT_THETA,
                nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                warps=DEFAULT_WARPS, epsilon=DEFAULT_EPSILON, stop="error",
                max_iterations=EXT_MAX_ITERATIONS, clamp_scales=True,
                level_callback=None, resume=None, verbose=False,
                with_diag=False, warp_mode="auto", max_motion=8,
                device=None, scale_solver=None):
    """Multiscale joint flow and occlusion estimation
    (Dual_TVL1_optic_flow_multiscale, src/tvl1occflow.cpp:335-481).

    Inputs (H, W), tensors or arrays, are moved to `device` in the dtype
    it computes in (`compute_inputs`: float32 on the card, float32 or
    float64 on the CPU);
    the default device is the card, and with no card the call raises
    unless device="cpu" is given.  Returns (u1, u2, chi) at the finest
    scale, chi thresholded at 0.75 into {0, 1}.  `filt_i0` defaults to
    I0 (the reference CLI's fallback, src/tvl1occflow_main.cpp:100-110).
    Scales clamp on min(nx, ny) >= 16 (src/tvl1occflow_main.cpp:192-196).
    The displacement bound of the fast warp at level s is
    max(3, ceil(max_motion * zfactor**s)).

    `level_callback(scale, state)` / `resume=(scale, state)` are the
    pyramid loop's hooks (`run_pyramid_state`), state {"u1", "u2",
    "chi"}.  `verbose` prints `verbose` on stdout once per scale
    (src/tvl1occflow.cpp:192-194) and `Warping: %d, Iterations: %d,
    Error: %e` per warp on stderr (:292-296).  `with_diag=True` returns
    (u1, u2, chi, diags), diags[s] = `tvl1occ_scale`'s diag, finest
    first.  `scale_solver` replaces `tvl1occ_scale` as the per-level
    solver, called with its arguments
    (tpuflow_torch.parallel.spatial.tvl1occflow_spatial gives its tiled
    solver)."""
    if filt_i0 is None:
        filt_i0 = I0
    Im1, I0, I1, filt_i0 = compute_inputs(device, Im1, I0, I1, filt_i0)
    warp_mode = resolve_warp_mode(warp_mode, I0.device)
    ny, nx = I0.shape[-2:]
    if clamp_scales:
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    def state_init(size, dtype):
        cnx, cny = size
        z = torch.zeros((cny, cnx), dtype=dtype, device=I0.device)
        return {"u1": z, "u2": z, "chi": z}

    def upsample(state, out_size, zfactor_):
        u1, u2 = upsample_flow(state["u1"], state["u2"], out_size, zfactor_)
        # chi upsampled WITHOUT the magnitude rescale (src/tvl1occflow.cpp:470)
        return {"u1": u1, "u2": u2, "chi": zoom_in(state["chi"], out_size)}

    diag = with_diag or verbose
    diags = [None] * nscales
    solver = tvl1occ_scale if scale_solver is None else scale_solver

    def solve(level_images, state, scale):
        lm1, l0, l1, lf = level_images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = solver(lm1, l0, l1, lf, state["u1"], state["u2"],
                     state["chi"], lam, alpha, beta, theta, warps, epsilon,
                     stop, max_iterations, with_diag=diag,
                     warp_mode=warp_mode, dmax=dmax)
        if diag:
            d = diags[scale] = out[3]
            if verbose:
                print("verbose", file=sys.stdout)
                its, errs = d["iterations"].tolist(), d["error"].tolist()
                for w in range(warps):
                    print(f"Warping: {w}, Iterations: {int(its[w])}, "
                          f"Error: {float(errs[w]):e}", file=sys.stderr)
        return {"u1": out[0], "u2": out[1], "chi": out[2]}

    state = run_pyramid_state(
        (Im1, I0, I1, filt_i0), nscales, zfactor, solve,
        presmooth=PRESMOOTHING_SIGMA, preprocess=None, state_init=state_init,
        upsample_state=upsample, level_callback=level_callback,
        resume=resume)
    chi = (state["chi"] > THR_CHI).to(I0.dtype)
    if with_diag:
        return state["u1"], state["u2"], chi, diags
    return state["u1"], state["u2"], chi
