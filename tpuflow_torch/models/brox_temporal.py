"""Brox et al. 2004 robust optical flow with spatio-temporal smoothness
over a frame sequence.

Counterpart of tpuflow/models/brox_temporal.py (reference
src/brox_optic_flow_temporal.cpp + src/brox_temporal_mask.cpp).  Given
T frames there are T-1 flow fields, one per consecutive pair, coupled by
two temporal psi terms to the neighbouring fields (psi5 the previous
field, psi6 the next; src/brox_temporal_mask.cpp:108-133).  Per scale
(brox_optic_flow, src/brox_optic_flow_temporal.cpp:282-513):

  outer loop: warp each frame f+1 and its 5 derivative planes by flow f
    (:357-364); the 3-D flow gradient (:367-368);
    psi_smooth with the temporal derivative (:94-113); 4 spatial
    divergence coefficients (zero across the image border) and 2
    temporal ones (zero at the first / last field);
    inner loop: psi_data / psi_gradient and Au/Av/Du/Dv/D, the pointwise
    math of Brox spatial (:397-423); red-black SOR over the whole
    (field, y, x) volume until sqrt(err/size) <= TOL or 300 sweeps
    (:429-457).

The colours are (f + i + j) % 2 over the (T-1, H, W) volume, so each of
the 6 neighbours (4 spatial, 2 temporal) has the other colour; the
reference sweeps the frames in turn instead (:434-454), and both reach
the same fixed point.

On the card each outer iteration warps all T-1 fields in one launch
(`warp_by_mode` with the (T-1, 6, H, W) stack built once per scale):
K5 (`warp_planes_batched`) at B = T-1 on levels of at least 96x96 px,
K5p (`warp_planes_shift_batched`, border_out) below, as "auto" resolves
to "fast" for CUDA tensors.  The 3-D SOR has no kernel of its own, in
JAX (an inline XLA loop) or here: it is plain PyTorch, and its stop is
read on the host after every sweep (`host_reads` in the diag).  On the
CPU the warp runs the kernels' plain versions ("fast") or the exact
gather ("auto").  The JAX package's whole-pyramid jit
(`_brox_temporal_whole`, TPU only) has no counterpart: the levels run in
a host loop.
"""

import math

import torch

from tpuflow_torch._device import compute_inputs
from tpuflow_torch.models.brox_spatial import (
    EPSILON,
    MAXITER_SOR,
    print_iterations,
    psi_divergence,
    psi_weighted_divergence,
)
from tpuflow_torch.models.common import run_pyramid_state
from tpuflow_torch.ops.brox import SOR_OMEGA
from tpuflow_torch.ops.gaussian import gaussian
from tpuflow_torch.ops.gradients import (
    _shift_clamp,
    centered_gradient,
    dxx,
    dxy,
    dyy,
)
from tpuflow_torch.ops.interp import resolve_warp_mode, warp_by_mode
from tpuflow_torch.ops.pyramid import clamp_nscales
from tpuflow_torch.utils.trace import traced

# CLI defaults, reference src/brox_temporal_main.cpp:19-27 (v1 2012
# defaults: alpha=18 gamma=7)
DEFAULT_ALPHA = 18.0
DEFAULT_GAMMA = 7.0
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.75
DEFAULT_TOL = 1e-4
DEFAULT_INNER = 1
DEFAULT_OUTER = 15
PRESMOOTH_SIGMA = 0.8  # src/brox_optic_flow_temporal.cpp:26


def preprocess_volume(images):
    """The pyramid's preprocessing of a (T, H, W) volume, `images` =
    (vol,): one [0, 255] normalisation over the whole volume (not the
    per-image normalize_joint), then the sigma-0.8 presmoothing."""
    (vol,) = images
    mn, mx = vol.min(), vol.max()
    den = mx - mn
    von = torch.where(den > 0,
                      255.0 * (vol - mn) / torch.where(den > 0, den, 1.0),
                      vol)
    return (gaussian(von, PRESMOOTH_SIGMA),)


def red_black_3d(fields, ny, nx, valid=None):
    """(red, black) masks of fields `fields` ((tl, 1, 1) global field
    indices) of a (T-1, H, W) volume: (f+i+j) even, odd; where `valid`
    is given, fields outside it take neither colour."""
    par = (fields + torch.arange(ny, device=fields.device)[None, :, None]
           + torch.arange(nx, device=fields.device)[None, None, :]) % 2
    if valid is None:
        return par == 0, par == 1
    return (par == 0) & valid, (par == 1) & valid


def solve_scale(I, u, v, frame_shifts, first, last, colors, size1,
                alpha, gamma, tol, inner_iter, outer_iter, stop, maxiter,
                warp_mode, dmax, sum_ranks=None):
    """The outer and inner iterations of one scale (reference
    brox_optic_flow, src/brox_optic_flow_temporal.cpp:357-461) on the
    (tl, H, W) fields u, v of the (tl + 1, H, W) frames I: those of the
    whole volume (`brox_temporal_scale`) or one rank's block of them
    (tpuflow_torch.parallel.temporal).

    `frame_shifts(f, clamp)` gives (f[t-1], f[t+1]) over the whole
    volume, clamped at its first and last field where `clamp` (the flow
    gradient's rule; the other reads are weighted by psi5 / psi6, which
    are zero there). `first` / `last` mark the volume's first and last
    field, `colors` the red-black masks, `size1` the volume's size; the
    stop tests sqrt(err / size1) > tol, err summed by `sum_ranks` where
    given.  Returns (u, v, each solve's sweep count, host reads)."""
    tl = u.shape[0]
    eps2 = EPSILON * EPSILON
    w = SOR_OMEGA
    tol_t = torch.tensor(tol, dtype=I.dtype, device=I.device)

    Ix, Iy = centered_gradient(I)
    I0, Ix0, Iy0 = I[:tl], Ix[:tl], Iy[:tl]
    # the derivative planes of frames 1..tl, warped by flow field f: one
    # (tl, 6, H, W) stack for the whole scale
    tail = I[1:]
    planes = torch.stack([tail, Ix[1:], Iy[1:], dxx(tail), dxy(tail),
                          dyy(tail)], dim=1).contiguous()

    def grad3(f):
        fx, fy = centered_gradient(f)
        prev, nxt = frame_shifts(f, True)
        return fx, fy, 0.5 * (nxt - prev)

    def div6(f, psi1, psi2, psi3, psi4, psi5, psi6):
        # the psi_i vanish across every boundary, so clamped shifts are
        # exact
        prev, nxt = frame_shifts(f, False)
        return (psi1 * _shift_clamp(f, 1, -2) + psi2 * _shift_clamp(f, -1, -2)
                + psi3 * _shift_clamp(f, 1, -1) + psi4 * _shift_clamp(f, -1, -1)
                + psi5 * prev + psi6 * nxt)

    nsors = []
    host_reads = 0
    for _ in range(outer_iter):
        Iw, Iwx, Iwy, Iwxx, Iwxy, Iwyy = warp_by_mode(
            planes, u, v, warp_mode, dmax).unbind(1)

        ux, uy, ut = grad3(u)
        vx, vy, vt = grad3(v)
        psis_s = 1.0 / torch.sqrt(ux * ux + uy * uy + ut * ut
                                  + vx * vx + vy * vy + vt * vt + eps2)
        psi1, psi2, psi3, psi4 = psi_divergence(psis_s)
        # psi5 / psi6: temporal half-sums, zero at the first / last field
        # (src/brox_temporal_mask.cpp:108-133)
        ps_prev, ps_next = frame_shifts(psis_s, False)
        zero = torch.zeros_like(psis_s)
        psi5 = torch.where(first, zero, 0.5 * (ps_prev + psis_s))
        psi6 = torch.where(last, zero, 0.5 * (ps_next + psis_s))
        psis = (psi1, psi2, psi3, psi4, psi5, psi6)
        u_prev, u_next = frame_shifts(u, False)
        v_prev, v_next = frame_shifts(v, False)
        div_u = (psi_weighted_divergence(u, psi1, psi2, psi3, psi4)
                 + psi5 * (u_prev - u) + psi6 * (u_next - u))
        div_v = (psi_weighted_divergence(v, psi1, psi2, psi3, psi4)
                 + psi5 * (v_prev - v) + psi6 * (v_next - v))
        div_d = alpha * (psi1 + psi2 + psi3 + psi4 + psi5 + psi6)

        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _ in range(inner_iter):
            dI = Iw - I0 + Iwx * du + Iwy * dv
            psid = 1.0 / torch.sqrt(dI * dI + eps2)
            dIx = Iwx - Ix0 + Iwxx * du + Iwxy * dv
            dIy = Iwy - Iy0 + Iwxy * du + Iwyy * dv
            psig = 1.0 / torch.sqrt(dIx * dIx + dIy * dIy + eps2)

            g = gamma * psig
            dif = Iw - I0
            dx = Iwx - Ix0
            dy = Iwy - Iy0
            Au = -psid * dif * Iwx - g * (dx * Iwxx + dy * Iwxy) + alpha * div_u
            Av = -psid * dif * Iwy - g * (dx * Iwxy + dy * Iwyy) + alpha * div_v
            Du = psid * Iwx * Iwx + g * (Iwxx * Iwxx + Iwxy * Iwxy) + div_d
            Dv = psid * Iwy * Iwy + g * (Iwyy * Iwyy + Iwxy * Iwxy) + div_d
            D = psid * Iwy * Iwx + g * (Iwxx + Iwyy) * Iwxy

            nsor = 0
            while nsor < maxiter:
                # one 3-D red-black SOR sweep on the coupled (du, dv)
                err = torch.zeros((), dtype=du.dtype, device=du.device)
                for mask in colors:
                    du_c = ((1.0 - w) * du
                            + w * (Au - D * dv + alpha * div6(du, *psis)) / Du)
                    du_n = torch.where(mask, du_c, du)
                    dv_c = ((1.0 - w) * dv
                            + w * (Av - D * du_n + alpha * div6(dv, *psis)) / Dv)
                    dv_n = torch.where(mask, dv_c, dv)
                    err = err + torch.sum((du_n - du) ** 2 + (dv_n - dv) ** 2)
                    du, dv = du_n, dv_n
                nsor += 1
                if stop == "error":
                    if sum_ranks is not None:
                        sum_ranks(err)
                    host_reads += 1
                    if not bool(torch.sqrt(err / size1) > tol_t):
                        break
            nsors.append(nsor)
        u = u + du
        v = v + dv
    return u, v, nsors, host_reads


def brox_temporal_scale(I, u, v, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                        tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                        outer_iter=DEFAULT_OUTER, stop="error",
                        maxiter=MAXITER_SOR, with_diag=False,
                        warp_mode="exact", dmax=8):
    """Single-scale spatio-temporal Brox flow (reference brox_optic_flow,
    src/brox_optic_flow_temporal.cpp:282-513).

    I: (T, H, W) frames; u, v: (T-1, H, W) flow fields.  stop="error"
    ends each SOR solve when sqrt(err/size) <= tol (or after `maxiter`
    sweeps), tested on the host after every sweep; stop="fixed" runs
    `maxiter` sweeps.  `with_diag=True` also returns {"iterations":
    (outer, inner) int32, "warp_overflow_tiles": 0, "host_reads": the
    stop reads made}: the sweep counts the reference prints when verbose
    (src/brox_optic_flow_temporal.cpp:459-461)."""
    if stop not in ("error", "fixed"):
        raise ValueError(f"unknown stop mode {stop!r}")
    frames, ny, nx = I.shape
    nz = frames - 1
    fields = torch.arange(nz, device=I.device)[:, None, None]

    def frame_shifts(f, clamp):
        return _shift_clamp(f, -1, 0), _shift_clamp(f, 1, 0)

    u, v, nsors, host_reads = solve_scale(
        I, u, v, frame_shifts, fields == 0, fields == nz - 1,
        red_black_3d(fields, ny, nx), nz * ny * nx, alpha, gamma, tol,
        inner_iter, outer_iter, stop, maxiter, warp_mode, dmax)
    if with_diag:
        its = torch.tensor(nsors, dtype=torch.int32, device=u.device)
        return u, v, {"iterations": its.reshape(outer_iter, inner_iter),
                      "warp_overflow_tiles": torch.zeros(
                          (), dtype=torch.int32, device=u.device),
                      "host_reads": host_reads}
    return u, v


@traced
def brox_temporal(I, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                  nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                  tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                  outer_iter=DEFAULT_OUTER, stop="error",
                  maxiter=MAXITER_SOR, clamp_scales=True,
                  level_callback=None, resume=None, verbose=False,
                  with_diag=False, warp_mode="auto", max_motion=8,
                  device=None):
    """Multiscale spatio-temporal Brox flow (reference
    brox_optic_flow_temporal, src/brox_optic_flow_temporal.cpp:520-626).

    I: (T, H, W) frames with T >= 3 (tensor or array, moved to `device`
    in the dtype it computes in, `compute_inputs`: float32 on the card,
    float32 or float64 on the CPU; the default device is the card, and
    with no card the call raises unless device="cpu" is given); returns
    (T-1, H, W) u and v.

    The volume is normalised to [0, 255] as one (image_normalization_1,
    src/utils.cpp:251-276), then smoothed with sigma 0.8; scales clamp
    on min(nx, ny) >= 16 (src/brox_temporal_main.cpp:141-147).  The
    displacement bound of the fast warp at level s is
    max(3, ceil(max_motion * zfactor**s)).

    `level_callback(scale, state)` / `resume=(scale, state)` are the
    pyramid loop's hooks (`run_pyramid_state`), state {"u1", "u2"}
    each (T-1, h, w).
    `verbose` prints the reference's stdout lines: `Scale: %d` per level
    (src/brox_optic_flow_temporal.cpp:592-594) and `Iterations: %d` per
    outer*inner iteration (:459-461).  `with_diag=True` returns (u, v,
    diags), diags[s] = `brox_temporal_scale`'s diag, finest first."""
    (I,) = compute_inputs(device, I)
    warp_mode = resolve_warp_mode(warp_mode, I.device)
    frames, ny, nx = I.shape
    if frames <= 2:
        raise ValueError("The method needs more than two frames "
                         "(src/brox_optic_flow_temporal.cpp:537)")
    if clamp_scales:
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    def state_init(size, dtype):
        cnx, cny = size
        z = torch.zeros((frames - 1, cny, cnx), dtype=dtype, device=I.device)
        return {"u1": z, "u2": z}

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(level_images, state, scale):
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = brox_temporal_scale(level_images[0], state["u1"], state["u2"],
                                  alpha, gamma, tol, inner_iter, outer_iter,
                                  stop, maxiter, with_diag=diag,
                                  warp_mode=warp_mode, dmax=dmax)
        if diag:
            diags[scale] = out[2]
            if verbose:
                print_iterations(scale, out[2], outer_iter, inner_iter)
        return {"u1": out[0], "u2": out[1]}

    state = run_pyramid_state(
        (I,), nscales, zfactor, solve, presmooth=None,
        preprocess=preprocess_volume,
        state_init=state_init, level_callback=level_callback, resume=resume)
    if with_diag:
        return state["u1"], state["u2"], diags
    return state["u1"], state["u2"]
