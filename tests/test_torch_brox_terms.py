"""K9's plain version and its tile schedule on the CPU.

`brox_terms_plain` (tpuflow_torch.ops.brox_terms) forms the Brox spatial
system of one inner iteration and writes it into K7's constants; here it
is held bit for bit to the assembly `brox_scale` made before K9, rebuilt
from `centered_gradient`, `psi_divergence` and
`psi_weighted_divergence` and stacked with `_system`, on the first inner
iteration (zero increment) and on a later one; `brox_scale` with two
inner iterations is held to that composition too.  K9 itself runs only
on the card (chip_smoke.py's `check_brox_terms`); its block schedule
(tiles of `TILE` pixels, u and v staged over a clamped halo of `HALO`,
psi_s over a halo of 1 at the clamped pixel) is replayed here tile by
tile and held to the plain version with `torch.equal`.  At 64x128 with
B = 2, in float32 and float64; a few seconds in all.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow_torch.data import synth_pair
from tpuflow_torch.models.brox_spatial import (DEFAULT_ALPHA, DEFAULT_GAMMA,
                                               _solve, _system, brox_scale)
from tpuflow_torch.ops import brox_terms as bt
from tpuflow_torch.ops.gradients import centered_gradient, dxx, dxy, dyy
from tpuflow_torch.ops.interp import warp_by_mode
from tpuflow_torch.utils.trace import counters

NY, NX, B = 64, 128, 2
CSRC = Path(bt.__file__).resolve().parent.parent / "csrc" / "brox_terms.cu"
DTYPES = [torch.float32, torch.float64]


def _flow(dtype, ny=NY, nx=NX, seed=0):
    """Two smooth flows of a few pixels, with a ramp so no gradient is 0."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, ny, dtype=torch.float64),
                            torch.linspace(0, 1, nx, dtype=torch.float64),
                            indexing="ij")
    out = []
    for _ in range(2):
        a = torch.rand((B, 3), generator=g, dtype=torch.float64)
        out.append((3 * a[:, 0, None, None] * torch.sin(6 * xx + 3 * a[:, 1, None, None])
                    + 2 * a[:, 2, None, None] * yy).to(dtype))
    return out


def _inputs(dtype, ny=NY, nx=NX):
    """(I1, I2, u, v, I1x, I1y, warped, state) of one outer iteration:
    synth_pair's images, smooth flows, the six planes of I2 warped by
    the exact gather, and a nonzero increment."""
    I1, I2 = (torch.as_tensor(np.stack(x), dtype=dtype)
              for x in zip(*(synth_pair(ny, nx, seed=s) for s in range(B))))
    u, v = _flow(dtype, ny, nx)
    I1x, I1y = centered_gradient(I1)
    I2x, I2y = centered_gradient(I2)
    planes = torch.stack([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)], dim=1)
    warped = warp_by_mode(planes, u, v, "exact", 8)
    state = torch.stack(_flow(dtype, ny, nx, seed=1), dim=1) * 0.1
    return I1, I2, u, v, I1x, I1y, warped, state.contiguous()


def _pr18_system(u, v, I1, I1x, I1y, warped, du, dv, alpha, gamma):
    """The (B, 9, ny, nx) constants as `brox_scale` assembled them before
    K9: the smoothness terms once an outer iteration, the data terms at
    (du, dv), stacked by `_system`."""
    eps2 = bt.EPSILON * bt.EPSILON
    I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = warped.unbind(1)
    ux, uy = centered_gradient(u)
    vx, vy = centered_gradient(v)
    psis_s = 1.0 / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + eps2)
    psis = bt.psi_divergence(psis_s)
    div_u = bt.psi_weighted_divergence(u, *psis)
    div_v = bt.psi_weighted_divergence(v, *psis)
    div_d = alpha * (psis[0] + psis[1] + psis[2] + psis[3])
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
    return _system(Au, Av, Du, Dv, D, *psis)


def _pr18_brox_scale(I1, I2, u, v, alpha, gamma, tol, inner_iter,
                     outer_iter):
    """`brox_scale` on (B, ny, nx) stacks as it composed a level before
    K9: a fresh `_system` of the increment and of the constants for
    every K7 call.  Returns (u, v, sweeps (B, outer, inner))."""
    size = I1.shape[-2] * I1.shape[-1]
    I1x, I1y = centered_gradient(I1)
    I2x, I2y = centered_gradient(I2)
    planes = torch.stack([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)], dim=1)
    nsors = []
    for _ in range(outer_iter):
        warped = warp_by_mode(planes, u, v, "exact", 8)
        du, dv = torch.zeros_like(u), torch.zeros_like(v)
        for _ in range(inner_iter):
            const = _pr18_system(u, v, I1, I1x, I1y, warped, du, dv, alpha,
                                 gamma)
            du, dv, nsor, _ = _solve(_system(du, dv), const, alpha, tol, size,
                                     "error", 300)
            nsors.append(nsor)
        u = u + du
        v = v + dv
    return u, v, torch.stack(nsors, dim=-1).reshape(-1, outer_iter, inner_iter)


def _const_like(u):
    B, ny, nx = u.shape
    return torch.full((B, 9, ny, nx), float("nan"), dtype=u.dtype)


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_plain_equals_the_pr18_assembly(dtype, first):
    I1, _, u, v, I1x, I1y, warped, state = _inputs(dtype)
    const = bt.brox_terms_plain(u, v, I1, I1x, I1y, warped, state,
                                _const_like(u), DEFAULT_ALPHA, DEFAULT_GAMMA,
                                first)
    du, dv = ((torch.zeros_like(u), torch.zeros_like(v)) if first
              else (state[:, 0], state[:, 1]))
    want = _pr18_system(u, v, I1, I1x, I1y, warped, du, dv, DEFAULT_ALPHA,
                        DEFAULT_GAMMA)
    assert const.dtype == dtype
    assert torch.equal(const, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_psis_are_zero_across_the_boundary(dtype):
    """psi1 (down) on the last row, psi2 (up) on the first, psi3 (right)
    on the last column, psi4 (left) on the first, and positive inside."""
    I1, _, u, v, I1x, I1y, warped, state = _inputs(dtype)
    const = bt.brox_terms_plain(u, v, I1, I1x, I1y, warped, state,
                                _const_like(u), DEFAULT_ALPHA, DEFAULT_GAMMA,
                                True)
    psi1, psi2, psi3, psi4 = const[:, 5:].unbind(1)
    assert not psi1[:, -1].any() and not psi2[:, 0].any()
    assert not psi3[:, :, -1].any() and not psi4[:, :, 0].any()
    for inside in (psi1[:, :-1], psi2[:, 1:], psi3[:, :, :-1], psi4[:, :, 1:]):
        assert bool((inside > 0).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_brox_scale_inner2_equals_the_old_composition(dtype):
    """Two inner iterations: the second reads the increment K7 left in
    the state, where the old composition stacked it anew."""
    I1, I2, u, v, *_ = _inputs(dtype)
    got = brox_scale(I1, I2, u, v, inner_iter=2, outer_iter=3,
                     with_diag=True)
    want = _pr18_brox_scale(I1, I2, u, v, DEFAULT_ALPHA, DEFAULT_GAMMA, 1e-4,
                            2, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2]["iterations"], want[2])


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `brox_terms` is `brox_terms_plain`, launches nothing,
    and with `first` set takes the increment as zero whatever the state
    holds."""
    I1, _, u, v, I1x, I1y, warped, state = _inputs(torch.float32)
    before = counters().get("calls.brox_terms", 0)
    got = bt.brox_terms(u, v, I1, I1x, I1y, warped, state, _const_like(u),
                        DEFAULT_ALPHA, DEFAULT_GAMMA, True)
    zero = bt.brox_terms_plain(u, v, I1, I1x, I1y, warped,
                               torch.zeros_like(state), _const_like(u),
                               DEFAULT_ALPHA, DEFAULT_GAMMA, False)
    assert torch.equal(got, zero)
    assert counters().get("calls.brox_terms", 0) == before


def _replay(u, v, I1, I1x, I1y, warped, state, alpha, gamma, first):
    """csrc/brox_terms.cu's schedule in PyTorch: per tile of TILE pixels,
    u and v over the tile and a halo of HALO read at clamped indices into
    a local window; psi_s over the tile and a halo of 1, each entry that
    of the clamped pixel, from the window alone; psi1..psi4, the
    divergences and the data terms of the tile's pixels, from the windows
    and the pixel's own planes, in the kernel's grouping.  Entries no
    tile writes stay NaN."""
    (TY, TX), H = bt.TILE, bt.HALO
    Bn, ny, nx = u.shape
    eps2 = bt.EPSILON * bt.EPSILON
    out = _const_like(u)
    clamp_y = lambda t: t.clamp(0, ny - 1)  # noqa: E731
    clamp_x = lambda t: t.clamp(0, nx - 1)  # noqa: E731

    def at(s, r, c):
        return s[:, r][:, :, c]

    for y0 in range(0, ny, TY):
        for x0 in range(0, nx, TX):
            rows = clamp_y(torch.arange(y0 - H, y0 + TY + H))
            cols = clamp_x(torch.arange(x0 - H, x0 + TX + H))
            su, sv = at(u, rows, cols), at(v, rows, cols)
            qy = clamp_y(torch.arange(y0 - 1, y0 + TY + 1))
            qx = clamp_x(torch.arange(x0 - 1, x0 + TX + 1))
            ly, lx = qy - y0 + H, qx - x0 + H
            lu, ld = clamp_y(qy - 1) - y0 + H, clamp_y(qy + 1) - y0 + H
            ll, lr = clamp_x(qx - 1) - x0 + H, clamp_x(qx + 1) - x0 + H
            ux = 0.5 * (at(su, ly, lr) - at(su, ly, ll))
            uy = 0.5 * (at(su, ld, lx) - at(su, lu, lx))
            vx = 0.5 * (at(sv, ly, lr) - at(sv, ly, ll))
            vy = 0.5 * (at(sv, ld, lx) - at(sv, lu, lx))
            sp = 1.0 / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + eps2)

            i = torch.arange(y0, min(y0 + TY, ny))
            j = torch.arange(x0, min(x0 + TX, nx))
            pr, pc = i - y0 + 1, j - x0 + 1
            ps = at(sp, pr, pc)
            zero = torch.zeros((), dtype=u.dtype)
            psi1 = torch.where((i < ny - 1)[:, None], 0.5 * (at(sp, pr + 1, pc) + ps), zero)
            psi2 = torch.where((i > 0)[:, None], 0.5 * (at(sp, pr - 1, pc) + ps), zero)
            psi3 = torch.where(j < nx - 1, 0.5 * (at(sp, pr, pc + 1) + ps), zero)
            psi4 = torch.where(j > 0, 0.5 * (at(sp, pr, pc - 1) + ps), zero)
            cy, cx = i - y0 + H, j - x0 + H
            dn, up = clamp_y(i + 1) - y0 + H, clamp_y(i - 1) - y0 + H
            rt, lt = clamp_x(j + 1) - x0 + H, clamp_x(j - 1) - x0 + H
            divs = []
            for s in (su, sv):
                c = at(s, cy, cx)
                divs.append(psi1 * (at(s, dn, cx) - c) + psi2 * (at(s, up, cx) - c)
                            + psi3 * (at(s, cy, rt) - c) + psi4 * (at(s, cy, lt) - c))
            div_u, div_v = divs
            div_d = alpha * (psi1 + psi2 + psi3 + psi4)

            px = (slice(None), slice(i[0], i[-1] + 1), slice(j[0], j[-1] + 1))
            I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = (w[px] for w in warped.unbind(1))
            i1, i1x, i1y = I1[px], I1x[px], I1y[px]
            du, dv = ((torch.zeros_like(i1), torch.zeros_like(i1)) if first
                      else (state[:, 0][px], state[:, 1][px]))
            dI = I2w - i1 + I2wx * du + I2wy * dv
            psid = 1.0 / torch.sqrt(dI * dI + eps2)
            dIx = I2wx - i1x + I2wxx * du + I2wxy * dv
            dIy = I2wy - i1y + I2wxy * du + I2wyy * dv
            psig = 1.0 / torch.sqrt(dIx * dIx + dIy * dIy + eps2)
            g = gamma * psig
            npd = -psid * (I2w - i1)
            dx, dy = I2wx - i1x, I2wy - i1y
            planes = (npd * I2wx - g * (dx * I2wxx + dy * I2wxy) + alpha * div_u,
                      npd * I2wy - g * (dx * I2wxy + dy * I2wyy) + alpha * div_v,
                      psid * I2wx * I2wx + g * (I2wxx * I2wxx + I2wxy * I2wxy) + div_d,
                      psid * I2wy * I2wy + g * (I2wyy * I2wyy + I2wxy * I2wxy) + div_d,
                      psid * I2wy * I2wx + g * (I2wxx + I2wyy) * I2wxy,
                      psi1, psi2, psi3, psi4)
            for k, p in enumerate(planes):
                out[:, k][px] = p
    return out


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("shape", [(NY, NX), (37, 45), (1, 5)],
                         ids=["64x128", "37x45", "1x5"])
def test_kernel_schedule_replayed_tile_by_tile(shape, first):
    """At 64x128 (tiles divide it), 37x45 (they do not) and 1x5 (one row:
    psi1 and psi2 both zero), in float64."""
    I1, _, u, v, I1x, I1y, warped, state = _inputs(torch.float64, *shape)
    want = bt.brox_terms_plain(u, v, I1, I1x, I1y, warped, state,
                               _const_like(u), DEFAULT_ALPHA, DEFAULT_GAMMA,
                               first)
    got = _replay(u, v, I1, I1x, I1y, warped, state, DEFAULT_ALPHA,
                  DEFAULT_GAMMA, first)
    assert torch.equal(got, want)


def test_the_stated_geometry_is_the_kernels():
    """TILE, HALO and THREADS as csrc/brox_terms.cu defines them (the
    library checks them again when it loads on the card)."""
    src = CSRC.read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (TX|TY|ROWS|HALO) = (\d+);", src)}
    assert (const["TY"], const["TX"]) == bt.TILE
    assert const["HALO"] == bt.HALO
    assert const["TX"] * const["ROWS"] == bt.THREADS


@pytest.mark.parametrize("fault,match", [
    ("float64", "float32"), ("strided", "contiguous"), ("shape", "not"),
    ("cpu_u", "one CUDA device"), ("none", "one CUDA device")])
def test_the_wrapper_refuses_what_k9_does_not_take(fault, match):
    """Tensors off the CPU that K9 does not take raise a ValueError
    before any launch, for the fault they have: meta tensors stand in
    for the card's, so a call without a fault still raises, for the
    device."""
    dev = torch.device("meta")
    B_, ny, nx = 2, 8, 16
    dtype = torch.float64 if fault == "float64" else torch.float32
    mk = lambda *s: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    u, v, I1, I1x, I1y = (mk(B_, ny, nx) for _ in range(5))
    warped, state, const = mk(B_, 6, ny, nx), mk(B_, 2, ny, nx), mk(B_, 9, ny, nx)
    if fault == "strided":
        warped = mk(B_, ny, 6, nx).transpose(1, 2)
    if fault == "shape":
        const = mk(B_, 8, ny, nx)
    if fault == "cpu_u":
        u = torch.empty((B_, ny, nx))
    with pytest.raises(ValueError, match=match):
        bt.brox_terms(u, v, I1, I1x, I1y, warped, state, const, 1.0, 1.0, True)
