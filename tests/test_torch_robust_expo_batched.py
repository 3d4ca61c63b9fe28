"""`robust_expo_batched` and K10's plain version on the CPU.

Each sample of the batch is `robust_expo` of its pair, bit for bit: a
percentile, a gradient maximum or a presmooth taken over the batch, or
alpha scaled by the batch size, would move every field.  The batch
agrees with the benchmark's plain reference
(flowbench/reference/robust_expo_batched.py); each sample's SOR solves
stop on their own; a call keeps the spans the benchmark's readers take.
`expo_terms_plain` (K10's plain version) is held bit for bit to the
assembly `robust_expo`'s outer iterations made before it was moved
into tpuflow_torch.ops.brox_terms, and K10's block schedule is replayed
tile by tile; K10 itself runs only on the card (chip_smoke.py's
`check_expo_terms`).

At 64x96 (three pyramid levels), B = 2: two textures, one moving
forward and one backward.  The float32 batch runs at the reference
CLI's defaults with the cell's bounded warp, methods 1 and 3; the
float64 one with 5 outer iterations, which holds every level's code and
keeps the file cheap."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flowbench.reference import robust_expo_batched as reference
from tpuflow_torch import robust_expo, robust_expo_batched
from tpuflow_torch.data import synth_pair
from tpuflow_torch.models.robust_expo import (DEFAULT_ALPHA, DEFAULT_GAMMA,
                                              DEFAULT_LAMBDA,
                                              exponential_diffusivity)
from tpuflow_torch.ops import brox_terms as bt
from tpuflow_torch.ops.brox_terms import (expo_terms, expo_terms_plain,
                                          psi_divergence,
                                          psi_weighted_divergence)
from tpuflow_torch.ops.gradients import centered_gradient, dxx, dxy, dyy
from tpuflow_torch.ops.interp import warp_by_mode
from tpuflow_torch.utils.trace import counters, recording, spans

NY, NX = 64, 96
LEVELS = 3
CONFIG = Path(__file__).resolve().parent.parent / "flowbench" / "configs" / \
    "robust-expo-batched-sintel.json"


def _pairs(dtype=np.float32):
    """Two pairs of different textures: seed 0 moving forward, seed 5
    backward (its frames swapped)."""
    a0, b0 = synth_pair(NY, NX, seed=0)
    b1, a1 = synth_pair(NY, NX, seed=5)
    return np.stack([a0, a1]).astype(dtype), np.stack([b0, b1]).astype(dtype)


def _sweeps(diags):
    """{scale: per-solve lists of one sample's sweeps} of a pair call."""
    return {s: d["iterations"].reshape(-1).tolist()
            for s, d in enumerate(diags)}


def _of_sample(stats, b):
    return {s: [per[b] for per in solves]
            for s, solves in stats["iterations"].items()}


@pytest.fixture(scope="module")
def batch32():
    """The float32 batch at the CLI defaults and the cell's warp, methods
    1 and 3, method 3 called under `recording()`; and each pair alone."""
    a, b = _pairs()
    out = {}
    for method in (1, 3):
        with recording():
            before = {s.id for s in spans()}
            got = robust_expo_batched(a, b, method_type=method,
                                      warp_mode="fast", with_stats=True,
                                      device="cpu")
            kept = [s for s in spans() if s.id not in before]
        pairs = [robust_expo(a[k], b[k], method_type=method, warp_mode="fast",
                             with_diag=True, device="cpu") for k in range(2)]
        out[method] = got, pairs, kept
    return a, b, out


@pytest.mark.parametrize("dtype,method", [
    (torch.float32, 1), (torch.float32, 3), (torch.float64, 3)],
    ids=["float32-df", "float32-df_auto", "float64-df_auto"])
def test_each_sample_is_its_pair_bit_for_bit(dtype, method, batch32):
    if dtype == torch.float32:
        (u, v, stats), pairs, _ = batch32[2][method]
    else:
        a, b = _pairs(np.float64)
        kw = {"method_type": method, "outer_iter": 5}
        u, v, stats = robust_expo_batched(a, b, with_stats=True,
                                          device="cpu", **kw)
        pairs = [robust_expo(a[k], b[k], with_diag=True, device="cpu", **kw)
                 for k in range(2)]
    assert u.dtype == dtype and tuple(u.shape) == (2, NY, NX)
    for k, (pu, pv, diags) in enumerate(pairs):
        assert torch.equal(u[k], pu) and torch.equal(v[k], pv), k
        assert _of_sample(stats, k) == _sweeps(diags), k


def test_the_batch_agrees_with_the_plain_reference(batch32):
    """On the CPU the port's plain versions and the reference compute the
    same float32 arithmetic in the same order (the reference's SOR sums
    each sweep's error as the plain K7 does), so each field lies within
    1e-6 px of it, far inside the cell's limits
    (flowbench/configs/robust-expo-batched-sintel.json); a fault of the
    batching (a sample's flow, stop, diffusivity or pyramid mixed with
    another's) lies far outside both."""
    a, b, out = batch32
    (u, v, _), _, _ = out[3]
    config = json.loads(CONFIG.read_text())
    params = dict(config["params"], warp_mode="fast")
    ru, rv = reference.flow(torch.as_tensor(a), torch.as_tensor(b), params)
    assert float((u - ru).abs().max()) <= 1e-6
    assert float((v - rv).abs().max()) <= 1e-6
    epe = torch.hypot(u - ru, v - rv).mean(dim=(-2, -1))
    assert float(epe.max()) <= config["limits"]["field_epe"], epe.tolist()


def test_each_sample_stops_on_its_own(batch32):
    """The two samples' solves stop at sweeps of their own (each its
    pair's, above), at every level, and run past the first sweep."""
    (_, _, stats), _, _ = batch32[2][3]
    first, second = (_of_sample(stats, k) for k in range(2))
    assert set(first) == set(second) == set(range(LEVELS))
    assert any(first[s] != second[s] for s in first)
    for counts in (first, second):
        assert all(max(solves) > 1 for solves in counts.values())
        assert all(1 <= n <= 300 for solves in counts.values() for n in solves)


def test_a_call_keeps_the_spans_of_its_layers(batch32):
    """One root span, the pyramid's spans, one `expo` a level (the
    diffusivity), and per outer iteration of each level one `warp`, two
    `terms` (the increment's zero fill, then K10) and one `solve` (a K7
    call), all inside the root."""
    *_, kept = batch32[2][3]
    roots = [s for s in kept if s.parent is None]
    assert [r.name for r in roots] == ["robust_expo_batched"]
    names = [s.name for s in kept if s.call == roots[0].id]
    for name, want in (("expo", LEVELS), ("warp", 15 * LEVELS),
                       ("terms", 30 * LEVELS), ("solve", 15 * LEVELS),
                       ("prepare", 1), ("upsample", LEVELS - 1)):
        assert names.count(name) == want, name
    assert {n for n in names if n.startswith("level_")} == {
        f"level_{s}" for s in range(LEVELS)}


def test_colour_stacks_are_refused():
    a, b = _pairs()
    rgb = np.repeat(a[:, None], 3, axis=1)
    with pytest.raises(ValueError, match="gray"):
        robust_expo_batched(rgb, rgb, device="cpu")


@pytest.mark.parametrize("method", [1, 2, 3])
def test_each_sample_has_its_own_diffusivity(method):
    """`channel_dim=None` gives each (H, W) sample of a stack the
    diffusivity of that sample alone (DF-AUTO's percentile over its own
    pixels); the stack's samples differ enough that one percentile over
    the whole stack would not."""
    a, _ = _pairs(np.float64)
    I1 = torch.as_tensor(a) * torch.tensor([1.0, 3.0])[:, None, None]
    gx, gy = centered_gradient(I1)
    got = exponential_diffusivity(gx, gy, method, DEFAULT_ALPHA,
                                  DEFAULT_LAMBDA, channel_dim=None)
    for k in range(2):
        one = exponential_diffusivity(gx[k:k + 1], gy[k:k + 1], method,
                                      DEFAULT_ALPHA, DEFAULT_LAMBDA)
        assert torch.equal(got[k], one)
    if method == 3:
        whole = exponential_diffusivity(gx.reshape(1, 2 * NY, NX),
                                        gy.reshape(1, 2 * NY, NX), method,
                                        DEFAULT_ALPHA, DEFAULT_LAMBDA)
        assert not torch.equal(whole.reshape(2, NY, NX), got)


# ---- K10's plain version -------------------------------------------------

def _inputs(dtype, ny=NY, nx=NX, B=2):
    """(u, v, expo, I1, I1x, I1y, warped, state) of one outer iteration:
    two pairs, smooth flows of a few pixels with a ramp, each sample's
    DF-AUTO diffusivity, the six planes of I2 warped by the exact gather,
    and a nonzero increment."""
    I1, I2 = (torch.as_tensor(np.stack(x), dtype=dtype) for x in
              zip(*(synth_pair(ny, nx, seed=s) for s in range(B))))
    yy, xx = torch.meshgrid(torch.linspace(0, 1, ny, dtype=dtype),
                            torch.linspace(0, 1, nx, dtype=dtype),
                            indexing="ij")
    k = torch.arange(1, B + 1, dtype=dtype)[:, None, None]
    u = 2 * torch.sin(5 * xx + k) + 1.5 * yy * k
    v = 1.5 * torch.cos(4 * yy + k) - xx / k
    I1x, I1y = centered_gradient(I1)
    expo = exponential_diffusivity(I1x * k, I1y * k, 3, DEFAULT_ALPHA,
                                   DEFAULT_LAMBDA, channel_dim=None)
    I2x, I2y = centered_gradient(I2)
    planes = torch.stack([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)], dim=1)
    warped = warp_by_mode(planes, u, v, "exact", 8).contiguous()
    state = (0.1 * torch.stack([v, -u], dim=1)).contiguous()
    return u, v, expo, I1, I1x, I1y, warped, state


def _const_like(u):
    B, ny, nx = u.shape
    return torch.full((B, 9, ny, nx), float("nan"), dtype=u.dtype)


def _parent_assembly(I1, I1x, I1y, expo, u, v, warped, du, dv, alpha, gamma):
    """The (Au, Av, Du, Dv, D, psi1..psi4) of one pair, as
    `outer_iterations` assembled them before K10: (C, H, W) image planes,
    (H, W) flow, sums over the channels."""
    eps2 = 0.001 * 0.001
    I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = warped.unbind(0)
    ux, uy = centered_gradient(u)
    vx, vy = centered_gradient(v)
    norm_flow = expo * (ux * ux + uy * uy + vx * vx + vy * vy)
    psis = psi_divergence(expo / torch.sqrt(norm_flow + eps2))
    div_u = psi_weighted_divergence(u, *psis)
    div_v = psi_weighted_divergence(v, *psis)
    div_d = alpha * (psis[0] + psis[1] + psis[2] + psis[3])
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
    return torch.stack([Au, Av, Du, Dv, D, *psis])


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_plain_equals_the_parent_assembly(dtype, first):
    u, v, expo, I1, I1x, I1y, warped, state = _inputs(dtype)
    const = expo_terms_plain(u, v, expo, I1, I1x, I1y, warped, state,
                             _const_like(u), DEFAULT_ALPHA, DEFAULT_GAMMA,
                             first)
    for k in range(2):
        du, dv = ((torch.zeros_like(u[k]), torch.zeros_like(v[k])) if first
                  else (state[k, 0], state[k, 1]))
        want = _parent_assembly(I1[k][None], I1x[k][None], I1y[k][None],
                                expo[k], u[k], v[k], warped[k][:, None], du,
                                dv, DEFAULT_ALPHA, DEFAULT_GAMMA)
        assert torch.equal(const[k], want), k


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `expo_terms` is `expo_terms_plain`, launches
    nothing, and with `first` set takes the increment as zero whatever
    the state holds."""
    u, v, expo, I1, I1x, I1y, warped, state = _inputs(torch.float32)
    before = counters().get("calls.expo_terms", 0)
    got = expo_terms(u, v, expo, I1, I1x, I1y, warped, state, _const_like(u),
                     DEFAULT_ALPHA, DEFAULT_GAMMA, True)
    zero = expo_terms_plain(u, v, expo, I1, I1x, I1y, warped,
                            torch.zeros_like(state), _const_like(u),
                            DEFAULT_ALPHA, DEFAULT_GAMMA, False)
    assert torch.equal(got, zero)
    assert counters().get("calls.expo_terms", 0) == before


@pytest.mark.parametrize("fault,match", [
    ("float64", "float32"), ("strided", "contiguous"), ("shape", "not"),
    ("cpu_expo", "one CUDA device"), ("none", "one CUDA device")])
def test_the_wrapper_refuses_what_k10_does_not_take(fault, match):
    """Tensors off the CPU that K10 does not take raise a ValueError
    before any launch, for the fault they have: meta tensors stand in
    for the card's, so a call without a fault still raises, for the
    device."""
    dev = torch.device("meta")
    B_, ny, nx = 2, 8, 16
    dtype = torch.float64 if fault == "float64" else torch.float32
    mk = lambda *s: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    u, v, expo, I1, I1x, I1y = (mk(B_, ny, nx) for _ in range(6))
    warped, state, const = mk(B_, 6, ny, nx), mk(B_, 2, ny, nx), mk(B_, 9, ny, nx)
    if fault == "strided":
        expo = mk(B_, nx, ny).transpose(1, 2)
    if fault == "shape":
        expo = mk(B_, ny, nx + 1)
    if fault == "cpu_expo":
        expo = torch.empty((B_, ny, nx))
    before = counters()
    with pytest.raises(ValueError, match=match):
        expo_terms(u, v, expo, I1, I1x, I1y, warped, state, const, 1.0, 1.0,
                   True)
    assert counters() == before


def _replay(u, v, expo, I1, I1x, I1y, warped, state, alpha, gamma, first):
    """csrc/brox_terms.cu's schedule with EXPO set, in PyTorch: per tile
    of TILE pixels, u and v over the tile and a halo of HALO read at
    clamped indices into a local window; psi_s over the tile and a halo
    of 1, each entry that of the clamped pixel with expo read there; the
    divergences and robust-expo's data terms of the tile's pixels, in
    the kernel's grouping.  Entries no tile writes stay NaN."""
    (TY, TX), H = bt.TILE, bt.HALO
    _, ny, nx = u.shape
    eps2 = bt.EPSILON * bt.EPSILON
    out = _const_like(u)
    cy_ = lambda t: t.clamp(0, ny - 1)  # noqa: E731
    cx_ = lambda t: t.clamp(0, nx - 1)  # noqa: E731

    def at(s, r, c):
        return s[:, r][:, :, c]

    for y0 in range(0, ny, TY):
        for x0 in range(0, nx, TX):
            su = at(u, cy_(torch.arange(y0 - H, y0 + TY + H)),
                    cx_(torch.arange(x0 - H, x0 + TX + H)))
            sv = at(v, cy_(torch.arange(y0 - H, y0 + TY + H)),
                    cx_(torch.arange(x0 - H, x0 + TX + H)))
            qy = cy_(torch.arange(y0 - 1, y0 + TY + 1))
            qx = cx_(torch.arange(x0 - 1, x0 + TX + 1))
            ly, lx = qy - y0 + H, qx - x0 + H
            lu, ld = cy_(qy - 1) - y0 + H, cy_(qy + 1) - y0 + H
            ll, lr = cx_(qx - 1) - x0 + H, cx_(qx + 1) - x0 + H
            ux = 0.5 * (at(su, ly, lr) - at(su, ly, ll))
            uy = 0.5 * (at(su, ld, lx) - at(su, lu, lx))
            vx = 0.5 * (at(sv, ly, lr) - at(sv, ly, ll))
            vy = 0.5 * (at(sv, ld, lx) - at(sv, lu, lx))
            e = at(expo, qy, qx)
            sp = e / torch.sqrt(e * (ux * ux + uy * uy + vx * vx + vy * vy)
                                + eps2)

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
            dn, up = cy_(i + 1) - y0 + H, cy_(i - 1) - y0 + H
            rt, lt = cx_(j + 1) - x0 + H, cx_(j - 1) - x0 + H
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
            dI = I2w + I2wx * du + I2wy * dv - i1
            psid = 1.0 / torch.sqrt(dI * dI + eps2)
            dIx = I2wx + I2wxx * du + I2wxy * dv - i1x
            dIy = I2wy + I2wxy * du + I2wyy * dv - i1y
            psig = 1.0 / torch.sqrt(dIx * dIx + dIy * dIy + eps2)
            g = gamma * psig
            dif, dx, dy = I2w - i1, I2wx - i1x, I2wy - i1y
            planes = (-psid * (dif * I2wx) - g * (dx * I2wxx + dy * I2wxy) + alpha * div_u,
                      -psid * (dif * I2wy) - g * (dx * I2wxy + dy * I2wyy) + alpha * div_v,
                      psid * (I2wx * I2wx) + g * (I2wxx * I2wxx + I2wxy * I2wxy) + div_d,
                      psid * (I2wy * I2wy) + g * (I2wyy * I2wyy + I2wxy * I2wxy) + div_d,
                      psid * (I2wy * I2wx) + g * ((I2wxx + I2wyy) * I2wxy),
                      psi1, psi2, psi3, psi4)
            for k, p in enumerate(planes):
                out[:, k][px] = p
    return out


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("shape", [(NY, NX), (37, 45), (1, 5)],
                         ids=["64x96", "37x45", "1x5"])
def test_k10_schedule_replayed_tile_by_tile(shape, first):
    """At 64x96 (tiles divide it), 37x45 (they do not) and 1x5 (one row:
    psi1 and psi2 both zero), in float64."""
    args = _inputs(torch.float64, *shape)
    want = expo_terms_plain(*args, _const_like(args[0]), DEFAULT_ALPHA,
                            DEFAULT_GAMMA, first)
    got = _replay(*args, DEFAULT_ALPHA, DEFAULT_GAMMA, first)
    assert torch.equal(got, want)
