"""K8's twin on the CPU: the tap tables, the gather, the reflect map and
the block schedule of csrc/pyramid.cu, against the plain pyramid.

K8 itself runs only on the card (chip_smoke.py's `check_pyramid`); here
its Python pieces (`tpuflow_torch.ops.pyramid_level` and
`ops.pyramid.resample_taps`) and a replay of its blocks in PyTorch are
held to `build_pyramid_plain`, `zoom_out_plain` and `gaussian._pad`.
Sizes are small; all cases together take about a second.
"""

import importlib

import numpy as np
import pytest
import torch

from tpuflow_torch._device import on_card
from tpuflow_torch.models.common import build_pyramid, build_pyramid_plain
from tpuflow_torch.ops import pyramid as pyr
from tpuflow_torch.ops import pyramid_level as pl
from tpuflow_torch.ops.gaussian import gaussian_taps
from tpuflow_torch.ops.normalize import joint_range
from tpuflow_torch.utils.trace import counters

# the module: tpuflow_torch.ops exports the function `gaussian` by that name
tgauss = importlib.import_module("tpuflow_torch.ops.gaussian")

# each (n_in, n_out) of 436 at zfactor 0.5, and 37x53's axes at 0.5, 0.75
AXES = [(436, 218, 2.0), (218, 109, 2.0), (109, 55, 2.0), (55, 28, 2.0),
        (37, 19, 2.0), (53, 27, 2.0), (37, 28, 1 / 0.75), (53, 40, 1 / 0.75)]


def _pair(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * 90 + 3,
            torch.rand(shape, generator=g) * 40)


def _gather(I, ty, tx):
    """K8's resampling of I (..., ny, nx) from the tables of each axis,
    along x, then along y, its terms in K8's order (K8 fuses each product
    after the first into the sum, as a GEMM does; here each is rounded)."""
    def axis(a, table, dim):
        anchors, _, w, n = table
        idx = [torch.as_tensor(np.clip(anchors - 1 + m, 0, n - 1))
               for m in range(4)]
        w = w.to(a.dtype).cpu()
        shape = [1] * a.ndim
        shape[dim] = -1
        terms = [w[:, m].reshape(shape) * a.index_select(dim, idx[m])
                 for m in range(4)]
        return ((terms[0] + terms[1]) + terms[2]) + terms[3]

    return axis(axis(I, tx, -1), ty, -2)


def _tables(n_out_y, ny, n_out_x, nx, inv, dtype):
    return (pyr._taps(n_out_y, ny, inv, dtype, torch.device("cpu")),
            pyr._taps(n_out_x, nx, inv, dtype, torch.device("cpu")))


def _replay_level(images, taps, norm=None, resample=None):
    """csrc/pyramid.cu block by block: each block's haloed footprint
    gathered through the reflect map, blurred and resampled alone, its
    outputs written to their place; NaN where no block writes."""
    *lead, ny, nx = images[0].shape
    planes = torch.stack(images).reshape(-1, ny, nx)
    ppi = planes.shape[0] // len(images)
    if norm is not None:
        mn, mx, inner = norm
        s = (torch.arange(planes.shape[0]) % ppi) // inner
        lo, den = mn[s][:, None, None], (mx - mn)[s][:, None, None]
        planes = torch.where(den > 0, 255.0 * (planes - lo)
                             / torch.where(den > 0, den, 1.0), planes)
    if len(taps) == 1:
        planes = taps[0] * planes
    h = len(taps) - 1 if len(taps) > 1 else 0
    nyy, nxx = (ny, nx) if resample is None else (len(resample[0][0]),
                                                  len(resample[1][0]))
    tile, span, _ = pl._geometry(len(taps), resample)
    out = torch.full((planes.shape[0], nyy, nxx), float("nan"))
    for i0 in range(0, nyy, tile[0]):
        for j0 in range(0, nxx, tile[1]):
            ni, nj = min(tile[0], nyy - i0), min(tile[1], nxx - j0)
            if resample is None:
                rlo, rhi, clo, chi = i0, i0 + ni - 1, j0, j0 + nj - 1
            else:
                ay, ax = resample[0][0], resample[1][0]
                rlo, rhi = (min(max(v, 0), ny - 1)
                            for v in (ay[i0] - 1, ay[i0 + ni - 1] + 2))
                clo, chi = (min(max(v, 0), nx - 1)
                            for v in (ax[j0] - 1, ax[j0 + nj - 1] + 2))
            wr, wc = rhi - rlo + 1, chi - clo + 1
            assert wr <= span[0] and wc <= span[1]
            rows = [pl.reflect_index(r, ny) for r in range(rlo - h, rhi + h + 1)]
            cols = [pl.reflect_index(c, nx) for c in range(clo - h, chi + h + 1)]
            t = planes[:, rows][:, :, cols]
            if h:
                acc = taps[0] * t[:, :, h:h + wc]
                for j in range(1, h + 1):
                    acc = acc + taps[j] * (t[:, :, h - j:h - j + wc]
                                           + t[:, :, h + j:h + j + wc])
                t = taps[0] * acc[:, h:h + wr]
                for j in range(1, h + 1):
                    t = t + taps[j] * (acc[:, h - j:h - j + wr]
                                       + acc[:, h + j:h + j + wr])
            if resample is not None:
                # the block's tables, shifted into its footprint; K8
                # clamps a tap to the image, then shifts it: the same
                # sample, since the footprint runs from the first clamped
                # tap to the last
                (ay, _, wy, _), (ax, _, wx, _) = resample
                sub = tuple((a[k0:k0 + n] - lo, None, w[k0:k0 + n], m)
                            for a, w, k0, n, lo, m in (
                                (ay, wy, i0, ni, rlo, wr),
                                (ax, wx, j0, nj, clo, wc)))
                assert all(np.all(np.clip(a - 1 + m, 0, n - 1) - lo
                                  == np.clip(a - 1 + m - lo, 0, k - 1))
                           for a, n, lo, k in ((ay[i0:i0 + ni], ny, rlo, wr),
                                               (ax[j0:j0 + nj], nx, clo, wc))
                           for m in range(4))
                t = _gather(t, *sub)
            out[:, i0:i0 + ni, j0:j0 + nj] = t
    return tuple(out.reshape(len(images), *lead, nyy, nxx))


def _replay_pyramid(images, nscales, zfactor):
    ny, nx = images[0].shape[-2:]
    sizes = pyr.pyramid_sizes(nx, ny, zfactor, nscales)
    levels = [_replay_level(images, gaussian_taps(0.8, images[0].dtype),
                            norm=joint_range(*images))]
    for s in range(1, nscales):
        prev = levels[-1]
        nxx, nyy, sigma, inv = pyr._zoom_out_args(prev[0], zfactor, sizes[s])
        tables = _tables(nyy, prev[0].shape[-2], nxx, prev[0].shape[-1], inv,
                         prev[0].dtype)
        levels.append(_replay_level(prev, gaussian_taps(sigma, prev[0].dtype),
                                    resample=tables))
    return levels


def case_tables():
    """The tap tables, made dense, equal `_resample_matrix`."""
    for n_in, n_out, inv in AXES:
        anchors, weights = pyr.resample_taps(n_out, n_in, inv)
        dense = pyr.taps_matrix(anchors, weights, n_in)
        assert np.array_equal(dense, pyr._resample_matrix(n_out, n_in, inv))
        if inv == 2.0:   # a decimation: weights (0, 1, 0, 0) at 2i
            assert np.array_equal(anchors, 2 * np.arange(n_out))
            assert np.array_equal(weights, np.tile([0.0, 1.0, 0.0, 0.0],
                                                   (n_out, 1)))


def case_gather():
    """A gather with the tables against the dense products."""
    for dtype in (torch.float32, torch.float64):
        for ny, nx, z in ((436, 64, 0.5), (109, 55, 0.5), (37, 53, 0.5),
                          (37, 53, 0.75)):
            I = _pair((2, ny, nx))[0].to(dtype)
            nxx, nyy = pyr.zoom_size(nx, ny, z)
            got = _gather(I, *_tables(nyy, ny, nxx, nx, 1 / z, dtype))
            want = pyr._resample(I, nxx, nyy, 1 / z, 1 / z)
            if z == 0.5:
                assert torch.equal(got, want)
                assert torch.equal(got, I[:, ::2, ::2][:, :nyy, :nxx])
            else:   # the Keys weights can cancel: ulps of the largest value
                ulp = np.spacing(np.asarray(I.abs().max().item(),
                                            dtype=np.float32 if dtype ==
                                            torch.float32 else np.float64))
                assert (got - want).abs().max().item() <= 4 * ulp


def case_reflect():
    """K8's reflect map equals `_pad`'s asymmetric reflecting pad."""
    for size in (5, 6):
        for n in (size + 1, size + 2, 13):
            a = torch.arange(n, dtype=torch.float64) * 10 + 1
            padded = tgauss._pad(a, size, 0, "reflecting")
            mapped = a[[pl.reflect_index(i, n) for i in range(-size, n + size)]]
            assert torch.equal(padded, mapped)


def case_tiles():
    """K8's blocks, replayed, give the plain pyramid: bit for bit at
    zfactor 0.5, within 4 ulp of 255 at 0.75; every output written."""
    old = pl.TILE
    pl.TILE = {False: (8, 16), True: (4, 8)}   # many blocks at a small size
    try:
        for z, nscales in ((0.5, 4), (0.75, 4)):
            images = _pair((2, 37, 53), seed=1)
            want = build_pyramid_plain(images, nscales, z)[0]
            got = _replay_pyramid(images, nscales, z)
            for w, g in zip(want, got):
                for a, b in zip(w, g):
                    assert not torch.isnan(b).any()
                    if z == 0.5:
                        assert torch.equal(a, b)
                    else:
                        assert (a - b).abs().max().item() <= 4 * np.spacing(
                            np.float32(255))
    finally:
        pl.TILE = old


def case_cpu_plain():
    """A CPU tensor takes the plain path: no K8 launch, the plain
    versions' results."""
    images = _pair((2, 24, 40), seed=2)
    before = counters().get("launches.k8", 0)
    levels, _ = build_pyramid(images, 3, 0.5)
    plain, _ = build_pyramid_plain(images, 3, 0.5)
    assert all(torch.equal(a, b) for la, lb in zip(levels, plain)
               for a, b in zip(la, lb))
    assert torch.equal(pyr.zoom_out(images[0], 0.5),
                       pyr.zoom_out_plain(images[0], 0.5))
    assert torch.equal(tgauss.gaussian(images[0], 0.8),
                       tgauss.gaussian_plain(images[0], 0.8))
    assert counters().get("launches.k8", 0) == before
    assert not on_card(images[0])


def case_route():
    """Any tensor not on the CPU goes to K8, which takes CUDA float32 and
    raises for every other dtype or device: no plain path off the CPU.
    "meta" tensors stand in for the card's here."""
    calls = (lambda t: tgauss.gaussian(t, 0.8),
             lambda t: pyr.zoom_out(t, 0.5),
             lambda t: build_pyramid((t, t), 3, 0.5))
    before = counters().get("launches.k8", 0)
    for dtype, message in ((torch.float64, "float32"),
                           (torch.float16, "float32"),
                           (torch.float32, "unsupported device meta")):
        t = torch.empty((2, 24, 40), dtype=dtype, device="meta")
        assert on_card(t)
        for call in calls:
            with pytest.raises(ValueError, match=message):
                call(t)
    images = _pair((24, 40), seed=3) * 3
    with pytest.raises(ValueError, match="images exceed"):
        pl.pyramid_level(tuple(im.to("meta") for im in images), (1.0,))
    assert counters().get("launches.k8", 0) == before


CASES = {f.__name__[5:]: f for f in (case_tables, case_gather, case_reflect,
                                      case_tiles, case_cpu_plain, case_route)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k8_twin(case):
    CASES[case]()
