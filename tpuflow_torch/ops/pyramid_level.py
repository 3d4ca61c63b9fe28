"""K8: one level of the Gaussian pyramid in one launch.

`pyramid_level` makes, for up to MAX_INPUTS same-shape images, one
level of the pyramid in one launch of csrc/pyramid.cu: the joint [0, 255]
normalisation at the load (the first level), the separable reflecting
Gaussian of `tpuflow_torch.ops.gaussian`, and the bicubic resampling of
`tpuflow_torch.ops.pyramid.zoom_out` from tap tables (anchor and 4
weights per output row and column).  The result is one buffer
(images, *lead, nyy, nxx); its views `out[k]` are the images' levels.

Its callers route on what they can observe: `gaussian(..., "reflecting")`,
`zoom_out` and `models.common.build_pyramid` run their plain versions
for a CPU tensor and hand any other to `pyramid_level`
(`tpuflow_torch._device.on_card`), which launches K8 for CUDA float32
tensors and raises for every other dtype or device (`check_inputs`);
there is no switch and no fallback, and a launch the card refuses
raises.  Each launch counts in `launches.k8`
(tpuflow_torch.utils.trace).  The kernel rounds every operation as the
plain versions do, so its levels equal theirs bit for bit where each
output has one non-zero resampling weight (zfactor 0.5).
"""

import ctypes

import numpy as np
import torch

from tpuflow_torch import _build
from tpuflow_torch._device import check_inputs
from tpuflow_torch.utils.trace import count

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pyramid_level": [_P, _I, _L, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _L, _P, _P],
    "pyramid_level_geometry": [_I],
}
# as csrc/pyramid.cu states them (checked when the library loads): the
# most one-sided taps, input tensors and threads a block
MAX_TAPS = 64
MAX_INPUTS = 4
THREADS = 256
# outputs a block makes, (rows, columns): without and with resampling
TILE = {False: (64, 64), True: (32, 32)}
SMEM_LIMIT = 232448   # the shared memory a block may opt into on sm_90


def reflect_index(i, n):
    """The input index K8 reads for index i of an axis of n samples:
    the reference's asymmetric reflecting pad, x[-m] = x[m] and
    x[n-1+m] = x[n-m] (`tpuflow_torch.ops.gaussian._pad`)."""
    return -i if i < 0 else (2 * n - 1 - i if i >= n else i)


def footprint(anchors, n_in, tile):
    """The most input samples a tile of `tile` outputs reads along an
    axis whose outputs have these Keys anchors (taps anchor-1..anchor+2,
    clamped to [0, n_in-1])."""
    a = np.asarray(anchors)
    first = np.clip(a[::tile] - 1, 0, n_in - 1)
    last = np.clip(a[np.minimum(np.arange(tile, len(a) + tile, tile),
                                len(a)) - 1] + 2, 0, n_in - 1)
    return int((last - first).max()) + 1


def smem_bytes(ntaps, resample, tile, span):
    """Dynamic shared memory of a block, passed to csrc/pyramid.cu with the
    launch: the haloed input tile, then the row-blurred tile, each row
    an odd number of floats (the kernel's layout)."""
    h = ntaps - 1 if ntaps > 1 else 0
    if not resample and ntaps <= 1:
        return 0
    rows = span[0] + 2 * h
    rb = rows * ((max(span[1], tile[1]) if resample else span[1]) | 1)
    return 4 * (rows * ((span[1] + 2 * h) | 1) + rb)


def _geometry(ntaps, resample):
    """(tile, span, smem): the tile a block makes, halved until its shared
    memory fits, the most input rows and columns a tile reads, and the
    block's shared memory in bytes."""
    tile = TILE[resample is not None]
    while True:
        if resample is not None:
            (ay, _, _, ny), (ax, _, _, nx) = resample
            span = (footprint(ay, ny, tile[0]), footprint(ax, nx, tile[1]))
        else:
            span = tile
        smem = smem_bytes(ntaps, resample is not None, tile, span)
        if smem <= SMEM_LIMIT:
            return tile, span, smem
        if tile == (1, 1):
            raise ValueError(f"pyramid_level: {ntaps} taps need more shared "
                             f"memory than a block has")
        tile = ((tile[0] + 1) // 2, tile[1]) if tile[0] >= tile[1] else (
            tile[0], (tile[1] + 1) // 2)


def pyramid_level(images, taps=(), norm=None, resample=None):
    """One pyramid level of `images` (a tuple of at most MAX_INPUTS
    same-shape CUDA float32 tensors (*lead, ny, nx)) in one launch;
    returns (len(images), *lead, nyy, nxx).  Raises a ValueError for any
    other dtype, device or number of images.

    taps      the one-sided Gaussian weights (rounded to float32): none
              for no smoothing, one for a plain multiply (`gaussian`'s
              size-1 kernel), else the separable reflecting Gaussian
    norm      None, or (mn, mx, inner): per-sample minima and maxima
              (float32, contiguous); plane q of an image normalises with
              entry q // inner
    resample  None, or (y, x) tables, each (anchors (host int array),
              anchors on the card (int32), weights on the card (float32,
              (n_out, 4)), n_in): the Keys cell per output row and column
    """
    if len(images) > MAX_INPUTS:
        raise ValueError(f"pyramid_level: {len(images)} images exceed "
                         f"{MAX_INPUTS}")
    if len(taps) > MAX_TAPS:
        raise ValueError(f"pyramid_level: {len(taps)} taps exceed {MAX_TAPS}")
    images = tuple(im.contiguous() for im in images)
    ref = images[0]
    check_inputs("pyramid_level", cpu=False, **{
        f"images[{k}]": (im, tuple(ref.shape)) for k, im in enumerate(images)})
    *lead, ny, nx = ref.shape
    h = len(taps) - 1 if len(taps) > 1 else 0
    for n in (ny, nx):
        if h and h + 1 >= n:
            raise ValueError(f"gaussian: pad {h + 1} exceeds dim {n} "
                             f"(sigma too large)")
    nyy, nxx = (ny, nx) if resample is None else (
        len(resample[0][0]), len(resample[1][0]))
    ppi = 1
    for d in lead:
        ppi *= d
    out = torch.empty((len(images), *lead, nyy, nxx), dtype=ref.dtype,
                      device=ref.device)
    if out.numel() == 0:
        return out
    tile, span, smem = _geometry(len(taps), resample)
    wts = ctypes.cast((ctypes.c_float * max(1, len(taps)))(*taps),
                      ctypes.c_void_p)
    mn, mx, inner = (None, None, 1) if norm is None else norm
    ay = wy = ax = wx = None
    if resample is not None:
        (_, ay, wy, _), (_, ax, wx, _) = resample
    lib = _build.load("pyramid", _SIGNATURES,
                      ("pyramid_level_geometry",
                       (MAX_TAPS, MAX_INPUTS, THREADS)))
    ptrs = ctypes.cast((ctypes.c_longlong * len(images))(
        *(im.data_ptr() for im in images)), ctypes.c_void_p)
    _build.launch(lib, "pyramid_level", ptrs, len(images), ppi, ny, nx, mn, mx,
                  inner, wts, len(taps), ay, wy, ax, wx, nyy, nxx, tile[0],
                  tile[1], span[0], span[1], smem, out, device=ref.device)
    count("launches.k8")
    return out
