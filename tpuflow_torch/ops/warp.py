"""Bounded bicubic warp, alone or fused with per-warp constants: kernels
and plain versions.

Counterpart of tpuflow/ops/warp_pallas.py (`warp_const_pallas_batched`,
modes "tvl1" and "hs", and `warp_planes_pallas_batched` in mode
"planes_fast", `fast_only=True`, and mode "planes", `fast_only=False`).
K5, `warp_planes_batched`, warps any number P of planes by the current
flow and assembles nothing (Brox and robust-expo warp I2 and its five
derivative planes); K5p, `warp_planes_shift_batched`, is the same warp
with the shift path's bound (below).  The fused wrappers warp three planes (I, Ix, Iy) by the current flow and assemble
one warp's constants in one pass, with `aux` the other image:

  * "tvl1" (K1, `warp_const_batched`): planes (I1, I1x, I1y), aux = I0,
    (I1wx, I1wy, rho_c = I1w - I1wx*u - I1wy*v - I0, grad = I1wx^2 + I1wy^2)
    (reference src/tvl1flow.cpp:94-109);
  * "hs" (K3, `warp_const_hs_batched`): planes (I2, I2x, I2y), aux = I1,
    dif = I1 - I2w + I2wx*u + I2wy*v and
    (Au = dif*I2wx, Av = dif*I2wy, Du = I2wx^2 + alpha2,
     Dv = I2wy^2 + alpha2, D = I2wx*I2wy)
    (reference src/horn_schunck_pyramidal.cpp:128-137).

The function is the EXACT bounded bicubic warp: the 16-tap Keys cell at
the floor anchor x0 = floor(j + u), y0 = floor(i + v); a pixel is out of
domain when x+u < 1, x0 > nx-3, y+v < 1 or y0 > ny-3, or when
|x0 - j| > dmax or |y0 - i| > dmax (the strict displacement bound); the
warped planes are 0 there, so rho_c = -I0 and grad = 0 ("tvl1"), and
Au = Av = D = 0 and Du = Dv = alpha2 ("hs").  The exact
gather of `tpuflow_torch.ops.interp` anchors at trunc instead; the two
differ only for negative coordinates, which are out of domain anyway.

The TPU kernel approximates this function with at most two
tile-constant residual windows and flags the tiles where some pixel's
displacement fell outside both (those pixels degrade to 0 for that
warp).  On tiles it does not flag the two are identical.  A gather is
cheap on the GPU, so the CUDA kernel (csrc/warp_const.cu) computes every
pixel exactly and never degrades one: the overflow count it returns is
always 0, kept so that `with_stats` reports the same keys as the JAX
engine.

K5p is the function of the TPU's mode "planes" and of
`tpuflow/ops/interp.py:warp_planes_shift`, a different function from
K5: there is no strict bound.  Tap m of the row axis (tap row y0-1+m)
counts only where its offset from the pixel, y0-1+m-i, lies in the
shift window [-dmax-1, dmax+2], and likewise for columns; so a pixel up
to 3 px past dmax keeps its in-window taps, and one further out is 0.
Tap indices are clamped to the image.  With `border_out=True` the
pixels with x+u < 1, x0 > nx-3, y+v < 1 or y0 > ny-3 are 0; with
`border_out=False` (tvl1occflow's warp) they keep the clamped taps'
sum, the reference's Neumann clamping.

Two CUDA sources hold them: csrc/warp_const.cu K1 and K3, one template
on the mode; csrc/warp_planes.cu K5 and K5p, one kernel body templated
on the variant (K5's strict bound, or K5p's shift window with or
without border_out), whose Keys cell is K1's (csrc/keys.cuh) and whose
K5p keeps its own anchor, window masks, index clamps and rounding.
K5 and K5p run one thread per pixel and group of planes, gathering
from device memory (see the note in the source); `warp_planes_group`
picks the planes a thread warps, GROUPS[0] or GROUPS[1], from the
level's size and the device's SMs.  No switch picks it, a refused
launch raises, and nothing falls back to the plain version.  The
kernels take u and v as two pointers with one batch stride, so a call
launches the kernel and nothing else.  The launches are counted
(tpuflow_torch.utils.trace): K1's in `launches.k1`, K3's in
`launches.k3`, K5's and K5p's per group in
`calls.warp_planes[_shift]_batched.g<planes>`, so a run can show them
apart.  On a CUDA tensor a wrapper launches the
kernel (or raises); on a CPU tensor it runs `warp_const_plain`,
`warp_planes_plain`, `warp_planes_shift_plain` or `warp_planes_uv_plain`,
the same arithmetic in PyTorch.  The four K5/K5p wrappers are thin calls
into one entry, `_warp_planes`, which checks their inputs once.
"""

import ctypes
import functools

import torch

from tpuflow_torch import _build
from tpuflow_torch._device import KernelInputError, check_inputs, on_card
from tpuflow_torch.utils.trace import count

_SIGNATURES = {
    "warp_const_tvl1": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p],
    "warp_const_hs": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p],
}
# mode -> (C entry point, constant planes, launch counter)
_MODES = {"tvl1": ("warp_const_tvl1", 4, "k1"),
          "hs": ("warp_const_hs", 5, "k3")}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLANES_SIGNATURES = {
    "warp_planes": [_P, _I, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P],
    "warp_planes_geometry": [_I],
}
# K5 and K5p's geometry, as csrc/warp_planes.cu states it (checked when
# the library loads): how far a tap may lie before and after its pixel
# beyond dmax (K5p's shift window); a block's columns and rows; the
# planes a thread may warp, the larger first
TAP_MARGIN = (1, 2)
BLOCK = (32, 4)
GROUPS = (6, 3)
# a thread warps GROUPS[0] planes only where the blocks of one group's
# pixels number at least this many per SM (chip_smoke.py times both
# groups at each shape of the main paths)
WAVES = 4
# K5, K5p with border_out, K5p without
_VARIANT = {(False, True): 0, (True, True): 1, (True, False): 2}


def _keys(t):
    """Keys cell weights per tap (reference src/bicubic_interpolation.cpp:108-123)."""
    t2 = t * t
    t3 = t2 * t
    return (0.5 * (-t3 + 2 * t2 - t),
            0.5 * (3 * t3 - 5 * t2 + 2),
            0.5 * (-3 * t3 + 4 * t2 + t),
            0.5 * (t3 - t2))


def _bounded_bicubic(planes, u, v, dmax, strict=True, border_out=True):
    """The bounded bicubic warp of every plane of (B, P, ny, nx) `planes`
    by the (B, ny, nx) flow `u`, `v`: (B, P, ny, nx).  `strict`: K5's
    bound, 0 past dmax and out of domain; else K5p's shift window, with
    out-of-domain pixels 0 only if `border_out`."""
    B, P, ny, nx = planes.shape
    dtype, dev = planes.dtype, planes.device
    jj = torch.arange(nx, dtype=dtype, device=dev)
    ii = torch.arange(ny, dtype=dtype, device=dev)[:, None]
    xx = jj + u
    yy = ii + v
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    in_dom = (xx >= 1) & (x0 <= nx - 3) & (yy >= 1) & (y0 <= ny - 3)
    cx = _keys(xx - x0)
    cy = _keys(yy - y0)
    if strict:
        in_dom = in_dom & ((x0 - jj).abs() <= dmax) & ((y0 - ii).abs() <= dmax)
        # in-domain taps never clamp; the clamp only keeps the gathers of
        # out-of-domain pixels (zeroed below) inside the image
        lo_x, hi_x, lo_y, hi_y = -1, nx, -1, ny
    else:
        cx = _window(cx, x0 - jj, dmax)
        cy = _window(cy, y0 - ii, dmax)
        # wide enough that every clamped tap index stays as it was
        lo_x, hi_x, lo_y, hi_y = -4, nx + 3, -4, ny + 3
    xa = torch.nan_to_num(x0).clamp(lo_x, hi_x).long() - 1
    ya = torch.nan_to_num(y0).clamp(lo_y, hi_y).long() - 1
    flat = planes.reshape(B, P, ny * nx)
    acc = torch.zeros_like(flat)
    for m in range(4):
        row = (ya + m).clamp(0, ny - 1) * nx
        for l in range(4):
            idx = (row + (xa + l).clamp(0, nx - 1)).reshape(B, 1, -1)
            w = (cy[m] * cx[l]).reshape(B, 1, -1)
            acc = acc + w * torch.gather(flat, 2, idx.expand(B, P, -1))
    if border_out:
        acc = torch.where(in_dom.reshape(B, 1, -1), acc, torch.zeros_like(acc))
    return acc.reshape(B, P, ny, nx)


def _window(c, rel, dmax):
    """Keys weights `c` with tap m zeroed where its offset from the pixel,
    rel - 1 + m, leaves the shift window [-dmax-1, dmax+2] (a NaN offset
    leaves it)."""
    out = []
    for m, w in enumerate(c):
        off = rel - 1 + m
        keep = (off >= -dmax - 1) & (off <= dmax + 2)
        out.append(torch.where(keep, w, torch.zeros_like(w)))
    return tuple(out)


def warp_const_plain(planes, uv, aux, dmax, mode="tvl1", alpha2=0.0):
    """Plain PyTorch version of K1 (mode "tvl1") and K3 ("hs"); same
    contract as `warp_const_batched` and `warp_const_hs_batched`."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    u, v = uv[:, 0], uv[:, 1]
    iw, iwx, iwy = _bounded_bicubic(planes, u, v, dmax).unbind(1)
    if mode == "tvl1":
        rho_c = iw - iwx * u - iwy * v - aux
        grad = iwx * iwx + iwy * iwy
        return torch.stack([iwx, iwy, rho_c, grad], dim=1), 0
    dif = aux - iw + iwx * u + iwy * v
    return torch.stack([dif * iwx, dif * iwy, iwx * iwx + alpha2,
                        iwy * iwy + alpha2, iwx * iwy], dim=1), 0


def warp_planes_plain(planes, uv, dmax):
    """Plain PyTorch version of K5; same contract as
    `warp_planes_batched`."""
    return _bounded_bicubic(planes, uv[:, 0], uv[:, 1], dmax), 0


def warp_planes_shift_plain(planes, uv, dmax, border_out=True):
    """Plain PyTorch version of K5p; same contract as
    `warp_planes_shift_batched`."""
    return _bounded_bicubic(planes, uv[:, 0], uv[:, 1], dmax, strict=False,
                            border_out=border_out), 0


def warp_planes_uv_plain(planes, u, v, dmax, shift=False, border_out=True):
    """Plain PyTorch version of `warp_planes_uv`, on any device."""
    if planes.ndim == 3:
        return warp_planes_uv_plain(planes[None], u[None], v[None], dmax,
                                    shift, border_out)[0]
    return _bounded_bicubic(planes, u, v, dmax, strict=not shift,
                            border_out=border_out or not shift)


def _check_dmax(dmax):
    if int(dmax) != dmax or dmax < 0:
        raise ValueError(f"dmax must be a non-negative integer, got {dmax}")


def _warp_const(mode, planes, uv, aux, dmax, alpha2):
    """Run `mode`'s kernel on a CUDA tensor (counting the launch in
    `launches.<k1 or k3>`), its plain version on a CPU tensor."""
    entry, nout, kernel = _MODES[mode]
    check_inputs(entry, planes=(planes, ("B", 3, "ny", "nx")),
                 uv=(uv, ("B", 2, "ny", "nx")), aux=(aux, ("B", "ny", "nx")),
                 views=("uv",))
    _check_dmax(dmax)
    if not on_card(planes):
        return warp_const_plain(planes, uv, aux, dmax, mode, alpha2)
    B, _, ny, nx = planes.shape
    out = torch.empty((B, nout, ny, nx), dtype=planes.dtype,
                      device=planes.device)
    if out.numel() == 0:
        return out, 0
    extra = (float(alpha2),) if mode == "hs" else ()
    _build.launch(_build.load("warp_const", _SIGNATURES), entry, planes, uv,
                  uv.stride(0), aux, out, B, ny, nx, int(dmax), *extra,
                  device=planes.device)
    count(f"launches.{kernel}")
    return out, 0


def warp_const_batched(planes, uv, aux, dmax):
    """Bounded warp of (I1, I1x, I1y) + one warp's TV-L1 constants (K1).

    planes: (B, 3, ny, nx) float32 contiguous; uv: (B, 2, ny, nx) float32
    flow (u, v), contiguous within each sample (a view of the first two
    planes of the solver state is fine); aux: (B, ny, nx) = I0.  Returns
    ((B, 4, ny, nx) = (I1wx, I1wy, rho_c, grad), overflow count = 0)."""
    return _warp_const("tvl1", planes, uv, aux, dmax, 0.0)


def warp_const_hs_batched(planes, uv, aux, dmax, alpha2):
    """Bounded warp of (I2, I2x, I2y) + Horn-Schunck constants (K3).

    Same inputs as `warp_const_batched` with aux = I1; returns
    ((B, 5, ny, nx) = (Au, Av, Du, Dv, D), overflow count = 0)."""
    return _warp_const("hs", planes, uv, aux, dmax, alpha2)


def plane_groups(P, largest):
    """(first plane, planes) of each group the kernels split P planes
    into: groups of `largest` (6 or 3), then, for 6, one group of 3 where
    3 or more remain, then groups of 1."""
    out = [(k, largest) for k in range(0, P - P % largest, largest)]
    k = len(out) * largest
    if largest == 6 and P - k >= 3:
        out.append((k, 3))
        k += 3
    return out + [(q, 1) for q in range(k, P)]


def warp_planes_group(B, ny, nx, sms):
    """The planes a K5 / K5p thread warps for B samples of (ny, nx)
    planes on a device with `sms` SMs: GROUPS[0] where the blocks of one
    group's pixels number at least WAVES per SM (the cell is then
    computed once for more planes), else GROUPS[1] (twice the threads at
    the small levels)."""
    blocks = B * -(-ny // BLOCK[1]) * -(-nx // BLOCK[0])
    return GROUPS[0] if blocks >= WAVES * sms else GROUPS[1]


def _planes_library():
    return _build.load("warp_planes", _PLANES_SIGNATURES, (
        "warp_planes_geometry", (*TAP_MARGIN, *BLOCK, *GROUPS)))


@functools.lru_cache(maxsize=None)
def device_group(B, ny, nx, index):
    """`warp_planes_group` on CUDA device `index`, from its SM count;
    cached, since the wrappers ask on every call."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return warp_planes_group(B, ny, nx, sms)


def _warp_planes(planes, u, v, dmax, shift, border_out, group=None):
    """The one entry of K5 (K5p with `shift`): the kernel on CUDA
    tensors, counting the launch per wrapper and group, the plain version
    on CPU tensors.

    planes: (B, P, ny, nx) contiguous; u, v: (B, ny, nx), each sample
    contiguous, with one batch stride (a stacked flow's two views are
    fine).  `group` planes a thread: `device_group`'s unless the test
    hook `warp_planes_on_group` forces one, on CUDA tensors only."""
    wrapper = "warp_planes_shift_batched" if shift else "warp_planes_batched"
    flow = ("B", "ny", "nx")
    check_inputs(wrapper, planes=(planes, ("B", "P", "ny", "nx")),
                 u=(u, flow), v=(v, flow), views=("u", "v"),
                 cpu=group is None)
    _check_dmax(dmax)
    B, P, ny, nx = planes.shape
    if B > 1 and u.stride(0) != v.stride(0):
        raise KernelInputError(f"{wrapper}: u and v must share one batch "
                               f"stride, not {u.stride(0)}, {v.stride(0)}")
    if not on_card(planes):
        return warp_planes_uv_plain(planes, u, v, dmax, shift, border_out)
    if group is not None and group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group}")
    out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    if group is None:
        group = device_group(B, ny, nx, planes.device.index)
    _build.launch(_planes_library(), "warp_planes", planes, P, u, v,
                  u.stride(0), out, B, ny, nx, int(dmax),
                  _VARIANT[bool(shift), bool(border_out) or not shift], group,
                  device=planes.device)
    count(f"calls.{wrapper}.g{group}")
    return out


def _split(uv):
    """u and v, the two views of a stacked flow uv (B, 2, ny, nx)."""
    if uv.ndim != 4 or uv.shape[1] != 2:
        raise KernelInputError(f"uv must be (B, 2, ny, nx), not "
                               f"{tuple(uv.shape)}")
    return uv[:, 0], uv[:, 1]


def warp_planes_on_group(planes, uv, dmax, group, shift=False,
                         border_out=True):
    """K5 (K5p with `shift`) on CUDA tensors with `group` planes a
    thread, one of GROUPS (the wrappers take `device_group`'s).  Same
    inputs and result as `warp_planes_batched`
    (`warp_planes_shift_batched`)."""
    return _warp_planes(planes, *_split(uv), dmax, shift, border_out,
                        group), 0


def warp_planes_uv(planes, u, v, dmax, shift=False, border_out=True):
    """The warp of one (P, ny, nx) stack by the flow planes u and v, each
    (ny, nx), or of B stacks (B, P, ny, nx) by u and v each (B, ny, nx):
    K5 (K5p with `shift`) with u and v handed to the kernel as they are
    (one batch stride for both), no stacked copy; the plain version on
    CPU tensors."""
    if planes.ndim == 3:
        return warp_planes_uv(planes[None], u[None], v[None], dmax, shift,
                              border_out)[0]
    return _warp_planes(planes.contiguous(), u.contiguous(), v.contiguous(),
                        dmax, shift, border_out)


def warp_planes_batched(planes, uv, dmax):
    """Bounded warp of P planes (K5).

    planes: (B, P, ny, nx) float32 contiguous, any P; uv: (B, 2, ny, nx)
    float32 flow (u, v), contiguous within each sample.  Returns
    ((B, P, ny, nx) warped planes, 0 out of domain; overflow count = 0)."""
    return _warp_planes(planes, *_split(uv), dmax, False, True), 0


def warp_planes_shift_batched(planes, uv, dmax, border_out=True):
    """Shift-window bounded warp of P planes (K5p).

    Same inputs as `warp_planes_batched`.  Returns ((B, P, ny, nx) warped
    planes, overflow count = 0): taps outside the window [-dmax-1,
    dmax+2] of each pixel weigh 0, and out-of-domain pixels are 0 if
    `border_out`, else the sum of their clamped taps."""
    return _warp_planes(planes, *_split(uv), dmax, True, border_out), 0
