"""One warp's 4-color SOR for pyramidal Horn-Schunck with per-sample
stopping: kernel and plain version.

Counterpart of tpuflow/ops/hs_pallas.py (`hs_sor_error_quarters`).
`hs_sor_error` sweeps the linearised system of one warp
(reference src/horn_schunck_pyramidal.cpp:32-71, omega = 1.9) until,
per sample, the summed squared update of the last full sweep `err`
drops to `thresh` (= tol^2 * level size) or `max_iter` sweeps ran;
`err` starts at inf and `thresh < 0` runs exactly `max_iter` sweeps.

A sweep updates the colors of the 2x2 parity grid in the order (0,0),
(0,1), (1,0), (1,1) (row parity, column parity), and within a color u
first, then v with that pixel's new u.  That order defines the
iterates; the TPU kernel's quarter-plane layout and (16, 256) padding
were layout choices and are not carried over: the layout is unpadded
(B, C, ny, nx) and the Neumann folds are index clamps.

The arithmetic is the TPU kernel's (hs_pallas.py:107-171), not
`_sor_sweep`'s (tpuflow_torch.models.hs_pyramidal): rdu = 1/max(Du, 1e-30)
then a product, and the separable Laplacian (hu + hd)/12 + (h + up + dn)/6
of `neighbour_sums`.

On a CUDA tensor the wrapper launches csrc/hs_sor.cu or raises; on a
CPU tensor it runs `hs_sor_error_plain`.  Both update `state` IN PLACE
and return it.  The kernel has two routes, which `hs_sor_route` picks
from the level's size and the device's shared memory (see the note in
the source): "tiles", one fused launch per sweep on tiles of `TILE`
pixels with a halo of `HALO`, color k updated on the interior grown by
3 - k pixels; and "level", the whole solve of a sample in one block
that holds the level's `LEVEL_PLANES` planes.  The kernel sums `err` in
another order than PyTorch, so a sample's `n` may differ from the plain
version's by one where `err` lands next to `thresh`.
"""

import ctypes

import torch

from tpuflow_torch import _build
from tpuflow_torch._device import check_inputs, on_card
from tpuflow_torch.ops.gradients import _shift_clamp
from tpuflow_torch.ops.sweeps import launch_until_stopped, unsolved
from tpuflow_torch.utils.trace import count

SOR_OMEGA = 1.9  # reference src/horn_schunck_pyramidal.cpp:21
D_FLOOR = 1e-30  # the TPU kernel's guard on Du, Dv (hs_pallas.py:107-110)

# the kernel's geometry, as csrc/hs_sor.cu states it (checked when the
# library loads): route "tiles"' interior (rows, columns) and the halo
# of u and v; route "level"'s planes (u, v, Au, Av, rdu, rdv, D) and the
# bytes of shared scratch beside them
TILE = (16, 56)
HALO = 4
LEVEL_PLANES = 7
LEVEL_SCRATCH = 512

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hs_sor_run": [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I,
                   _F, _I, _F, _I, _P],
    "hs_sor_partial_len": [_I, _I, _I],
    "hs_sor_finish": [_P, _P, _P, _I, _I, _I, _P],
    "hs_sor_solve": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P],
    "hs_sor_smem_optin": [],
    "hs_sor_geometry": [_I],
}


def hs_sor_route(ny, nx, smem_bytes):
    """The kernel's route for an (ny, nx) level on a device whose blocks
    may use `smem_bytes` of shared memory: "level" (the whole solve in
    one block per sample) where the level's planes and the scratch fit,
    else "tiles" (one fused launch per sweep)."""
    fits = LEVEL_PLANES * 4 * ny * nx + LEVEL_SCRATCH <= smem_bytes
    return "level" if fits else "tiles"


def neighbour_sums(f):
    """The clamped 3x3 neighbourhood of every pixel of (..., ny, nx) `f`
    as the separable pair sums the TPU kernels evaluate: (h, hu, hd, up,
    dn) with h the left + right pair of the pixel's row, hu and hd the
    pairs of the rows above and below, up and dn the pixels above and
    below.  The direct neighbours sum to h + up + dn, the diagonal ones
    to hu + hd (csrc/hs_sor.cu:laplacian12, csrc/hs_classic.cu)."""
    h = _shift_clamp(f, -1, -1) + _shift_clamp(f, 1, -1)
    return (h, _shift_clamp(h, -1, -2), _shift_clamp(h, 1, -2),
            _shift_clamp(f, -1, -2), _shift_clamp(f, 1, -2))


def _laplacian(f):
    h, hu, hd, up, dn = neighbour_sums(f)
    return (hu + hd) * (1.0 / 12.0) + (h + up + dn) * (1.0 / 6.0)


def _sweep(u, v, au, av, rdu, rdv, dd, alpha2):
    """One 4-color sweep of every sample; returns new (u, v) and the
    per-sample summed squared update."""
    w = SOR_OMEGA
    u0, v0 = u, v
    u, v = u.clone(), v.clone()
    for r in (0, 1):
        for c in (0, 1):
            q = (..., slice(r, None, 2), slice(c, None, 2))
            ula = _laplacian(u)[q]
            u[q] = ((1.0 - w) * u[q]
                    + w * (au[q] - dd[q] * v[q] + alpha2 * ula) * rdu[q])
            vla = _laplacian(v)[q]
            v[q] = ((1.0 - w) * v[q]
                    + w * (av[q] - dd[q] * u[q] + alpha2 * vla) * rdv[q])
    du = u - u0
    dv = v - v0
    return u, v, torch.sum(du * du + dv * dv, dim=(-2, -1))


def hs_sor_error_plain(state, const, thresh, max_iter, alpha2):
    """Plain PyTorch version of the kernel; same contract as
    `hs_sor_error`.  Counts each read of `active` in `host_reads`."""
    B = state.shape[0]
    au, av, du, dv, dd = const.unbind(1)
    rdu = 1.0 / torch.clamp(du, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv, min=D_FLOOR)
    err = torch.full((B,), float("inf"), dtype=state.dtype,
                     device=state.device)
    n = torch.zeros((B,), dtype=torch.int32, device=state.device)
    active = torch.full((B,), max_iter > 0, dtype=torch.bool,
                        device=state.device)
    u, v = state[:, 0], state[:, 1]
    while True:
        count("host_reads")
        if not bool(active.any()):
            break
        un, vn, e = _sweep(u, v, au, av, rdu, rdv, dd, alpha2)
        keep = active[:, None, None]
        u = torch.where(keep, un, u)
        v = torch.where(keep, vn, v)
        err = torch.where(active, e, err)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    state[:, 0] = u
    state[:, 1] = v
    return state, err, n


def _library():
    return _build.load("hs_sor", _SIGNATURES, (
        "hs_sor_geometry", (*TILE, HALO, LEVEL_PLANES, LEVEL_SCRATCH)))


def device_route(ny, nx):
    """`hs_sor_route` on the current CUDA device (builds the kernel
    library on first use)."""
    return hs_sor_route(ny, nx, _library().hs_sor_smem_optin())


def hs_sor_error(state, const, thresh, max_iter, alpha2):
    """Run one warp's SOR solve in place.

    state: (B, 2, ny, nx) = (u, v) float32 contiguous, updated in place;
    const: (B, 5, ny, nx) = (Au, Av, Du, Dv, D) as `warp_const_hs_batched`
    gives them; thresh, max_iter, alpha2: Python scalars.
    Returns (state, err (B,) float32, n (B,) int32)."""
    check_inputs("hs_sor_error", state=(state, ("B", 2, "ny", "nx")),
                 const=(const, ("B", 5, "ny", "nx")))
    if not on_card(state):
        return hs_sor_error_plain(state, const, thresh, max_iter, alpha2)
    state, err, n = unsolved(state)
    if state.numel() == 0 or max_iter <= 0:
        return state, err, n
    B, _, ny, nx = state.shape
    dev = state.device
    lib = _library()
    args = (float(thresh), int(max_iter), float(alpha2))
    count("calls.hs_sor_error")
    with torch.cuda.device(dev):
        route = device_route(ny, nx)
    if route == "level":
        _build.launch(lib, "hs_sor_solve", state, const, err, n, B, ny, nx,
                      *args, device=dev)
        return state, err, n
    scratch = torch.empty_like(state)
    partial = torch.empty(lib.hs_sor_partial_len(B, ny, nx),
                          dtype=torch.float32, device=dev)
    active = torch.ones((B,), dtype=torch.int32, device=dev)

    def sweeps(iters):
        _build.launch(lib, "hs_sor_run", state, scratch, const, partial,
                      partial.numel(), err, n, active, B, ny, nx, *args,
                      iters, device=dev)

    launch_until_stopped(sweeps, active, max_iter)
    _build.launch(lib, "hs_sor_finish", state, scratch, n, B, ny, nx,
                  device=dev)
    return state, err, n
