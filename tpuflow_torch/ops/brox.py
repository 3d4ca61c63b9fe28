"""One inner iteration's red-black SOR for the Brox family with
per-sample stopping: kernel and plain version.

Counterpart of tpuflow/ops/brox_pallas.py (`brox_sor_error_quarters`).
`brox_sor_error` relaxes the coupled 5-point system on the flow
increment (du, dv) of Brox spatial and robust-expo (reference
sor_iteration, src/brox_optic_flow_spatial.cpp:129-172, omega = 1.9;
src/robust_expo_generic_tensor.cpp:18-167) until, per sample, the
summed squared update of the last full sweep `err` drops to `thresh`
(= tol^2 * size) or `max_iter` sweeps ran; `err` starts at inf and
`thresh < 0` runs exactly `max_iter` sweeps.

A sweep updates RED pixels ((i+j) even) first, then BLACK, and within a
color du first, then dv with that pixel's new du.  That order defines
the iterates; the TPU kernel's quarter-plane layout and (16, 256)
padding were layout choices and are not carried over: the layout is
unpadded (B, C, ny, nx), and the neighbour reads are index clamps (the
psi_i are 0 across the image boundary, so a clamped neighbour never
contributes).

The arithmetic is the TPU kernel's (brox_pallas.py:68-125), not
`_sor_sweep`'s (tpuflow_torch.models.brox_spatial): rdu = 1/max(Du, 1e-30)
then a product, and the divergence psi1*down + psi2*up + psi3*right +
psi4*left in that order.

On a CUDA tensor the wrapper launches csrc/brox_sor.cu or raises; on a
CPU tensor it runs `brox_sor_error_plain`.  Both update `state` IN
PLACE and return it.  The kernel has two routes, which `brox_sor_route`
picks from the system's size and the device's limits (see the note in
the source): "resident", the whole solve in one cooperative launch with
the level in the SMs' shared memory, one block per tile of `TILE`
pixels (halo `HALO`) per sample and the stop tested on the device after
every sweep; and "stream", for systems whose tiles outnumber the blocks
the device holds at once: one launch per K sweeps that updates both
colors of every active sample's tiles into the other of two state
buffers, then the stop's fixed-order sum, with a host read of `active`
every CHECK_EVERY sweeps (ops/sweeps.py) and a last launch that settles
the samples that end in the scratch buffer.  `brox_sor_depth` picks K
from the device's limits: DEEP_K where a block of the K-sweep kernel
fits (tiles of `DEEP_TILE`, du and dv over a halo of 2K and the constants
over 2K - 1 in shared memory, sweep s of K updating red on the interior
grown by 2(K - s) + 1 and black on it grown by 2(K - s)), else 1 (tiles
of `STREAM_TILE` pixels, halo `STREAM_HALO`, red on the interior grown
by one, black on the interior).  At K > 1 each
sweep's summed squared update is kept, the stop walks them in order,
and a sample that stops inside a launch is run again for its sweeps by
the settle from that launch's input, so n sweeps give the same state,
bit for bit, at either K.  No switch picks a route or K, and a refused
launch raises.  The kernel sums `err` in another order than PyTorch (and
per tile, so at each K in its own), so a sample's `n` may differ from
the plain version's by one where `err` lands next to `thresh`.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpuflow_torch import _build
from tpuflow_torch._device import check_inputs, on_card
from tpuflow_torch.ops.hs import D_FLOOR
from tpuflow_torch.ops.sweeps import launch_until_stopped, unsolved
from tpuflow_torch.utils.trace import count, span

SOR_OMEGA = 1.9  # reference src/brox_optic_flow_spatial.cpp:25

# the kernel's geometry, as csrc/brox_sor.cu states it (checked when the
# library loads): route "resident"'s tile (rows, columns), the halo of
# du and dv, the threads of a block (one per-sample stop slot each: the
# most samples a launch takes), the bytes of shared scratch before the
# planes, and a block's shared memory: the scratch, the 9 constants
# (Au, Av, rdu, rdv, D, psi1-psi4) over the tile, du and dv over the
# tile and its halo; route "stream"'s tile interior (rows, columns), the
# halo of du and dv in shared memory, and the threads of a block
TILE = (64, 64)
HALO = 1
RESIDENT_THREADS = 512
RESIDENT_SCRATCH = 6400
RESIDENT_SMEM = RESIDENT_SCRATCH + 4 * (
    9 * TILE[0] * TILE[1] + 2 * (TILE[0] + 2 * HALO) * (TILE[1] + 2 * HALO))
STREAM_TILE = (30, 60)
STREAM_HALO = 2
STREAM_THREADS = 256
# route "stream"'s K-sweep launch: its sweeps K, its tile interior (rows,
# columns), its threads and its dynamic shared memory (du and dv over the
# interior and a halo of 2K, the nine constants over a halo of 2K - 1)
DEEP_K = 4
DEEP_TILE = (32, 96)
DEEP_THREADS = 1024
DEEP_SMEM = 4 * (
    2 * (DEEP_TILE[0] + 4 * DEEP_K) * (DEEP_TILE[1] + 4 * DEEP_K)
    + 9 * (DEEP_TILE[0] + 4 * DEEP_K - 2) * (DEEP_TILE[1] + 4 * DEEP_K - 2))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "brox_sor_run": [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _I,
                     _I, _I, _F, _I, _F, _I, _I, _P],
    "brox_sor_finish": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "brox_sor_solve": [_P, _P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _F,
                       _I, _F, _P],
    "brox_sor_limits": [_P],
    "brox_sor_geometry": [_I],
}


def tile_count(ny, nx, tile=TILE):
    """The tiles of `tile` pixels (route "resident"'s blocks per sample by
    default) that cover an (ny, nx) level."""
    return -(-ny // tile[0]) * -(-nx // tile[1])


def brox_sor_route(B, ny, nx, smem_optin, resident_blocks):
    """The kernel's route for B samples of (ny, nx) on a device whose
    blocks may opt in to `smem_optin` bytes of shared memory and which
    holds `resident_blocks` blocks of route "resident" at once:
    "resident" (the whole solve in one launch, one block per tile per
    sample) where a block fits and every block is resident at once, else
    "stream" (one launch per sweep for both colors)."""
    fits = (RESIDENT_SMEM <= smem_optin and B <= RESIDENT_THREADS
            and B * tile_count(ny, nx) <= resident_blocks)
    return "resident" if fits else "stream"


def brox_sor_depth(deep_blocks):
    """The sweeps route "stream" runs a launch on a device that holds
    `deep_blocks` blocks of its K-sweep kernel at once (0 where one does
    not fit): DEEP_K where one fits, else 1 (one sweep a launch, on tiles
    of `STREAM_TILE`).  On an H100 a sweep at DEEP_K took 0.61-0.76 of
    one at 1 at every stream level of 128 Sintel-sized pairs, down to
    3.9 tiles a block, so the level's size does not enter.  Both divide
    CHECK_EVERY, so the host reads the stop as often at either."""
    return DEEP_K if deep_blocks > 0 else 1


def _sweep(s, au, av, rdu, rdv, dd, psis, alpha, colors):
    """One red-black sweep of every sample, in place on the (B, 2, ny,
    nx) state `s` = (du, dv); `colors` are the (red, black) masks and
    the psi_i are (B, 1, ny, nx).  Each color's update is evaluated over
    the whole plane and kept where the mask is set: every neighbour of a
    pixel has the other color, so that is the same as updating the
    color's pixels alone, and both divergences of a color can be taken
    before its du update."""
    w = SOR_OMEGA
    psi1, psi2, psi3, psi4 = psis
    du, dv = s[:, 0], s[:, 1]
    for mask in colors:
        # edge-replicated copy: fp[i + 1, j + 1] = s[clamp(i), clamp(j)]
        fp = F.pad(s, (1, 1, 1, 1), mode="replicate")
        dp = (psi1 * fp[..., 2:, 1:-1] + psi2 * fp[..., :-2, 1:-1]
              + psi3 * fp[..., 1:-1, 2:] + psi4 * fp[..., 1:-1, :-2])
        new = (1.0 - w) * du + w * (au - dd * dv + alpha * dp[:, 0]) * rdu
        torch.where(mask, new, du, out=du)
        # dv with this color's new du
        new = (1.0 - w) * dv + w * (av - dd * du + alpha * dp[:, 1]) * rdv
        torch.where(mask, new, dv, out=dv)


def brox_sor_error_plain(state, const, thresh, max_iter, alpha):
    """Plain PyTorch version of the kernel; same contract as
    `brox_sor_error`."""
    B, _, ny, nx = state.shape
    au, av, du_c, dv_c, dd = const[:, :5].unbind(1)
    psis = const[:, 5:, None].unbind(1)
    rdu = 1.0 / torch.clamp(du_c, min=D_FLOOR)
    rdv = 1.0 / torch.clamp(dv_c, min=D_FLOOR)
    ii = torch.arange(ny, device=state.device)[:, None]
    jj = torch.arange(nx, device=state.device)
    red = (ii + jj) % 2 == 0
    colors = (red, ~red)
    err = torch.full((B,), float("inf"), dtype=state.dtype,
                     device=state.device)
    n = torch.zeros((B,), dtype=torch.int32, device=state.device)
    active = torch.full((B,), max_iter > 0, dtype=torch.bool,
                        device=state.device)
    s = state.clone()
    while True:
        count("host_reads")
        if not bool(active.any()):
            break
        s0 = s.clone()
        _sweep(s, au, av, rdu, rdv, dd, psis, alpha, colors)
        count("host_reads")
        if not bool(active.all()):
            s = torch.where(active[:, None, None, None], s, s0)
        d = s - s0
        err = torch.where(active, torch.sum(d * d, dim=(1, 2, 3)), err)
        n = n + active.to(torch.int32)
        active = active & (err > thresh) & (n < max_iter)
    state.copy_(s)
    return state, err, n


def _library():
    return _build.load("brox_sor", _SIGNATURES, (
        "brox_sor_geometry", (*TILE, HALO, RESIDENT_THREADS, RESIDENT_SCRATCH,
                              RESIDENT_SMEM, *STREAM_TILE, STREAM_HALO,
                              STREAM_THREADS, DEEP_K, *DEEP_TILE, DEEP_THREADS,
                              DEEP_SMEM)))


@functools.lru_cache(maxsize=None)
def _device_limits(index):
    """(opt-in shared memory per block, blocks of route "resident" the
    device holds at once, blocks of route "stream"'s K-sweep kernel it
    holds at once) of CUDA device `index`, as the device reports them."""
    out = (ctypes.c_int * 3)()
    _build.launch(_library(), "brox_sor_limits", out,
                  device=torch.device("cuda", index), stream=False)
    return out[0], out[1], out[2]


def _limits_of(device):
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _device_limits(index)


def device_route(B, ny, nx, device=None):
    """`brox_sor_route` on CUDA device `device` (default: the current
    one; builds the kernel library on first use)."""
    return brox_sor_route(B, ny, nx, *_limits_of(device)[:2])


def device_depth(device=None):
    """`brox_sor_depth` on CUDA device `device`, as `device_route`."""
    return brox_sor_depth(_limits_of(device)[2])


def _solve_resident(state, const, thresh, max_iter, alpha):
    """Route "resident" on CUDA tensors: one cooperative launch, in a
    span `solve` as route "stream"'s loop is."""
    state, err, n = unsolved(state)
    B, _, ny, nx = state.shape
    partial = torch.empty(2 * B * tile_count(ny, nx), dtype=torch.float32,
                          device=state.device)
    lib = _library()
    with span("solve"):
        count("calls.brox_sor_error.resident")
        _build.launch(lib, "brox_sor_solve", state, const, partial,
                      partial.numel(), err, n, B, ny, nx, float(thresh),
                      int(max_iter), float(alpha), device=state.device)
    return state, err, n


def _solve_stream(state, const, thresh, max_iter, alpha, depth):
    """Route "stream" on CUDA tensors: `depth` sweeps a launch (1 or
    DEEP_K), each launch followed by the stop's sum; the host reads
    `active` every CHECK_EVERY sweeps, and the settle runs again the
    samples that stopped inside a launch and copies those whose state
    ended in the scratch buffer back."""
    state, err, n = unsolved(state)
    B, _, ny, nx = state.shape
    dev = state.device
    lib = _library()
    scratch = torch.empty_like(state)
    tile = STREAM_TILE if depth == 1 else DEEP_TILE
    partial = torch.empty(B * tile_count(ny, nx, tile) * depth,
                          dtype=torch.float32, device=dev)
    active = torch.ones((B,), dtype=torch.int32, device=dev)
    redo = torch.zeros((B,), dtype=torch.int32, device=dev)
    count("calls.brox_sor_error.stream")

    def sweeps(iters):
        _build.launch(lib, "brox_sor_run", state, scratch, const, partial,
                      partial.numel(), err, n, active, redo, B, ny, nx,
                      float(thresh), int(max_iter), float(alpha), iters,
                      depth, device=dev)
        launches = -(-iters // depth)
        count("iters.k7", launches * depth)
        count("launches.k7", launches)

    launch_until_stopped(sweeps, active, max_iter)
    # the settle is K7 work too: a second span `solve`, after the loop's
    with span("solve"):
        _build.launch(lib, "brox_sor_finish", state, scratch, const, n, redo,
                      B, ny, nx, float(alpha), depth, device=dev)
    return state, err, n


def brox_sor_error(state, const, thresh, max_iter, alpha):
    """Run one inner iteration's SOR solve in place.

    state: (B, 2, ny, nx) = (du, dv) float32 contiguous, updated in place;
    const: (B, 9, ny, nx) = (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4)
    float32 contiguous; thresh, max_iter, alpha: Python scalars.
    Returns (state, err (B,) float32, n (B,) int32).  Every launch of a
    solve lies in a span `solve`: one on route "resident" and in the plain
    version, two on route "stream" (the sweeps' loop, then the settle)."""
    check_inputs("brox_sor_error", state=(state, ("B", 2, "ny", "nx")),
                 const=(const, ("B", 9, "ny", "nx")))
    if not on_card(state):
        with span("solve"):
            return brox_sor_error_plain(state, const, thresh, max_iter, alpha)
    if state.numel() == 0 or max_iter <= 0:
        return unsolved(state)
    B, _, ny, nx = state.shape
    if device_route(B, ny, nx, state.device) == "resident":
        return _solve_resident(state, const, thresh, max_iter, alpha)
    return _solve_stream(state, const, thresh, max_iter, alpha,
                         device_depth(state.device))
