"""Spatially tiled (halo-exchanged) versions of the core ops, of the
single-scale TV-L1 solver and of the pieces of robust-expo and TV-L1
with occlusions.

Counterpart of tpuflow/parallel/tiled.py.  Every rank of a mesh with
dimensions (y_axis, x_axis) calls these on its (..., h, w) tile of a
global (..., h*Y, w*X) image; a halo exchange (tpuflow_torch.parallel
.halo) rebuilds the neighbourhood that the full-image op sees, so a
tiled result equals the full-image op's.  The ops are plain PyTorch, as
the JAX package's tiled path is plain XLA; no kernel lies on this lane.

Communication: one exchange of width-1 halos per stencil, one of width
`warp_halo` per warp, and an `all_reduce` of the convergence error per
inner iteration, summed over all tiles before the stop test so that
every tile stops together (the reference's global rule,
src/tvl1flow.cpp:113,150-162).  That test is a host read per inner
iteration.  `tvl1_warps_tiled` is the warp loop with the warp as a
parameter: the multiscale lane (tpuflow_torch.parallel.spatial) gives
it the bounded warp of the whole level.

For robust-expo: the psi divergence coefficients and the psi-weighted
divergence on a halo of 1 (its SOR solve runs on the gathered level).
For TV-L1 with occlusions:
the 3x3 median on a halo of 1 and `rof_box_tiled`, the staggered ROF
box relaxation on a halo of `ROF_HALO` cells, exchanged after each
half-sweep.  Each tiled op equals its untiled op bit for bit
(tests/test_torch_spatial_tiling.py replays them tile by tile).
"""

import torch
import torch.distributed as dist

from tpuflow_torch.config import numpy_dtype
from tpuflow_torch.models.brox_spatial import psi_divergence
from tpuflow_torch.models.tvl1occ_rof import rof_box_cell_centered
from tpuflow_torch.ops.gaussian import gaussian, gaussian_kernel_1d
from tpuflow_torch.ops.gradients import centered_gradient, forward_gradient
from tpuflow_torch.ops.interp import warp_stack
from tpuflow_torch.ops.median import median_filter
from tpuflow_torch.ops.tvl1 import GRAD_IS_ZERO, _step
from tpuflow_torch.parallel.halo import crop, exchange_2d
from tpuflow_torch.parallel.mesh import axis_size

# the halo of the ROF box relaxation: a cell's update reads the edge
# duals of the cells two away (sweep_color's shifts of neighbour edges),
# and the cells one past the tile must update the tile's own edges
ROF_HALO = 2


class TileGeom:
    """Geometry of a 2-D tiling: the mesh (None: one tile), its
    dimension names and sizes, and the local tile shape."""

    def __init__(self, mesh, tile_h, tile_w, y_axis="y", x_axis="x"):
        self.mesh = mesh
        self.y_axis = y_axis
        self.x_axis = x_axis
        self.y_size = axis_size(mesh, y_axis)
        self.x_size = axis_size(mesh, x_axis)
        self.h = tile_h
        self.w = tile_w
        self.global_ny = self.y_size * tile_h
        self.global_nx = self.x_size * tile_w

    def pad(self, a, halo, fill="edge"):
        return exchange_2d(a, halo, self.mesh, self.x_axis, self.y_axis, fill)

    def origins(self):
        """(origin_y, origin_x) of this rank's tile in global indices."""
        yi = self.mesh.get_local_rank(self.y_axis) if self.y_size > 1 else 0
        xi = self.mesh.get_local_rank(self.x_axis) if self.x_size > 1 else 0
        return yi * self.h, xi * self.w

    def psum(self, value):
        """`value` (a tensor) summed over all tiles, in place."""
        for axis, size in ((self.y_axis, self.y_size),
                           (self.x_axis, self.x_size)):
            if size > 1:
                dist.all_reduce(value, group=self.mesh.get_group(axis))
        return value

    def _index(self, t, dim):
        """Global row (dim=-2) or column (dim=-1) index of `t`'s cells."""
        oy, ox = self.origins()
        n = t.shape[dim]
        idx = torch.arange(n, device=t.device) + (ox if dim == -1 else oy)
        return idx if dim == -1 else idx[:, None]


def centered_gradient_tiled(I, geom):
    """Tiled centred gradient: the edge fill gives the one-sided
    boundary differences."""
    dx, dy = centered_gradient(geom.pad(I, 1, "edge"))
    return crop(dx, 1), crop(dy, 1)


def forward_gradient_tiled(f, geom):
    """Tiled forward gradient: the edge fill makes the difference
    vanish at the global last row and column."""
    fx, fy = forward_gradient(geom.pad(f, 1, "edge"))
    return crop(fx, 1), crop(fy, 1)


def divergence_tiled(v1, v2, geom):
    """Tiled backward-difference divergence: v1 with its global last
    column zeroed (v2: last row), a zero halo on the leading side, and
    plain backward differences, which is Chambolle's boundary rule."""
    v1m = torch.where(geom._index(v1, -1) == geom.global_nx - 1,
                      torch.zeros_like(v1), v1)
    v2m = torch.where(geom._index(v2, -2) == geom.global_ny - 1,
                      torch.zeros_like(v2), v2)
    p1 = geom.pad(v1m, 1, "zero")
    p2 = geom.pad(v2m, 1, "zero")
    div_x = p1[..., 1:-1, 1:-1] - p1[..., 1:-1, :-2]
    div_y = p2[..., 1:-1, 1:-1] - p2[..., :-2, 1:-1]
    return div_x + div_y


def psi_divergence_tiled(psi, geom):
    """Tiled `psi_divergence`: the half sums on an edge-filled halo of
    1, psi1..psi4 zeroed at the GLOBAL last row, first row, last column
    and first column."""
    rows, cols = geom._index(psi, -2), geom._index(psi, -1)
    psi1, psi2, psi3, psi4 = (crop(p, 1) for p in
                              psi_divergence(geom.pad(psi, 1, "edge")))
    return (torch.where(rows == geom.global_ny - 1, 0.0, psi1),
            torch.where(rows == 0, 0.0, psi2),
            torch.where(cols == geom.global_nx - 1, 0.0, psi3),
            torch.where(cols == 0, 0.0, psi4))


def psi_weighted_divergence_tiled(f, psi1, psi2, psi3, psi4, geom):
    """Tiled `psi_weighted_divergence`: the neighbours from an
    edge-filled halo of 1, which is the untiled op's clamp at the
    global rim."""
    fp = geom.pad(f, 1, "edge")
    return (psi1 * (fp[..., 2:, 1:-1] - f) + psi2 * (fp[..., :-2, 1:-1] - f)
            + psi3 * (fp[..., 1:-1, 2:] - f) + psi4 * (fp[..., 1:-1, :-2] - f))


def median_filter_tiled(I, geom, wsize=3):
    """Tiled 3x3 `median_filter`: for wsize 3 the untiled op's border
    fold (-1 -> 0, n -> n-1) is the edge fill of a halo of 1."""
    if wsize != 3:
        raise ValueError(f"median_filter_tiled takes wsize 3, got {wsize}")
    return crop(median_filter(geom.pad(I, 1, "edge"), wsize), 1)


def rof_box_tiled(u, f, p1, p2, g, lam, geom, omega=1.25, n_iter=10):
    """Tiled `rof_box_cell_centered` on this rank's (h, w) tiles:
    `rof_box_cell_centered(window=...)` on the tiles padded by ROF_HALO
    (u, f and g with an edge fill; the duals p1, p2 with a zero fill,
    since boundary edges stay 0), whose duals are exchanged again after
    each half-sweep and u after each primal recovery.  ROF_HALO is the
    least halo that equals the untiled op; returns this rank's tiles of
    (u, p1, p2)."""
    oy, ox = geom.origins()
    halo = ROF_HALO

    def refresh(t, fill):
        return geom.pad(crop(t, halo), halo, fill)

    up, fp, gp = (geom.pad(t, halo, "edge") for t in (u, f, g))
    pp = geom.pad(torch.stack([p1, p2]), halo, "zero")
    out = rof_box_cell_centered(
        up, fp, pp[0], pp[1], gp, lam, omega, n_iter,
        window=(oy - halo, ox - halo, geom.global_ny, geom.global_nx),
        halo=refresh)
    return tuple(crop(t, halo) for t in out)


def gaussian_tiled(I, sigma, geom, window=5):
    """Tiled separable Gaussian with the reference's asymmetric
    reflecting pad at the global boundary (fill "gaussian")."""
    if sigma <= 0:
        return I
    _, size = gaussian_kernel_1d(sigma, window)
    out = gaussian(geom.pad(I, size, "gaussian"), sigma, bc="reflecting",
                   window=window)
    return crop(out, size)


def warp_planes_tiled(planes, u, v, geom, halo, border_out=True):
    """Tiled exact bicubic warp of an (N, h, w) stack by one flow field.

    `halo` must cover the largest displacement plus the bicubic taps
    (|flow| <= halo - 3): taps beyond it clamp to the padded rim.  The
    out-of-domain test and the border_out zeros use the global extent
    (`warp_stack(window=...)`)."""
    oy, ox = geom.origins()
    padded = geom.pad(planes, halo, "edge")
    xx = geom._index(u, -1).to(u.dtype) + u
    yy = geom._index(v, -2).to(v.dtype) + v
    return warp_stack(padded, xx, yy, border_out,
                      window=(oy - halo, ox - halo, geom.global_ny,
                              geom.global_nx))


def tvl1_warps_tiled(I0, u1, u2, geom, warp, tau=0.25, lam=0.15, theta=0.3,
                     warps=5, epsilon=0.01, max_iterations=300,
                     stop="error"):
    """The warps of a tiled single-scale TV-L1 on this rank's (h, w)
    tiles: `warp(u1, u2)` gives this rank's tiles of (I1w, I1wx, I1wy)
    warped by the tiles of the flow, each warp's constants follow, and
    the inner iterations run through the halo-exchanged stencils.

    stop="error" ends a warp's iterations when err, the squared flow
    update summed over the GLOBAL image, drops to epsilon^2 * size (the
    rule of tpuflow_torch.models.tvl1.tvl1_scale, read on the host after
    every iteration); stop="fixed" runs `max_iterations` and reads err
    once per warp.  Returns this rank's tiles of (u1, u2) and
    {"iterations": each warp's inner count, "error": each warp's last
    mean squared update, "host_reads": the err reads made}."""
    if stop not in ("error", "fixed"):
        raise ValueError(f"unknown stop mode {stop!r}")
    h, w = I0.shape[-2:]
    l_t = lam * theta
    taut = tau / theta
    size = geom.global_ny * geom.global_nx
    f = numpy_dtype(I0.dtype)
    thresh = float(f(epsilon * epsilon) * f(size))

    def div(a, b):
        return divergence_tiled(a, b, geom)

    def fgrad(a):
        return forward_gradient_tiled(a, geom)

    state = I0.new_zeros((1, 6, h, w))
    state[0, 0] = u1
    state[0, 1] = u2
    ns, errs, reads = [], [], 0
    for _ in range(warps):
        u, v = state[0, 0], state[0, 1]
        I1w, I1wx, I1wy = warp(u, v)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u - I1wy * v - I0
        fi = -1.0 / torch.clamp(grad, min=GRAD_IS_ZERO)
        n, err = 0, float("inf")
        while n < max_iterations:
            state, e = _step(state, I1wx[None], I1wy[None], rho_c[None],
                             grad[None], fi[None], l_t, theta, taut,
                             divergence=div, forward_gradient=fgrad)
            n += 1
            if stop == "error" or n == max_iterations:
                err = float(geom.psum(e)[0])
                reads += 1
                if stop == "error" and not err > thresh:
                    break
        ns.append(n)
        errs.append(err / size)
    return (state[0, 0].clone(), state[0, 1].clone(),
            {"iterations": ns, "error": errs, "host_reads": reads})


def tvl1_scale_tiled(I0, I1, u1, u2, geom, warp_halo, tau=0.25, lam=0.15,
                     theta=0.3, warps=5, epsilon=0.01, max_iterations=300,
                     with_diag=False):
    """Tiled single-scale TV-L1 on this rank's (h, w) tiles of
    normalised, presmoothed images (cf. tpuflow_torch.models.tvl1
    .tvl1_scale with warp_mode="exact", whose arithmetic and stopping
    rule it runs: err, the squared flow update summed over the GLOBAL
    image, against epsilon^2 * size).  Each warp is the tiled exact
    warp (`warp_planes_tiled`) with a halo of `warp_halo`.  Returns
    this rank's tiles of (u1, u2); with `with_diag=True` also
    `tvl1_warps_tiled`'s diag."""
    planes = torch.stack([I1, *centered_gradient_tiled(I1, geom)])
    u1, u2, diag = tvl1_warps_tiled(
        I0, u1, u2, geom,
        lambda u, v: warp_planes_tiled(planes, u, v, geom, warp_halo),
        tau, lam, theta, warps, epsilon, max_iterations)
    if with_diag:
        return u1, u2, diag
    return u1, u2
