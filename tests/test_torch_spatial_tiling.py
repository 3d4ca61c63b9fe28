"""The tiled pieces of `robust_expo_spatial` and `tvl1occflow_spatial`
(tpuflow_torch.parallel.tiled), replayed tile by tile in one process
and held equal to their untiled ops in float64 (`torch.equal`).

Each tile runs the tiled op in a thread of its own, on its own tiles
only; the threads meet at every halo exchange and every sum over the
tiles, as ranks do.  A tile sees nothing of the image but its tiles and
the window around them that its exchange asks for: the replay cuts that
window out of the image the tiles posted at that exchange, padded at
the image's rim by the exchange's fill (`exchange_2d` with no mesh).
Where an op must not read part of its window, that part is NaN:
  * `psi_divergence_tiled` and `psi_weighted_divergence_tiled`: the
    halo's four corners (a 5-point stencil);
  * `rof_box_tiled`: nothing; its halo of ROF_HALO = 2 is shown to be
    needed by a halo of 1, which differs from the untiled op.
With tiles of odd size the second row and column of tiles start at an
odd origin, where the ROF box relaxation's red-black colours must come
from the global index.  So a missed exchange, a halo too narrow, a
local colour or a boundary taken at the tile's edge instead of the
image's shows as NaN or as a difference.
"""

import threading

import numpy as np
import pytest
import torch

from tpuflow_torch.models.brox_spatial import (psi_divergence,
                                               psi_weighted_divergence)
from tpuflow_torch.models.tvl1occ_rof import rof_box_cell_centered
from tpuflow_torch.ops.median import median_filter
from tpuflow_torch.parallel.halo import exchange_2d
from tpuflow_torch.parallel import tiled
from tpuflow_torch.parallel.tiled import (ROF_HALO, TileGeom,
                                          median_filter_tiled,
                                          psi_divergence_tiled,
                                          psi_weighted_divergence_tiled,
                                          rof_box_tiled)

NAN = float("nan")
# (rows, cols of tiles, tile height, tile width): tiles of odd size put
# the origins of the second row and column at odd indices
MESHES = {"2x2_odd": (2, 2, 7, 9), "3x2_even": (3, 2, 6, 10),
          "1x3_odd": (1, 3, 9, 5)}


class ReplayGeom(TileGeom):
    """The geometry of tile (ty, tx) of a replay: `pad` and `psum` meet
    the other tiles' threads at `board`."""

    def __init__(self, board, ty, tx, h, w, poison=None):
        super().__init__(None, h, w)
        self.board, self.ty, self.tx = board, ty, tx
        self.y_size, self.x_size = board.rows, board.cols
        self.global_ny, self.global_nx = board.rows * h, board.cols * w
        self.poison = poison
        self.pads = 0

    def origins(self):
        return self.ty * self.h, self.tx * self.w

    def _share(self, t):
        board = self.board
        board.posts[self.ty, self.tx] = t.clone()
        board.barrier.wait()
        posts = dict(board.posts)
        board.barrier.wait()
        return posts

    def pad(self, a, halo, fill="edge"):
        posts = self._share(a)
        rows, cols = self.board.rows, self.board.cols
        whole = torch.cat([torch.cat([posts[i, j] for j in range(cols)], -1)
                           for i in range(rows)], -2)
        oy, ox = self.origins()
        win = exchange_2d(whole, halo, None, fill=fill)[
            ..., oy:oy + self.h + 2 * halo, ox:ox + self.w + 2 * halo].clone()
        if self.poison is not None:
            self.poison(self, win, halo)
        self.pads += 1
        return win

    def psum(self, value):
        posts = self._share(value)
        total = posts[0, 0].clone()
        for key in sorted(posts)[1:]:
            total = total + posts[key]
        return value.copy_(total)


class Board:
    def __init__(self, rows, cols):
        self.rows, self.cols = rows, cols
        self.posts = {}
        self.barrier = threading.Barrier(rows * cols, timeout=60)


def replay(mesh, run, poison=None):
    """run(geom, tile of a global tensor) on every tile of `mesh`, one
    thread a tile; returns {(ty, tx): result}."""
    rows, cols, h, w = mesh
    board = Board(rows, cols)
    out, errors = {}, []

    def tile_of(ty, tx):
        return lambda t: t[..., ty * h:(ty + 1) * h, tx * w:(tx + 1) * w]

    def one(ty, tx):
        try:
            geom = ReplayGeom(board, ty, tx, h, w, poison)
            out[ty, tx] = run(geom, tile_of(ty, tx))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=one, args=(ty, tx))
               for ty in range(rows) for tx in range(cols)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def assemble(out, mesh, pick=lambda r: r):
    rows, cols = mesh[:2]
    return torch.cat([torch.cat([pick(out[i, j]) for j in range(cols)], -1)
                      for i in range(rows)], -2)


def _global_index(geom, win, halo):
    oy, ox = geom.origins()
    ii = torch.arange(win.shape[-2])[:, None] + oy - halo
    jj = torch.arange(win.shape[-1])[None, :] + ox - halo
    return ii, jj


def _ring(win, halo):
    ring = torch.ones(win.shape[-2:], dtype=torch.bool)
    ring[halo:-halo, halo:-halo] = False
    return ring


def poison_corners(geom, win, halo):
    """NaN in the halo's four corners."""
    ii, jj = _global_index(geom, win, halo)
    oy, ox = geom.origins()
    rows_out = (ii < oy) | (ii >= oy + geom.h)
    cols_out = (jj < ox) | (jj >= ox + geom.w)
    win[..., rows_out & cols_out] = NAN


def _rng(seed):
    return np.random.default_rng(seed)


def _field(rng, shape, scale=1.0, offset=0.0):
    return torch.from_numpy(offset + scale * rng.standard_normal(shape))


def _global_shape(mesh):
    rows, cols, h, w = mesh
    return rows * h, cols * w


@pytest.mark.parametrize("mesh", MESHES.values(), ids=MESHES.keys())
def test_psi_divergence_tiled_equals_untiled(mesh):
    ny, nx = _global_shape(mesh)
    rng = _rng(1)
    psi = 0.5 + torch.from_numpy(rng.random((ny, nx)))
    f = _field(rng, (ny, nx), 3.0)
    want = psi_divergence(psi)
    want_div = psi_weighted_divergence(f, *want)

    def run(geom, tile):
        psis = psi_divergence_tiled(tile(psi), geom)
        return psis, psi_weighted_divergence_tiled(tile(f), *psis, geom)

    out = replay(mesh, run, poison_corners)
    for k in range(4):
        assert torch.equal(assemble(out, mesh, lambda r: r[0][k]), want[k])
    assert torch.equal(assemble(out, mesh, lambda r: r[1]), want_div)


@pytest.mark.parametrize("mesh", MESHES.values(), ids=MESHES.keys())
def test_median_filter_tiled_equals_untiled(mesh):
    ny, nx = _global_shape(mesh)
    I = _field(_rng(2), (ny, nx), 10.0)
    out = replay(mesh, lambda geom, tile: median_filter_tiled(tile(I), geom))
    assert torch.equal(assemble(out, mesh), median_filter(I, 3))
    with pytest.raises(ValueError, match="wsize 3"):
        replay((1, 1, ny, nx),
               lambda geom, tile: median_filter_tiled(tile(I), geom, 5))


def _rof_inputs(ny, nx, seed=5):
    """(u, f, p1, p2, g) float64: the duals 0 on the boundary edges (the
    south edges of the last row, the east edges of the last column), as
    the solver keeps them."""
    rng = _rng(seed)
    u = _field(rng, (ny, nx), 2.0)
    f = _field(rng, (ny, nx), 5.0)
    p1 = _field(rng, (ny, nx), 0.3)
    p2 = _field(rng, (ny, nx), 0.3)
    p1[-1] = 0.0
    p2[:, -1] = 0.0
    g = 1.0 / (1.0 + 0.05 * torch.from_numpy(rng.random((ny, nx))) * 40)
    return u, f, p1, p2, g


@pytest.mark.parametrize("n_iter", [1, 10])
@pytest.mark.parametrize("mesh", MESHES.values(), ids=MESHES.keys())
def test_rof_box_tiled_equals_untiled(mesh, n_iter):
    args = _rof_inputs(*_global_shape(mesh))
    want = rof_box_cell_centered(*args, 0.3, 1.25, n_iter)

    def run(geom, tile):
        return rof_box_tiled(*(tile(a) for a in args), 0.3, geom, 1.25,
                             n_iter)

    out = replay(mesh, run)
    for k in range(3):
        assert torch.equal(assemble(out, mesh, lambda r: r[k]), want[k])


def test_rof_box_tiled_needs_a_halo_of_two(monkeypatch):
    """A halo of 1 misses the edge duals of the cells two away that a
    cell's update reads: the result differs from the untiled op."""
    mesh = MESHES["2x2_odd"]
    args = _rof_inputs(*_global_shape(mesh))
    want = rof_box_cell_centered(*args, 0.3, 1.25, 2)[0]
    got = {}
    for halo in (ROF_HALO, 1):
        monkeypatch.setattr(tiled, "ROF_HALO", halo)
        out = replay(mesh, lambda geom, tile: rof_box_tiled(
            *(tile(a) for a in args), 0.3, geom, 1.25, 2))
        got[halo] = assemble(out, mesh, lambda r: r[0])
    assert ROF_HALO == 2 and torch.equal(got[2], want)
    assert float((got[1] - want).abs().max()) > 1e-6


def test_rof_window_of_the_whole_image_is_the_plain_op():
    """`window` at the origin of an image of the arrays' own size is the
    default."""
    args = _rof_inputs(11, 13)
    a = rof_box_cell_centered(*args, 0.3, 1.25, 3)
    b = rof_box_cell_centered(*args, 0.3, 1.25, 3, window=(0, 0, 11, 13))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
