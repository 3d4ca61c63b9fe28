"""Staggered-grid box relaxation for the scalar ROF problem.

Counterpart of tpuflow/models/tvl1occ_rof.py (reference
Scalar_ROF_BoxCellCentered, src/tvl1occflow_tv_rof_box.cpp:22-644, the
dual-ROF solver of Garamendi et al. 2013), used by tvl1occflow's
Solver_wrt_u.  Each image cell owns four dual unknowns p on its edges
(shared with the neighbour cells; boundary edges stay 0).  A sweep
relaxes every cell's 4x4 system

    [ b0 -1  1  1 ] [pW]   [W]      b_k = -2 - alfa(edge_k),
    [ -1 b1  1  1 ] [pN] = [N],     alfa = |grad u| / (lambda * g),
    [  1  1 b2 -1 ] [pS]   [S]      W/N/S/E = neighbour-cell dual
    [  1  1 -1 b3 ] [pE]   [E]      values  -  edge gradient of f

with over-relaxation omega = 1.25, rows of boundary edges pinned to 0,
in red-black order over the cell checkerboard (same-colour cells share
no edge, so each half-sweep is one masked solve over the whole grid).
After each sweep the primal is u = lambda*(f + div p) (:609-635).

As in the JAX package: the per-cell systems are held as sixteen (H, W)
planes and solved by unrolled elimination (not a batched
`torch.linalg.solve`); boundary cells take the relaxed exact solution;
interior cells chain the RELAXED values through the back-substitution,
the reference's quirk (tv_rof_box.cpp:428-453); the new duals go into
the edge planes by four masked writes.  The matrix depends on alfa
only, which is fixed within a sweep, so it is eliminated once per sweep
and both colours reuse its multipliers: the same operations on the
right-hand sides as eliminating per colour.  Any float dtype.
"""

import torch

# fixed off-diagonal coupling pattern (derivation in the JAX module)
BASE = ((0.0, -1.0, 1.0, 1.0),
        (-1.0, 0.0, 1.0, 1.0),
        (1.0, 1.0, 0.0, -1.0),
        (1.0, 1.0, -1.0, 0.0))


def _zshift(a, off, dim):
    """a[index + off] along `dim` with zero padding out of range
    (|off| == 1)."""
    n = a.shape[dim]
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    if off == 1:
        return torch.cat([a.narrow(dim, 1, n - 1), z], dim=dim)
    return torch.cat([z, a.narrow(dim, 0, n - 1)], dim=dim)


def _factor4(A):
    """Unrolled Gaussian elimination of the per-cell 4x4 systems held as
    sixteen (H, W) planes: (U, multipliers).  No pivoting: diagonals are
    -2-alfa <= -2 (diagonally dominant) or exactly 1 (masked identity
    rows)."""
    A = [list(row) for row in A]
    mult = {}
    for k in range(4):
        inv = 1.0 / A[k][k]
        for i in range(k + 1, 4):
            f = A[i][k] * inv
            mult[i, k] = f
            for j in range(k + 1, 4):
                A[i][j] = A[i][j] - f * A[k][j]
    return A, mult


def _solve4(U, mult, b):
    """The per-cell solutions for right-hand sides b (four planes), from
    `_factor4`'s factors."""
    b = list(b)
    for k in range(4):
        for i in range(k + 1, 4):
            b[i] = b[i] - mult[i, k] * b[k]
    x = [None] * 4
    for k in range(3, -1, -1):
        s = b[k]
        for j in range(k + 1, 4):
            s = s - U[k][j] * x[j]
        x[k] = s / U[k][k]
    return x


def rof_box_cell_centered(u, f, p1, p2, g, lam, omega=1.25, n_iter=10,
                          window=None, halo=None):
    """Run `n_iter` red-black box-relaxation sweeps on the dual ROF
    problem; returns (u, p1, p2).

    u, f, g: (H, W); p1 / p2 are the south / east edge duals per cell
    (the reference's initialP1 / initialP2, tv_rof_box.cpp:130-131),
    carried across calls by Solver_wrt_u.

    `window=(origin_y, origin_x, global_ny, global_nx)` places the
    arrays at that origin of a larger image, as `warp_stack`'s does:
    the boundary masks, the colours and the edge gradient of f follow
    the global indices, and cells outside the global image are never
    written.  `halo(t, fill)` gives `t` with its rim refreshed from the
    neighbouring tiles (tpuflow_torch.parallel.tiled.rof_box_tiled): it
    is called on the duals p1, p2 (stacked, fill "zero": boundary edges
    stay 0) after each half-sweep and on u (fill "edge") after each
    primal recovery but the last."""
    ny, nx = u.shape
    dtype, device = u.dtype, u.device
    oy, ox, gny, gnx = (0, 0, ny, nx) if window is None else window

    ii = torch.arange(ny, device=device)[:, None] + oy
    jj = torch.arange(nx, device=device)[None, :] + ox
    inside = (ii >= 0) & (ii < gny) & (jj >= 0) & (jj < gnx)
    colors = (((ii + jj) % 2 == 0) & inside, ((ii + jj) % 2 == 1) & inside)
    has_w = (jj > 0).expand(ny, nx)
    has_n = (ii > 0).expand(ny, nx)
    has_s = (ii < gny - 1).expand(ny, nx)
    has_e = (jj < gnx - 1).expand(ny, nx)
    present = [has_w, has_n, has_s, has_e]
    interior = has_w & has_n & has_s & has_e
    # the off-diagonal entries: BASE on present rows, 0 on pinned ones
    off_diag = [[None if i == j else
                 torch.where(present[i], BASE[i][j], 0.0).to(dtype)
                 for j in range(4)] for i in range(4)]

    # edge-placed gradient of f (tv_rof_box.cpp:137-165): interior edges
    # only, boundary edges stay 0; F_h[k] lies between rows k-1 and k
    F_h = torch.zeros((ny + 1, nx), dtype=dtype, device=device)
    F_h[1:ny] = torch.where((ii[1:] > 0) & (ii[1:] < gny), f[1:] - f[:-1],
                            0.0)
    F_v = torch.zeros((ny, nx + 1), dtype=dtype, device=device)
    F_v[:, 1:nx] = torch.where((jj[:, 1:] > 0) & (jj[:, 1:] < gnx),
                               f[:, 1:] - f[:, :-1], 0.0)

    def edges(p1, p2):
        """(ph, pv) from the cells' south and east duals: ph[i] is the
        horizontal edge above cell row i (N edge of cell (i, j) is
        ph[i, j], S edge ph[i+1, j]); pv likewise for vertical edges."""
        ph = torch.zeros((ny + 1, nx), dtype=dtype, device=device)
        ph[1:] = p1
        pv = torch.zeros((ny, nx + 1), dtype=dtype, device=device)
        pv[:, 1:] = p2
        return ph, pv

    def cell_system(alfa):
        """What a sweep's two colours share: the diagonal b0..b3, the
        factors of the 4x4 systems, the interior chain's coefficients."""
        b0 = torch.where(has_w, -2.0 - _zshift(alfa, -1, -1), 0.0)
        b1 = torch.where(has_n, -2.0 - _zshift(alfa, -1, -2), 0.0)
        b2 = torch.where(has_s, -2.0 - alfa, 0.0)
        b3 = torch.where(has_e, -2.0 - alfa, 0.0)
        betas = [b0, b1, b2, b3]
        # masked-identity rows pin absent (boundary) edges to 0
        A = [[torch.where(present[i], betas[i], 1.0) if i == j
              else off_diag[i][j] for j in range(4)] for i in range(4)]
        U, mult = _factor4(A)
        a = 1.0 / torch.where(interior, b0, 1.0)
        bb = -(b0 + 1.0) / torch.where(interior, b0 * b1 - 1.0, 1.0)
        alf = 1.0 + a
        gam = -a + bb * alf
        return dict(U=U, mult=mult, a=a, bb=bb, alf=alf, gam=gam,
                    cc=(1.0 - gam) / torch.where(interior, b2 + gam, 1.0),
                    b0=b0, b1=b1, b2=b2, b3=b3)

    def sweep_color(ph, pv, sy, mask):
        pW, pE = pv[:, :-1], pv[:, 1:]
        pN, pS = ph[:-1], ph[1:]
        # neighbour-cell contributions (tv_rof_box.cpp:395-402)
        W = (-_zshift(pW, -1, -1) + _zshift(pS, -1, -1) - _zshift(pN, -1, -1)
             - F_v[:, :-1])
        N = (-_zshift(pN, -1, -2) + _zshift(pE, -1, -2) - _zshift(pW, -1, -2)
             - F_h[:-1])
        S = (-_zshift(pS, 1, -2) - _zshift(pE, 1, -2) + _zshift(pW, 1, -2)
             - F_h[1:])
        E = (-_zshift(pE, 1, -1) - _zshift(pS, 1, -1) + _zshift(pN, 1, -1)
             - F_v[:, 1:])
        rhs = [torch.where(p, r, 0.0) for p, r in zip(present, (W, N, S, E))]
        x = _solve4(sy["U"], sy["mult"], rhs)

        old = [pW, pN, pS, pE]
        # boundary cells: relaxation of the exact reduced solve (the
        # reference's Cramer special cases, tv_rof_box.cpp:193-607)
        newp = [(1.0 - omega) * o + omega * xi for o, xi in zip(old, x)]

        # interior cells: the relaxed values chained through the
        # back-substitution, as the reference does
        a, bb, alf, gam, cc = (sy[k] for k in ("a", "bb", "alf", "gam", "cc"))
        b0, b1, b2, b3 = (sy[k] for k in ("b0", "b1", "b2", "b3"))
        xx = N + a * W
        yy = -a * W + bb * xx
        pe_ch = (1.0 - omega) * pE + omega * (E + yy + cc * (S + yy)) / \
            torch.where(interior, b3 + gam + cc * (gam - 1.0), 1.0)
        ps_ch = (1.0 - omega) * pS + omega * (S + yy + pe_ch * (1.0 - gam)) / \
            torch.where(interior, b2 + gam, 1.0)
        pn_ch = (1.0 - omega) * pN + omega * (xx - alf * (pe_ch + ps_ch)) / \
            torch.where(interior, b1 - a, 1.0)
        pw_ch = (1.0 - omega) * pW + omega * (W + pn_ch - ps_ch - pe_ch) / \
            torch.where(interior, b0, 1.0)
        chained = [pw_ch, pn_ch, ps_ch, pe_ch]
        newp = [torch.where(interior, c, n) for c, n in zip(chained, newp)]

        # four masked writes: same-colour cells share no edge, so each
        # edge gets at most one per half-sweep
        ph = torch.cat([torch.where(mask, newp[1], ph[:-1]), ph[-1:]])
        ph = torch.cat([ph[:1], torch.where(mask, newp[2], ph[1:])])
        pv = torch.cat([torch.where(mask, newp[0], pv[:, :-1]), pv[:, -1:]],
                       dim=1)
        pv = torch.cat([pv[:, :1], torch.where(mask, newp[3], pv[:, 1:])],
                       dim=1)
        if halo is not None:
            ph, pv = edges(*halo(torch.stack([ph[1:], pv[:, 1:]]), "zero"))
        return ph, pv

    ph, pv = edges(p1, p2)
    for k in range(n_iter):
        # alfa = |grad u| / (lambda g), forward differences
        # (tv_rof_box.cpp:175-190)
        ux = _zshift(u, 1, -1) - u
        ux[:, -1] = 0.0
        uy = _zshift(u, 1, -2) - u
        uy[-1] = 0.0
        alfa = torch.sqrt(ux * ux + uy * uy) / (lam * g)
        sy = cell_system(alfa)
        for mask in colors:
            ph, pv = sweep_color(ph, pv, sy, mask)
        # primal recovery u = lambda*(f + div p) (tv_rof_box.cpp:609-635)
        u = lam * (f + ph[1:] - ph[:-1] + pv[:, 1:] - pv[:, :-1])
        if halo is not None and k < n_iter - 1:
            u = halo(u, "edge")
    return u, ph[1:], pv[:, 1:]
