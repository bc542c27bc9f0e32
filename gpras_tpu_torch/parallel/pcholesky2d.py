"""Distributed Cholesky and triangular solves with K tiled over a 2-D mesh.

Port of ``gpras_tpu/parallel/pcholesky2d.py``. Rank (a, b) of a (di, dj)
mesh holds the contiguous (N/di, N/dj) tile K[a nr:(a+1) nr, b nc:(b+1) nc],
the layout ``pgram.pgram_2d`` builds without communication.

Right-looking blocked algorithm, one step per b-wide global panel:

1. the owner column of ranks broadcasts each row's (nr, b) slice of the
   panel along "j";
2. the owner row broadcasts the (b, b) diagonal block along "i"; every rank
   factors it (the same bits everywhere);
3. every rank solves its rows of the panel column; the owner column writes
   the result back;
4. one all-gather along "i" assembles the (N, b) panel column; each rank
   takes the slice matching its global columns and updates its trailing
   block, ``tile -= panel_rows @ panel_cols^T``.

The reference's masked full-width update (~3x the minimal operations) and
masked-``psum`` broadcasts are XLA devices; here the update covers the
trailing block's lower part only (``pcholesky.UPDATE_ROWS`` rows a matmul)
and the broadcasts are ``broadcast`` from the owner. In the solves only the
ranks that hold a panel's rows (forward) or columns (backward) reduce its
correction, over one axis; the owner of the diagonal block solves and
broadcasts along both axes. Everything runs without autograd, in the
caller's dtype.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.parallel.mesh import _all_gather, _bcast, _index, _psum, _size
from gpras_tpu_torch.parallel.pcholesky import UPDATE_ROWS, _chol_block, _right_solve

Tensor = torch.Tensor


def _tile_geometry(mesh: DeviceMesh, shape, axes):
    """(nr, nc, n, mi, mj) of this rank's tile."""
    ai, aj = axes
    nr, nc = shape
    n = nr * _size(mesh, ai)
    if nc * _size(mesh, aj) != n:
        raise ValueError(f"tile {tuple(shape)} does not tile a square over the mesh")
    return nr, nc, n, _index(mesh, ai), _index(mesh, aj)


@torch.no_grad()
def dist_cholesky_2d_local(mesh: DeviceMesh, k_local: Tensor, b: int,
                           axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """This rank's part of the factorization: ``k_local`` is its (nr, nc)
    tile of the SPD matrix, overwritten with its tile of the lower factor
    (upper triangle zeroed) and returned. Every rank of the mesh calls it."""
    ai, aj = axes
    nr, nc, n, mi, mj = _tile_geometry(mesh, k_local.shape, axes)
    r0, c0 = mi * nr, mj * nc
    step_rows = b * max(1, UPDATE_ROWS // b)
    for kb in range(n // b):
        g0 = kb * b
        owner_i, owner_j = g0 // nr, g0 // nc
        loc_r, loc_c = g0 - owner_i * nr, g0 - owner_j * nc
        # 1. the panel column's slice of my rows, from the owner column
        if mj == owner_j:
            col = k_local[:, loc_c:loc_c + b].contiguous()
        else:
            col = torch.empty((nr, b), dtype=k_local.dtype, device=k_local.device)
        col = _bcast(col, mesh, aj, owner_j)
        # 2. the diagonal block, from the owner row; factored everywhere
        a_kk = col[loc_r:loc_r + b].contiguous() if mi == owner_i else torch.empty_like(col[:b])
        l_kk = _chol_block(_bcast(a_kk, mesh, ai, owner_i))
        # 3. my rows of the panel column: L_kk on the panel's rows, the TRSM
        # below them
        lr0 = min(max(g0 + b - r0, 0), nr)
        below = _right_solve(l_kk, col[lr0:])
        if mj == owner_j:
            if mi == owner_i:
                k_local[loc_r:loc_r + b, loc_c:loc_c + b] = l_kk
            k_local[lr0:, loc_c:loc_c + b] = below
        # 4. the (N, b) panel column, zero at and above the panel; the slice
        # of my columns updates my trailing block's lower part
        masked = torch.zeros((nr, b), dtype=k_local.dtype, device=k_local.device)
        masked[lr0:] = below
        col_full = _all_gather(masked, mesh, ai)
        lc0 = min(max(g0 + b - c0, 0), nc)
        for q0 in range(lr0, nr, step_rows):
            q1 = min(q0 + step_rows, nr)
            lc1 = min(max(r0 + q1 - c0, 0), nc)  # columns up to the chunk's last row
            if lc1 > lc0:
                k_local[q0:q1, lc0:lc1].addmm_(below[q0 - lr0:q1 - lr0],
                                               col_full[c0 + lc0:c0 + lc1].mT, alpha=-1.0)
    return k_local.tril_(r0 - c0)


@torch.no_grad()
def dist_solve_lower_2d_local(mesh: DeviceMesh, l_local: Tensor, rhs: Tensor, b: int,
                              axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """Forward substitution L y = rhs with L tiled over the mesh; ``rhs``
    (N, m) and the result whole on every rank. The correction against the
    solved rows is summed over "j" on the panel's row of ranks."""
    ai, aj = axes
    nr, nc, n, mi, mj = _tile_geometry(mesh, l_local.shape, axes)
    c0 = mj * nc
    m = rhs.shape[1]
    y = torch.zeros_like(rhs)
    for kb in range(n // b):
        g0 = kb * b
        owner_i, owner_j = g0 // nr, g0 // nc
        loc_r, loc_c = g0 - owner_i * nr, g0 - owner_j * nc
        y_kb = torch.empty((b, m), dtype=rhs.dtype, device=rhs.device)
        if mi == owner_i:
            done = min(max(g0 - c0, 0), nc)  # my columns left of the panel
            corr = l_local[loc_r:loc_r + b, :done] @ y[c0:c0 + done]
            corr = _psum(corr, mesh, aj)
            if mj == owner_j:
                y_kb = torch.linalg.solve_triangular(
                    l_local[loc_r:loc_r + b, loc_c:loc_c + b], rhs[g0:g0 + b] - corr, upper=False)
            y_kb = _bcast(y_kb, mesh, aj, owner_j)
        y[g0:g0 + b] = _bcast(y_kb, mesh, ai, owner_i)
    return y


@torch.no_grad()
def dist_solve_upper_2d_local(mesh: DeviceMesh, l_local: Tensor, rhs: Tensor, b: int,
                              axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """Backward substitution L^T x = rhs, the same layout and conventions;
    the correction from the rows below is summed over "i" on the panel's
    column of ranks."""
    ai, aj = axes
    nr, nc, n, mi, mj = _tile_geometry(mesh, l_local.shape, axes)
    r0 = mi * nr
    m = rhs.shape[1]
    x = torch.zeros_like(rhs)
    for kb in reversed(range(n // b)):
        g0 = kb * b
        owner_i, owner_j = g0 // nr, g0 // nc
        loc_r, loc_c = g0 - owner_i * nr, g0 - owner_j * nc
        x_kb = torch.empty((b, m), dtype=rhs.dtype, device=rhs.device)
        if mj == owner_j:
            lr0 = min(max(g0 + b - r0, 0), nr)  # my rows below the panel
            corr = l_local[lr0:, loc_c:loc_c + b].mT @ x[r0 + lr0:r0 + nr]
            corr = _psum(corr, mesh, ai)
            if mi == owner_i:
                x_kb = torch.linalg.solve_triangular(
                    l_local[loc_r:loc_r + b, loc_c:loc_c + b].mT, rhs[g0:g0 + b] - corr,
                    upper=True)
            x_kb = _bcast(x_kb, mesh, ai, owner_i)
        x[g0:g0 + b] = _bcast(x_kb, mesh, aj, owner_j)
    return x


# ---------------------------------------------------------------------------
# mesh-level wrappers
# ---------------------------------------------------------------------------


def _check_divisible_2d(n: int, di: int, dj: int, b: int) -> None:
    if n % di != 0 or n % dj != 0:
        raise ValueError(f"N={n} must divide by both mesh axes ({di}, {dj})")
    if (n // di) % b != 0 or (n // dj) % b != 0:
        raise ValueError(
            f"block size {b} must divide both local extents "
            f"({n // di} rows, {n // dj} cols) so panels never straddle a "
            "device boundary")


def dist_cholesky_2d(mesh: DeviceMesh, k: Tensor, b: int = 128,
                     axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """This rank's tile of the lower Cholesky factor of the SPD matrix whose
    tile ``k`` is (tiled P(i, j); ``k`` is left as it was)."""
    ai, aj = axes
    _check_divisible_2d(k.shape[0] * _size(mesh, ai), _size(mesh, ai), _size(mesh, aj), b)
    return dist_cholesky_2d_local(mesh, k.clone(), b, axes)


def dist_cho_solve_2d(mesh: DeviceMesh, l: Tensor, rhs: Tensor, b: int = 128,
                      axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """(L L^T)^-1 rhs with the factor's tile ``l`` on this rank; ``rhs``
    ((N,) or (N, m)) and the result whole on every rank."""
    ai, aj = axes
    _check_divisible_2d(l.shape[0] * _size(mesh, ai), _size(mesh, ai), _size(mesh, aj), b)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    y = dist_solve_lower_2d_local(mesh, l, rhs2, b, axes)
    out = dist_solve_upper_2d_local(mesh, l, y, b, axes)
    return out[:, 0] if rhs.ndim == 1 else out


@torch.no_grad()
def dist_logdet_from_chol_2d(mesh: DeviceMesh, l: Tensor,
                             axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """log det(K) = 2 sum log diag(L): each rank sums the diagonal entries
    inside its tile, summed over the mesh; the result on every rank."""
    ai, aj = axes
    nr, nc = l.shape
    offset = _index(mesh, ai) * nr - _index(mesh, aj) * nc
    s = torch.sum(torch.log(l.diagonal(offset=offset))).reshape(1)
    return 2.0 * _psum(s, mesh, axes)[0]
