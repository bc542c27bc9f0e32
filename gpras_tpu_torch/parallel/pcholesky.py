"""Distributed blocked Cholesky and triangular solves over row strips.

Port of ``gpras_tpu/parallel/pcholesky.py``. K (N, N) is sharded by
contiguous row blocks over a mesh axis: each of d ranks holds its (N/d, N)
strip (``pgram.pgram_rows`` builds it without communication).

Right-looking blocked factorization, one step per b-wide panel at column g0:
the owner of rows [g0, g0 + b) broadcasts the (b, b) diagonal block, every
rank factors it (the same bits everywhere), each rank solves its rows below
the panel against it (one TRSM), one all-gather along the axis assembles the
(N, b) panel column, and each rank updates its trailing block. The
reference updates the whole strip width through masks, a static-shape
device of XLA's that costs ~3x the minimal operations; here the update
covers only the trailing rows and, in chunks of ``UPDATE_ROWS`` rows, the
columns up to each chunk's last row, near the minimal N^3 / 3 in all. The
reference's masked ``psum`` broadcasts become ``broadcast`` from the owner.

The solves keep the right-hand side whole on every rank. The forward solve
walks the ranks in order: each solves its diagonal block against what the
ranks before it solved and broadcasts its rows. The backward solve walks
them in reverse: the ranks below sum their parts of the correction onto the
owner (one all-reduce), which solves and broadcasts. 2d collectives a solve,
where the reference issues one or two per panel.

Everything here runs without autograd, in the caller's dtype (the trailing
updates are plain matmuls: no TF32 unless the caller enables it). The
distributed losses (``pexact``) differentiate through their own backward
passes, which reuse the factor. A factor that does not exist (a diagonal
block that is not positive definite) comes out NaN, as the reference's
``jnp.linalg.cholesky`` does.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.parallel.mesh import _all_gather, _bcast, _index, _psum, _size

Tensor = torch.Tensor

#: rows of the trailing update per matmul: each chunk updates the columns up
#: to its own last row, so the update skips most of the upper triangle
UPDATE_ROWS = 4096


def _chol_block(a: Tensor) -> Tensor:
    """Lower factor of the (b, b) block; NaN where it does not factor."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, l, torch.nan)


def _right_solve(l_kk: Tensor, c: Tensor) -> Tensor:
    """C L_kk^-T, the panel column's rows below the diagonal block."""
    return torch.linalg.solve_triangular(l_kk.mT, c, upper=True, left=False)


@torch.no_grad()
def dist_cholesky_local(mesh: DeviceMesh, k_local: Tensor, b: int,
                        axis: str = "i") -> Tensor:
    """This rank's part of the factorization: ``k_local`` is its (nr, N) row
    strip of the SPD matrix, overwritten with its strip of the lower factor
    (upper triangle zeroed) and returned. Every rank of ``axis`` calls it."""
    nr, n = k_local.shape
    nb = n // b
    me = _index(mesh, axis)
    r0 = me * nr
    step_rows = b * max(1, UPDATE_ROWS // b)
    for kb in range(nb):
        g0 = kb * b
        owner = g0 // nr
        loc = g0 - owner * nr
        if me == owner:
            a_kk = k_local[loc:loc + b, g0:g0 + b].contiguous()
        else:
            a_kk = torch.empty((b, b), dtype=k_local.dtype, device=k_local.device)
        l_kk = _chol_block(_bcast(a_kk, mesh, axis, owner))
        if me == owner:
            k_local[loc:loc + b, g0:g0 + b] = l_kk
        # local rows below the panel: global rows >= g0 + b
        lr0 = min(max(g0 + b - r0, 0), nr)
        below = _right_solve(l_kk, k_local[lr0:, g0:g0 + b])
        k_local[lr0:, g0:g0 + b] = below
        col = torch.zeros((nr, b), dtype=k_local.dtype, device=k_local.device)
        col[lr0:] = below
        col_full = _all_gather(col, mesh, axis)  # (N, b), zero at and above the panel
        # trailing update of the lower part: rows >= g0 + b, columns in
        # [g0 + b, the chunk's last row]
        for c0 in range(lr0, nr, step_rows):
            c1 = min(c0 + step_rows, nr)
            k_local[c0:c1, g0 + b:r0 + c1].addmm_(
                below[c0 - lr0:c1 - lr0], col_full[g0 + b:r0 + c1].mT, alpha=-1.0)
    return k_local.tril_(r0)


@torch.no_grad()
def dist_solve_lower_local(mesh: DeviceMesh, l_local: Tensor, rhs: Tensor, b: int,
                           axis: str = "i") -> Tensor:
    """Forward substitution L y = rhs with L's (nr, N) strip on this rank;
    ``rhs`` (N, m) and the result whole on every rank."""
    nr, n = l_local.shape
    me = _index(mesh, axis)
    y = torch.zeros_like(rhs)
    for q in range(n // nr):
        q0 = q * nr
        if me == q:
            t = rhs[q0:q0 + nr] - l_local[:, :q0] @ y[:q0]
            y_q = torch.linalg.solve_triangular(l_local[:, q0:q0 + nr], t, upper=False)
        else:
            y_q = torch.empty((nr, rhs.shape[1]), dtype=rhs.dtype, device=rhs.device)
        y[q0:q0 + nr] = _bcast(y_q, mesh, axis, q)
    return y


@torch.no_grad()
def dist_solve_upper_local(mesh: DeviceMesh, l_local: Tensor, rhs: Tensor, b: int,
                           axis: str = "i") -> Tensor:
    """Backward substitution L^T x = rhs, the same layout and conventions:
    the correction L[below, q]^T x[below] is summed over the ranks that hold
    the rows below block q."""
    nr, n = l_local.shape
    me = _index(mesh, axis)
    r0 = me * nr
    x = torch.zeros_like(rhs)
    for q in reversed(range(n // nr)):
        q0 = q * nr
        if me > q:
            corr = l_local[:, q0:q0 + nr].mT @ x[r0:r0 + nr]
        else:
            corr = torch.zeros((nr, rhs.shape[1]), dtype=rhs.dtype, device=rhs.device)
        corr = _psum(corr, mesh, axis)
        if me == q:
            x_q = torch.linalg.solve_triangular(l_local[:, q0:q0 + nr].mT, rhs[q0:q0 + nr] - corr,
                                                upper=True)
        else:
            x_q = corr
        x[q0:q0 + nr] = _bcast(x_q, mesh, axis, q)
    return x


# ---------------------------------------------------------------------------
# mesh-level wrappers
# ---------------------------------------------------------------------------


def dist_cholesky(mesh: DeviceMesh, k: Tensor, b: int = 128, axis: str = "i") -> Tensor:
    """This rank's (N/d, N) strip of the lower Cholesky factor of the SPD
    matrix whose strip ``k`` is (rows sharded over ``axis``; ``k`` is left
    as it was). N must divide evenly by the axis size, and b must divide
    N/d."""
    nr, n = k.shape
    _check_divisible(n, _size(mesh, axis), b)
    if nr * _size(mesh, axis) != n:
        raise ValueError(f"strip of {nr} rows is not N={n} over {_size(mesh, axis)} ranks")
    return dist_cholesky_local(mesh, k.clone(), b, axis)


def dist_cho_solve(mesh: DeviceMesh, l: Tensor, rhs: Tensor, b: int = 128,
                   axis: str = "i") -> Tensor:
    """(L L^T)^-1 rhs with the factor's strip ``l`` on this rank; ``rhs``
    ((N,) or (N, m)) and the result whole on every rank."""
    _check_divisible(l.shape[1], _size(mesh, axis), b)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    y = dist_solve_lower_local(mesh, l, rhs2, b, axis)
    out = dist_solve_upper_local(mesh, l, y, b, axis)
    return out[:, 0] if rhs.ndim == 1 else out


@torch.no_grad()
def dist_logdet_from_chol(mesh: DeviceMesh, l: Tensor, axis: str = "i") -> Tensor:
    """log det(K) = 2 sum log diag(L): each rank sums its strip's diagonal
    entries, one all-reduce; the result on every rank."""
    nr = l.shape[0]
    s = torch.sum(torch.log(l.diagonal(offset=_index(mesh, axis) * nr))).reshape(1)
    return 2.0 * _psum(s, mesh, axis)[0]


def _check_divisible(n: int, d: int, b: int) -> None:
    if n % d != 0:
        raise ValueError(f"N={n} must be divisible by the mesh axis size {d}")
    nr = n // d
    # b must divide the per-rank row count: a panel's rows never straddle
    # two ranks
    if nr % b != 0:
        raise ValueError(f"block size {b} must divide local rows {nr} "
                         f"(N={n} over {d} devices)")
