"""Blocked right-looking Cholesky, in place, and the blocked panel solves.

Port of ``gpras_tpu/ops/block_cholesky.py``. ``torch.linalg.cholesky_ex``
consumes K and returns L as a second (N, N) buffer: 2 x 9.66 GB at
N = 49,152 in float32. ``super_cholesky`` overwrites K with its factor
instead, one (w, w) diagonal block, one panel solve and one trailing update
at a time, so the factorization holds one (N, N) buffer and temporaries of
O(N w). ``blocked_cholesky`` is the same walk on a copy with the panel width
as its strip. The solves walk the factor in b-row panels.

The reference's loop bodies mask full-width updates so that XLA compiles one
static shape (~3x the operations); here every update is a slice: the
trailing update of a strip of columns covers its rows at and below the
strip's first row only, applied by ``addmm_`` on the view. No function reads
the factor above its diagonal, so a factor with stale values there (K's, as
``super_cholesky(..., zero_upper=False)`` leaves them) is a valid input to
each. Everything runs in the input's dtype with plain matmuls (no TF32
unless the caller enables it); the reference's ``precision`` is dropped.
The engines of ``gp/exact_stochastic`` and ``gp/exact_lean`` call these
inside their own autograd Functions, so nothing here is differentiated.

``fit_block`` also sizes the matrix-free engine's variance solves
(``gp/exact_cg.py``: the largest divisor of the query count at or below
256), which is why the serving layer pads requests to bucket sizes.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from gpras_tpu_torch.ops import linalg

Tensor = torch.Tensor


def _chol_block(a: Tensor) -> Tensor:
    """Lower factor of a diagonal block from its lower triangle: the block
    above the diagonal may hold stale values. ``safe_cholesky`` escalates
    the jitter on this block rather than let a Schur complement that float32
    round-off made indefinite poison every later panel."""
    return linalg.safe_cholesky(a, jitter=0.0, symmetrize=False)


def _factor_(k: Tensor, w: int, strip: int, inv_panel: bool,
             diag: Callable[[Tensor], Tensor]) -> Tensor:
    """Overwrite the lower triangle of ``k`` with its Cholesky factor, panel
    by panel of width ``w``: ``diag`` factors the diagonal block, the panel
    below it is solved (by ``tri_inverse`` and a matmul when ``inv_panel``,
    else by a triangular solve), and the trailing matrix is updated in
    column strips of ``strip``, each at and below its first row."""
    n = k.shape[0]
    for g0 in range(0, n, w):
        c0 = g0 + w
        l11 = diag(k[g0:c0, g0:c0])
        k[g0:c0, g0:c0] = l11
        if c0 == n:
            break
        a21 = k[c0:, g0:c0]
        if inv_panel:
            l21 = a21 @ linalg.tri_inverse(l11).mT
        else:
            l21 = torch.linalg.solve_triangular(l11.mT, a21, upper=True, left=False)
        a21.copy_(l21)
        for cs in range(c0, n, strip):
            ce = min(cs + strip, n)
            k[cs:, cs:ce].addmm_(l21[cs - c0:], l21[cs - c0:ce - c0].mT, alpha=-1)
    return k


def blocked_cholesky(k: Tensor, b: int = 512) -> Tensor:
    """Lower Cholesky factor of SPD ``k`` (N, N), upper triangle zero; N must
    be divisible by ``b``. Reads only ``k``'s lower triangle and leaves ``k``
    as it is. Panels of ``b`` columns, each solved by a triangular solve."""
    n = k.shape[0]
    if n % b != 0:
        raise ValueError(f"N={n} must be divisible by block size {b}")
    # the strips are the panels, so each diagonal block's upper part, which
    # a trailing update writes, is overwritten by its factor
    return _factor_(torch.tril(k), b, b, False, _chol_block)


def super_cholesky(k: Tensor, w: int = 4096, strip: int = 8192,
                   inv_panel: bool = True, zero_upper: bool = True) -> Tensor:
    """Cholesky factor of SPD ``k`` (N, N), computed in place: the result is
    ``k`` itself (the same storage), its lower triangle the factor. N must be
    divisible by the panel width ``w``.

    Per panel at offset g: the (w, w) diagonal block is factored
    (``blocked_cholesky`` with blocks of ``fit_block(w, 512)`` when w is
    wider, ``safe_cholesky`` without jitter otherwise); the panel below it
    is solved, L21 = A21 L11^-T, by ``tri_inverse`` and one matmul
    (``inv_panel``) or by a triangular solve; then A22 -= L21 L21^T in
    column strips of ``strip``, each strip's rows at and below its first row
    only, by ``addmm_`` on the view of ``k``. The peak temporary is the
    (N - g, w) panel. Only ``k``'s lower triangle is read.

    ``zero_upper=False`` leaves the stale values above the diagonal, as the
    reference does: every consumer of the factor here (the blocked solves,
    ``torch.cholesky_solve``, the log-determinant) reads only its lower
    triangle. ``zero_upper=True`` zeroes them in place.
    """
    n = k.shape[0]
    if n % w != 0:
        raise ValueError(f"N={n} must be divisible by super-panel width {w}")
    inner = fit_block(w, 512)
    diag = (lambda a: blocked_cholesky(a, inner)) if w > inner else _chol_block
    _factor_(k, w, strip, inv_panel, diag)
    return k.tril_() if zero_upper else k


def blocked_solve_lower(l: Tensor, rhs: Tensor, b: int = 512) -> Tensor:
    """Forward substitution L y = rhs (rhs (N, M)) in b-row panels: each
    panel subtracts what the rows above it solved, then solves its diagonal
    block. Reads only L's lower triangle."""
    n = l.shape[0]
    if n % b != 0:
        raise ValueError(f"N={n} must be divisible by block size {b}")
    y = torch.empty_like(rhs)
    for g0 in range(0, n, b):
        g1 = g0 + b
        r = torch.addmm(rhs[g0:g1], l[g0:g1, :g0], y[:g0], alpha=-1) if g0 else rhs[g0:g1]
        y[g0:g1] = torch.linalg.solve_triangular(l[g0:g1, g0:g1], r, upper=False)
    return y


def blocked_solve_upper(l: Tensor, rhs: Tensor, b: int = 512) -> Tensor:
    """Backward substitution L^T x = rhs, bottom-up panels. Reads only L's
    lower triangle."""
    n = l.shape[0]
    if n % b != 0:
        raise ValueError(f"N={n} must be divisible by block size {b}")
    x = torch.empty_like(rhs)
    for g0 in range(n - b, -1, -b):
        g1 = g0 + b
        r = torch.addmm(rhs[g0:g1], l[g1:, g0:g1].mT, x[g1:], alpha=-1) if g1 < n \
            else rhs[g0:g1]
        x[g0:g1] = torch.linalg.solve_triangular(l[g0:g1, g0:g1].mT, r, upper=True)
    return x


def fit_block(n: int, target: int = 512) -> int:
    """Largest block size <= target that divides n."""
    b = min(target, n)
    while n % b != 0:
        b -= 1
    return b


def blocked_cho_solve(l: Tensor, rhs: Tensor, b: int = 512) -> Tensor:
    """(L L^T)^-1 rhs through the blocked panel solves; ``rhs`` (N,) or
    (N, M). ``b`` is a target: it is shrunk to the largest divisor of N at
    or below it."""
    b = fit_block(l.shape[0], b)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    x = blocked_solve_upper(l, blocked_solve_lower(l, rhs2, b), b)
    return x[:, 0] if rhs.ndim == 1 else x
