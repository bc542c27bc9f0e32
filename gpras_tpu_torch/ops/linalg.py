"""Dense linear-algebra helpers for the GP core: Cholesky with jitter, solves.

Port of ``gpras_tpu/ops/linalg.py``: ``default_jitter``, ``add_jitter``,
``safe_cholesky`` (forward: the x10 jitter escalation), triangular and
Cholesky solves, and the log-determinant. ``safe_cholesky``'s custom VJP is
training and waits (ROADMAP.md, queue A).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

#: Default relative diagonal jitter, scaled to the working dtype.
DEFAULT_JITTER_F32 = 1e-6
DEFAULT_JITTER_F64 = 1e-9


def default_jitter(dtype: torch.dtype) -> float:
    return DEFAULT_JITTER_F64 if dtype == torch.float64 else DEFAULT_JITTER_F32


def _eye_like(k: Tensor) -> Tensor:
    return torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)


def add_jitter(k: Tensor, jitter: float | Tensor | None = None) -> Tensor:
    """K + jitter * mean(diag(K)) * I — relative jitter keeps scale-invariance."""
    if jitter is None:
        jitter = default_jitter(k.dtype)
    scale = torch.mean(torch.diagonal(k, dim1=-2, dim2=-1))
    return k + (jitter * scale) * _eye_like(k)


def cholesky(k: Tensor, jitter: float | None = None) -> Tensor:
    """Lower Cholesky factor of K + jitter*I (relative jitter)."""
    return torch.linalg.cholesky(add_jitter(k, jitter))


def safe_cholesky(k: Tensor, max_tries: int = 5, jitter: float | None = None,
                  *, symmetrize: bool = True) -> Tensor:
    """Cholesky with adaptive jitter escalation (x10 per retry).

    ``jitter`` is the first attempt's relative jitter; ``0.0`` factors K as
    given and starts escalating from ``default_jitter(dtype)`` only on
    failure. The reference retries while its factor holds NaNs; here the
    failure signal is ``cholesky_ex``'s ``info``, and a factor that still
    fails after ``max_tries`` retries is returned as NaN, as the reference's
    is. ``symmetrize`` factors (K + K^T) / 2, as XLA's ``symmetrize_input``.
    """
    if jitter is None:
        jitter = default_jitter(k.dtype)
    if symmetrize:
        k = 0.5 * (k + k.mT)
    scale = torch.mean(torch.diagonal(k, dim1=-2, dim2=-1))
    eye = _eye_like(k)
    j = float(jitter)
    l, info = torch.linalg.cholesky_ex(k + (j * scale) * eye)
    tries = 0
    while tries < max_tries and bool(torch.any(info != 0)):
        j = j * 10.0 if j > 0 else default_jitter(k.dtype)
        l, info = torch.linalg.cholesky_ex(k + (j * scale) * eye)
        tries += 1
    if bool(torch.any(info != 0)):
        l = torch.full_like(l, float("nan"))
    return l


def solve_triangular(l: Tensor, b: Tensor, *, lower: bool = True, trans: bool = False) -> Tensor:
    """Triangular solve of op(L) x = b with op = transpose when ``trans``."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=lower)
    return torch.linalg.solve_triangular(l, b, upper=not lower)


def cho_solve(l: Tensor, b: Tensor) -> Tensor:
    """Solve (L L^T) x = b given the lower factor L."""
    y = solve_triangular(l, b, lower=True)
    return solve_triangular(l, y, lower=True, trans=True)


def logdet_from_chol(l: Tensor) -> Tensor:
    """log det(K) = 2 * sum(log diag(L))."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
