"""Dense linear-algebra helpers for the GP core: Cholesky with jitter, solves.

Port of ``gpras_tpu/ops/linalg.py``: ``default_jitter``, ``add_jitter``,
``safe_cholesky`` (the x10 jitter escalation, differentiable), triangular and
Cholesky solves, the log-determinant, ``inv_from_chol`` and ``tri_inverse``.
"""

from __future__ import annotations

import torch

from gpras_tpu_torch.utils.profiling import count

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


def _chol_attempt(k: Tensor, jcoef: Tensor, symmetrize: bool) -> tuple[Tensor, Tensor]:
    """One factorization of (sym(K) + jcoef I) (``jcoef`` one per matrix of
    the batch); returns (L, info)."""
    if symmetrize:
        k = 0.5 * (k + k.mT)
    return torch.linalg.cholesky_ex(k + jcoef[..., None, None] * _eye_like(k))


def _any(t: Tensor) -> bool:
    """``bool(torch.any(t))``: a host read, counted."""
    count("host_reads")
    return bool(torch.any(t))


class _SafeCholesky(torch.autograd.Function):
    """Forward: the escalation loop. Backward: the Cholesky gradient of one
    attempt at the final jitter coefficient, held constant (the reference's
    custom VJP, linalg.py:99-117). A batch of matrices escalates matrix by
    matrix, each with its own scale, as the reference's loop does under
    ``jax.vmap``."""

    @staticmethod
    def forward(ctx, k, max_tries, jitter, symmetrize):
        # the jitter scale is mean(diag K), which symmetrizing leaves as it is
        scale = torch.mean(torch.diagonal(k, dim1=-2, dim2=-1), dim=-1)
        jcoef = jitter * scale
        l, info = _chol_attempt(k, jcoef, symmetrize)
        failed = info != 0
        if _any(failed):  # the one host read of a call that factors at once
            j = torch.full_like(scale, jitter)
            tries = 0
            while tries < max_tries and _any(failed):
                j = torch.where(failed, torch.where(j > 0, j * 10.0, default_jitter(k.dtype)), j)
                retry, retry_info = _chol_attempt(k, j * scale, symmetrize)
                l = torch.where(failed[..., None, None], retry, l)
                failed = failed & (retry_info != 0)
                tries += 1
            # a matrix that still fails comes back as NaN, as the reference's does
            l = torch.where(failed[..., None, None], float("nan"), l)
            jcoef = j * scale
        ctx.save_for_backward(k, jcoef)
        ctx.symmetrize = symmetrize
        return l

    @staticmethod
    def backward(ctx, lbar):
        k, jcoef = ctx.saved_tensors
        with torch.enable_grad():
            kk = k.detach().requires_grad_(True)
            l, _ = _chol_attempt(kk, jcoef, ctx.symmetrize)
            (kbar,) = torch.autograd.grad(l, kk, lbar)
        return kbar, None, None, None


def safe_cholesky(k: Tensor, max_tries: int = 5, jitter: float | None = None,
                  *, symmetrize: bool = True) -> Tensor:
    """Cholesky with adaptive jitter escalation (x10 per retry), differentiable.

    ``jitter`` is the first attempt's relative jitter; ``0.0`` factors K as
    given and starts escalating from ``default_jitter(dtype)`` only on
    failure. The reference retries while its factor holds NaNs; here the
    failure signal is ``cholesky_ex``'s ``info``, and a factor that still
    fails after ``max_tries`` retries is returned as NaN, as the reference's
    is. ``symmetrize`` factors (K + K^T) / 2, as XLA's ``symmetrize_input``.
    The gradient differentiates one factorization at the final jitter.
    """
    if jitter is None:
        jitter = default_jitter(k.dtype)
    return _SafeCholesky.apply(k, int(max_tries), float(jitter), bool(symmetrize))


def tri_inverse(l: Tensor, *, newton_steps: int = 2) -> Tensor:
    """Explicit inverse of the lower triangle of ``l``, Newton-refined.

    A triangular solve against I, then ``newton_steps`` steps
    X <- X + X (I - L X), each followed by ``tril`` so that round-off above
    the diagonal does not leak into later products. Values above ``l``'s
    diagonal are never read. ``super_cholesky`` multiplies each panel by
    this inverse (one matmul) instead of solving it. The matmuls run in the
    input's dtype; in float32 they follow ``torch.backends.cuda.matmul
    .allow_tf32``, which the port's numeric paths keep off.
    """
    eye = _eye_like(l)
    l = torch.tril(l)  # the refinement matmuls read the whole matrix
    x = torch.linalg.solve_triangular(l, eye, upper=False)
    for _ in range(newton_steps):
        x = torch.tril(x + x @ (eye - l @ x))
    return x


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


def inv_from_chol(l: Tensor) -> Tensor:
    """K^{-1} from the lower factor L (the dense NLML backward)."""
    linv = solve_triangular(l, _eye_like(l), lower=True)
    return linv.mT @ linv
