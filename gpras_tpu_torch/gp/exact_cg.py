"""Matrix-free exact-GP posterior: batched (preconditioned) conjugate gradients.

Port of the serving half of ``gpras_tpu/gp/exact_cg.py`` (GPyTorch's BBMM
engine, Gardner et al. 2018): no (N, N) object is ever stored.

- ``kmv``: (K + noise I) @ V. A stationary kernel on float32 CUDA tensors at
  N >= 2048 goes to the symmetric fused CUDA kernel
  (``ops/fused_gram.kmv_sym``); otherwise (CPU, float64, other kernels) row
  panels of the Gram are built and contracted in plain PyTorch.
- ``pivoted_cholesky`` + ``make_woodbury_pinv``: the rank-k preconditioner.
- ``mbcg``: modified batched CG with per-column scalars, always
  ``max_iters`` iterations with a freeze mask for converged or broken-down
  columns — no host synchronization inside the loop.
- ``cg_posterior_alpha`` / ``cg_predict``: the posterior mean weights and the
  posterior (mean, variance), the variance by one batched CG solve per chunk
  of queries.

The SLQ log-determinant, the CG training loss and its gradients are training
and wait (ROADMAP.md, queue A). ``vmap`` and ``fori_loop`` of the reference
become Python loops.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.ops.block_cholesky import fit_block as _fit_panel

Tensor = torch.Tensor

#: below this many training points the plain panel loop is used everywhere
FUSED_MIN_N = 2048


def _fused(kernel: str, x: Tensor) -> bool:
    """The reference's kernel dispatch (exact_cg.py:82-83, 775-776) with the
    TPU replaced by a CUDA device."""
    return (x.shape[0] >= FUSED_MIN_N and kernel in K.STATIONARY_KERNELS
            and x.dtype == torch.float32 and x.is_cuda)


def kmv(kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
        noise: Tensor, row_panel: int = 4096) -> Tensor:
    """(K(x, x) + noise I) @ v without materializing K. v: (N, R) -> (N, R)."""
    if _fused(kernel, x):
        return fused_gram.kmv_sym(kernel, params, x, v, noise=noise)
    return fused_gram.kmv_plain(kernel, params, x, v, noise=noise, row_panel=row_panel)


def pivoted_cholesky(kernel: str, params: dict[str, Tensor], x: Tensor,
                     rank: int) -> Tensor:
    """Rank-``rank`` pivoted (partial) Cholesky of K(x, x), matrix-free:
    L (N, rank) with K ~= L L^T + residual. Each step evaluates one kernel
    column at the largest residual-diagonal entry; the pivot stays on the
    device (no host synchronization)."""
    n = x.shape[0]
    diag = K.kdiag(kernel, params, x)
    l = torch.zeros((n, rank), dtype=x.dtype, device=x.device)
    diag_r = diag
    steps = torch.arange(rank, device=x.device)
    for i in range(rank):
        piv = torch.argmax(diag_r).reshape(1)
        x_piv = x.index_select(0, piv)  # (1, D)
        col = K.gram(kernel, params, x, x_piv)[:, 0]  # (N,)
        l_piv = l.index_select(0, piv)[0]  # (rank,)
        # mask out factors not yet computed (j >= i)
        proj = l @ (l_piv * (steps < i).to(x.dtype))
        d_raw = diag_r.index_select(0, piv)[0]
        new_col = (col - proj) / torch.sqrt(torch.clamp_min(d_raw, 1e-30))
        # zero the column once the residual diagonal is (numerically) exhausted
        new_col = torch.where(d_raw > 1e-12 * diag.index_select(0, piv)[0], new_col, 0.0)
        l[:, i] = new_col
        diag_r = torch.clamp_min(diag_r - new_col * new_col, 0.0)
    return l


def make_woodbury_pinv(l: Tensor, noise: Tensor) -> tuple[Callable[[Tensor], Tensor], Tensor]:
    """P^{-1} for P = L L^T + noise I via the Woodbury identity. Returns
    (pinv(v), logdet_P); the (k, k) capacitance is factorized once."""
    n, k = l.shape
    m = noise * torch.eye(k, dtype=l.dtype, device=l.device) + l.T @ l
    lm = torch.linalg.cholesky(m)

    def pinv(v: Tensor) -> Tensor:
        t = torch.cholesky_solve(l.T @ v, lm)  # M^{-1} L^T v
        return (v - l @ t) / noise

    logdet_p = (n - k) * torch.log(noise) + 2.0 * torch.sum(
        torch.log(torch.clamp_min(torch.diagonal(lm), 1e-30)))
    return pinv, logdet_p


def _identity(v: Tensor) -> Tensor:
    return v


def mbcg(matvec: Callable[[Tensor], Tensor], b: Tensor, max_iters: int = 32,
         tol: float = 1e-6, pinv: Callable[[Tensor], Tensor] | None = None):
    """Modified batched CG: solve A X = b per column, recording the Lanczos
    coefficients. b: (N, R). Returns (x, alphas, betas, rz0) with alphas and
    betas (max_iters, R) and rz0 = b^T P^{-1} b. Always runs ``max_iters``
    iterations; converged columns freeze through the tolerance mask."""
    if pinv is None:
        pinv = _identity
    carry, rz0, stop2 = _mbcg_init(b, max_iters, tol, pinv)
    x, _, _, _, alphas, betas, _ = _mbcg_run(matvec, carry, 0, max_iters, stop2, pinv)
    return x, alphas, betas, rz0


def _mbcg_init(b: Tensor, max_iters: int, tol: float, pinv):
    """Initial mbcg carry + (rz0, stop2)."""
    r = b.shape[1]
    stop2 = (tol * tol) * torch.sum(b * b, dim=0)
    z0 = pinv(b)
    rz0 = torch.sum(b * z0, dim=0)
    x0 = torch.zeros_like(b)
    alphas = torch.zeros((max_iters, r), dtype=b.dtype, device=b.device)
    betas = torch.zeros((max_iters, r), dtype=b.dtype, device=b.device)
    done0 = torch.zeros((r,), dtype=torch.bool, device=b.device)
    return (x0, z0, b, rz0, alphas, betas, done0), rz0, stop2


def _mbcg_run(matvec, carry, start: int, stop: int, stop2: Tensor, pinv):
    """mbcg iterations [start, stop): the reference's fori_loop body."""
    x, p, res, rz, alphas, betas, done = carry
    for i in range(start, stop):
        ap = matvec(p)
        pap = torch.sum(p * ap, dim=0)
        # breakdown guard: non-positive / non-finite curvature or residual
        # energy freezes the column permanently
        done_now = done | (pap <= 0) | ~torch.isfinite(pap)
        alpha = torch.where(done_now, 0.0, rz / torch.where(pap > 0, pap, 1.0))
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * ap
        z = pinv(res)
        rz_new = torch.sum(res * z, dim=0)
        res2 = torch.sum(res * res, dim=0)
        broken2 = (rz_new <= 0) | ~torch.isfinite(rz_new)
        beta = torch.where(done_now | broken2, 0.0, rz_new / torch.where(rz > 0, rz, 1.0))
        p = z + beta[None, :] * p
        alphas[i] = alpha
        betas[i] = beta
        done = done_now | broken2 | (res2 <= stop2)
        rz = torch.where(done, rz, rz_new)
    return x, p, res, rz, alphas, betas, done


def kmv_cross(kernel: str, params: dict[str, Tensor], x1: Tensor, x2: Tensor,
              v: Tensor, row_panel: int = 4096) -> Tensor:
    """k(x1, x2) @ v without storing the cross Gram. v: (N2, R) -> (N1, R).

    The fused dense kernel is chosen on the TRAINING side, x2: the reference
    tests the query count x1 against 2048, which never holds for a 256-query
    bucket, so its posterior mean never reached the Pallas body in serving;
    the work here is (queries x N2) covariance entries and it is the N2 side
    that makes it worth a kernel."""
    if _fused(kernel, x2) and x1.dtype == torch.float32:
        return fused_gram.kmv_dense(kernel, params, x1, v, x2=x2)
    return fused_gram.kmv_plain(kernel, params, x1, v, x2=x2, row_panel=row_panel)


def _noise(params: dict[str, Tensor], dtype: torch.dtype) -> Tensor:
    """Likelihood noise + the dtype's relative jitter (reference convention)."""
    return torch.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(dtype) * torch.exp(params["log_variance"])


def cg_posterior_alpha(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor,
                       max_iters: int = 64, row_panel: int = 4096,
                       precond_rank: int = 32) -> Tensor:
    """alpha = (K + noise I)^{-1} y via batched PCG (matrix-free) with a
    rank-k pivoted-Cholesky preconditioner (0 disables it)."""
    noise = _noise(params, x.dtype)
    pinv = None
    if precond_rank > 0:
        pinv, _ = make_woodbury_pinv(pivoted_cholesky(kernel, params, x, precond_rank), noise)
    y2 = y[:, None] if y.ndim == 1 else y
    sol, _, _, _ = mbcg(lambda v: kmv(kernel, params, x, v, noise, row_panel), y2,
                        max_iters=max_iters, pinv=pinv)
    return sol[:, 0] if y.ndim == 1 else sol


def cg_predict(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor,
               x_test: Tensor, alpha: Tensor | None = None, max_iters: int = 64,
               row_panel: int = 4096, var_chunk: int = 256, precond_rank: int = 32,
               l_pc: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Matrix-free posterior (mean, variance) of y* at x_test.

    mean = k(x*, X) alpha; var_i = k(x*_i, x*_i) - k_i* K^{-1} k_i*^T + noise,
    with the per-query solves batched ``fit_block(S, var_chunk)`` columns at
    a time (one batched CG run per chunk)."""
    if alpha is None:
        alpha = cg_posterior_alpha(kernel, params, x, y, max_iters, row_panel, precond_rank)
    mean = kmv_cross(kernel, params, x_test, x, alpha[:, None], row_panel)[:, 0]
    noise = _noise(params, x.dtype)
    pinv = None
    if l_pc is None and precond_rank > 0:
        l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
    if l_pc is not None:
        pinv, _ = make_woodbury_pinv(l_pc, noise)
    s = x_test.shape[0]
    c = _fit_panel(s, var_chunk)
    quad_all = torch.empty((s,), dtype=x.dtype, device=x.device)
    for c0 in range(0, s, c):
        ks = K.gram(kernel, params, x, x_test[c0:c0 + c])  # (N, c) tile
        sol, _, _, _ = mbcg(lambda v: kmv(kernel, params, x, v, noise, row_panel), ks,
                            max_iters=max_iters, pinv=pinv)
        quad_all[c0:c0 + c] = torch.sum(ks * sol, dim=0)
    var = K.kdiag(kernel, params, x_test) - quad_all
    var = torch.clamp_min(var, 0.0) + torch.exp(params["log_noise_variance"])
    return mean, var
