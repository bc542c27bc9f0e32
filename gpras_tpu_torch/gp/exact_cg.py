"""Matrix-free exact GP: batched (preconditioned) conjugate gradients and
stochastic Lanczos quadrature, for serving and for training.

Port of ``gpras_tpu/gp/exact_cg.py`` (GPyTorch's BBMM engine, Gardner et al.
2018): no (N, N) object is ever stored.

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
- ``make_cg_nlml`` / ``make_cg_training_loss``: the training NLML. One mbcg
  run solves K [y, Z] for the target and the m probes together; the quad
  term comes from the y column, the log-determinant from SLQ over the probe
  columns' Lanczos coefficients (``_slq_logdet_from_coeffs``), and the
  backward contracts the rank-(m + 1) cotangent with dK/dtheta without a
  Gram (``fused_gram.kgrad``: kernel B5, or B4 below 3,585 points).
- ``make_cg_step_chunked`` / ``gate_abort_decision``: the cold fit's
  evaluation (``gp/coldfit.py``): the same loss and gradient with mbcg run
  in segments, between which the host stops once every column has converged
  (the early exit, identical to running every segment) or once the
  residual gate's verdict is decided (the gate abort).
- ``slq_logdet_rr``: the Russian-roulette (randomly truncated, unbiased)
  SLQ log-determinant.

Randomness is an input: the probes (Rademacher z, or u1 (rank, m) and
u2 (N, m) normal draws from which z = L u1 + sqrt(noise) u2 is formed) and
the roulette's uniform draw, where the reference takes a PRNG key.
``precond_probes`` draws the fixed probes ``GPRAS`` trains with. ``vmap``
and ``fori_loop`` of the reference become batched ops and Python loops.

Arguments of the reference that only steer the TPU are dropped:
``row_panel``'s effect on the Pallas path, ``sub`` (the Pallas sub-tile),
``precision`` (the MXU pass count; every matmul here is full fp32 or
better) and ``col_panel`` on the kernel route (the CUDA contraction takes
the whole square). ``row_panel`` and ``col_panel`` still size the plain
loops.
"""

from __future__ import annotations

import logging
import math
from collections.abc import Callable

import torch

from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.ops.block_cholesky import fit_block as _fit_panel
from gpras_tpu_torch.utils import profiling

Tensor = torch.Tensor

_log = logging.getLogger(__name__)

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
    (pinv(v), logdet_P); the (k, k) capacitance is factorized once. A
    capacitance that does not factor (non-finite parameters) gives NaN, as
    the reference's Cholesky does, and no exception or host synchronization."""
    n, k = l.shape
    m = noise * torch.eye(k, dtype=l.dtype, device=l.device) + l.T @ l
    lm, info = torch.linalg.cholesky_ex(m)
    lm = torch.where(info == 0, lm, torch.nan)

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
    iterations; converged columns freeze through the tolerance mask.

    While a profiler records, counts ``cg.column_iters`` (R x iterations)
    and ``cg.live_column_iters``, the column-iterations before a column
    froze: a frozen column's alpha is exactly 0, so one reduction on the
    device counts the nonzero alphas."""
    if pinv is None:
        pinv = _identity
    carry, rz0, stop2 = _mbcg_init(b, max_iters, tol, pinv)
    x, _, _, _, alphas, betas, _ = _mbcg_run(matvec, carry, 0, max_iters, stop2, pinv)
    if profiling.tracing():
        profiling.count("cg.column_iters", alphas.numel())
        profiling.count("cg.live_column_iters", torch.count_nonzero(alphas))
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


# ------------------------------------------------------------------ training


def _slq_terms(alphas: Tensor, betas: Tensor, b2: Tensor) -> Tensor:
    """Per-probe SLQ terms ||z_i||^2 e1' log(T_i) e1, (m,): each probe's
    tridiagonal T rebuilt from its CG coefficients, alphas and betas (k, m),
    and eigendecomposed (``torch.linalg.eigh`` batched over the probes, in
    the input's dtype). T[0, 0] = 1 / alpha_0, T[j, j] = 1 / alpha_j +
    beta_{j-1} / alpha_{j-1}, T[j-1, j] = sqrt(beta_{j-1}) / alpha_{j-1}.
    Frozen steps (alpha = 0) are padded with identity rows, whose log
    eigenvalue 0 adds nothing; an off-diagonal entry exists only when both
    its nodes are active (a column frozen by breakdown records an O(1) beta
    just before it freezes, which would otherwise couple the last Lanczos
    node into the padding and move every Ritz value)."""
    a, bt = alphas.mT, betas.mT  # (m, k)
    active = a > 0
    safe_a = torch.where(active, a, 1.0)
    diag = 1.0 / safe_a
    diag[:, 1:] += torch.where(active[:, :-1], bt[:, :-1] / safe_a[:, :-1], 0.0)
    off = torch.where(active[:, :-1] & active[:, 1:],
                      torch.sqrt(torch.clamp_min(bt[:, :-1], 0.0)) / safe_a[:, :-1], 0.0)
    diag = torch.where(active, diag, 1.0)  # identity padding
    t = torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    evals, evecs = torch.linalg.eigh(t)
    w = evecs[:, 0, :] ** 2
    return b2 * torch.sum(w * torch.log(torch.clamp_min(evals, 1e-30)), dim=-1)


def _slq_logdet_from_coeffs(alphas: Tensor, betas: Tensor, b2: Tensor) -> Tensor:
    """Stochastic Lanczos quadrature: the mean of ``_slq_terms`` over the m
    probe columns (alphas, betas (k, m); b2 (m,), the probes' squared norms
    in the preconditioner's metric)."""
    return torch.mean(_slq_terms(alphas, betas, b2))


def precond_probes(n: int, rank: int, probes: int = 16, dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None,
                   gen: torch.Generator | None = None) -> tuple[Tensor, Tensor]:
    """(u1 (rank, probes), u2 (n, probes)) standard normal draws from ``gen``
    (default: a ``torch.Generator`` seeded 0), drawn on the CPU and then
    moved, so they are the same on every device: the fixed probes of the
    preconditioned CG loss (z = L u1 + sqrt(noise) u2 is formed from them at
    every evaluation)."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    u1 = torch.randn((rank, probes), generator=gen, dtype=torch.float64)
    u2 = torch.randn((n, probes), generator=gen, dtype=torch.float64)
    profiling.count("host_reads", 2)  # the copies up wait for the device's queue
    return u1.to(dtype=dtype, device=device), u2.to(dtype=dtype, device=device)


def _probe_matrix(kernel: str, params: dict[str, Tensor], x: Tensor, draws, noise: Tensor,
                  precond_rank: int):
    """(z (N, m), pinv, logdet P): with a rank-k preconditioner P = L L^T +
    noise I, z = L u1 + sqrt(noise) u2 ~ N(0, P) from ``draws`` = (u1, u2);
    without one, ``draws`` is z itself (Rademacher), P = I."""
    if precond_rank > 0:
        u1, u2 = draws
        l_pc = pivoted_cholesky(kernel, params, x, precond_rank)
        pinv, logdet_p = make_woodbury_pinv(l_pc, noise)
        return l_pc @ u1 + torch.sqrt(noise) * u2, pinv, logdet_p
    return draws, _identity, torch.zeros((), dtype=x.dtype, device=x.device)


def _cg_solves(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor, draws,
               max_iters: int, precond_rank: int, residual_gate: float | None, row_panel: int):
    """The training loss's forward: (value, alpha, W, V, per-probe SLQ terms,
    logdet P, relative residuals of every column). One mbcg run of
    ``max_iters`` iterations at tolerance 1e-6 over b = [y, z]. No host
    synchronization: the gate stays on the device."""
    n = x.shape[0]
    noise = _noise(params, x.dtype)
    z, pinv, logdet_p = _probe_matrix(kernel, params, x, draws, noise, precond_rank)
    b = torch.cat([y[:, None], z], dim=1)
    carry, rz0, stop2 = _mbcg_init(b, max_iters, 1e-6, pinv)
    sol, _, res, _, alphas, betas, _ = _mbcg_run(
        lambda v: kmv(kernel, params, x, v, noise, row_panel), carry, 0, max_iters, stop2, pinv)
    # the mbcg solution's columns are strided views; the kernels take rows
    alpha, w = sol[:, 0].contiguous(), sol[:, 1:].contiguous()
    terms = _slq_terms(alphas[:, 1:], betas[:, 1:], rz0[1:])
    v = pinv(z) if precond_rank > 0 else z
    value = 0.5 * torch.dot(y, alpha) + 0.5 * (logdet_p + torch.mean(terms)) + \
        0.5 * n * math.log(2.0 * math.pi)
    rel = torch.sqrt(torch.sum(res * res, dim=0) / torch.clamp_min(torch.sum(b * b, dim=0), 1e-30))
    if residual_gate is not None:
        value = torch.where(torch.max(rel) > residual_gate, torch.inf, value)
    return value, alpha, w, v.contiguous(), terms, logdet_p, rel


def _cotangent_grads(kernel: str, params: dict[str, Tensor], x: Tensor, alpha: Tensor,
                     w: Tensor, v: Tensor, g: Tensor, inv_m: float,
                     col_panel: int = 4096) -> dict[str, Tensor]:
    """dNLML/dparams from the rank-(m + 1) cotangent
    Kbar = g/2 [inv_m W V^T - alpha alpha^T] (V = P^-1 z under
    preconditioning, z otherwise: tr(K^-1 dK) = E[(K^-1 z)^T dK (P^-1 z)]
    for z ~ N(0, P)). Kernels B5/B4 (``fused_gram.kgrad``) on the fused route,
    the reference's panel loop (``fused_gram.kgrad_plain``) otherwise; then
    the noise and jitter diagonal, sum_i Kbar_ii times their derivatives."""
    diag_sum = 0.5 * g * (inv_m * torch.sum(w * v) - torch.sum(alpha * alpha))
    if _fused(kernel, x):
        grads = {k: torch.zeros_like(val) for k, val in params.items()}
        grads.update(fused_gram.kgrad(kernel, params, x, w, v, alpha, g, inv_m))
    else:
        grads = fused_gram.kgrad_plain(kernel, params, x, w, v, alpha, g, inv_m, col_panel)
    grads["log_noise_variance"] = grads["log_noise_variance"] + \
        diag_sum * torch.exp(params["log_noise_variance"])
    grads["log_variance"] = grads["log_variance"] + \
        diag_sum * linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
    return grads


class _CGNLML(torch.autograd.Function):
    """The CG NLML over the parameters ``values`` (named ``names``); saves
    alpha, W and V for the backward. The preconditioner and the probes get
    no gradient, as in the reference's custom VJP."""

    @staticmethod
    def forward(ctx, kernel, opts, names, x, y, draws, *values):
        params = dict(zip(names, values))
        value, alpha, w, v, *_ = _cg_solves(kernel, params, x, y, draws, *opts)
        ctx.kernel, ctx.names = kernel, names
        ctx.save_for_backward(x, alpha, w, v, *values)
        return value

    @staticmethod
    def backward(ctx, g):
        x, alpha, w, v, *values = ctx.saved_tensors
        params = dict(zip(ctx.names, values))
        g = g.to(x.dtype)  # Adam reads the loss in the engine's dtype, the tests in float64
        grads = _cotangent_grads(ctx.kernel, params, x, alpha, w, v, g, 1.0 / w.shape[1])
        y_grad = g * alpha if ctx.needs_input_grad[4] else None
        return (None, None, None, None, y_grad, None, *(grads[k] for k in ctx.names))


def make_cg_nlml(kernel: str, probes: int = 16, max_iters: int = 32, row_panel: int = 4096,
                 precond_rank: int = 0, residual_gate: float | None = None):
    """Returns ``nlml(params, x, y, draws)``: the matrix-free NLML with its
    stochastic backward. ``draws``: with ``precond_rank`` > 0 the pair
    (u1 (rank, probes), u2 (N, probes)) of standard normal draws, from which
    z = L u1 + sqrt(noise) u2 ~ N(0, P) is formed at the current parameters
    (P = L L^T + noise I, L the rank-k pivoted Cholesky), and
    logdet K = logdet P + E[(z^T P^-1 z) e1' log(T) e1]; otherwise the
    (N, probes) Rademacher probes z. The value is quad + logdet / 2 +
    N log(2 pi) / 2; the quad term is exact up to the CG tolerance, the
    log-determinant and the gradient's trace term are stochastic.
    ``residual_gate``: when any column's final relative CG residual exceeds
    it, the value is +inf (a linesearch then rejects the point). Differentiable
    with respect to the parameters and y."""
    opts = (max_iters, precond_rank, residual_gate, row_panel)

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor, draws) -> Tensor:
        m = (draws[1] if precond_rank > 0 else draws).shape[1]
        if m != probes:
            raise ValueError(f"make_cg_nlml was made for {probes} probes, got {m}")
        names = tuple(params)
        return _CGNLML.apply(kernel, opts, names, x, y, draws, *(params[k] for k in names))

    return nlml


def make_cg_training_loss(kernel: str, probes: int = 16, max_iters: int = 32, **kwargs):
    """``loss(params, x, y, draws)``: the CG NLML minus the log prior."""
    nlml = make_cg_nlml(kernel, probes, max_iters, **kwargs)

    def loss(params: dict[str, Tensor], x: Tensor, y: Tensor, draws) -> Tensor:
        return nlml(params, x, y, draws) - log_prior(params)

    return loss


def gate_abort_decision(rel_hist: list[float], rel: float, segs_ran: int,
                        n_segs: int, gate: float) -> bool:
    """The segmented step's gate-abort rule, a pure host-side predicate.

    Abort (True) only when both hold:
    - the decay is near-stalled: the best per-segment improvement ratio seen
      in this solve is >= 0.9 (a solve that once decayed faster may be mid
      Ritz-value convergence and can accelerate again, so it is never
      aborted);
    - even projecting that best ratio over every remaining segment leaves
      the final residual above 4x the gate.

    CG's decay accelerates late (superlinearly as Ritz values converge), so
    a solve with any sub-0.9 segment is left to run; a solve frozen by
    convergence or breakdown is caught by the early exit, not by this rule.
    """
    if segs_ran < 4:
        return False  # the projection needs history to mean anything
    ratios = [rel_hist[i + 1] / rel_hist[i]
              for i in range(len(rel_hist) - 1) if rel_hist[i] > 0]
    r_best = min(1.0, min(ratios)) if ratios else 1.0
    if r_best < 0.9:
        return False  # decay not stalled: late acceleration is plausible
    projected = rel * r_best ** (n_segs - segs_ran)
    return projected > 4.0 * gate


def _post(vals: Tensor):
    """Start copying a small device tensor to the host without waiting:
    (host tensor, event to wait on, or None on the CPU)."""
    if not vals.is_cuda:
        return vals, None
    host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _fetch(posted) -> list:
    host, event = posted
    profiling.count("host_reads")
    if event is not None:
        event.synchronize()
    return host.tolist()


def make_cg_step_chunked(kernel: str, probes: int = 127, max_iters: int = 24,
                         seg_iters: int = 4, col_panel: int = 4096, tol: float = 1e-6,
                         precond_rank: int = 0, residual_gate: float | None = None,
                         early_exit: bool = True, gate_abort: bool = True,
                         row_panel: int = 4096):
    """Training-loss value and gradient of the CG engine, with the mbcg
    iterations run as ``seg_iters``-iteration segments between which the
    host may stop.

    Returns ``step(params, x, y, draws) -> (loss, grads)``: ``draws`` as
    ``make_cg_nlml`` takes them ((u1, u2) normal draws with
    ``precond_rank`` > 0, forming z = L u1 + sqrt(noise) u2 ~ N(0, P);
    Rademacher z otherwise). ``setup`` forms the probes, the preconditioner
    and mbcg's initial carry at tolerance ``tol``; the segments run mbcg's
    iterations [i0, i0 + seg_iters); ``finish`` reads the carry: quad + logdet
    / 2 + N log(2 pi) / 2 - log prior (logdet = logdet P + SLQ over the probe
    columns), +inf when any column's relative residual exceeds
    ``residual_gate``, and the gradient from the rank-(m + 1) cotangent
    (``_cotangent_grads``: B5, or B4 below 3,585 points, on the kernel
    route) minus the log prior's.

    ``residual_gate`` defines the solver-validity region: a linesearch on a
    truncated CG + SLQ objective finds hyperparameter regions where the
    unconverged estimator is biased far below the true NLML, and the gate
    makes those regions rejected trials instead of false minima.

    ``early_exit`` (default on): between segments the host reads whether
    every column has converged to ``tol`` (or frozen on breakdown) and stops
    running segments once they have. That is identical to running them: a
    fully frozen carry is a fixed point of the mbcg iteration on every
    output ``finish`` reads (alpha and beta are 0, so x, the residual, rz
    and the coefficient rows stay as they are; only the unused search
    direction moves).

    ``gate_abort`` (default on; only with a ``residual_gate``): stop running
    segments once the gate's outcome is decided (``gate_abort_decision``);
    each abort is logged (module logger, INFO) with the residual, the gate
    and the recent history. ``finish`` then gates the returned loss to +inf
    on the current, still above-gate residuals, as the full budget would.

    The host reads one (all frozen, largest relative residual) pair per
    segment, lagging one segment behind: segment k + 1 is already queued
    when segment k's pair is read, so the card does not wait on the read.
    Stopping one segment late changes nothing (a frozen carry is a fixed
    point; the abort's loss is +inf either way). ``step.last_segments`` is
    the number of segments the last call ran (single-threaded diagnostic).
    """
    if max_iters % seg_iters != 0:
        raise ValueError(f"seg_iters {seg_iters} must divide max_iters {max_iters}")
    from gpras_tpu_torch.fit.optimizers import value_and_grad

    inv_m = 1.0 / probes
    n_segs = max_iters // seg_iters

    def step(params: dict[str, Tensor], x: Tensor, y: Tensor, draws):
        params = {k: v.detach() for k, v in params.items()}
        with torch.no_grad():
            # setup
            n = x.shape[0]
            noise = _noise(params, x.dtype)
            z, pinv, logdet_p = _probe_matrix(kernel, params, x, draws, noise, precond_rank)
            b = torch.cat([y[:, None], z], dim=1)
            carry, rz0, stop2 = _mbcg_init(b, max_iters, tol, pinv)
            b2 = torch.clamp_min(torch.sum(b * b, dim=0), 1e-30)

            def mv(v: Tensor) -> Tensor:
                return kmv(kernel, params, x, v, noise, row_panel)

            # segments
            ran = 0
            rel_hist: list[float] = []
            check = early_exit or (gate_abort and residual_gate is not None)
            prev_probe = None
            prev_ran = 0
            for k, i0 in enumerate(range(0, max_iters, seg_iters)):
                carry = _mbcg_run(mv, carry, i0, i0 + seg_iters, stop2, pinv)
                ran = k + 1
                if not check or ran >= n_segs:
                    continue
                res, done = carry[2], carry[6]
                rel = torch.sqrt(torch.max(torch.sum(res * res, dim=0) / b2))
                cur = _post(torch.stack([torch.all(done).to(rel.dtype), rel]))
                stop = False
                if prev_probe is not None:
                    all_done, rel_v = _fetch(prev_probe)
                    if early_exit and all_done:
                        stop = True
                    elif gate_abort and residual_gate is not None:
                        rel_hist.append(rel_v)
                        if gate_abort_decision(rel_hist, rel_v, prev_ran, n_segs,
                                               residual_gate):
                            _log.info("cg gate_abort at segment %d/%d: rel=%.3g gate=%.3g "
                                      "history=%s", prev_ran, n_segs, rel_v, residual_gate,
                                      ["%.3g" % r for r in rel_hist[-4:]])
                            stop = True  # finish()'s gate fires on these residuals
                if stop:
                    break
                prev_probe, prev_ran = cur, ran
            step.last_segments = ran

            # finish
            sol, _, res, _, alphas, betas, _ = carry
            alpha, w = sol[:, 0].contiguous(), sol[:, 1:].contiguous()
            logdet = logdet_p + _slq_logdet_from_coeffs(alphas[:, 1:], betas[:, 1:], rz0[1:])
            loss = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi) \
                - log_prior(params)
            if residual_gate is not None:
                rel2 = torch.sum(res * res, dim=0) / b2
                loss = torch.where(torch.max(rel2) > residual_gate * residual_gate,
                                   torch.inf, loss)
            v = (pinv(z) if precond_rank > 0 else z).contiguous()
            grads = _cotangent_grads(kernel, params, x, alpha, w, v,
                                     torch.ones((), dtype=x.dtype, device=x.device), inv_m,
                                     col_panel)
        _, prior_grads = value_and_grad(log_prior, params)
        return loss, {k: grads[k] - prior_grads[k] for k in grads}

    step.last_segments = 0
    return step


def rr_depth(u: float, q: float = 0.6, n_tail: int = 8) -> int:
    """The roulette's truncation J = min(G, n_tail), P(G >= j) = q^j, from one
    uniform draw ``u`` (the reference's host-side sample)."""
    return min(int(math.floor(math.log(max(u, 1e-30)) / math.log(q))), n_tail)


def slq_logdet_rr(kernel: str, params: dict[str, Tensor], x: Tensor, draws, j_trunc: int,
                  base_iters: int = 16, seg_iters: int = 8, q: float = 0.6,
                  precond_rank: int = 0) -> Tensor:
    """Russian-roulette SLQ: an unbiased estimate of the depth
    ``base_iters + n_tail * seg_iters`` quadrature of logdet(K + noise I).

    Telescopes the quadrature over the depths k_j = base + j seg,
    Q_K = Q_0 + sum_j (Q_j - Q_{j-1}), truncates at J = ``j_trunc`` (the
    caller's draw: ``rr_depth`` of a uniform, as the reference samples it on
    the host), runs mbcg only to depth k_J and reweights the surviving
    increments by 1 / q^j. ``draws`` are the probes as ``make_cg_nlml`` takes
    them; the preconditioned path adds the analytic logdet P. Returns a
    scalar."""
    noise = _noise(params, x.dtype)
    depth = base_iters + j_trunc * seg_iters
    z, pinv, logdet_p = _probe_matrix(kernel, params, x, draws, noise, precond_rank)
    _, alphas, betas, rz0 = mbcg(lambda v: kmv(kernel, params, x, v, noise), z,
                                 max_iters=depth, tol=1e-12,
                                 pinv=pinv if precond_rank > 0 else None)

    def q_at(k_nodes: int) -> Tensor:
        keep = (torch.arange(depth, device=x.device) < k_nodes).to(alphas.dtype)[:, None]
        return _slq_logdet_from_coeffs(alphas * keep, betas * keep, rz0)

    qs = [q_at(base_iters + j * seg_iters) for j in range(j_trunc + 1)]
    est = qs[0]
    for j in range(1, j_trunc + 1):
        est = est + (qs[j] - qs[j - 1]) / (q ** j)
    return est + logdet_p
