"""Distributed matrix-free exact GP: row-sharded CG and SLQ over a mesh axis.

Port of ``gpras_tpu/parallel/pcg.py``. The single-card engine
(``gp/exact_cg.py``) with its only O(N^2) work, the matvec, sharded over the
ranks of one axis:

    (K @ V)[rows_d] = k(x[rows_d], x) @ V        on rank d

Each rank holds its rows of x and gathers the whole of x once (N x D is
small); V stays whole on every rank. Its rows of K V come from
``exact_cg.kmv_cross``, which launches kernel B2 (``fused_gram.kmv_dense``)
for a stationary kernel on a float32 CUDA tensor of at least
``exact_cg.FUSED_MIN_N`` training points, as the reference's reaches
``pallas_kmv`` on TPU; one all-gather of the (N, R) product per iteration
makes it whole again, and the CG scalars are computed from whole vectors on
every rank (the same bits everywhere), so no other collective runs in the
iteration. The preconditioner (a replicated rank-k pivoted Cholesky) and
every Woodbury apply are replicated O(N k) work.

The gradient is the single-card engine's rank-(m + 1) cotangent, contracted
against this rank's Gram rows by autograd through ``ops/kernels.gram``, one
row panel at a time (the reference holds this rank's whole (N/d, N)
cotangent strip: 17.2 GB in float32 at N = 65,536 on one card; by panels
the memory is O(panel N)), and summed over the ranks by one all-reduce.

Calling convention: ``x`` is this rank's rows (the reference's ``P(axis)``);
``y``, the right-hand sides and the draws are whole on every rank.
Randomness is an input: the Rademacher probes z (N, m), or with a
preconditioner the standard normal draws (u1 (rank, m), u2 (N, m)) from
which z = L u1 + sqrt(noise) u2 ~ N(0, P) is formed, as in
``exact_cg.make_cg_nlml``; the reference draws them from a key.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.gp import exact_cg
from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.parallel.mesh import _all_gather, _index, _psum_all
from gpras_tpu_torch.parallel.pgram import _gram_vjp

Tensor = torch.Tensor


def _local_kmv(kernel: str, params: dict[str, Tensor], x_local: Tensor, x_full: Tensor,
               v: Tensor, noise: Tensor, row_panel: int, mesh: DeviceMesh,
               axis: str) -> Tensor:
    """This rank's rows of (K + noise I) @ v: its (N/d, N) Gram strip, never
    stored, contracted with the whole v by ``exact_cg.kmv_cross`` (kernel B2
    on the card)."""
    nl = x_local.shape[0]
    row0 = _index(mesh, axis) * nl
    out = exact_cg.kmv_cross(kernel, params, x_local, x_full, v, row_panel)
    return out + noise * v[row0:row0 + nl]


@torch.no_grad()
def dist_pivoted_cholesky(mesh: DeviceMesh, kernel: str, params: dict[str, Tensor],
                          x: Tensor, rank: int, axis: str = "i") -> Tensor:
    """The rank-``rank`` pivoted-Cholesky factor of K(x, x), (N, rank), the
    same on every rank: each rank gathers x from its rows ``x`` and runs the
    single-card greedy build (``exact_cg.pivoted_cholesky``), whose pivot
    order is deterministic."""
    x_full = _all_gather(x, mesh, axis)
    return exact_cg.pivoted_cholesky(kernel, params, x_full, rank)


@torch.no_grad()
def dist_mbcg(mesh: DeviceMesh, kernel: str, params: dict[str, Tensor], x: Tensor,
              b: Tensor, noise: Tensor, max_iters: int = 32, tol: float = 1e-6,
              row_panel: int = 1024, axis: str = "i", l_pc: Tensor | None = None):
    """Batched (preconditioned) CG on (K + noise I) X = b with the matvec
    sharded over ``axis``: ``x`` is this rank's rows, ``b`` (N, R) whole.
    With ``l_pc``, a whole (N, k) pivoted-Cholesky factor, the iteration is
    PCG against P = l_pc l_pc^T + noise I (Woodbury). Returns (solution
    (N, R), alphas (k, R), betas (k, R), rz0 (R,)), the same on every rank:
    ``exact_cg.mbcg``'s iteration and freeze rules, each matvec one
    all-gather of the ranks' (N/d, R) blocks."""
    x_full = _all_gather(x, mesh, axis)
    x_local = x.contiguous()
    pinv = exact_cg.make_woodbury_pinv(l_pc, noise)[0] if l_pc is not None else None

    def matvec(v: Tensor) -> Tensor:
        local = _local_kmv(kernel, params, x_local, x_full, v.contiguous(), noise, row_panel,
                           mesh, axis)
        return _all_gather(local, mesh, axis)

    return exact_cg.mbcg(matvec, b, max_iters, tol, pinv)


def _dist_cg_solves(mesh: DeviceMesh, kernel: str, params: dict[str, Tensor], x: Tensor,
                    y: Tensor, draws, max_iters: int, precond_rank: int, row_panel: int,
                    axis: str):
    """The forward: (value, alpha, W, V, per-probe SLQ terms, logdet P),
    whole on every rank; V = P^-1 z under preconditioning, z otherwise."""
    n = y.shape[0]
    noise = exact_cg._noise(params, x.dtype)
    if precond_rank > 0:
        u1, u2 = draws
        l_pc = dist_pivoted_cholesky(mesh, kernel, params, x, precond_rank, axis=axis)
        pinv, logdet_p = exact_cg.make_woodbury_pinv(l_pc, noise)
        z = l_pc @ u1 + torch.sqrt(noise) * u2  # z ~ N(0, P)
    else:
        l_pc, pinv = None, None
        logdet_p = torch.zeros((), dtype=x.dtype, device=x.device)
        z = draws
    rhs = torch.cat([y[:, None], z], dim=1)
    sol, alphas, betas, rz0 = dist_mbcg(mesh, kernel, params, x, rhs, noise, max_iters,
                                        row_panel=row_panel, axis=axis, l_pc=l_pc)
    terms = exact_cg._slq_terms(alphas[:, 1:], betas[:, 1:], rz0[1:])
    alpha, w = sol[:, 0].contiguous(), sol[:, 1:].contiguous()
    v = pinv(z) if pinv is not None else z
    value = 0.5 * torch.dot(y, alpha) + 0.5 * (logdet_p + torch.mean(terms)) + \
        0.5 * n * math.log(2.0 * math.pi)
    return value, alpha, w, v.contiguous(), terms, logdet_p


class _DistCGNLML(torch.autograd.Function):
    """The distributed CG NLML over ``values`` (named ``names``)."""

    @staticmethod
    def forward(ctx, mesh, kernel, opts, names, x, y, draws, *values):
        max_iters, precond_rank, row_panel, axis = opts
        params = dict(zip(names, values))
        with torch.no_grad():
            value, alpha, w, v, *_ = _dist_cg_solves(mesh, kernel, params, x, y, draws,
                                                    max_iters, precond_rank, row_panel, axis)
        ctx.mesh, ctx.kernel, ctx.names, ctx.row_panel, ctx.axis = \
            mesh, kernel, names, row_panel, axis
        ctx.save_for_backward(x, alpha, w, v, *values)
        return value

    @staticmethod
    def backward(ctx, g):
        x, alpha, w, v, *values = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        params = dict(zip(ctx.names, values))
        g = g.to(x.dtype)
        inv_m = 1.0 / w.shape[1]
        nl = x.shape[0]
        row0 = _index(mesh, axis) * nl
        x_full = _all_gather(x, mesh, axis)
        acc = {k: torch.zeros_like(val) for k, val in params.items()}
        # this rank's rows of Kbar = 0.5 g [(1/m) W V^T - alpha alpha^T], a
        # panel of rows at a time
        for p0 in range(0, nl, ctx.row_panel):
            p1 = min(p0 + ctx.row_panel, nl)
            rows = slice(row0 + p0, row0 + p1)
            with torch.no_grad():
                kbar = 0.5 * g * (inv_m * (w[rows] @ v.mT) - alpha[rows, None] * alpha[None, :])
            part = _gram_vjp(ctx.kernel, params, x[p0:p1], x_full, kbar)
            for k in acc:
                acc[k] += part[k]
        # the diagonal term (noise and jitter): this rank's diagonal entries
        rows = slice(row0, row0 + nl)
        diag = 0.5 * g * (inv_m * torch.sum(w[rows] * v[rows]) - torch.sum(alpha[rows] ** 2))
        *summed, diag_sum = _psum_all(list(acc.values()) + [diag], mesh, axis)
        grads = dict(zip(acc, summed))
        grads["log_noise_variance"] = grads["log_noise_variance"] + \
            diag_sum * torch.exp(params["log_noise_variance"])
        grads["log_variance"] = grads["log_variance"] + \
            diag_sum * linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
        y_grad = g * alpha if ctx.needs_input_grad[5] else None
        return (None,) * 5 + (y_grad, None) + tuple(grads[k] for k in ctx.names)


def make_dist_cg_nlml(mesh: DeviceMesh, kernel: str, probes: int = 8, max_iters: int = 32,
                      row_panel: int = 1024, col_panel: int = 1024, axis: str = "i",
                      precond_rank: int = 0):
    """Distributed matrix-free NLML with the BBMM stochastic gradient.

    Returns ``(nlml, loss)``, each ``f(params, x, y, draws)``: ``x`` this
    rank's rows (N/d, D), ``y`` (N,) whole, ``draws`` the (N, ``probes``)
    Rademacher probes, or with ``precond_rank`` > 0 the pair (u1
    (precond_rank, probes), u2 (N, probes)) of standard normal draws. The
    value (exact quad + SLQ logdet) and the gradient (the rank-(m + 1)
    cotangent against each rank's Gram rows, one all-reduce) are the same
    on every rank; ``loss`` subtracts the log prior. With a preconditioner
    it is the single-card engine's math (``exact_cg.make_cg_nlml``) on the
    same draws. ``row_panel`` sizes the plain matvec's and the backward's
    row panels; ``col_panel`` is accepted for the reference's signature."""
    opts = (max_iters, precond_rank, row_panel, axis)

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor, draws) -> Tensor:
        m = (draws[1] if precond_rank > 0 else draws).shape[1]
        if m != probes:
            raise ValueError(f"make_dist_cg_nlml was made for {probes} probes, got {m}")
        names = tuple(params)
        return _DistCGNLML.apply(mesh, kernel, opts, names, x, y, draws,
                                 *(params[k] for k in names))

    def loss(params: dict[str, Tensor], x: Tensor, y: Tensor, draws) -> Tensor:
        return nlml(params, x, y, draws) - log_prior(params)

    return nlml, loss
