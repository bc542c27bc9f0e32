"""Stochastic-trace (Hutchinson) backward for the exact-GP NLML at large N.

Port of ``gpras_tpu/gp/exact_stochastic.py``. The exact gradient needs
tr(K^-1 dK/dtheta), an O(N^3) inverse per step; Adam tolerates the unbiased
estimate (1/m) sum_i (K^-1 z_i)^T dK z_i over Rademacher probes z_i
(GPyTorch's BBMM). With the factor from the forward, the backward is one
(N, m) Cholesky solve, W = K^-1 Z, and one pass over the Gram contracting it
against the rank-(m+1) cotangent 0.5 g [(1/m) W Z^T - alpha alpha^T].

The loss value is exact (the log-determinant comes from the factor); only
the trace term of the gradient is stochastic. The probes are an input: the
caller draws them once (``rademacher_probes``, a generator seeded 0, the
counterpart of the reference's fixed ``PRNGKey(0)``), so the objective is
deterministic.

Routes, as in the reference with "tpu" read as "cuda", picked by ``chol``
(``default_chol_config(n)`` gives the reference's choice for N points):
- ``"xla"``: the library factorization, ``torch.linalg.cholesky_ex``
  (cuSOLVER on the card), and ``torch.cholesky_solve``; the forward Gram is
  ``kernels.gram`` plus the noise diagonal. K and L are two (N, N) buffers
  while it factors;
- ``"super"``: kernel B1 (``fused_gram.gram``, the noise added in the
  kernel) builds K as one buffer when the kernel is stationary and the data
  float32, ``ops/block_cholesky.super_cholesky`` factors it in place, and
  ``blocked_cho_solve`` solves: one (N, N) buffer in all;
- ``"blocked"``: ``blocked_cholesky`` and ``blocked_cho_solve``.
A matrix that does not factor gives a NaN loss and NaN gradients, never an
exception, as ``jnp.linalg.cholesky``'s NaN factor does. The backward
contraction is kernels B4/B5 (``fused_gram.kgrad``) for N >= 2048, a
stationary kernel, float32 and a CUDA tensor; the reference's panel loop
(``fused_gram.kgrad_plain``) otherwise.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import NamedTuple

import torch

from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import block_cholesky as bc
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.utils.profiling import count, current, span

Tensor = torch.Tensor


def rademacher_probes(n: int, probes: int = 16, dtype: torch.dtype = torch.float32,
                      device: str | torch.device | None = None,
                      gen: torch.Generator | None = None) -> Tensor:
    """(n, probes) Rademacher +-1 probes from ``gen`` (default: a
    ``torch.Generator`` seeded 0), drawn on the CPU: one fixed probe set per
    problem size, so the objective is deterministic."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (n, probes), generator=gen)
    count("host_reads")  # the copy up waits for the device's queue
    return (2 * bits - 1).to(dtype=dtype, device=device)


def _kernel_route(kernel: str, x: Tensor) -> bool:
    return (x.shape[0] >= 2048 and kernel in K.STATIONARY_KERNELS
            and x.dtype == torch.float32 and x.is_cuda)


class _Factor(NamedTuple):
    """How an exact engine's forward builds, factors and solves K + noise I:
    ``fused`` builds K with kernel B1 (a stationary kernel, float32), ``chol``
    factors it (the lower triangle of its result is L), ``solve(l, rhs)``
    solves (L L^T) x = rhs."""
    fused: bool
    chol: Callable[[Tensor], Tensor]
    solve: Callable[[Tensor, Tensor], Tensor]


def _cholesky_ex(k: Tensor) -> Tensor:
    """The library factor; NaN where K does not factor, as the reference's
    ``jnp.linalg.cholesky`` returns."""
    l, info = torch.linalg.cholesky_ex(k)
    count("host_reads")
    if int(info) != 0:
        l.fill_(float("nan"))
    return l


_XLA = _Factor(False, _cholesky_ex, lambda l, rhs: torch.cholesky_solve(rhs, l))


def _super_factor(chol_w: int, chol_strip: int) -> _Factor:
    """B1's one-buffer Gram, ``super_cholesky`` in place (panels of the
    largest divisor of N at or below ``chol_w``, stale upper triangle left)
    and the blocked solves."""
    return _Factor(True, lambda k: bc.super_cholesky(k, bc.fit_block(k.shape[0], chol_w),
                                                     chol_strip, zero_upper=False),
                   lambda l, rhs: bc.blocked_cho_solve(l, rhs, 512))


def _forward(kernel: str, factor: _Factor, params: dict[str, Tensor], x: Tensor, y: Tensor):
    """(NLML, L, alpha) of K + (noise + jitter) I, built, factored and
    solved as ``factor`` says."""
    n = x.shape[0]
    noise = torch.exp(params["log_noise_variance"])
    jitter = linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
    with span("fit.gram"):
        if factor.fused and kernel in K.STATIONARY_KERNELS and x.dtype == torch.float32:
            k = fused_gram.gram(kernel, params, x, noise=noise + jitter)
        else:
            k = fused_gram.gram_plain(kernel, params, x, noise=noise + jitter)
    with span("fit.factor"):
        l = factor.chol(k)
    del k  # K and L are 9.66 GB each at N = 49,152 in float32 unless chol is in place
    with span("fit.solve"):
        alpha = factor.solve(l, y[:, None])[:, 0]
        quad = 0.5 * torch.dot(y, alpha)
        out = quad + 0.5 * linalg.logdet_from_chol(l) + 0.5 * n * math.log(2.0 * math.pi)
    return out, l, alpha


class _HutchinsonNLML(torch.autograd.Function):
    """NLML over the parameters ``values`` (named ``names``); saves only the
    factor L and alpha for the backward."""

    @staticmethod
    def forward(ctx, kernel, factor, names, x, y, z, *values):
        ctx.kernel, ctx.factor, ctx.names = kernel, factor, names
        # the backward runs on autograd's device thread: it joins this span there
        ctx.span = current()
        out, l, alpha = _forward(kernel, factor, dict(zip(names, values)), x, y)
        ctx.save_for_backward(x, z, l, alpha, *values)
        return out

    @staticmethod
    def backward(ctx, g):
        with span("fit.backward", parent=ctx.span):
            return _HutchinsonNLML._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        x, z, l, alpha, *values = ctx.saved_tensors
        kernel = ctx.kernel
        params = dict(zip(ctx.names, values))
        g = g.to(x.dtype)
        inv_m = 1.0 / z.shape[1]
        # (N, m): W = K^-1 Z, made row-major for the kernel (cuSOLVER's is not)
        w = ctx.factor.solve(l, z).contiguous()
        # the noise and jitter diagonal: sum_i Kbar_ii times d(noise + jitter)
        diag_sum = 0.5 * g * (inv_m * torch.sum(w * z) - torch.sum(alpha * alpha))
        if _kernel_route(kernel, x):
            grads = {k: torch.zeros_like(v) for k, v in params.items()}
            grads.update(fused_gram.kgrad(kernel, params, x, w, z, alpha, g, inv_m))
        else:
            grads = fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, g, inv_m)
        grads["log_noise_variance"] = grads["log_noise_variance"] + \
            diag_sum * torch.exp(params["log_noise_variance"])
        grads["log_variance"] = grads["log_variance"] + \
            diag_sum * linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
        y_grad = g * alpha if ctx.needs_input_grad[4] else None
        return (None, None, None, None, y_grad, None,
                *(grads[k] for k in ctx.names))


def make_hutchinson_nlml(kernel: str, chol: str = "xla", chol_w: int = 2048,
                         chol_strip: int = 16384):
    """Returns ``nlml(params, x, y, z)`` with the stochastic backward; ``z``
    is the (N, m) probe matrix. ``chol`` picks the factorization (the
    module's docstring): ``"xla"``, ``"super"`` (panels of ``chol_w``
    columns, trailing strips of ``chol_strip``) or ``"blocked"`` (blocks of
    ``chol_w``, which must divide N)."""
    if chol == "super":
        factor = _super_factor(chol_w, chol_strip)
    elif chol == "blocked":
        factor = _Factor(False, lambda k: bc.blocked_cholesky(k, chol_w),
                         lambda l, rhs: bc.blocked_cho_solve(l, rhs, 512))
    elif chol == "xla":
        factor = _XLA
    else:
        raise ValueError(f"unknown chol {chol!r}; expected xla|super|blocked")

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor, z: Tensor) -> Tensor:
        names = tuple(params)
        return _HutchinsonNLML.apply(kernel, factor, names, x, y, z,
                                     *(params[k] for k in names))

    return nlml


def make_hutchinson_training_loss(kernel: str, **chol_kwargs):
    """``loss(params, x, y, z)``: the Hutchinson NLML minus the log prior;
    ``chol_kwargs`` go to ``make_hutchinson_nlml``."""
    nlml = make_hutchinson_nlml(kernel, **chol_kwargs)

    def loss(params: dict[str, Tensor], x: Tensor, y: Tensor, z: Tensor) -> Tensor:
        return nlml(params, x, y, z) - log_prior(params)

    return loss


def default_chol_config(n: int) -> dict:
    """The reference's factorization knobs for problem size ``n``, shared by
    ``GPRAS`` and ``gp/coldfit``: the in-place engine above 16,384 points,
    panels of 2,048 columns and strips of 16,384 below 32,768 points, 512 and
    2,048 from there (the reference's measurements on a 16 GB TPU; they are
    kept for parity, not re-derived for the card)."""
    return {
        "chol": "super" if n > 16384 else "xla",
        "chol_strip": 16384 if n <= 32768 else 2048,
        "chol_w": 2048 if n < 32768 else 512,
    }
