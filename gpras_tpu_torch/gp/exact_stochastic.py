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

Routes, as in the reference with "tpu" read as "cuda":
- forward Gram: kernel B1 (``fused_gram.gram``) when ``fused_gram`` is set
  (``GPRAS`` sets it above 16,384 points, as the reference's
  ``default_chol_config`` does), the kernel stationary and the data float32;
  ``kernels.gram`` plus the noise diagonal otherwise;
- factor: ``torch.linalg.cholesky_ex`` (cuSOLVER on the card). A matrix
  that does not factor gives a NaN loss and NaN gradients, never an
  exception, as ``jnp.linalg.cholesky``'s NaN factor does. The reference's
  in-place ``super_cholesky`` and ``blocked_cholesky`` are not ported;
- backward contraction: kernels B4/B5 (``fused_gram.kgrad``) for N >= 2048,
  a stationary kernel, float32 and a CUDA tensor; the reference's panel loop
  (``fused_gram.kgrad_plain``) otherwise.
"""

from __future__ import annotations

import math

import torch

from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg

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
    return (2 * bits - 1).to(dtype=dtype, device=device)


def _kernel_route(kernel: str, x: Tensor) -> bool:
    return (x.shape[0] >= 2048 and kernel in K.STATIONARY_KERNELS
            and x.dtype == torch.float32 and x.is_cuda)


def _forward(kernel: str, fused: bool, params: dict[str, Tensor], x: Tensor, y: Tensor):
    """(NLML, L, alpha), or None when K + noise I does not factor."""
    n = x.shape[0]
    noise = torch.exp(params["log_noise_variance"])
    jitter = linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
    if fused and kernel in K.STATIONARY_KERNELS and x.dtype == torch.float32:
        k = fused_gram.gram(kernel, params, x, noise=noise + jitter)
    else:
        k = fused_gram.gram_plain(kernel, params, x, noise=noise + jitter)
    l, info = torch.linalg.cholesky_ex(k)
    del k  # K and its factor are 9.66 GB each at N = 49,152 in float32
    if int(info) != 0:
        return None
    alpha = torch.cholesky_solve(y[:, None], l)[:, 0]
    quad = 0.5 * torch.dot(y, alpha)
    out = quad + 0.5 * linalg.logdet_from_chol(l) + 0.5 * n * math.log(2.0 * math.pi)
    return out, l, alpha


class _HutchinsonNLML(torch.autograd.Function):
    """NLML over the parameters ``values`` (named ``names``); saves only the
    factor L and alpha for the backward."""

    @staticmethod
    def forward(ctx, kernel, fused, names, x, y, z, *values):
        ctx.kernel, ctx.names = kernel, names
        res = _forward(kernel, fused, dict(zip(names, values)), x, y)
        if res is None:
            ctx.failed = True
            ctx.save_for_backward(*values)
            return torch.full((), float("nan"), dtype=x.dtype, device=x.device)
        out, l, alpha = res
        ctx.failed = False
        ctx.save_for_backward(x, z, l, alpha, *values)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.failed:
            return (None,) * 6 + tuple(torch.full_like(v, float("nan"))
                                       for v in ctx.saved_tensors)
        x, z, l, alpha, *values = ctx.saved_tensors
        kernel = ctx.kernel
        params = dict(zip(ctx.names, values))
        g = g.to(x.dtype)
        inv_m = 1.0 / z.shape[1]
        # (N, m): W = K^-1 Z, made row-major for the kernel (cuSOLVER's is not)
        w = torch.cholesky_solve(z, l).contiguous()
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


def make_hutchinson_nlml(kernel: str, fused_gram: bool = False):
    """Returns ``nlml(params, x, y, z)`` with the stochastic backward; ``z``
    is the (N, m) probe matrix. ``fused_gram`` builds the forward Gram with
    kernel B1."""

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor, z: Tensor) -> Tensor:
        names = tuple(params)
        return _HutchinsonNLML.apply(kernel, fused_gram, names, x, y, z,
                                     *(params[k] for k in names))

    return nlml


def make_hutchinson_training_loss(kernel: str, fused_gram: bool = False):
    """``loss(params, x, y, z)``: the Hutchinson NLML minus the log prior."""
    nlml = make_hutchinson_nlml(kernel, fused_gram)

    def loss(params: dict[str, Tensor], x: Tensor, y: Tensor, z: Tensor) -> Tensor:
        return nlml(params, x, y, z) - log_prior(params)

    return loss
