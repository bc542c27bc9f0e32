"""Exact Gaussian-process regression: the dense NLML and posterior.

Port of ``gpras_tpu/gp/exact.py``. ``quad_logdet`` is the one custom-gradient
boundary: its forward factorizes K once and its backward reuses the factor
(the adjoint of 0.5 y^T K^-1 y + 0.5 logdet K is 0.5 (K^-1 - alpha alpha^T)).
The gradient with respect to the kernel hyperparameters then flows through
``kernels.gram`` by autograd, as in the reference.

Where the reference's ``jnp.linalg.cholesky`` returns NaN on a matrix that is
not positive definite, ``torch.linalg.cholesky`` raises; the port factors
with ``cholesky_ex`` and turns a failure into a NaN loss and NaN gradients,
which the optimizers' non-finite step rejection relies on.
"""

from __future__ import annotations

import math

import torch

from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg

Tensor = torch.Tensor


class _QuadLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, y):
        l, info = torch.linalg.cholesky_ex(k)
        if int(info) != 0:
            ctx.failed = True
            ctx.save_for_backward(k, y)
            return torch.full((y.shape[1],), float("nan"), dtype=k.dtype, device=k.device)
        ctx.failed = False
        alpha = torch.cholesky_solve(y, l)
        ctx.save_for_backward(l, alpha)
        quad = 0.5 * torch.sum(y * alpha, dim=0)
        return quad + 0.5 * linalg.logdet_from_chol(l)

    @staticmethod
    def backward(ctx, g):
        if ctx.failed:
            k, y = ctx.saved_tensors
            return torch.full_like(k, float("nan")), torch.full_like(y, float("nan"))
        l, alpha = ctx.saved_tensors
        kinv = linalg.inv_from_chol(l)
        k_bar = 0.5 * (torch.sum(g) * kinv - (alpha * g[None, :]) @ alpha.mT)
        return k_bar, alpha * g[None, :]


def quad_logdet(k: Tensor, y: Tensor) -> Tensor:
    """Per-output 0.5 y_p^T K^-1 y_p + 0.5 logdet K, shape (P,); ``k`` (N, N)
    with the noise on its diagonal, ``y`` (N, P). NaN where K does not
    factor."""
    return _QuadLogdet.apply(k, y)


def build_train_gram(kernel: str, params: dict[str, Tensor], x: Tensor, *,
                     jitter: float | None = None) -> Tensor:
    """K(x, x) + (noise_variance + jitter * variance) * I."""
    noise = torch.exp(params["log_noise_variance"])
    k = K.gram(kernel, params, x)
    if jitter is None:
        jitter = linalg.default_jitter(k.dtype)
    variance = torch.exp(params["log_variance"])
    return k + (noise + jitter * variance) * torch.eye(x.shape[0], dtype=k.dtype,
                                                       device=k.device)


def nlml(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
    """Negative log marginal likelihood, summed over the columns of ``y``
    ((N,) or (N, P), one kernel shared by the outputs)."""
    y2 = y[:, None] if y.ndim == 1 else y
    n, p = y2.shape
    k = build_train_gram(kernel, params, x)
    return torch.sum(quad_logdet(k, y2)) + 0.5 * p * n * math.log(2.0 * math.pi)


def training_loss(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
    """NLML minus the log prior: the objective the reference optimizes."""
    return nlml(kernel, params, x, y) - log_prior(params)


def predict(kernel: str, params: dict[str, Tensor], x_train: Tensor, y_train: Tensor,
            x_test: Tensor, include_noise: bool = True) -> tuple[Tensor, Tensor]:
    """Posterior mean and variance at ``x_test``; (S,) or (S, P) following
    y_train. ``include_noise`` gives the observation-space variance."""
    y2 = y_train[:, None] if y_train.ndim == 1 else y_train
    k = build_train_gram(kernel, params, x_train)
    l = torch.linalg.cholesky(k)
    alpha = linalg.cho_solve(l, y2)
    ks = K.gram(kernel, params, x_test, x_train)  # (S, N)
    mean = ks @ alpha
    v = linalg.solve_triangular(l, ks.T, lower=True)  # (N, S)
    var = torch.clamp_min(K.kdiag(kernel, params, x_test) - torch.sum(v * v, dim=0), 0.0)
    if include_noise:
        var = var + torch.exp(params["log_noise_variance"])
    var = var[:, None].expand(mean.shape)
    if y_train.ndim == 1:
        return mean[:, 0], var[:, 0]
    return mean, var


def init_params(kernel: str, x: Tensor, noise_variance: float = 1.0,
                variance: float = 1.0,
                lengthscales: float | Tensor | None = None) -> dict[str, Tensor]:
    """Reference heuristic: variance 1, lengthscale mean(|x|), noise variance 1."""
    if lengthscales is None:
        lengthscales = torch.mean(torch.abs(x))
    p = K.init_params(kernel, x.shape[-1], variance=variance, lengthscales=lengthscales,
                      dtype=x.dtype, device=x.device)
    p["log_noise_variance"] = torch.tensor(math.log(noise_variance), dtype=x.dtype,
                                           device=x.device)
    return p
