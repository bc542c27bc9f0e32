"""Sparse GP regression: the Titsias (2009) collapsed ELBO, the reference's
workhorse.

Port of ``gpras_tpu/gp/sgpr.py`` (GPflow's ``SGPR``, which the reference
builds per EOF mode, gpras/gpr.py:293-299). With kernel k, inducing inputs
Z (M, D), training data (X (N, D), y (N,)) and Gaussian noise s2:

    Kuu = k(Z, Z) + jitter*I          L  = chol(Kuu)
    A   = L^{-1} k(Z, X) / s          B  = I + A A^T       LB = chol(B)
    c   = LB^{-1} A y / s

    ELBO = -N/2 log(2 pi) - sum(log diag LB) - N/2 log s2
           - ||y||^2 / (2 s2) + ||c||^2 / 2
           - sum(kdiag(X)) / (2 s2) + trace(A A^T) / 2

The last two terms are the Titsias trace correction. One (M, M) Cholesky
pair and (M, N) matmuls: plain PyTorch (cuBLAS and cuSOLVER on the card),
as the reference leaves it to XLA; no hand-written kernel is on this path.
Gradients flow by autograd. The inducing inputs live in the parameter dict
(key ``"z"``), so the staged schedules' freezing is a gradient mask.
"""

from __future__ import annotations

import math

import torch

from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg

Tensor = torch.Tensor


def kuu_gram(kernel: str, params: dict[str, Tensor], z: Tensor) -> Tensor:
    """Kuu with a dtype-scaled diagonal jitter, jitter * (1 + variance)
    (1e-6 in float32, 1e-9 in float64: ``linalg.default_jitter``)."""
    k = K.gram(kernel, params, z)
    variance = torch.exp(params["log_variance"])
    jitter = linalg.default_jitter(k.dtype)
    return k + (jitter * (1.0 + variance)) * torch.eye(z.shape[0], dtype=k.dtype,
                                                        device=k.device)


def _common(kernel: str, params: dict[str, Tensor], x: Tensor):
    """The factors the ELBO and the posterior share: (s, s2, L, A, LB)."""
    z = params["z"]
    sigma2 = torch.exp(params["log_noise_variance"])
    sigma = torch.sqrt(sigma2)
    kuu = kuu_gram(kernel, params, z)
    kuf = K.gram(kernel, params, z, x)  # (M, N)
    # Kuu already carries its jitter: the first attempt is the plain
    # factorization; near-duplicate inducing points escalate instead of NaN
    l = linalg.safe_cholesky(kuu, jitter=0.0)
    a = linalg.solve_triangular(l, kuf, lower=True) / sigma  # (M, N)
    b = a @ a.T + torch.eye(z.shape[0], dtype=x.dtype, device=x.device)
    lb = linalg.safe_cholesky(b, jitter=0.0)
    return sigma, sigma2, l, a, lb


def elbo(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
    """Collapsed evidence lower bound, summed over the output columns of
    y (N,) or (N, P)."""
    y2 = y[:, None] if y.ndim == 1 else y
    n, p = y2.shape
    sigma, sigma2, l, a, lb = _common(kernel, params, x)
    aerr = a @ y2  # (M, P)
    c = linalg.solve_triangular(lb, aerr, lower=True) / sigma  # (M, P)
    kdiag_sum = torch.sum(K.kdiag(kernel, params, x))
    out = -0.5 * p * n * math.log(2.0 * math.pi)
    out = out - p * torch.sum(torch.log(torch.diagonal(lb)))
    out = out - 0.5 * p * n * torch.log(sigma2)
    out = out - 0.5 * torch.sum(y2 * y2) / sigma2
    out = out + 0.5 * torch.sum(c * c)
    out = out - 0.5 * p * kdiag_sum / sigma2
    out = out + 0.5 * p * torch.sum(a * a)  # trace(A A^T)
    return out


def training_loss(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
    """-(ELBO + log prior): the objective every reference optimizer minimizes
    (gpras/gpr.py:154,187, priors gpras/gpr.py:303-305)."""
    return -(elbo(kernel, params, x, y) + log_prior(params))


def predict(kernel: str, params: dict[str, Tensor], x_train: Tensor, y_train: Tensor,
            x_test: Tensor, include_noise: bool = True) -> tuple[Tensor, Tensor]:
    """Posterior predictive mean and variance at ``x_test`` from the
    collapsed posterior; (S,) or (S, P) following ``y_train``.
    ``include_noise`` gives the observation-space variance (the reference's
    ``predict_y``, gpras/gpr.py:337)."""
    y2 = y_train[:, None] if y_train.ndim == 1 else y_train
    sigma, sigma2, l, a, lb = _common(kernel, params, x_train)
    c = linalg.solve_triangular(lb, a @ y2, lower=True) / sigma
    kus = K.gram(kernel, params, params["z"], x_test)  # (M, S)
    tmp1 = linalg.solve_triangular(l, kus, lower=True)  # (M, S)
    tmp2 = linalg.solve_triangular(lb, tmp1, lower=True)  # (M, S)
    mean = tmp2.T @ c  # (S, P)
    var = (K.kdiag(kernel, params, x_test) - torch.sum(tmp1 * tmp1, dim=0)
           + torch.sum(tmp2 * tmp2, dim=0))
    var = torch.clamp_min(var, 0.0)
    if include_noise:
        var = var + sigma2
    var = var[:, None].expand(mean.shape)
    if y_train.ndim == 1:
        return mean[:, 0], var[:, 0]
    return mean, var


def init_params(kernel: str, x: Tensor, z: Tensor, noise_variance: float = 1.0,
                variance: float = 1.0,
                lengthscales: float | Tensor | None = None) -> dict[str, Tensor]:
    """Initial SGPR parameters: the reference's heuristics (variance 1,
    lengthscale mean|x|, gpras/gpr.py:289-298) plus the inducing inputs as
    the trainable leaf ``"z"``."""
    if lengthscales is None:
        lengthscales = torch.mean(torch.abs(x))
    p = K.init_params(kernel, x.shape[-1], variance=variance, lengthscales=lengthscales,
                      dtype=x.dtype, device=x.device)
    p["log_noise_variance"] = torch.tensor(math.log(noise_variance), dtype=x.dtype,
                                           device=x.device)
    p["z"] = torch.as_tensor(z, dtype=x.dtype, device=x.device)
    return p
