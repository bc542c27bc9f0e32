"""Exact Gaussian-process regression: the dense posterior.

Port of the serving half of ``gpras_tpu/gp/exact.py``: ``build_train_gram``,
``predict`` and ``init_params``. The custom-VJP NLML (``quad_logdet``,
``nlml``, ``training_loss``) is training and waits (ROADMAP.md, queue A).
"""

from __future__ import annotations

import math

import torch

from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg

Tensor = torch.Tensor


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
