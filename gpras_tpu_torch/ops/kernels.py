"""Covariance-kernel zoo: plain PyTorch Gram builders with ARD lengthscales.

Port of ``gpras_tpu/ops/kernels.py`` (same eight kernels, same GPflow
conventions, same ``_R2_FLOOR``):

- ``Matern12``:     k(r) = s2 * exp(-r)
- ``Matern32``:     k(r) = s2 * (1 + sqrt(3) r) exp(-sqrt(3) r)
- ``Matern52``:     k(r) = s2 * (1 + sqrt(5) r + 5/3 r^2) exp(-sqrt(5) r)
- ``RBF``:          k(r2) = s2 * exp(-r2 / 2)
- ``Exponential``:  k(r) = s2 * exp(-r / 2)
- ``Linear``:       k(x, x') = s2 * <x, x'>
- ``Polynomial``:   k(x, x') = (s2 * <x, x'> + offset) ** degree
- ``Periodic``:     k = s2 * exp(-0.5 * sum_d (2 sin(pi (x_d - x'_d) / p_d) / l_d)^2)

where ``r2 = sum_d ((x_d - x'_d) / l_d)^2`` and ``r = sqrt(r2)``. Parameters
are carried unconstrained (log-space) in a flat dict of tensors. The fused
large-N matvec over these covariances lives in ``ops/fused_gram.py``.
"""

from __future__ import annotations

import math
from typing import Literal

import torch

Tensor = torch.Tensor

KernelName = Literal[
    "Matern12",
    "Matern32",
    "Matern52",
    "RBF",
    "Linear",
    "Polynomial",
    "Periodic",
    "Exponential",
]

KERNEL_NAMES: tuple[str, ...] = (
    "Matern12",
    "Matern32",
    "Matern52",
    "RBF",
    "Linear",
    "Polynomial",
    "Periodic",
    "Exponential",
)

#: Kernels whose Gram depends only on the scaled distance r (or r^2).
STATIONARY_KERNELS = ("Matern12", "Matern32", "Matern52", "RBF", "Exponential")

_R2_FLOOR = 1e-36  # keeps sqrt differentiable at coincident points


def init_params(
    kernel: str,
    dim: int,
    variance: float = 1.0,
    lengthscales: float | Tensor = 1.0,
    period: float = 1.0,
    offset: float = 1.0,
    degree: float = 3.0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> dict[str, Tensor]:
    """Unconstrained (log-space) parameter dict for ``kernel`` (reference
    defaults: variance 1, Polynomial degree a non-trainable 3)."""
    _check_kernel(kernel)
    ls = torch.as_tensor(lengthscales, dtype=dtype, device=device).expand(dim)
    params = {"log_variance": torch.tensor(math.log(variance), dtype=dtype, device=device)}
    if kernel in STATIONARY_KERNELS or kernel == "Periodic":
        params["log_lengthscales"] = torch.log(ls)
    if kernel == "Periodic":
        params["log_period"] = torch.full((dim,), math.log(period), dtype=dtype, device=device)
    if kernel == "Polynomial":
        params["log_offset"] = torch.tensor(math.log(offset), dtype=dtype, device=device)
        params["degree"] = torch.tensor(degree, dtype=dtype, device=device)
    return params


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"Unknown kernel {kernel!r}; expected one of {KERNEL_NAMES}")


def constrain(params: dict[str, Tensor]) -> dict[str, Tensor]:
    """Map unconstrained (log-space) params to their positive/constrained values."""
    return {k[4:] if k.startswith("log_") else k:
            torch.exp(v) if k.startswith("log_") else v
            for k, v in params.items()}


def unconstrain(params: dict[str, Tensor]) -> dict[str, Tensor]:
    """Inverse of :func:`constrain`."""
    return {k if k == "degree" else "log_" + k:
            v if k == "degree" else torch.log(v)
            for k, v in params.items()}


def scaled_sqdist(x1: Tensor, x2: Tensor, lengthscales: Tensor) -> Tensor:
    """Pairwise squared distance of lengthscale-scaled points, shape (N1, N2),
    as ||a||^2 + ||b||^2 - 2 a b^T clamped at zero."""
    a = x1 / lengthscales
    b = x2 / lengthscales
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    r2 = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return torch.clamp_min(r2, 0.0)


def _safe_r(r2: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(r2, _R2_FLOOR))


def _stationary_from_r2(kernel: str, variance: Tensor, r2: Tensor) -> Tensor:
    if kernel == "RBF":
        return variance * torch.exp(-0.5 * r2)
    r = _safe_r(r2)
    if kernel == "Matern12":
        return variance * torch.exp(-r)
    if kernel == "Matern32":
        s3r = math.sqrt(3.0) * r
        return variance * (1.0 + s3r) * torch.exp(-s3r)
    if kernel == "Matern52":
        s5r = math.sqrt(5.0) * r
        return variance * (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)
    if kernel == "Exponential":
        return variance * torch.exp(-0.5 * r)
    raise ValueError(f"{kernel} is not stationary")


def gram(kernel: str, params: dict[str, Tensor], x1: Tensor, x2: Tensor | None = None) -> Tensor:
    """Full covariance (Gram) matrix K(x1, x2) of shape (N1, N2) from
    unconstrained ``params``."""
    _check_kernel(kernel)
    if x2 is None:
        x2 = x1
    variance = torch.exp(params["log_variance"])
    if kernel in STATIONARY_KERNELS:
        ls = torch.exp(params["log_lengthscales"])
        return _stationary_from_r2(kernel, variance, scaled_sqdist(x1, x2, ls))
    if kernel == "Linear":
        return variance * (x1 @ x2.T)
    if kernel == "Polynomial":
        offset = torch.exp(params["log_offset"])
        return (variance * (x1 @ x2.T) + offset) ** params["degree"]
    if kernel == "Periodic":
        ls = torch.exp(params["log_lengthscales"])
        period = torch.exp(params["log_period"])
        # one (N1, N2) accumulator per dimension, never (N1, N2, D)
        r2 = torch.zeros((x1.shape[0], x2.shape[0]), dtype=x1.dtype, device=x1.device)
        for i in range(x1.shape[-1]):
            dx = x1[:, i][:, None] - x2[:, i][None, :]
            s = torch.sin(math.pi * dx / period[i]) / ls[i]
            r2 = r2 + 4.0 * s * s
        return variance * torch.exp(-0.5 * r2)
    raise AssertionError("unreachable")


def kdiag(kernel: str, params: dict[str, Tensor], x: Tensor) -> Tensor:
    """Diagonal of K(x, x), shape (N,) — avoids building the full Gram."""
    _check_kernel(kernel)
    variance = torch.exp(params["log_variance"])
    if kernel in STATIONARY_KERNELS or kernel == "Periodic":
        return variance.expand(x.shape[0]).to(x.dtype)
    if kernel == "Linear":
        return variance * torch.sum(x * x, dim=-1)
    if kernel == "Polynomial":
        offset = torch.exp(params["log_offset"])
        return (variance * torch.sum(x * x, dim=-1) + offset) ** params["degree"]
    raise AssertionError("unreachable")


def trainable_param_names(kernel: str) -> tuple[str, ...]:
    """Unconstrained parameter names optimized during fitting (the Polynomial
    ``degree`` is structural)."""
    _check_kernel(kernel)
    if kernel in STATIONARY_KERNELS:
        return ("log_variance", "log_lengthscales")
    if kernel == "Linear":
        return ("log_variance",)
    if kernel == "Polynomial":
        return ("log_variance", "log_offset")
    if kernel == "Periodic":
        return ("log_variance", "log_lengthscales", "log_period")
    raise AssertionError("unreachable")
