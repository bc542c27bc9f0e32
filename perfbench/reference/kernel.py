"""The Matern52 covariance, k(r) = s2 (1 + a + a^2 / 3) exp(-a) with
a = sqrt(5) r and r^2 = sum_d (x_d - x'_d)^2 / l_d^2, and its derivative in
r^2, dk/dr^2 = -(5/6) s2 (1 + a) exp(-a), which is finite at r = 0."""

from __future__ import annotations

import math

import torch

from perfbench.reference.precision import Precision

Tensor = torch.Tensor


def sqdist(prec: Precision, s1: Tensor, s2: Tensor) -> Tensor:
    """Squared distances of the rows of two scaled inputs (|a|^2 + |b|^2 -
    2 a.b, clamped at 0), the product in ``prec``."""
    a2 = (s1 * s1).sum(1)[:, None]
    b2 = (s2 * s2).sum(1)[None, :]
    return torch.clamp_min(a2 + b2 - 2.0 * prec.mm(s1, s2.T), 0.0)


class _Matern52(torch.autograd.Function):
    """k(r2) / s2 with the closed-form derivative in r2 (autograd through
    sqrt would give 0 * inf at r = 0)."""

    @staticmethod
    def forward(ctx, r2):
        a = torch.sqrt(5.0 * r2)
        e = torch.exp(-a)
        ctx.save_for_backward(a, e)
        return (1.0 + a + a * a / 3.0) * e

    @staticmethod
    def backward(ctx, g):
        a, e = ctx.saved_tensors
        return g * (-5.0 / 6.0) * (1.0 + a) * e


def matern52(variance: Tensor, r2: Tensor) -> Tensor:
    return variance * _Matern52.apply(r2)


def dk_dr2(variance: Tensor, r2: Tensor) -> Tensor:
    a = torch.sqrt(5.0 * r2)
    return (-5.0 / 6.0) * variance * (1.0 + a) * torch.exp(-a)


def gram(prec: Precision, p: dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tensor:
    ls = torch.exp(p["log_lengthscales"])
    return matern52(torch.exp(p["log_variance"]), sqdist(prec, x1 / ls, x2 / ls))


def log_prior_neg(p: dict[str, Tensor]) -> Tensor:
    """-log prior: standard normal densities on the log variance, the log
    lengthscales and the log noise variance (LogNormal(0, 1) priors)."""
    total = 0.0
    for k in ("log_variance", "log_lengthscales", "log_noise_variance"):
        eta = p[k]
        total = total + (0.5 * eta * eta + 0.5 * math.log(2.0 * math.pi)).sum()
    return total
