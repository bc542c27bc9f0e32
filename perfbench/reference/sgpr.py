"""Sparse GP regression (Titsias 2009): its posterior, from the equations:

    Kuu = k(Z, Z) + jitter (1 + s2) I     L = chol(Kuu)
    A = L^-1 k(Z, X) / sigma              LB = chol(I + A A^T)
    c = LB^-1 A y / sigma

The inducing inputs Z are a parameter (``"z"``).
"""

from __future__ import annotations

import torch

from perfbench.reference.kernel import matern52, sqdist
from perfbench.reference.precision import Precision

Tensor = torch.Tensor


def _common(prec: Precision, p: dict[str, Tensor], x: Tensor, jitter: float):
    ls = torch.exp(p["log_lengthscales"])
    var = torch.exp(p["log_variance"])
    sz = p["z"] / ls
    sx = prec.cast(x) / ls
    m = sz.shape[0]
    eye = torch.eye(m, dtype=prec.dtype, device=x.device)
    kuu = matern52(var, sqdist(prec, sz, sz)) + jitter * (1.0 + var) * eye
    kuf = matern52(var, sqdist(prec, sz, sx))
    sigma2 = torch.exp(p["log_noise_variance"])
    sigma = torch.sqrt(sigma2)
    l = torch.linalg.cholesky(kuu)
    a = torch.linalg.solve_triangular(l, kuf, upper=False) / sigma
    lb = torch.linalg.cholesky(prec.mm(a, a.T) + eye)
    return sigma, sigma2, var, l, a, lb


def posterior(prec: Precision, p: dict[str, Tensor], x: Tensor, y: Tensor, xq: Tensor,
              jitter: float) -> tuple[Tensor, Tensor]:
    """Posterior (mean, variance with the likelihood noise) at ``xq``."""
    with torch.no_grad():
        p = {k: prec.cast(v) for k, v in p.items()}
        sigma, sigma2, var, l, a, lb = _common(prec, p, x, jitter)
        c = torch.linalg.solve_triangular(lb, prec.mm(a, prec.cast(y)[:, None]),
                                          upper=False) / sigma
        ls = torch.exp(p["log_lengthscales"])
        kus = matern52(var, sqdist(prec, p["z"] / ls, prec.cast(xq) / ls))
        t1 = torch.linalg.solve_triangular(l, kus, upper=False)
        t2 = torch.linalg.solve_triangular(lb, t1, upper=False)
        mean = prec.mm(t2.T, c)[:, 0]
        post = var - (t1 * t1).sum(0) + (t2 * t2).sum(0)
        return mean, torch.clamp_min(post, 0.0) + sigma2
