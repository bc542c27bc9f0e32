"""The exact GP: its training loss with the Hutchinson gradient, Adam, and
the dense posterior, in row blocks so that N = 49,152 fits in float64.

Loss: NLML - log prior of K + (s2_noise + jitter s2) I, with the
log-determinant and the quadratic term from the Cholesky factor. Gradient:
the NLML's 0.5 sum_jk dK_jk C_jk with C = (1/m) W Z^T - alpha alpha^T,
W = K^-1 Z over the fixed Rademacher probes Z (the stochastic trace
estimate of tr(K^-1 dK)); plus the prior's. The probes are the model's
fixed draw: a CPU ``torch.Generator`` seeded 0, ``randint(0, 2)``.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.kernel import dk_dr2, log_prior_neg, matern52, sqdist
from perfbench.reference.precision import Precision

Tensor = torch.Tensor

BLOCK = 2048


def probes(n: int, m: int) -> Tensor:
    gen = torch.Generator().manual_seed(0)
    return (2 * torch.randint(0, 2, (n, m), generator=gen) - 1).to(torch.float64)


def _scaled(prec: Precision, p: dict[str, Tensor], x: Tensor) -> Tensor:
    return prec.cast(x) / torch.exp(p["log_lengthscales"])


def factor(prec: Precision, p: dict[str, Tensor], x: Tensor, jitter: float) -> Tensor | None:
    """The lower Cholesky factor of K + (noise + jitter variance) I, built in
    row blocks; None when it does not factor."""
    n = x.shape[0]
    s = _scaled(prec, p, x)
    var = torch.exp(p["log_variance"])
    k = torch.empty((n, n), dtype=prec.dtype, device=x.device)
    for r0 in range(0, n, BLOCK):
        k[r0:r0 + BLOCK] = matern52(var, sqdist(prec, s[r0:r0 + BLOCK], s))
    k.diagonal().add_(torch.exp(p["log_noise_variance"]) + jitter * var)
    l, info = torch.linalg.cholesky_ex(k)
    del k
    return None if int(info) != 0 else l


def value_and_grad(prec: Precision, p: dict[str, Tensor], x: Tensor, y: Tensor,
                   z: Tensor | None, jitter: float) -> tuple[float, dict[str, Tensor] | None]:
    """(loss, gradient or None) at the parameters ``p`` (tensors in
    ``prec``'s dtype); ``z`` None skips the gradient."""
    p = {k: prec.cast(v) for k, v in p.items()}
    n = x.shape[0]
    l = factor(prec, p, x, jitter)
    if l is None:
        return float("nan"), None
    yv = prec.cast(y)[:, None]
    alpha = torch.cholesky_solve(yv, l)[:, 0]
    nlml = (0.5 * torch.dot(yv[:, 0], alpha) + torch.log(torch.diagonal(l)).sum()
            + 0.5 * n * math.log(2.0 * math.pi))
    loss = float(nlml + log_prior_neg(p))
    if z is None:
        return loss, None
    zv = prec.cast(z)
    m = zv.shape[1]
    w = torch.cholesky_solve(zv, l)
    del l
    s = _scaled(prec, p, x)
    var = torch.exp(p["log_variance"])
    g_var = torch.zeros((), dtype=prec.dtype, device=x.device)
    t = torch.zeros(s.shape[1], dtype=prec.dtype, device=x.device)
    col = torch.zeros(n, dtype=prec.dtype, device=x.device)
    for r0 in range(0, n, BLOCK):
        sb = s[r0:r0 + BLOCK]
        c = prec.mm(w[r0:r0 + BLOCK], zv.T) / m - alpha[r0:r0 + BLOCK, None] * alpha[None, :]
        r2 = sqdist(prec, sb, s)
        g_var = g_var + (matern52(var, r2) * c).sum()
        g = dk_dr2(var, r2) * c
        del r2, c
        t = t + g.sum(1) @ (sb * sb) - 2.0 * (sb * prec.mm(g, s)).sum(0)
        col = col + g.sum(0)
        del g
    t = t + col @ (s * s)
    tr_c = (w * zv).sum() / m - (alpha * alpha).sum()
    s2 = torch.exp(p["log_noise_variance"])
    grad = {"log_variance": 0.5 * g_var + 0.5 * jitter * var * tr_c + p["log_variance"],
            "log_lengthscales": -t + p["log_lengthscales"],
            "log_noise_variance": 0.5 * s2 * tr_c + p["log_noise_variance"]}
    return loss, grad


def posterior(prec: Precision, p: dict[str, Tensor], x: Tensor, y: Tensor, xq: Tensor,
              jitter: float) -> tuple[Tensor, Tensor]:
    """Dense posterior (mean, variance with the likelihood noise) at the
    queries ``xq`` of one mode."""
    p = {k: prec.cast(v) for k, v in p.items()}
    l = factor(prec, p, x, jitter)
    if l is None:
        nan = torch.full((xq.shape[0],), float("nan"), dtype=prec.dtype, device=x.device)
        return nan, nan
    alpha = torch.cholesky_solve(prec.cast(y)[:, None], l)
    ls = torch.exp(p["log_lengthscales"])
    var = torch.exp(p["log_variance"])
    ks = matern52(var, sqdist(prec, prec.cast(xq) / ls, prec.cast(x) / ls))  # (Q, N)
    mean = prec.mm(ks, alpha)[:, 0]
    v = torch.linalg.solve_triangular(l, ks.T, upper=False)
    del l
    post = torch.clamp_min(var - (v * v).sum(0), 0.0) + torch.exp(p["log_noise_variance"])
    return mean, post
