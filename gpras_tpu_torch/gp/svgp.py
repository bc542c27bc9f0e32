"""Stochastic variational GP (SVGP): the minibatch-trainable sparse engine.

Port of ``gpras_tpu/gp/svgp.py``: the uncollapsed bound of Hensman et al.
(2013), whose data term decomposes over points, so training takes
minibatches at O(M^2) memory for any N, and serving reads only the fitted
parameters, never the training set.

Whitened parametrization (v = L^{-1} u with L = chol(Kuu), so the prior is
p(v) = N(0, I)):

    A        = L^{-1} k(Z, X)                                   (M, B)
    mean_f   = A^T q_mu
    var_f_i  = kdiag(x_i) - ||a_i||^2 + ||q_sqrt^T a_i||^2
    ELBO     = (N / B) * sum_i [ log N(y_i | mean_f_i, s2) - var_f_i / (2 s2) ]
               - KL(q(v) || N(0, I))
    KL       = 0.5 * ( ||q_mu||^2 + ||q_sqrt||_F^2 - M
                       - 2 sum log diag(q_sqrt) )               per output

q_sqrt is stored as the unconstrained (P, M, M) leaf ``q_raw`` (strict lower
triangle free, diagonal ``exp``-positive), so ``q_mu = 0, q_raw = 0`` is
q(v) = N(0, I) with zero KL. The variational leaves share the parameter dict
with the hyperparameters and ``"z"``; ``gp/priors.log_prior`` skips them.

Plain PyTorch throughout (cuBLAS and cuSOLVER on the card), as the
reference leaves SVGP to XLA: its K(Z, X) is the plain ``ops/kernels.gram``,
and no hand-written kernel is on this path.

The trainers are Python loops over steps. A step is the reference's, in
its order: the natural-gradient step on (``q_mu``, ``q_raw``) when
``natgrad`` is set, then the loss and its gradient at the updated
parameters (q-gradients zeroed under ``natgrad``), then optax's Adam update
(eps 1e-8, ``optax.adam``'s default). The reference's ``optimizer``
argument (any optax transformation) is not ported: no caller passes one.
Randomness is an input: ``make_minibatch_fit``'s ``fit`` takes a
``torch.Generator`` or the epochs' permutations themselves.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import numpy as np
import torch

from gpras_tpu_torch.fit.optimizers import _adam_update, value_and_grad
from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.gp.sgpr import kuu_gram
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg

Tensor = torch.Tensor
Params = dict[str, Tensor]

#: the variational leaves the natural-gradient step owns
Q_LEAVES = ("q_mu", "q_raw")
#: optax.adam's defaults (not the exact GP's tf.keras eps of 1e-7)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _eye(m: int, like: Tensor) -> Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _data_scale(n_total: int | Tensor, batch: int, dtype: torch.dtype) -> float | Tensor:
    """n_total / batch rounded in the data's dtype, as the reference computes
    it; a Python number stays on the host (a tensor made from it would cost a
    blocking host-to-device copy every step)."""
    if isinstance(n_total, Tensor):
        return n_total.to(dtype) / batch
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    return float(np.asarray(n_total, dtype=np_dtype) / np.asarray(batch, dtype=np_dtype))


def q_sqrt_from_raw(q_raw: Tensor) -> Tensor:
    """Lower-triangular Cholesky factor of S from the unconstrained leaf:
    the strict lower triangle passes through, the diagonal is ``exp`` of the
    raw diagonal (raw zeros give S = I). Batched over leading axes."""
    tril = torch.tril(q_raw, diagonal=-1)
    diag = torch.exp(torch.diagonal(q_raw, dim1=-2, dim2=-1))
    return tril + _eye(q_raw.shape[-1], q_raw) * diag[..., None, :]


def raw_from_q_sqrt(q_sqrt: Tensor) -> Tensor:
    """Inverse of :func:`q_sqrt_from_raw` (strictly positive diagonal)."""
    tril = torch.tril(q_sqrt, diagonal=-1)
    diag = torch.log(torch.diagonal(q_sqrt, dim1=-2, dim2=-1))
    return tril + _eye(q_sqrt.shape[-1], q_sqrt) * diag[..., None, :]


def init_params(kernel: str, x: Tensor, z: Tensor, noise_variance: float = 1.0,
                variance: float = 1.0, lengthscales: float | Tensor | None = None,
                outputs: int = 1) -> Params:
    """SVGP parameters: SGPR's hyperparameter heuristics (variance 1,
    lengthscale mean|x|) plus the whitened variational leaves ``q_mu``
    (M, P) and ``q_raw`` (P, M, M) at q(v) = N(0, I) (zero KL)."""
    if lengthscales is None:
        lengthscales = torch.mean(torch.abs(x))
    p = K.init_params(kernel, x.shape[-1], variance=variance, lengthscales=lengthscales,
                      dtype=x.dtype, device=x.device)
    p["log_noise_variance"] = torch.tensor(math.log(noise_variance), dtype=x.dtype,
                                           device=x.device)
    p["z"] = torch.as_tensor(z, dtype=x.dtype, device=x.device)
    m = p["z"].shape[0]
    p["q_mu"] = torch.zeros((m, outputs), dtype=x.dtype, device=x.device)
    p["q_raw"] = torch.zeros((outputs, m, m), dtype=x.dtype, device=x.device)
    return p


def _whitened_projection(kernel: str, params: Params, x: Tensor) -> Tensor:
    """A = L^{-1} k(Z, x): the only O(M^2 B) work per batch."""
    kuu = kuu_gram(kernel, params, params["z"])
    l = linalg.safe_cholesky(kuu, jitter=0.0)
    kux = K.gram(kernel, params, params["z"], x)  # (M, B)
    return linalg.solve_triangular(l, kux, lower=True)


def _f_moments(params: Params, a: Tensor, kdiag: Tensor) -> tuple[Tensor, Tensor]:
    """Marginal moments of the noise-free latent f at the batch points:
    mean (B, P) and variance (B, P) of the variational posterior."""
    q_sqrt = q_sqrt_from_raw(params["q_raw"])  # (P, M, M)
    mean = a.T @ params["q_mu"]  # (B, P)
    sa = torch.einsum("pkm,kb->pmb", q_sqrt, a)  # q_sqrt^T a, (P, M, B)
    var = (kdiag - torch.sum(a * a, dim=0))[:, None] + torch.sum(sa * sa, dim=1).T
    return mean, torch.clamp_min(var, 0.0)


def kl_to_prior(params: Params) -> Tensor:
    """KL(q(v) || N(0, I)) summed over outputs; zero at init."""
    q_sqrt = q_sqrt_from_raw(params["q_raw"])  # (P, M, M)
    p, m = q_sqrt.shape[0], q_sqrt.shape[-1]
    logdet = 2.0 * torch.sum(torch.diagonal(params["q_raw"], dim1=-2, dim2=-1))
    return 0.5 * (torch.sum(params["q_mu"] ** 2) + torch.sum(q_sqrt ** 2) - p * m - logdet)


def elbo(kernel: str, params: Params, x: Tensor, y: Tensor, n_total: int | Tensor) -> Tensor:
    """Uncollapsed evidence lower bound on a (mini)batch.

    ``n_total`` is the full data set's size: the data term is scaled by
    ``n_total / batch``, so minibatch gradients estimate the full bound's
    without bias. At ``x.shape[0] == n_total`` this is the exact bound, at
    most SGPR's collapsed bound, with equality at the optimal q."""
    scale = _data_scale(n_total, y.shape[0], y.dtype)
    return scale * _expected_loglik(kernel, params, x, y) - kl_to_prior(params)


def _expected_loglik(kernel: str, params: Params, x: Tensor, y: Tensor) -> Tensor:
    """The bound's data term on a batch, unscaled: the sum over its points and
    outputs of the closed-form Gaussian expected log-likelihood."""
    y2 = y[:, None] if y.ndim == 1 else y
    sigma2 = torch.exp(params["log_noise_variance"])
    a = _whitened_projection(kernel, params, x)
    mean, var_f = _f_moments(params, a, K.kdiag(kernel, params, x))
    quad = (y2 - mean) ** 2 + var_f
    loglik = -0.5 * (math.log(2.0 * math.pi) + torch.log(sigma2)) - 0.5 * quad / sigma2
    return torch.sum(loglik)


def training_loss(kernel: str, params: Params, x: Tensor, y: Tensor,
                  n_total: int | Tensor) -> Tensor:
    """-(ELBO + log prior): the objective of every other engine too."""
    return -(elbo(kernel, params, x, y, n_total) + log_prior(params))


def predict(kernel: str, params: Params, x_test: Tensor,
            include_noise: bool = True) -> tuple[Tensor, Tensor]:
    """Posterior predictive at ``x_test`` from the fitted parameters alone
    (no training set). ``include_noise`` gives the observation-space
    variance (the reference's ``predict_y``). (S,) each when P = 1, else
    (S, P)."""
    a = _whitened_projection(kernel, params, x_test)
    mean, var = _f_moments(params, a, K.kdiag(kernel, params, x_test))
    if include_noise:
        var = var + torch.exp(params["log_noise_variance"])
    if params["q_mu"].shape[1] == 1:
        return mean[:, 0], var[:, 0]
    return mean, var


def optimal_q(kernel: str, params: Params, x: Tensor, y: Tensor) -> Params:
    """The optimal whitened q(v) for the Gaussian likelihood over the full
    data set: with A = L^{-1} K_zx, S* = (I + A A^T / s2)^{-1} and
    m* = S* A y / s2. Substituted into the uncollapsed bound they give
    Titsias' collapsed bound exactly."""
    y2 = y[:, None] if y.ndim == 1 else y
    sigma2 = torch.exp(params["log_noise_variance"])
    a = _whitened_projection(kernel, params, x)
    m = a.shape[0]
    eye = _eye(m, x)
    b_mat = eye + (a @ a.T) / sigma2
    lb = linalg.safe_cholesky(b_mat, jitter=0.0)
    s_star = linalg.cho_solve(lb, eye)
    q_sqrt = linalg.safe_cholesky(s_star, jitter=0.0)
    out = dict(params)
    out["q_mu"] = s_star @ (a @ y2) / sigma2
    out["q_raw"] = raw_from_q_sqrt(q_sqrt)[None].expand(y2.shape[1], m, m).clone()
    return out


@torch.no_grad()
def natgrad_step(kernel: str, params: Params, x: Tensor, y: Tensor, n_total: int | Tensor,
                 lr: float = 0.1) -> Params:
    """One natural-gradient step on the variational leaves (q_mu, q_raw).

    The bound is conjugate in q's natural parameters (lam1, lam2) =
    (S^{-1} m, -S^{-1} / 2); with G = (n_total / B) A A^T / s2 and
    b = (n_total / B) A y / s2 over the batch,

        lam1'      = (1 - lr) lam1 + lr b
        -2 lam2'   = (1 - lr) S^{-1} + lr (G + I)

    positive definite for any lr in (0, 1]. At lr = 1 on the full data set
    it lands on :func:`optimal_q` from any q. Runs without autograd, the
    outputs as one batch (the reference's ``jax.vmap``)."""
    y2 = y[:, None] if y.ndim == 1 else y
    aat, ay = _natgrad_stats(kernel, params, x, y2)
    return _natgrad_update(params, aat, ay, _data_scale(n_total, y2.shape[0], y2.dtype), lr)


def _natgrad_stats(kernel: str, params: Params, x: Tensor, y2: Tensor) -> tuple[Tensor, Tensor]:
    """The batch's sums behind a natural-gradient step: A A^T (M, M) and
    A y (M, P), A = L^-1 k(Z, x)."""
    a = _whitened_projection(kernel, params, x)  # (M, B)
    return a @ a.T, a @ y2


def _natgrad_update(params: Params, aat: Tensor, ay: Tensor, scale, lr: float) -> Params:
    """The natural-gradient step from the batch's sums (``_natgrad_stats``)
    and the data scale n_total / B."""
    sigma2 = torch.exp(params["log_noise_variance"])
    m = aat.shape[0]
    g_mat = scale * aat / sigma2  # (M, M), shared across outputs
    b_vec = scale * ay / sigma2  # (M, P)
    eye = _eye(m, aat)
    q_sqrt = q_sqrt_from_raw(params["q_raw"])  # (P, M, M)
    # S^{-1} = L^{-T} L^{-1}; lam1 = S^{-1} m, per output
    linv = linalg.solve_triangular(q_sqrt, eye, lower=True)
    s_inv = linv.mT @ linv
    lam1 = s_inv @ params["q_mu"].T[:, :, None]  # (P, M, 1)
    prec_new = (1.0 - lr) * s_inv + lr * (g_mat + eye)
    lp = linalg.safe_cholesky(prec_new, jitter=0.0)
    s_new = linalg.cho_solve(lp, eye)
    lam1_new = (1.0 - lr) * lam1 + lr * b_vec.T[:, :, None]
    m_new = s_new @ lam1_new  # (P, M, 1)
    out = dict(params)
    out["q_mu"] = m_new[:, :, 0].T.contiguous()
    out["q_raw"] = raw_from_q_sqrt(linalg.safe_cholesky(s_new, jitter=0.0))
    return out


def _step_fn(kernel: str, learning_rate: float, natgrad: float | None):
    """One training step of both trainers: (params, Adam state, xb, yb,
    n_total) -> (params, Adam state, loss)."""

    def step(p: Params, state, xb: Tensor, yb: Tensor, n_total):
        if natgrad is not None:
            p = natgrad_step(kernel, p, xb, yb, n_total, lr=natgrad)
        loss, g = value_and_grad(lambda q: training_loss(kernel, q, xb, yb, n_total), p)
        if natgrad is not None:
            g = {k: (torch.zeros_like(v) if k in Q_LEAVES else v) for k, v in g.items()}
        updates, state = _adam_update(g, state, learning_rate, ADAM_B1, ADAM_B2, ADAM_EPS)
        return {k: v + updates[k] for k, v in p.items()}, state, loss

    return step


def _adam_init(params: Params):
    return ({k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()}, 0)


def make_minibatch_fit(kernel: str, batch_size: int, epochs: int, learning_rate: float = 0.01,
                       n_total: int | None = None, natgrad: float | None = None
                       ) -> Callable[..., tuple[Params, Tensor]]:
    """Minibatch trainer: ``fit(params, x, y, key) -> (params, losses)``.

    Each epoch permutes the N points, drops the remainder and walks the
    batches (every batch a uniform random subset, so the ``n_total / B``
    scaling stays unbiased). ``key`` is a ``torch.Generator`` (on the data's
    device, one ``randperm`` per epoch) or the permutations themselves, an
    (epochs, N) index tensor. ``natgrad`` (e.g. 0.5) interleaves a
    :func:`natgrad_step` on q with the Adam step on everything else, the
    GPflow NaturalGradient + Adam recipe. ``losses`` (epochs,) holds each
    epoch's mean step loss; the steps' losses stay on the device until the
    epoch ends."""
    step = _step_fn(kernel, learning_rate, natgrad)

    def fit(params: Params, x: Tensor, y: Tensor, key: torch.Generator | Tensor
            ) -> tuple[Params, Tensor]:
        n = x.shape[0]
        scale_n = n if n_total is None else n_total
        nb = n // batch_size
        if nb == 0:
            raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
        if isinstance(key, Tensor) and tuple(key.shape) != (epochs, n):
            raise ValueError(f"permutations of shape {tuple(key.shape)}, expected ({epochs}, {n})")
        y2 = y[:, None] if y.ndim == 1 else y
        p = {k: v.detach() for k, v in params.items()}
        state = _adam_init(p)
        hist = []
        for e in range(epochs):
            if isinstance(key, Tensor):
                perm = key[e].to(x.device)
            else:
                perm = torch.randperm(n, generator=key, device=key.device).to(x.device)
            perm = perm[: nb * batch_size]
            xb = x[perm].reshape(nb, batch_size, x.shape[-1])
            yb = y2[perm].reshape(nb, batch_size, y2.shape[-1])
            losses = []
            for i in range(nb):
                p, state, loss = step(p, state, xb[i], yb[i], scale_n)
                losses.append(loss)
            hist.append(torch.stack(losses).mean())
        return p, torch.stack(hist)

    return fit


def make_stream_fit(kernel: str, learning_rate: float = 0.01, natgrad: float | None = None):
    """Trainer for archives that live off the device: ``(init, run_chunk)``.

    - ``state = init(params)``
    - ``params, state, losses = run_chunk(params, state, xc, yc, n_total)``
      where ``xc`` is (n_batches, B, D) and ``yc`` (n_batches, B, P): one
      shuffled chunk of minibatches, already on the device; ``n_total`` is
      the archive's size, not the chunk's.

    The caller shuffles on the host and copies the next chunk while the
    current one computes. The step is :func:`make_minibatch_fit`'s, so the
    two walk the same trajectory on the same batch stream."""
    step = _step_fn(kernel, learning_rate, natgrad)

    def init(params: Params):
        return _adam_init(params)

    def run_chunk(params: Params, state, xc: Tensor, yc: Tensor, n_total: int):
        p = {k: v.detach() for k, v in params.items()}
        losses = []
        for i in range(xc.shape[0]):
            p, state, loss = step(p, state, xc[i], yc[i], n_total)
            losses.append(loss)
        return p, state, torch.stack(losses)

    return init, run_chunk
