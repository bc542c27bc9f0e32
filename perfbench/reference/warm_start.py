"""The warm-started exact fit, stage by stage, from its definition:
``fit(x, y, optimization_method="adam", warm_start_subsample=S)`` on float32
data with no start given.

(a) The rung: every ceil(N / S)-th row (only when N >= 2 S), the standard
    start (variance 1, noise variance 1, every lengthscale the mean |x| of
    the rung's inputs) and Adam on the exact dense loss, NLML - log prior of
    K + (noise + jitter variance) I, its gradient by autograd, with the
    noise floor.
(b) The transfer: the kernel variance clamped to at most ``cap`` times the
    noise variance and certified by the full-N loss. While the clamped
    K + (noise + jitter variance) I does not factor in float32, the dtype
    the model computes in, the cap halves, down to ``MIN_CAP``; a mode that
    never factors takes the standard start of the full inputs. The loss
    that certifies is computed in the stage's precision.
(c) Adam at full N from the certified parameters: ``reference/exact.py``'s
    loss and Hutchinson gradient on the model's probes, ``reference/adam.py``.

Each stage is a function of its own inputs, so that a comparison can start
each from the program's input to that stage.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import adam
from perfbench.reference import exact as ref_exact
from perfbench.reference.kernel import log_prior_neg, matern52, sqdist
from perfbench.reference.precision import Precision

Tensor = torch.Tensor

RATIO_CAP = 50.0  # the transfer's first cap: kernel variance / noise variance
MIN_CAP = 2.0     # the cap the certification halves down to before it gives up


def no_tf32() -> None:
    """Products in full float32 wherever the reference runs in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rung_stride(n: int, subsample: int) -> int | None:
    """The rung's row stride, ceil(n / subsample); None where n is under
    twice the subsample and the fit takes no rung."""
    if subsample <= 0 or n < 2 * subsample:
        return None
    return -(-n // subsample)


def standard_start(x: Tensor, dtype: torch.dtype) -> dict[str, Tensor]:
    """Log variance 0, log noise variance 0, each log lengthscale the log of
    the mean |x| over every entry of ``x``."""
    ls = torch.log(x.to(dtype).abs().mean())
    zero = torch.zeros((), dtype=dtype, device=x.device)
    return {"log_variance": zero.clone(), "log_lengthscales": ls.expand(x.shape[1]).clone(),
            "log_noise_variance": zero.clone()}


def dense_loss(prec: Precision, p: dict[str, Tensor], x: Tensor, y: Tensor,
               jitter: float) -> Tensor:
    """NLML - log prior with the whole Gram, differentiable in ``p``; NaN
    where K does not factor."""
    n = x.shape[0]
    s = prec.cast(x) / torch.exp(p["log_lengthscales"])
    var = torch.exp(p["log_variance"])
    k = matern52(var, sqdist(prec, s, s))
    diag = torch.exp(p["log_noise_variance"]) + jitter * var
    k = k + diag * torch.eye(n, dtype=k.dtype, device=k.device)
    l, info = torch.linalg.cholesky_ex(k)
    if int(info) != 0:
        return torch.full((), float("nan"), dtype=k.dtype, device=k.device)
    yv = prec.cast(y)[:, None]
    alpha = torch.cholesky_solve(yv, l)[:, 0]
    nlml = (0.5 * torch.dot(yv[:, 0], alpha) + torch.log(torch.diagonal(l)).sum()
            + 0.5 * n * math.log(2.0 * math.pi))
    return nlml + log_prior_neg(p)


def dense_value_and_grad(prec: Precision, x: Tensor, y: Tensor, jitter: float):
    """``value_and_grad(p, grad)`` of the dense loss, as ``adam.follow``
    takes it: (loss, gradient or None)."""

    def vag(p: dict[str, Tensor], grad: bool):
        if not grad:
            with torch.no_grad():
                return float(dense_loss(prec, p, x, y, jitter)), None
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        loss = dense_loss(prec, leaves, x, y, jitter)
        value = float(loss.detach())
        if not math.isfinite(value):
            return value, None
        parts = torch.autograd.grad(loss, list(leaves.values()))
        return value, {k: g.detach() for k, g in zip(leaves, parts)}

    return vag


def rung(prec: Precision, x: Tensor, y: Tensor, subsample: int, steps: int, lr: float,
         floors: dict[str, float], jitter: float) -> dict | None:
    """Stage (a) for one mode (``y`` one column): ``adam.follow``'s losses,
    first gradient and parameters after ``steps`` steps, and the start;
    None where the fit takes no rung."""
    stride = rung_stride(x.shape[0], subsample)
    if stride is None:
        return None
    xs, ys = x[::stride], y[::stride]
    p0 = standard_start(xs, prec.dtype)
    out = adam.follow(dense_value_and_grad(prec, xs, ys, jitter), p0, steps, lr, floors)
    out["start"] = p0
    return out


def clamp(p: dict[str, Tensor], cap: float) -> dict[str, Tensor]:
    """The kernel variance clamped to at most ``cap`` x the noise variance."""
    out = dict(p)
    out["log_variance"] = torch.minimum(p["log_variance"],
                                        p["log_noise_variance"] + math.log(cap))
    return out


def factors_in_float32(p: dict[str, Tensor], x: Tensor, jitter: float) -> bool:
    """Whether K + (noise + jitter variance) I, built in float64 in row
    blocks and rounded to float32, has a float32 Cholesky factor."""
    f64 = Precision("f64")
    p = {k: v.to(torch.float64) for k, v in p.items()}
    n = x.shape[0]
    s = x.to(torch.float64) / torch.exp(p["log_lengthscales"])
    var = torch.exp(p["log_variance"])
    k = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for r0 in range(0, n, ref_exact.BLOCK):
        k[r0:r0 + ref_exact.BLOCK] = matern52(var, sqdist(f64, s[r0:r0 + ref_exact.BLOCK], s))
    k.diagonal().add_(float(torch.exp(p["log_noise_variance"]) + jitter * var))
    info = torch.linalg.cholesky_ex(k)[1]
    del k
    return int(info) == 0


def certify(prec: Precision, p: dict[str, Tensor], x: Tensor, y: Tensor, jitter: float,
            cap: float = RATIO_CAP, min_cap: float = MIN_CAP, clamped: bool = True) -> dict:
    """Stage (b) for one mode at the rung's parameters ``p``: ``params``
    (certified, or None where the mode falls back), ``cap`` (the cap that
    certified, or the last one tried), ``loss`` (the certifying loss in
    ``prec``, NaN where none certified) and ``evals`` (the forwards tried).
    ``clamped`` False leaves the clamp out (a fault): the rung's parameters
    are certified as they are."""
    evals = 0
    last = cap
    while cap >= min_cap:
        q = clamp(p, cap) if clamped else dict(p)
        evals += 1
        last = cap
        if factors_in_float32(q, x, jitter):
            loss, _ = ref_exact.value_and_grad(prec, q, x, y, None, jitter)
            if math.isfinite(loss):
                return {"params": q, "cap": cap, "loss": loss, "evals": evals}
        cap /= 2.0
    return {"params": None, "cap": last, "loss": float("nan"), "evals": evals}


def full(prec: Precision, p0: dict[str, Tensor], x: Tensor, y: Tensor, z: Tensor, steps: int,
         lr: float, floors: dict[str, float], jitter: float) -> dict:
    """Stage (c) for one mode: ``steps`` Adam steps at full N from ``p0``
    and one more loss (``adam.follow``'s record)."""
    p0 = {k: v.detach().to(prec.dtype) for k, v in p0.items()}
    vag = lambda p, grad: ref_exact.value_and_grad(prec, p, x, y, z if grad else None, jitter)
    return adam.follow(vag, p0, steps, lr, floors)
