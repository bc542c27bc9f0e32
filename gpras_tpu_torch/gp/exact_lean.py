"""Memory-lean exact-GP NLML: the exact gradient in column panels.

Port of ``gpras_tpu/gp/exact_lean.py``. The dense engine (``gp/exact.py``)
differentiates ``kernels.gram`` by autograd and its backward forms K^-1 and
the cotangent K_bar whole: several (N, N) buffers beside the factor. This
engine keeps the same mathematics,

    dNLML/dK = 0.5 (K^-1 - alpha alpha^T),

but rebuilds K^-1 one (N, R) column panel at a time: each panel solves
(L L^T) Z = E_panel for its identity columns, forms its slice of K_bar, and
contracts it with dK/dtheta by autograd of the Gram panel k(x, x_panel).
The backward holds the forward's factor and O(N R) temporaries. Its
operations are the dense backward's: the identity solves are O(N^3).

``engine`` picks the factorization as ``gp/exact_stochastic``'s ``chol``
does: the library's (``None`` / ``"xla"``), ``"super"`` (kernel B1's
one-buffer Gram on the card, ``super_cholesky`` in place, the blocked
solves: one (N, N) buffer in all) or ``"blocked"``.
"""

from __future__ import annotations

import torch

from gpras_tpu_torch.gp.exact_stochastic import _XLA, _Factor, _forward, _super_factor
from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import block_cholesky as bc
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg

Tensor = torch.Tensor


class _LeanNLML(torch.autograd.Function):
    """NLML over the parameters ``values`` (named ``names``); saves the
    factor L and alpha, and rebuilds K^-1 panel by panel in the backward."""

    @staticmethod
    def forward(ctx, kernel, factor, col_panel, names, x, y, *values):
        ctx.kernel, ctx.factor, ctx.col_panel, ctx.names = kernel, factor, col_panel, names
        out, l, alpha = _forward(kernel, factor, dict(zip(names, values)), x, y)
        ctx.save_for_backward(x, l, alpha, *values)
        return out

    @staticmethod
    def backward(ctx, g):
        x, l, alpha, *values = ctx.saved_tensors
        params = dict(zip(ctx.names, values))
        g = g.to(x.dtype)
        n = x.shape[0]
        r = bc.fit_block(n, ctx.col_panel)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        diag_sum = torch.zeros((), dtype=x.dtype, device=x.device)
        eye_cols = torch.zeros((n, r), dtype=x.dtype, device=x.device)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                      for k, v in params.items()}
            diff = [k for k, v in leaves.items() if v.requires_grad]
            for c0 in range(0, n, r):
                cols = slice(c0, c0 + r)
                eye_cols[cols].diagonal().fill_(1.0)
                z = ctx.factor.solve(l, eye_cols)  # (N, R) columns of K^-1
                eye_cols[cols].diagonal().fill_(0.0)
                # K_bar's panel, in place: 0.5 g (Z - alpha alpha_cols^T)
                kbar = z.addr_(alpha, alpha[cols], alpha=-1.0).mul_(0.5 * g)
                diag_sum += kbar[cols].diagonal().sum()
                kmat = K.gram(ctx.kernel, leaves, x, x[cols])
                parts = torch.autograd.grad(kmat, [leaves[k] for k in diff], kbar,
                                            allow_unused=True)
                del kmat, kbar, z
                for k, gk in zip(diff, parts):
                    if gk is not None:
                        grads[k] += gk
        grads["log_noise_variance"] += diag_sum * torch.exp(params["log_noise_variance"])
        grads["log_variance"] += \
            diag_sum * linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
        y_grad = g * alpha if ctx.needs_input_grad[5] else None
        return (None, None, None, None, None, y_grad, *(grads[k] for k in ctx.names))


def make_lean_nlml(kernel: str, col_panel: int = 2048, blocked: int | None = None,
                   engine: str | None = None, chol_w: int = 1024, chol_strip: int = 16384):
    """Returns ``nlml(params, x, y)`` (y strictly (N,)) with the panel
    backward, differentiable with respect to the parameters and y. The
    panels are ``fit_block(N, col_panel)`` columns wide.

    ``engine``: ``None`` or ``"xla"``, ``torch.linalg.cholesky_ex`` and
    ``torch.cholesky_solve``; ``"super"``, ``super_cholesky`` in place
    (panels of the largest divisor of N at or below ``chol_w``, trailing
    strips of ``chol_strip``) on B1's Gram, and the blocked solves;
    ``"blocked"``, ``blocked_cholesky`` and the blocked solves in blocks of
    ``blocked`` (512 when not given; ``blocked=b`` alone also selects this
    engine, the reference's older spelling)."""
    if blocked is not None and engine is None:
        engine = "blocked"
    if engine == "super":
        factor = _super_factor(chol_w, chol_strip)
    elif engine == "blocked":
        b = blocked or 512
        factor = _Factor(False, lambda k: bc.blocked_cholesky(k, b),
                         lambda l, rhs: bc.blocked_cho_solve(l, rhs, b))
    elif engine in (None, "xla"):
        factor = _XLA
    else:
        raise ValueError(f"unknown engine {engine!r}; expected None|xla|super|blocked")

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
        names = tuple(params)
        return _LeanNLML.apply(kernel, factor, col_panel, names, x, y,
                               *(params[k] for k in names))

    return nlml


def make_lean_training_loss(kernel: str, col_panel: int = 2048, blocked: int | None = None,
                            **engine_kwargs):
    """``loss(params, x, y)``: the lean NLML minus the log prior (the
    optimizer's objective); ``engine_kwargs`` go to ``make_lean_nlml``."""
    nlml = make_lean_nlml(kernel, col_panel, blocked, **engine_kwargs)

    def loss(params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
        return nlml(params, x, y) - log_prior(params)

    return loss
