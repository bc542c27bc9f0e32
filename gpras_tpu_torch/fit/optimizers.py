"""Optimizers over a GP training loss.

Port of the part of ``gpras_tpu/fit/optimizers.py`` that the exact-GP fit
runs: the gradient masks and floors, ``adam_fit`` with the reference's early
stop, and ``two_stage_fit`` (``GPRAS.fit``'s default method). The reference
runs Adam inside one ``lax.while_loop``; here a Python loop takes the steps
and reads the loss once per step to apply the stopping rule.

Adam is optax's update, not ``torch.optim.Adam``'s: eps 1e-7 (tf.keras's
default, which the reference keeps) outside the square root, and optax's
bias correction, 1 - b**t computed in float64 and divided in the
parameter's dtype.

``FITTERS`` keeps the reference's keys; the methods not ported yet raise
NotImplementedError naming ROADMAP.md item A2.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Tensor = torch.Tensor
Params = dict[str, Tensor]
LossFn = Callable[[Params], Tensor]

#: Structural (non-trainable) parameter keys, excluded from every gradient mask.
NON_TRAINABLE = ("degree",)


def mask_only(params: Params, keys: tuple[str, ...]) -> Params:
    """Mask that trains only ``keys``."""
    return {k: torch.tensor(float(k in keys and k not in NON_TRAINABLE)) for k in params}


def mask_except(params: Params, keys: tuple[str, ...] = ()) -> Params:
    """Mask that trains everything except ``keys`` (and structural constants)."""
    return {k: torch.tensor(float(k not in keys and k not in NON_TRAINABLE)) for k in params}


def _apply_mask(grads: Params, mask: Params | None) -> Params:
    if mask is None:
        mask = {k: torch.tensor(float(k not in NON_TRAINABLE)) for k in grads}
    return {k: grads[k] * mask[k].to(dtype=grads[k].dtype, device=grads[k].device)
            for k in grads}


def _apply_floors(params: Params, floors: dict[str, float] | None) -> Params:
    """Project parameters onto ``{p_k >= floor_k}`` after an update step (the
    float32 noise floor of the exact-GP fit)."""
    if not floors:
        return params
    return {k: (torch.clamp_min(v, floors[k]) if k in floors else v) for k, v in params.items()}


def value_and_grad(loss_fn: LossFn, params: Params) -> tuple[Tensor, Params]:
    """(loss, gradient) of ``loss_fn`` at ``params``; zero gradients where the
    loss does not depend on a parameter."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in params.items()}
        loss = loss_fn(leaves)
        names = [k for k, v in leaves.items() if v.requires_grad]
        parts = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for k, gk in zip(names, parts):
        if gk is not None:
            grads[k] = gk
    return loss.detach(), grads


def _adam_update(grads: Params, state: tuple[Params, Params, int], lr: float,
                 b1: float, b2: float, eps: float) -> tuple[Params, tuple]:
    """optax.adam's update (scale_by_adam, then scale by -lr)."""
    mu, nu, count = state
    mu = {k: (1 - b1) * g + b1 * mu[k] for k, g in grads.items()}
    nu = {k: (1 - b2) * g ** 2 + b2 * nu[k] for k, g in grads.items()}
    count += 1
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    updates = {k: -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in grads}
    return updates, (mu, nu, count)


def adam_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    learning_rate: float = 0.001,
    tol: float = 1e-5,
    patience: int = 50,
    mask: Params | None = None,
    lower_bounds: dict[str, float] | None = None,
    reject_nonfinite: bool = False,
) -> tuple[Params, dict[str, Any]]:
    """Adam with the reference's early stopping (gpras/gpr.py:159-173).

    Stops when the relative improvement over the best-seen loss has been
    below ``tol`` for more than ``patience`` consecutive steps. Defaults
    mirror tf.keras Adam (lr 0.001, eps 1e-7). ``lower_bounds`` projects
    named parameters onto ``>= floor`` after each step.

    ``reject_nonfinite``: a step whose loss or gradient is not finite is
    skipped, and parameters and optimizer state go back to the last finite
    iterate (the step still counts against ``patience``); at the end, if the
    last iterate's loss is not finite, the last good parameters are
    returned. Without it a non-finite loss stops the fit at once.

    Returns ``(params, {"iterations", "losses", "loss"})``: ``losses`` holds
    ``max_iter`` entries, NaN past the last step.
    """
    b1, b2, eps = 0.9, 0.999, 1e-7
    p = {k: v.detach() for k, v in params.items()}
    ref = next(iter(p.values()))
    state = ({k: torch.zeros_like(v) for k, v in p.items()},
             {k: torch.zeros_like(v) for k, v in p.items()}, 0)
    losses = torch.full((max_iter,), float("nan"), dtype=ref.dtype, device=ref.device)
    best = torch.tensor(float("inf"), dtype=ref.dtype, device=ref.device)
    good_p, good_state = p, state
    i = count = 0
    while i < max_iter and count <= patience:
        loss, grads = value_and_grad(loss_fn, p)
        grads = _apply_mask(grads, mask)
        updates, state_next = _adam_update(grads, state, learning_rate, b1, b2, eps)
        p_next = _apply_floors({k: p[k] + updates[k] for k in p}, lower_bounds)
        improved = bool((best - loss) / torch.abs(loss) > tol)
        if improved:
            best = loss
        count = 0 if improved else count + 1
        losses[i] = loss
        if reject_nonfinite:
            finite = bool(torch.isfinite(loss)) and all(
                bool(torch.all(torch.isfinite(g))) for g in grads.values())
            if finite:
                good_p, good_state = p, state
            else:
                p_next, state_next = good_p, good_state
        elif not bool(torch.isfinite(loss)):
            # a non-finite loss can never improve again: stop now
            count = patience + 1
        p, state = p_next, state_next
        i += 1
    with torch.no_grad():
        final = loss_fn(p)
        if reject_nonfinite and not bool(torch.isfinite(final)):
            p = good_p
            final = loss_fn(p)
    return p, {"iterations": i, "losses": losses, "loss": final.detach()}


def two_stage_fit(loss_fn: LossFn, params: Params, max_iter: int = 100,
                  **adam_kwargs: Any) -> tuple[Params, dict[str, Any]]:
    """The reference's two stages are Adam on the inducing inputs Z, then on
    everything else (gpras/gpr.py:112-127). The exact model, the only one
    ported, has no Z, so this is one ``adam_fit``."""
    return adam_fit(loss_fn, params, max_iter, **adam_kwargs)


def _not_ported(name: str):
    def fitter(*args: Any, **kwargs: Any):
        raise NotImplementedError(
            f"optimization_method {name!r} is not ported yet (ROADMAP.md item A2); "
            "the port trains with 'adam' and 'two-stage'")

    fitter.__name__ = f"not_ported_{name}"
    return fitter


FITTERS: dict[str, Callable[..., tuple[Params, dict[str, Any]]]] = {
    "two-stage": two_stage_fit,
    "three-stage": _not_ported("three-stage"),
    "adam": adam_fit,
    "adadelta": _not_ported("adadelta"),
    "L-BFGS-B": _not_ported("L-BFGS-B"),
    "stochastic": _not_ported("stochastic"),
    "diffential_evolution": _not_ported("diffential_evolution"),  # [sic] reference key
    "differential_evolution": _not_ported("differential_evolution"),
}
