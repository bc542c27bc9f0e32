"""Adam as the model's optimizer states it (optax's update: b1 0.9, b2
0.999, eps 1e-7 outside the square root, bias correction 1 - b^t), with
its lower bounds projected after each step, followed for a few steps."""

from __future__ import annotations

from collections.abc import Callable

import torch

Tensor = torch.Tensor


def follow(value_and_grad: Callable, p0: dict[str, Tensor], steps: int, lr: float,
           floors: dict[str, float]) -> dict:
    """Runs ``steps`` Adam steps from ``p0`` and one more loss evaluation.
    Returns the losses before each step and after the last (steps + 1), the
    first gradient, and the parameters after the last step."""
    b1, b2, eps = 0.9, 0.999, 1e-7
    p = {k: v.clone() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        loss, g = value_and_grad(p, True)
        losses.append(loss)
        if g is None:
            break
        if first is None:
            first = {k: v.clone() for k, v in g.items()}
        mu = {k: (1 - b1) * g[k] + b1 * mu[k] for k in p}
        nu = {k: (1 - b2) * g[k] ** 2 + b2 * nu[k] for k in p}
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        p = {k: p[k] - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in p}
        p = {k: torch.clamp_min(v, floors[k]) if k in floors else v for k, v in p.items()}
    losses.append(value_and_grad(p, False)[0])
    return {"losses": losses, "first_grad": first, "params": p}
