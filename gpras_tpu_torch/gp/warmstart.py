"""Warm-start transfer protocol for large-N exact-GP fits.

Port of ``gpras_tpu/gp/warmstart.py``. A fit on a subsample rung hands its
hyperparameters to the full-N fit only after the conditioning-envelope
clamp (kernel variance <= ``ratio_cap`` x noise variance), and the full-N
fit certifies the clamped parameters with one forward loss evaluation per
mode, halving the cap while the loss is not finite (each certifying forward
counts ``warm.cert_evals``, each mode left at the standard init
``warm.fallback_modes``). The reason, measured by
the reference on the hard data recipe at N = 49,152: a subsample inflates
the variance along a flat ridge of the likelihood, and the unclamped
transfer does not factor in float32.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from gpras_tpu_torch.utils.profiling import count

Tensor = torch.Tensor

#: The reference's float32 feasibility envelope at N = 49,152 (its full-N cold
#: fit converges at var/noise = 47); 50 is that operating point with margin.
DEFAULT_RATIO_CAP = 50.0
#: The default cap certification halves down to before it gives up on a
#: transfer (``min_cap``).
MIN_RATIO_CAP = 2.0


def transfer_clamp(params: dict[str, Tensor],
                   ratio_cap: float = DEFAULT_RATIO_CAP) -> dict[str, Tensor]:
    """Clamp the kernel variance to ``<= ratio_cap * noise_variance``; every
    other entry is returned untouched. Works on one mode or a mode-batched
    dict (elementwise)."""
    p = dict(params)
    lv = p["log_variance"]
    p["log_variance"] = torch.minimum(lv, p["log_noise_variance"] + math.log(ratio_cap))
    return p


def certify_transfer(
    loss_fn: Callable[[dict[str, Tensor]], Any],
    params: dict[str, Tensor],
    ratio_cap: float = DEFAULT_RATIO_CAP,
    min_cap: float = MIN_RATIO_CAP,
) -> tuple[dict[str, Tensor], dict[str, Any]]:
    """Clamp ``params`` into the feasibility envelope of ``loss_fn``: one
    forward evaluation at the clamped parameters certifies them; while the
    loss is not finite the cap halves, down to ``min_cap``.

    Returns ``(clamped_params, info)`` with ``info["feasible"]``,
    ``info["ratio_cap_used"]`` and ``info["cert_loss"]`` (NaN when
    infeasible)."""
    cap = float(ratio_cap)
    cert = float("nan")
    while cap >= min_cap:
        clamped = transfer_clamp(params, cap)
        count("warm.cert_evals")
        with torch.no_grad():
            cert = float(loss_fn(clamped))
        if math.isfinite(cert):
            return clamped, {"feasible": True, "ratio_cap_used": cap, "cert_loss": cert}
        cap /= 2.0
    return transfer_clamp(params, min_cap), {
        "feasible": False, "ratio_cap_used": cap * 2.0, "cert_loss": cert}


def certify_transfer_batched(
    loss_fn: Callable[[dict[str, Tensor], int], Any],
    params: dict[str, Tensor],
    fallback: dict[str, Tensor],
    ratio_cap: float = DEFAULT_RATIO_CAP,
    min_cap: float = MIN_RATIO_CAP,
) -> tuple[dict[str, Tensor], dict[str, Any]]:
    """``certify_transfer`` per mode of a mode-batched parameter dict.

    ``loss_fn(p_i, i)`` is mode ``i``'s full-N loss; a mode whose transfer
    stays infeasible down to ``min_cap`` takes its entry of ``fallback`` (the
    standard init). Returns ``(params, info)`` with per-mode
    ``info["ratio_caps"]``, ``info["cert_losses"]`` and
    ``info["fell_back_modes"]``."""
    n_modes = next(iter(params.values())).shape[0]
    out_modes, caps, certs, fell_back = [], [], [], []
    for i in range(n_modes):
        p_i = {k: v[i] for k, v in params.items()}
        clamped, info = certify_transfer(lambda p: loss_fn(p, i), p_i, ratio_cap=ratio_cap,
                                         min_cap=min_cap)
        caps.append(info["ratio_cap_used"])
        certs.append(info["cert_loss"])
        if info["feasible"]:
            out_modes.append(clamped)
        else:
            fell_back.append(i)
            count("warm.fallback_modes")
            out_modes.append({k: v[i] for k, v in fallback.items()})
    stacked = {k: torch.stack([m[k] for m in out_modes]) for k in params}
    return stacked, {"ratio_caps": caps, "cert_losses": certs, "fell_back_modes": fell_back}
