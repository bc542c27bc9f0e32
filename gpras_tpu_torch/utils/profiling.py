"""Per-step loss logs of a fit.

Port of ``log_fit_losses`` from ``gpras_tpu/utils/profiling.py``; the
reference's phase timers and ``jax.profiler`` hooks are not ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger("gpras_tpu_torch")


def log_fit_losses(info: dict, name: str = "fit", every: int = 50) -> list[float]:
    """Expand an optimizer ``info`` dict (NaN-padded losses, a tensor or a
    numpy array, possibly batched over modes) into logged per-step losses;
    returns the flat history."""
    if info.get("losses") is None:
        return []
    losses = info["losses"]
    if isinstance(losses, torch.Tensor):
        losses = losses.detach().cpu().numpy()
    losses = np.asarray(losses)
    if losses.ndim > 1:  # (modes, steps) -> mean over modes per step
        losses = np.nanmean(losses, axis=0)
    valid = losses[np.isfinite(losses)]
    for i in range(0, len(valid), max(every, 1)):
        log.info("%s step %d: loss=%.6g", name, i, valid[i])
    if len(valid):
        log.info("%s final: loss=%.6g after %d steps", name, valid[-1], len(valid))
    return valid.tolist()
