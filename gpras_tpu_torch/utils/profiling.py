"""Per-step loss logs of a fit.

Port of ``log_fit_losses`` from ``gpras_tpu/utils/profiling.py``; the
reference's phase timers and ``jax.profiler`` hooks are not ported.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("gpras_tpu_torch")


def log_fit_losses(info: dict, name: str) -> None:
    """Log every 50th step's loss of an optimizer ``info`` dict (NaN-padded
    losses, possibly batched over modes)."""
    losses = info["losses"].cpu().numpy()
    if losses.ndim > 1:  # (modes, steps) -> mean over modes per step
        losses = np.nanmean(losses, axis=0)
    valid = losses[np.isfinite(losses)]
    for i in range(0, len(valid), 50):
        log.info("%s step %d: loss=%.6g", name, i, valid[i])
    if len(valid):
        log.info("%s final: loss=%.6g after %d steps", name, valid[-1], len(valid))
