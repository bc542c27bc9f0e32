"""Tracing/profiling: phase timers + torch.profiler traces + per-step loss logs.

Port of ``gpras_tpu/utils/profiling.py``: ``PhaseTimers`` (the reference's
timers.json surface, same JSON keys), ``profiler_trace`` on
``torch.profiler`` (a Chrome trace of the host and, on the card, the device,
written into ``log_dir``; ``None`` is a no-op), and ``log_fit_losses``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger("gpras_tpu_torch")


class PhaseTimers:
    """Named phase wall-clocks -> timers.json (reference pipeline.py:289-294)."""

    def __init__(self) -> None:
        self._starts: dict[str, float] = {}
        self.elapsed: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed[name] = self.elapsed.get(name, 0.0) + time.perf_counter() - t0

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self.elapsed[name] = time.perf_counter() - self._starts.pop(name)

    def to_file(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.elapsed, f, indent=4)


@contextlib.contextmanager
def profiler_trace(log_dir: str | Path | None):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format; no-op if dir None). The
    device's activity is recorded when a CUDA device is present."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


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
