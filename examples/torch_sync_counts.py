"""The port's blocking calls, counted two ways: the ``host_reads`` counter
of ``gpras_tpu_torch.utils.profiling`` against the synchronizing calls
that ``torch.cuda.set_sync_debug_mode("warn")`` reports, for
- one exact fit of one mode (Adam: ``steps`` steps and the closing loss
  evaluation, as each mode of a ``GPRAS.fit`` call; the Hutchinson engine,
  in place above 16,384 points);
- one SGPR request of ``--sgpr-fields`` fields;
- one exact request of ``--exact-fields`` fields (the matrix-free posterior).
Each phase runs once untimed first. One JSON line per phase: both counts,
the loss evaluations (``fit.eval`` spans) and the warned call sites (the
innermost frame of the package). On the CPU nothing synchronizes: the
counter alone is given.

    python examples/torch_sync_counts.py                      # N = 49,152, on the card
    python examples/torch_sync_counts.py --n 2048 --device cpu
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import tempfile
import threading
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpras_tpu_torch import GPRAS, PosteriorPredictor, PreProcessor  # noqa: E402
from gpras_tpu_torch.utils import profiling  # noqa: E402

PACKAGE = str(Path(__file__).resolve().parents[1] / "gpras_tpu_torch")


def counted(fn, device: torch.device) -> dict:
    """Runs ``fn`` under a profiler (so the spans and counters record) with
    the sync debug mode at "warn" on a CUDA device; both counts and the
    warned sites."""
    sites: collections.Counter = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # e.g. the mode's own notice that it is a prototype
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(PACKAGE)]
        if frames:
            sites[f"{Path(frames[-1].filename).name}:{frames[-1].lineno}"] += 1
        else:  # no frame of the package on this thread's stack
            sites[f"thread {threading.current_thread().name}"] += 1

    profiling.clear()
    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU]), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    spans, totals = profiling.records(), profiling.totals()
    return {"host_reads": totals.get("host_reads", 0),
            "sync_warnings": sum(sites.values()) if cuda else None,
            "evals": sum(s["name"] == "fit.eval" for s in spans),
            "sites": dict(sorted(sites.items()))}


def fields(gen: np.random.Generator, events: int, cells: int) -> tuple[np.ndarray, np.ndarray]:
    """Smooth WSE fields over a sloped bed with a dry band: (events, cells)."""
    c = np.linspace(0.0, 1.0, cells)
    elev = 10.0 * c
    elev[cells // 2: cells // 2 + cells // 20] = 40.0
    patterns = np.stack([np.sin((k + 1) * np.pi * c) for k in range(12)])
    amps = gen.normal(size=(events, 12)) / (1.0 + np.arange(12))
    return elev + 5.0 + amps @ patterns, elev


def predictor(model_type: str, x: torch.Tensor, y: torch.Tensor, params: dict, tmp: Path,
              device: torch.device) -> PosteriorPredictor:
    """A checkpoint of ``params`` (no fit) served from ``tmp``, beside the
    preprocessors there."""
    model = GPRAS("Matern52", model_type=model_type, device=device)
    model.x, model.y, model.params = x, y, params
    model.n_inducing = params["z"].shape[1] if "z" in params else 0
    model.to_file(tmp / f"{model_type}.npz")
    return PosteriorPredictor(tmp / f"{model_type}.npz", hf_preprocessor_path=tmp / "hf.npz",
                              lf_preprocessor_path=tmp / "lf.npz", device=device)


def main(n: int = 49152, d: int = 8, modes: int = 4, cells: int = 49152, steps: int = 3,
         sgpr_fields: int = 64, exact_fields: int = 256, inducing: int = 300,
         device: str = "cuda", seed: int = 0) -> dict[str, dict]:
    dev = torch.device(device)
    gen = np.random.default_rng(seed)
    x = torch.as_tensor(gen.uniform(-2.0, 2.0, (n, d)), dtype=torch.float32, device=dev)
    y = torch.sin(x[:, :modes]) + 0.1 * torch.as_tensor(
        gen.normal(size=(n, modes)), dtype=torch.float32, device=dev)
    start = {"log_variance": torch.zeros(modes, device=dev),
             "log_lengthscales": torch.zeros(modes, d, device=dev),
             "log_noise_variance": torch.full((modes,), math.log(0.1), device=dev)}
    out = {}

    model = GPRAS("Matern52", model_type="exact", device=dev)

    def fit(k: int):
        return lambda: model.fit(x, y[:, :1].contiguous(), optimization_method="adam",
                                 max_iter=k, learning_rate=0.02,
                                 initial_params={p: v[:1] for p, v in start.items()})

    fit(1)()
    out["fit"] = counted(fit(steps), dev)
    del model

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, k in (("lf", d), ("hf", modes)):
            f, elev = fields(gen, 300, cells)
            pre = PreProcessor(hydraulic_parameter="wse", device=dev)
            pre.fit(f, elev, spatial_mode_count=k)
            pre.to_file(tmp / f"{name}.npz")
        lf, _ = fields(gen, max(sgpr_fields, exact_fields), cells)
        z = x[torch.as_tensor(gen.choice(n, inducing, replace=False), device=dev)]
        for kind, k, params in (("sgpr", sgpr_fields,
                                 {**start, "z": z.expand(modes, *z.shape).contiguous()}),
                                ("exact", exact_fields, start)):
            pred = predictor(kind, x, y, params, tmp, dev)
            pred.predict_field(lf[:k])
            out[f"{kind}_request"] = counted(lambda: pred.predict_field(lf[:k]), dev)
            del pred
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=49152)
    ap.add_argument("--cells", type=int, default=49152)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--sgpr-fields", type=int, default=64)
    ap.add_argument("--exact-fields", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for phase, got in main(n=args.n, cells=args.cells, steps=args.steps,
                           sgpr_fields=args.sgpr_fields, exact_fields=args.exact_fields,
                           device=args.device).items():
        print(json.dumps({"phase": phase, **got}), flush=True)
