"""Serving traffic: ``PosteriorPredictor.predict_field`` requests from one
client, closed loop: the next request leaves when the last one returned.

Set-up makes the model's training data and its fixed hyperparameters from
the seed (no GP is fitted), fits the LF and HF EOF preprocessors on seeded
fields, writes the checkpoints under the temporary directory, loads the
predictor (its posterior cache is built there) and serves one request of
each size the traffic sends at its smallest and largest. Each request is a
slice of a pool of seeded LF fields; its size comes from the traffic's
sizes, each cycle of them shuffled by the seed, so every seed sends the same
sizes in another order. The window runs until ``--seconds`` have passed and
the request in flight has returned. Requests drawn from the seed are kept
and compared with the reference once the window has closed.
"""

from __future__ import annotations

import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import compare, data
from perfbench.reference import eof as ref_eof
from perfbench.reference import exact as ref_exact
from perfbench.reference import sgpr as ref_sgpr
from perfbench.reference.precision import Precision


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def sizes(traffic: dict) -> list[int]:
    s = traffic["sizes"]
    return list(range(s["from"], s["to"] + 1)) if isinstance(s, dict) else list(s)


def bucket(cfg: dict, k: int) -> int:
    """The padded size a request of ``k`` fields runs at: the smallest of
    the predictor's buckets that holds it."""
    return next((b for b in sorted(cfg["buckets"]) if k <= b), k)


class Plan:
    """The request stream: (size, offset into the pool, kept for the check)."""

    def __init__(self, traffic: dict, pool: int, seed: int):
        self.sizes = sizes(traffic)
        self.pool = pool
        self.share = float(traffic["kept_share"])
        self.gen = torch.Generator().manual_seed(int(seed) % (1 << 62))
        self.queue: list[int] = []

    def next(self) -> tuple[int, int, bool]:
        if not self.queue:
            order = torch.randperm(len(self.sizes), generator=self.gen).tolist()
            self.queue = [self.sizes[i] for i in order]
        k = self.queue.pop()
        draws = torch.rand(2, generator=self.gen, dtype=torch.float64).tolist()
        off = int(draws[0] * (self.pool - k + 1))
        return k, off, draws[1] < self.share


def setup(cell) -> dict:
    from gpras_tpu_torch import GPRAS, PosteriorPredictor, PreProcessor

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    x, y, w = data.training_set(cfg, cell.seed, dev)
    params = data.hyperparameters(cfg, w)
    if cfg["model_type"] != "exact":
        z = data.inducing_points(cfg, x, cell.seed)
        params["z"] = z.expand((cfg["hf_modes"],) + z.shape).contiguous()
    lf_fit, hf_fit, elev = data.fields(cfg, cell.seed, "preprocessor", cfg["eof_events"], dev)
    pool = data.fields(cfg, cell.seed, "requests", tr["pool"], dev, hf=False)[0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, f, modes in (("lf", lf_fit, cfg["lf_modes"]), ("hf", hf_fit, cfg["hf_modes"])):
            pre = PreProcessor(hydraulic_parameter="wse", wet_threshold=cfg["wet_threshold"],
                               device=dev)
            pre.fit(f.cpu().numpy(), elev.cpu().numpy(), spatial_mode_count=modes)
            pre.to_file(tmp / f"{name}_pre.npz")
        model = GPRAS(cfg["kernel"], model_type=cfg["model_type"],
                      exact_engine=cfg.get("exact_engine", "auto"), device=dev)
        model.x, model.y, model.params = x, y, params
        model.n_inducing = cfg.get("n_inducing", 0)
        model.to_file(tmp / "gp.npz")
        del model
        pred = PosteriorPredictor(tmp / "gp.npz", hf_preprocessor_path=tmp / "hf_pre.npz",
                                  lf_preprocessor_path=tmp / "lf_pre.npz",
                                  buckets=tuple(cfg["buckets"]), device=dev)
    pool_np = pool.cpu().numpy()
    for k in sorted({min(sizes(tr)), max(sizes(tr))}):
        pred.predict_field(pool_np[:k])
    _sync(dev)
    return {"cell": cell, "x": x, "y": y, "params": params, "pred": pred, "pool": pool_np,
            "lf_fit": lf_fit, "hf_fit": hf_fit, "elev": elev,
            "plan": Plan(tr, tr["pool"], cell.seed)}


def counters() -> dict[str, int]:
    from gpras_tpu_torch.ops import fused_gram

    return {k: getattr(fused_gram, k).launches for k in ("kmv_dense", "kmv_sym")}


def run_window(state, seconds: float) -> dict:
    pred, pool, plan = state["pred"], state["pool"], state["plan"]
    requests, kept = [], []
    t0 = time.perf_counter()
    while True:
        k, off, keep = plan.next()
        before = counters()
        t = time.perf_counter()
        field, var = pred.predict_field(pool[off:off + k])
        lat = time.perf_counter() - t
        after = counters()
        requests.append({"fields": k, "bucket": bucket(state["cell"].config, k), "latency_s": lat,
                         "launches": {c: after[c] - before[c] for c in after}})
        if keep:
            kept.append((off, k, field, var))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if not kept:  # at least one answer is compared: the last
        kept.append((off, k, field, var))
    return {"window_s": window_s, "requests": requests, "kept": kept,
            "attempted": len(requests), "failed": 0}


def end_to_end(state, window) -> dict[str, float]:
    lat = [r["latency_s"] for r in window["requests"]]
    out = {"fields_per_s": sum(r["fields"] for r in window["requests"]) / window["window_s"]}
    if len(lat) >= 20:
        out["request_p95_ms"] = statistics.quantiles(lat, n=20)[18] * 1e3
    return out


def layer_context(state, window) -> dict:
    return {"requests": window["requests"]}


def reference_fields(state, rows: np.ndarray, precision: str):
    """The reference's HF fields and variances for the pool rows ``rows``."""
    cfg = state["cell"].config
    prec = Precision(precision)
    dev = state["x"].device
    lf = ref_eof.Eof(state["lf_fit"], state["elev"], cfg["lf_modes"], cfg["wet_threshold"])
    hf = ref_eof.Eof(state["hf_fit"], state["elev"], cfg["hf_modes"], cfg["wet_threshold"])
    xq = lf.transform(torch.as_tensor(state["pool"][rows], device=dev))
    means, variances = [], []
    for m in range(cfg["hf_modes"]):
        p = {k: v[m] for k, v in state["params"].items()}
        fn = ref_exact.posterior if cfg["model_type"] == "exact" else ref_sgpr.posterior
        mean, var = fn(prec, p, state["x"], state["y"][:, m], xq, cfg["jitter"])
        means.append(mean.double())
        variances.append(var.double())
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    field, fvar = hf.decode(torch.stack(means, 1), torch.stack(variances, 1))
    return field.cpu().numpy(), fvar.cpu().numpy(), hf


def check(state, window, precision: str = "f64") -> tuple[dict[str, float], dict]:
    state["pred"] = None
    if state["cell"].device == "cuda":
        torch.cuda.empty_cache()
    rows = np.unique(np.concatenate([np.arange(off, off + k) for off, k, _, _ in window["kept"]]))
    field, fvar, hf = reference_fields(state, rows, precision)
    where = {r: i for i, r in enumerate(rows.tolist())}
    served = []
    for off, k, f, v in window["kept"]:
        idx = [where[r] for r in range(off, off + k)]
        served.append((f, v, field[idx], fvar[idx]))
    numbers = compare.serve_numbers(served, hf.wet.cpu().numpy(), hf.elevation.cpu().numpy(),
                                    hf.mean_field().cpu().numpy())
    return numbers, {"requests_compared": len(window["kept"]), "fields_compared": int(len(rows))}


def control_unit(state) -> dict:
    """One request, for ``control.py``."""
    return run_window(state, 0.0)


def control_readings(state, unit: dict, control: bool) -> list[tuple[str, dict, dict]]:
    """The request's numbers against the float64 reference; with
    ``control``, the TF32 reference's in the program's place."""
    state["pred"] = None
    if state["cell"].device == "cuda":
        torch.cuda.empty_cache()
    rows = np.unique(np.concatenate([np.arange(o, o + k) for o, k, _, _ in unit["kept"]]))
    where = {r: i for i, r in enumerate(rows.tolist())}
    field, fvar, hf = reference_fields(state, rows, "f64")
    args = (hf.wet.cpu().numpy(), hf.elevation.cpu().numpy(), hf.mean_field().cpu().numpy())

    def served(f_of):
        return [(*f_of(off, k, f, v), field[[where[r] for r in range(off, off + k)]],
                 fvar[[where[r] for r in range(off, off + k)]])
                for off, k, f, v in unit["kept"]]

    out = [("program", compare.serve_numbers(served(lambda o, k, f, v: (f, v)), *args), {})]
    if control:
        cf, cv, _ = reference_fields(state, rows, "tf32")
        out.append(("control_tf32", compare.serve_numbers(
            served(lambda o, k, f, v: (cf[[where[r] for r in range(o, o + k)]],
                                       cv[[where[r] for r in range(o, o + k)]])), *args), {}))
    return out
