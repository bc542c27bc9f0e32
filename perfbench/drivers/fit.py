"""Training traffic: back-to-back ``GPRAS.fit`` calls, closed loop, from
the configuration's start parameters, on data made from the seed.

Set-up builds one ``GPRAS`` and warms it up with one step of one mode at
the cell's N, which builds every kernel the window uses. The window repeats
the full call until ``--seconds`` have passed and the call in flight has
returned. Every call goes through an observer on the model's loss, which
records, for each mode, the parameters at the first ``steps + 1`` loss
evaluations and the gradient of the first, as the optimizer receives it.
The last call of the window is compared, every mode, with the reference,
which follows the same Adam steps in float64.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import compare, data
from perfbench.reference import adam
from perfbench.reference import exact as ref_exact
from perfbench.reference.precision import Precision

FOLLOWED = 3  # Adam steps the reference follows


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


class Observer:
    """Wraps ``model._loss_fn``: per mode, the parameters at the first
    ``calls`` loss evaluations and the first evaluation's gradient."""

    def __init__(self, model, calls: int):
        self.model, self.calls = model, calls
        self.inner = model._loss_fn
        model._loss_fn = self
        self.reset()

    def reset(self) -> None:
        self.count: dict[int, int] = {}
        self.params: dict[int, list] = {}
        self.grad: dict[int, dict] = {}

    def __call__(self, p, y_i):
        mode = (y_i.data_ptr() - self.model.y.data_ptr()) // y_i.element_size()
        c = self.count.get(mode, 0)
        self.count[mode] = c + 1
        if c < self.calls:
            self.params.setdefault(mode, []).append({k: v.detach().clone() for k, v in p.items()})
            if c == 0 and torch.is_grad_enabled():
                store = self.grad.setdefault(mode, {})
                for k, v in p.items():
                    if v.requires_grad:
                        v.register_hook(lambda g, k=k: store.__setitem__(k, g.detach().clone()))
        return self.inner(p, y_i)


def setup(cell) -> dict:
    from gpras_tpu_torch import GPRAS

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    if cfg["model_type"] != "exact":
        raise ValueError(f"the fit driver runs exact models, not {cfg['model_type']!r}")
    x, y, w = data.training_set(cfg, cell.seed, dev)
    start = data.hyperparameters(cfg, w)
    kwargs = {"optimization_method": tr["optimizer"], "max_iter": tr["max_iter"],
              "learning_rate": tr["learning_rate"]}
    model = GPRAS(cfg["kernel"], model_type=cfg["model_type"],
                  exact_engine=cfg.get("exact_engine", "auto"), device=dev)
    state = {"cell": cell, "x": x, "y": y, "start": start, "kwargs": kwargs, "model": model,
             "observer": Observer(model, FOLLOWED + 1)}
    # the warm-up: one step of the first mode, the same N and engine
    model.fit(x, y[:, :1].contiguous(), initial_params={k: v[:1] for k, v in start.items()},
              **{**kwargs, "max_iter": 1})
    _sync(dev)
    return state


def fit_call(state) -> dict:
    model, obs = state["model"], state["observer"]
    obs.reset()
    model.fit(state["x"], state["y"], initial_params=state["start"], **state["kwargs"])
    _sync(state["cell"].device)
    info = model.fit_info
    return {"iterations": [int(i) for i in info["iterations"]],
            "losses": info["losses"].detach().cpu().double().numpy(),
            "loss": info["loss"].detach().cpu().double().numpy(),
            "params": obs.params, "grad": obs.grad}


def counters() -> dict[str, int]:
    from gpras_tpu_torch.ops import fused_gram

    return {k: getattr(fused_gram, k).launches for k in ("kgrad_dense", "kgrad_sym")}


def run_window(state, seconds: float) -> dict:
    dev = state["cell"].device
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = counters()
    calls = []
    t0 = time.perf_counter()
    while True:
        calls.append(fit_call(state))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    after = counters()
    steps = sum(sum(c["iterations"]) for c in calls)
    # each mode of a call closes with one more evaluation of the loss
    evaluations = steps + sum(len(c["iterations"]) for c in calls)
    failed = int(sum(np.sum(~np.isfinite(c["losses"][:, :max(c["iterations"])])) for c in calls))
    return {"window_s": window_s, "steps": steps, "evaluations": evaluations,
            "calls": len(calls), "last": calls[-1],
            "iterations": [c["iterations"] for c in calls], "attempted": steps,
            "failed": failed, "launches": {k: after[k] - before[k] for k in after},
            "peak_bytes": torch.cuda.max_memory_allocated() if dev == "cuda" else 0}


def end_to_end(state, window) -> dict[str, float]:
    return {"fit_step_s": window["window_s"] / window["evaluations"],
            "peak_mem_gb": window["peak_bytes"] / 1e9}


def layer_context(state, window) -> dict:
    return {"steps": window["steps"], "iterations": window["iterations"],
            "launches": window["launches"]}


def program_readings(call: dict, modes: list[int], steps: int) -> dict:
    """The compared call's losses, first gradient and parameters after
    ``steps`` steps, per mode, as float64 CPU tensors."""
    out = {}
    for m in modes:
        it = call["iterations"][m]
        losses = list(call["losses"][m][:it]) + [float(call["loss"][m])]
        seen = call["params"].get(m, [])
        out[m] = {"losses": losses[:steps + 1],
                  "first_grad": call["grad"].get(m) or None,
                  "params": seen[steps] if len(seen) > steps else seen[-1]}
    return out


def follow_reference(state, modes: list[int], precision: str, rows: int | None = None) -> dict:
    """The reference's losses, first gradient and parameters after
    ``FOLLOWED`` Adam steps, per mode, in ``precision``; ``rows`` keeps only
    the first rows of the data (a fault: part of the batch left out)."""
    cfg, tr = state["cell"].config, state["cell"].traffic
    prec = Precision(precision)
    x, y = state["x"], state["y"]
    if rows is not None:
        x, y = x[:rows], y[:rows]
    n = x.shape[0]
    jitter = cfg["jitter"]
    floors = {k: math.log(v) for k, v in cfg.get("floors", {}).items()}
    z = ref_exact.probes(n, cfg["probes"]).to(x.device)
    out = {}
    for m in modes:
        p0 = {k: v[m].detach().to(prec.dtype) for k, v in state["start"].items()}
        vag = lambda p, grad, m=m: ref_exact.value_and_grad(
            prec, p, x, y[:, m], z if grad else None, jitter)
        out[m] = adam.follow(vag, p0, FOLLOWED, tr["learning_rate"], floors)
    return out


def check(state, window, precision: str = "f64") -> tuple[dict[str, float], dict]:
    """Frees the program's state, then the numbers of the window's last call
    against the reference followed in ``precision``."""
    modes = list(range(state["cell"].config["hf_modes"]))
    prog = program_readings(window["last"], modes, FOLLOWED)
    state["model"] = state["observer"] = None
    if state["cell"].device == "cuda":
        torch.cuda.empty_cache()
    ref = follow_reference(state, modes, precision)
    start = {m: {k: v[m] for k, v in state["start"].items()} for m in modes}
    return compare.fit_numbers(prog, ref, start), {"modes": modes}


def control_unit(state) -> dict:
    """One full fit call, for ``control.py``."""
    return fit_call(state)


def control_readings(state, unit: dict, control: bool) -> list[tuple[str, dict, dict]]:
    """The call's numbers against the float64 reference, with each mode's
    leaves; with ``control``, the TF32 reference's and the fault of half of
    the rows left out (the reference on the first N / 2 rows)."""
    modes = list(range(state["cell"].config["hf_modes"]))
    prog = program_readings(unit, modes, FOLLOWED)
    state["model"] = state["observer"] = None
    if state["cell"].device == "cuda":
        torch.cuda.empty_cache()
    start = {m: {k: v[m] for k, v in state["start"].items()} for m in modes}
    ref = follow_reference(state, modes, "f64")
    out = [("program", compare.fit_numbers(prog, ref, start),
            {"leaves": compare.fit_detail(prog, ref, start)})]
    if control:
        ctrl = follow_reference(state, modes, "tf32")
        out.append(("control_tf32", compare.fit_numbers(ctrl, ref, start),
                    {"leaves": compare.fit_detail(ctrl, ref, start)}))
        half = follow_reference(state, modes, "f64", rows=state["x"].shape[0] // 2)
        out.append(("fault_half_rows", compare.fit_numbers(half, ref, start), {}))
    return out
