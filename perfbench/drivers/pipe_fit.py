"""The pipeline's exact fit: back-to-back ``GPRAS.fit`` calls as
``python -m gpras_tpu_torch run`` makes them with ``model_backend="exact"``,
closed loop, on the training events of a seeded project.

Set-up draws the training events' HF and LF water surfaces on the device by
``chip_smoke.pipeline_project``'s recipe (a sloped valley, three flood
waves with random kicks of their amplitudes and 5 mm of noise per cell on
the HF field; the LF field the waves without kicks at 0.9 of their
amplitude, averaged over blocks of HF cells, 0.1-0.15 m high), fits the HF
``PreProcessor`` as the pipeline's ``ras_upskill`` does (the HF field, the
cells' elevations and areas, the configured mode count) and transforms both
fidelities with it: x the LF modes, y the HF modes, (N, P) each, the arrays
the pipeline hands to ``GPRAS.fit``. It warms up with one whole call at
``max_iter`` 1. The window repeats the call, never with ``initial_params``,
so each call runs the warm-start rung, the clamp and the certification,
then Adam at full N.

An observer on the model's full-N loss (the rung's loss is another model's)
counts every full-N evaluation and tells the certification's (before the
first with a gradient) from Adam's. The last call is checked stage by
stage against ``reference/warm_start.py``, each stage from the program's
own input to it: the rung from the program's x and y, the certification
from the program's rung optimum, Adam at full N (``FOLLOWED`` steps) from
the parameters the reference certifies there.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import compare, data
from perfbench.drivers.fit import _sync
from perfbench.reference import exact as ref_exact
from perfbench.reference import warm_start as ref_warm
from perfbench.reference.precision import Precision

FOLLOWED = 3  # Adam steps at full N the reference follows
CELL_AREA = 100.0  # m^2: the project's 10 m cells, the EOF fit's weights


def terrain(cfg: dict, device: str) -> dict[str, torch.Tensor]:
    """The valley: per cell (flattened) elevation, channel resting level,
    the LF model's bias, and the three flood waves' shapes (3, cells);
    float64, no randomness."""
    ny, nx = cfg["grid"]
    gy, gx = torch.meshgrid(*(torch.linspace(0, 1, k, device=device, dtype=torch.float64)
                              for k in (ny, nx)), indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    return {"elev": 2.0 * gx + 3.0 * (gy - 0.5).abs()
            + 0.05 * torch.sin(25 * gx) * torch.sin(25 * gy),
            "rest": 2.0 * gx + 0.2,
            "waves": torch.stack([torch.exp(-((gx - c) / 0.3) ** 2) * (1.0 - 0.6 * (gy - 0.5).abs())
                                  for c in (0.15, 0.5, 0.85)]),
            "lf_bias": 0.125 + 0.025 * torch.sin(2 * math.pi * gy)}


def fields(cfg: dict, seed: int, device: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(HF, LF) water surfaces of the training events, (events x steps,
    cells) float32 on ``device``, clamped at the ground, and the elevation.
    Each event: a peak in [0.5, 1.5], a start in [0.25, 0.45], a width in
    [0.08, 0.16] and a lag between waves in [0.04, 0.1] of its steps."""
    t = terrain(cfg, device)
    events, steps, b = cfg["events"][0], cfg["steps"], cfg["lf_block"]
    ny, nx = cfg["grid"]
    cells = ny * nx
    g = data.generator(seed, "pipeline", device)
    u = torch.rand((events, 4), generator=g, device=device, dtype=torch.float64)
    peak, start = 0.5 + u[:, 0], (0.25 + 0.2 * u[:, 1]) * steps
    width, lag = (0.08 + 0.08 * u[:, 2]) * steps, (0.04 + 0.06 * u[:, 3]) * steps
    ts = torch.arange(steps, device=device, dtype=torch.float64)[:, None]
    hf = torch.empty((events * steps, cells), dtype=torch.float32, device=device)
    lf = torch.empty_like(hf)
    for e in range(events):
        hydro = torch.cat([s * peak[e] * torch.exp(-((ts - start[e] - k * lag[e]) / width[e]) ** 2)
                           for k, s in enumerate((1.0, 0.85, 0.7))], dim=1)
        kicks = 0.08 * torch.randn((steps, 3), generator=g, device=device, dtype=torch.float64)
        h = t["rest"] + (hydro + kicks) @ t["waves"]
        h += 0.005 * torch.randn((steps, cells), generator=g, device=device, dtype=torch.float64)
        low = (t["rest"] + 0.9 * hydro @ t["waves"]).reshape(-1, 1, ny, nx)
        low = F.avg_pool2d(low, b).repeat_interleave(b, 2).repeat_interleave(b, 3)
        rows = slice(e * steps, (e + 1) * steps)
        hf[rows] = torch.maximum(h, t["elev"]).float()
        lf[rows] = torch.maximum(low.reshape(-1, cells) + t["lf_bias"], t["elev"]).float()
    return hf, lf, t["elev"]


def training_data(cfg: dict, seed: int, device: str) -> tuple[np.ndarray, np.ndarray]:
    """(x, y): the LF and HF fields transformed by the HF ``PreProcessor``
    fitted on the HF field, as the pipeline's ``ras_upskill`` does; (N, P)
    host arrays in the dtype the transform gives."""
    from gpras_tpu_torch import PreProcessor

    n = cfg["events"][0] * cfg["steps"]
    if n != cfg["n_train"]:
        raise ValueError(f"n_train {cfg['n_train']} is not events x steps = {n}")
    hf, lf, elev = fields(cfg, seed, device)
    hf, lf = hf.cpu().numpy(), lf.cpu().numpy()
    pre = PreProcessor(wet_threshold=cfg["wet_threshold"],
                       hydraulic_parameter=cfg["hydraulic_parameter"], device=device)
    pre.fit(hf, elev.cpu().numpy(), np.full(hf.shape[1], CELL_AREA), cfg["hf_modes"])
    return pre.transform(lf), pre.transform(hf)


class Observer:
    """Wraps ``model._loss_fn``, the full-N loss: per mode, every
    evaluation counted, those before the first with a gradient (the
    certification's) counted apart, the parameters at the first ``calls``
    with a gradient (Adam's) and the first one's gradient."""

    def __init__(self, model, calls: int):
        self.model, self.calls = model, calls
        self.inner = model._loss_fn
        model._loss_fn = self
        self.reset()

    def reset(self) -> None:
        self.evals: dict[int, int] = {}
        self.cert: dict[int, int] = {}
        self.params: dict[int, list] = {}
        self.grad: dict[int, dict] = {}

    def __call__(self, p, y_i):
        mode = (y_i.data_ptr() - self.model.y.data_ptr()) // y_i.element_size()
        self.evals[mode] = self.evals.get(mode, 0) + 1
        seen = self.params.setdefault(mode, [])
        if not torch.is_grad_enabled():
            if not seen:
                self.cert[mode] = self.cert.get(mode, 0) + 1
        elif len(seen) < self.calls:
            if not seen:
                store = self.grad.setdefault(mode, {})
                for k, v in p.items():
                    if v.requires_grad:
                        v.register_hook(lambda g, k=k: store.__setitem__(k, g.detach().clone()))
            seen.append({k: v.detach().clone() for k, v in p.items()})
        return self.inner(p, y_i)


def _kwargs(traffic: dict) -> dict:
    return {"optimization_method": traffic["optimizer"], "max_iter": traffic["max_iter"],
            "learning_rate": traffic["learning_rate"],
            "warm_start_subsample": traffic["warm_start_subsample"]}


def setup(cell) -> dict:
    from gpras_tpu_torch import GPRAS

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    if cfg["model_type"] != "exact":
        raise ValueError(f"the pipeline fit driver runs exact models, not {cfg['model_type']!r}")
    x, y = training_data(cfg, cell.seed, dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    model = GPRAS(cfg["kernel"], model_type=cfg["model_type"],
                  exact_engine=cfg.get("exact_engine", "auto"), device=dev)
    state = {"cell": cell, "x": x, "y": y, "model": model, "kwargs": _kwargs(tr),
             "observer": Observer(model, FOLLOWED + 1)}
    # the warm-up: one whole call, one step at each stage
    model.fit(x, y, **{**state["kwargs"], "max_iter": 1})
    _sync(dev)
    return state


def _host(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().double().numpy()


def fit_call(state) -> dict:
    model, obs = state["model"], state["observer"]
    obs.reset()
    model.fit(state["x"], state["y"], **state["kwargs"])
    _sync(state["cell"].device)
    info, warm = model.fit_info, model.warm_start_info or {}
    call = {"iterations": [int(i) for i in info["iterations"]], "losses": _host(info["losses"]),
            "loss": _host(info["loss"]), "params": obs.params, "grad": obs.grad,
            "evaluations": sum(obs.evals.values()), "cert_evals": dict(obs.cert),
            "caps": [float(c) for c in warm.get("ratio_caps", [])],
            "cert_losses": [float(c) for c in warm.get("cert_losses", [])],
            "fell_back": list(warm.get("fell_back_modes", [])), "rung": None}
    if "rung_params" in warm:
        call["rung"] = {"params": dict(warm["rung_params"]),
                        "losses": _host(warm["rung_losses"]["losses"]),
                        "iterations": [int(i) for i in warm["rung_losses"]["iterations"]]}
    return call


def run_window(state, seconds: float) -> dict:
    dev = state["cell"].device
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls = []
    t0 = time.perf_counter()
    while True:
        calls.append(fit_call(state))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    evaluations = sum(c["evaluations"] for c in calls)
    # a step rejected for a non-finite loss, or a certification that failed
    failed = sum(int(np.sum(~np.isfinite(c["losses"][m, :it])))
                 for c in calls for m, it in enumerate(c["iterations"]))
    failed += sum(not math.isfinite(v) for c in calls for v in c["cert_losses"])
    return {"window_s": window_s, "evaluations": evaluations, "calls": len(calls),
            "last": calls[-1], "iterations": [c["iterations"] for c in calls],
            "attempted": evaluations, "failed": failed,
            "peak_bytes": torch.cuda.max_memory_allocated() if dev == "cuda" else 0}


def end_to_end(state, window) -> dict[str, float]:
    """``fit_step_s``: the window over its full-N evaluations (each mode's
    certification, Adam steps and closing evaluation); the rung's time is
    in the window and not in the count."""
    return {"fit_step_s": window["window_s"] / window["evaluations"],
            "peak_mem_gb": window["peak_bytes"] / 1e9}


def layer_context(state, window) -> dict:
    """The cell's readers read the trace and the program's spans alone."""
    return {}


# ------------------------------------------------------------------- check


def _rung_of_program(state, call: dict) -> dict:
    """The compared call's rung: what the program kept of it, or where it
    keeps nothing, the same rung fit run again alone (a fresh model on the
    strided rows, the options of the call), as ``GPRAS.fit`` runs it."""
    if call["rung"] is not None:
        return call["rung"]
    from gpras_tpu_torch import GPRAS

    cfg, tr = state["cell"].config, state["cell"].traffic
    stride = ref_warm.rung_stride(cfg["n_train"], tr["warm_start_subsample"])
    kw = {k: v for k, v in state["kwargs"].items() if k != "warm_start_subsample"}
    warm = GPRAS(cfg["kernel"], model_type=cfg["model_type"],
                 exact_engine=cfg.get("exact_engine", "auto"), device=state["cell"].device)
    warm.fit(state["x32"][::stride].contiguous(), state["y32"][::stride].contiguous(), **kw)
    return {"params": warm.params, "losses": _host(warm.fit_info["losses"]),
            "iterations": [int(i) for i in warm.fit_info["iterations"]]}


def program_readings(state, call: dict) -> dict:
    """The compared call's readings per stage, in the form
    ``reference_readings`` gives."""
    modes = range(state["cell"].config["hf_modes"])
    rung = _rung_of_program(state, call)
    out = {"rung": {}, "cert": {}, "full": {}, "rung_params": {}}
    for m in modes:
        out["rung"][m] = {"losses": list(rung["losses"][m][:rung["iterations"][m]]),
                          "params": {k: v[m] for k, v in rung["params"].items()}}
        out["rung_params"][m] = out["rung"][m]["params"]
        out["cert"][m] = {"cap": call["caps"][m], "loss": call["cert_losses"][m],
                          "fell_back": m in call["fell_back"],
                          "evals": call["cert_evals"].get(m, 0)}
        it = call["iterations"][m]
        losses = list(call["losses"][m][:it]) + [float(call["loss"][m])]
        seen = call["params"].get(m, [])
        out["full"][m] = {"losses": losses[:FOLLOWED + 1],
                          "first_grad": call["grad"].get(m) or None,
                          "params": seen[FOLLOWED] if len(seen) > FOLLOWED else seen[-1]}
    return out


def reference_readings(state, rung_params: dict, precision: str, rows: int | None = None,
                       fault: str | None = None) -> dict:
    """The reference's readings per stage in ``precision``: the rung from
    x and y, the certification at ``rung_params`` (the program's rung
    optimum, per mode), Adam at full N from what the reference certifies.
    ``rows`` keeps only the first rows of x and y; ``fault`` plants one:
    ``"rung_skipped"`` (full N starts from the standard start) or
    ``"no_clamp"`` (the rung's parameters certified unclamped)."""
    ref_warm.no_tf32()
    cfg, tr = state["cell"].config, state["cell"].traffic
    prec = Precision(precision)
    x, y = state["x32"], state["y32"]
    if rows is not None:
        x, y = x[:rows], y[:rows]
    jitter, lr = cfg["jitter"], tr["learning_rate"]
    floors = {k: math.log(v) for k, v in cfg.get("floors", {}).items()}
    z = ref_exact.probes(x.shape[0], cfg["probes"]).to(x.device)
    out = {"rung": {}, "cert": {}, "full": {}, "start": {}, "rung_start": {}}
    for m in rung_params:
        r = ref_warm.rung(prec, x, y[:, m], tr["warm_start_subsample"], tr["max_iter"], lr,
                          floors, jitter)
        out["rung"][m] = {"losses": r["losses"][:tr["max_iter"]], "params": r["params"]}
        out["rung_start"][m] = r["start"]
        p = {k: torch.as_tensor(v).to(x.device) for k, v in rung_params[m].items()}
        c = ref_warm.certify(prec, p, x, y[:, m], jitter, clamped=fault != "no_clamp")
        out["cert"][m] = {"cap": c["cap"], "loss": c["loss"], "fell_back": c["params"] is None,
                          "evals": c["evals"]}
        start = c["params"]
        if start is None or fault == "rung_skipped":
            start = ref_warm.standard_start(x, prec.dtype)
        out["start"][m] = {k: v.to(torch.float64) for k, v in start.items()}
        out["full"][m] = ref_warm.full(prec, start, x, y[:, m], z, FOLLOWED, lr, floors, jitter)
    return out


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(v, dtype=torch.float64).cpu()))


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|; 0 where neither is finite (no certifying loss on
    either side), inf where one is."""
    fa, fb = math.isfinite(a), math.isfinite(b)
    if not fa and not fb:
        return 0.0
    return abs(a - b) / abs(b) if fa and fb else float("inf")


def stage_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The readings ``prog`` against ``ref``, stage by stage.

    ``rung_loss_gap``: the rung's step losses, largest relative gap.
    ``rung_param_gap``: the rung's optimum, per leaf the norm of the
    difference over the larger of the reference's change of that leaf from
    its start and the median leaf's change; the worst leaf. ``cap_mismatch``:
    modes whose cap, or whose fall-back, differ. ``cert_gap``: the
    certifying loss, relative. Full N: ``compare.fit_numbers`` from the
    reference's certified start."""
    rung_loss = rung_param = cert = 0.0
    mismatch = 0
    for m, r in ref["rung"].items():
        p = prog["rung"][m]
        lp, lr = np.asarray(p["losses"], np.float64), np.asarray(r["losses"], np.float64)
        if lp.shape != lr.shape or not np.isfinite(lp).all() or not np.isfinite(lr).all():
            rung_loss = float("inf")
        else:
            rung_loss = max(rung_loss, float(np.max(np.abs(lp - lr) / np.abs(lr))))
        start = ref["rung_start"][m]
        moved = {k: _norm(r["params"][k].double().cpu() - start[k].double().cpu())
                 for k in r["params"]}
        med = statistics.median(moved.values())
        for k in r["params"]:
            d = _norm(torch.as_tensor(p["params"][k]).double().cpu() - r["params"][k].double().cpu())
            rung_param = max(rung_param, d / max(moved[k], med, 1e-300))
        pc, rc = prog["cert"][m], ref["cert"][m]
        mismatch += int(pc["cap"] != rc["cap"] or pc["fell_back"] != rc["fell_back"])
        cert = max(cert, _rel(pc["loss"], rc["loss"]))
    full = compare.fit_numbers(prog["full"], ref["full"], ref["start"])
    return {"rung_loss_gap": rung_loss, "rung_param_gap": rung_param,
            "cap_mismatch": float(mismatch), "cert_gap": cert, **full}


def _free(state) -> None:
    state["model"] = state["observer"] = None
    if state["cell"].device == "cuda":
        torch.cuda.empty_cache()


def _inputs(state) -> None:
    """x and y as the program holds them: float32 on the device."""
    dev = state["cell"].device
    state["x32"] = torch.as_tensor(state["x"], dtype=torch.float32, device=dev).contiguous()
    state["y32"] = torch.as_tensor(state["y"], dtype=torch.float32, device=dev).contiguous()


def check(state, window, precision: str = "f64") -> tuple[dict[str, float], dict]:
    """Frees the program's state, then the window's last call against the
    reference followed in ``precision``, stage by stage."""
    call = window["last"]
    _free(state)
    _inputs(state)
    prog = program_readings(state, call)
    ref = reference_readings(state, prog["rung_params"], precision)
    about = {"modes": len(ref["full"]), "rung_kept": call["rung"] is not None,
             "caps": [ref["cert"][m]["cap"] for m in ref["cert"]],
             "cert_evals": [prog["cert"][m]["evals"] for m in prog["cert"]],
             "evaluations": call["evaluations"]}
    return stage_numbers(prog, ref), about


def control_unit(state) -> dict:
    """One full fit call, for ``control.py``."""
    return fit_call(state)


def _ratio(params: dict) -> list[float]:
    return [float(torch.exp(torch.as_tensor(p["log_variance"]).double()
                            - torch.as_tensor(p["log_noise_variance"]).double()))
            for p in params.values()]


def control_readings(state, unit: dict, control: bool) -> list[tuple[str, dict, dict]]:
    """The call's numbers against the float64 reference, with the rung
    optimum's variance over noise variance per mode (the clamp binds above
    its cap); with ``control``, the TF32 reference's, and three faults
    planted in the reference: the rung's result dropped (full N from the
    standard start), the clamp left out, half of the rows."""
    _free(state)
    _inputs(state)
    prog = program_readings(state, unit)
    ref = reference_readings(state, prog["rung_params"], "f64")
    detail = {"rung_ratio": _ratio(prog["rung_params"]),
              "caps": [prog["cert"][m]["cap"] for m in prog["cert"]],
              "cert_evals": [prog["cert"][m]["evals"] for m in prog["cert"]],
              "leaves": compare.fit_detail(prog["full"], ref["full"], ref["start"])}
    out = [("program", stage_numbers(prog, ref), detail)]
    if control:
        rung = prog["rung_params"]
        ctrl = reference_readings(state, rung, "tf32")
        out.append(("control_tf32", stage_numbers(ctrl, ref),
                    {"leaves": compare.fit_detail(ctrl["full"], ref["full"], ref["start"])}))
        for fault in ("rung_skipped", "no_clamp"):
            planted = reference_readings(state, rung, "f64", fault=fault)
            out.append((f"fault_{fault}", stage_numbers(planted, ref), {}))
        half = reference_readings(state, rung, "f64", rows=state["x32"].shape[0] // 2)
        out.append(("fault_half_rows", stage_numbers(half, ref), {}))
    return out
