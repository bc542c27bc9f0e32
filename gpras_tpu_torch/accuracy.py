"""Accuracy north stars of the port: depth-RMSE of the float32 surrogate
against a float64 dense exact posterior, and the production exact fit's
posterior against the dense float64 one at the same hyperparameters.

Port of ``gpras_tpu/accuracy.py``. ``DEFAULT_CONFIG``, ``make_problem``,
``summarize``, ``EXACT_CONFIG``, ``make_exact_problem`` and
``summarize_exact`` are its numpy code, copied (the same seeded problems bit
for bit). The paths run the port on ``device``, the card unless the caller
asks for the CPU:

- ``run_path("f32")``: EOF preprocessors and an SGPR fit and prediction in
  float32 (the pipeline's chain); ``run_path("f64")``: the same data through
  a dense exact GP in float64, on ``device`` too (the reference needed x64
  on its CPU).
- ``run_exact_path("f32")``: the production exact fit (``GPRAS``'s engine
  ladder: a dense warm-start rung, then the Hutchinson engine at
  N = 32,768) and its posterior; it writes the fitted hyperparameters to
  ``exact_f32.npz``. ``run_exact_path("f64")`` reads them and computes the
  dense float64 posterior. The npz files keep the reference's names, so
  either package's f64 path reads the other's f32 output.

The summaries keep the reference's keys too: ``*_f32_tpu`` names the
float32 path, here run on ``device``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

#: pipeline-scale default problem; tests shrink it.
DEFAULT_CONFIG: dict[str, Any] = {
    "n_events": 36,
    "n_train_events": 26,
    "t_steps": 48,
    "n_cells_hf": 16384,
    "n_cells_lf": 2048,
    "noise": 0.02,
    "seed": 0,
    "n_inducing": 128,
    "max_iter": 300,
}


def make_problem(cfg: dict[str, Any] | None = None) -> dict[str, np.ndarray]:
    """Deterministic synthetic upskilling problem (float64 host arrays).

    Latent 3-d forcing per event (hydrograph pulses with random peak/phase)
    drives a rank-6 HF depth field through mildly nonlinear features and a
    rank-3 LF depth field linearly — so LF modes carry the latent state and
    the GP must learn the nonlinear LF->HF map, like the real
    RasUpskillDataBuilder problem (gpras/preprocess.py:327-427).
    """
    cfg = {**DEFAULT_CONFIG, **(cfg or {})}
    rng = np.random.default_rng(cfg["seed"])
    ne, ts = cfg["n_events"], cfg["t_steps"]
    t = np.linspace(0.0, 1.0, ts)

    peaks = rng.uniform(0.8, 3.0, size=(ne, 3))
    centers = rng.uniform(0.3, 0.7, size=(ne, 3))
    widths = rng.uniform(0.01, 0.05, size=(ne, 3))
    # u: (events, steps, 3) smooth pulses
    u = peaks[:, None, :] * np.exp(
        -((t[None, :, None] - centers[:, None, :]) ** 2) / widths[:, None, :])

    def features(uu: np.ndarray) -> np.ndarray:
        u1, u2, u3 = uu[..., 0], uu[..., 1], uu[..., 2]
        return np.stack(
            [u1, u2, u3, 0.3 * u1 * u1, 0.4 * u1 * u2, np.tanh(u3)], axis=-1)

    f_hf = features(u).reshape(ne * ts, 6)
    pat_hf = rng.normal(size=(6, cfg["n_cells_hf"]))
    # smooth-ish positive patterns so depths are mostly wet with dry fringes
    hf = np.maximum(f_hf @ np.abs(pat_hf) * 0.2
                    + cfg["noise"] * rng.normal(size=(ne * ts, cfg["n_cells_hf"]))
                    - 0.05, 0.0)
    pat_lf = rng.normal(size=(3, cfg["n_cells_lf"]))
    lf = np.maximum(u.reshape(ne * ts, 3) @ np.abs(pat_lf) * 0.2
                    + cfg["noise"] * rng.normal(size=(ne * ts, cfg["n_cells_lf"]))
                    - 0.02, 0.0)

    n_train = cfg["n_train_events"] * ts
    return {
        "hf_train": hf[:n_train], "hf_test": hf[n_train:],
        "lf_train": lf[:n_train], "lf_test": lf[n_train:],
        "elev_hf": np.zeros(cfg["n_cells_hf"]),
        "elev_lf": np.zeros(cfg["n_cells_lf"]),
    }


def run_path(path: str, cfg: dict[str, Any] | None = None,
             device: str | torch.device = "cuda") -> dict[str, np.ndarray]:
    """Run one surrogate path end to end on ``device``; returns the predicted
    test depth fields (host arrays).

    ``path``: "f32" (SGPR, float32) or "f64" (dense exact GP, float64).
    """
    from gpras_tpu_torch.eof.preprocessor import PreProcessor
    from gpras_tpu_torch.gp.model import GPRAS

    cfg = {**DEFAULT_CONFIG, **(cfg or {})}
    prob = make_problem(cfg)

    hf_pre = PreProcessor(hydraulic_parameter="depth", device=device)
    hf_pre.fit(prob["hf_train"], prob["elev_hf"])
    lf_pre = PreProcessor(hydraulic_parameter="depth", device=device)
    lf_pre.fit(prob["lf_train"], prob["elev_lf"])
    x_train = lf_pre.transform(prob["lf_train"])
    y_train = hf_pre.transform(prob["hf_train"])
    x_test = lf_pre.transform(prob["lf_test"])

    if path == "f32":
        model = GPRAS("Matern52", model_type="sgpr", dtype=torch.float32, device=device)
        model.fit(x_train.astype(np.float32), y_train.astype(np.float32),
                  n_inducing=cfg["n_inducing"], optimization_method="adam",
                  max_iter=cfg["max_iter"])
    elif path == "f64":
        model = GPRAS("Matern52", model_type="exact", dtype=torch.float64, device=device)
        model.fit(x_train, y_train, optimization_method="adam", max_iter=cfg["max_iter"])
    else:
        raise ValueError(f"unknown accuracy path {path!r}")

    mean, var = model.predict(x_test)
    field, field_var = hf_pre.reverse_transform(
        np.asarray(mean, np.float64), np.asarray(var, np.float64))
    return {"field": field, "field_var": field_var,
            "truth": prob["hf_test"],
            "n_modes": np.asarray([hf_pre.spatial_mode_count])}


def summarize(f32: dict[str, np.ndarray], f64: dict[str, np.ndarray]
              ) -> dict[str, float]:
    """Headline accuracy numbers from the two paths' predictions."""
    truth = f32["truth"]

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    def coverage(pred, var):
        sig = np.sqrt(np.maximum(var, 0.0))
        return float(np.mean(np.abs(truth - pred) <= 2.0 * sig))

    r32 = rmse(f32["field"], truth)
    r64 = rmse(f64["field"], truth)
    return {
        "depth_rmse_f32_tpu": round(r32, 6),
        "depth_rmse_f64_gold": round(r64, 6),
        "depth_rmse_vs_f64": round(rmse(f32["field"], f64["field"]), 6),
        "depth_rmse_ratio_f32_over_f64": round(r32 / max(r64, 1e-300), 4),
        "coverage_2sigma_f32": round(coverage(f32["field"], f32["field_var"]), 4),
        "coverage_2sigma_f64": round(coverage(f64["field"], f64["field_var"]), 4),
    }


# ---------------------------------------------------------------------------
# The exact-engine north star: the production exact path (GPRAS
# model_type="exact", "auto" engine ladder -> Hutchinson at 32,768 points,
# warm start from a 2,048-point rung) in float32, scored against a dense
# float64 posterior at the SAME fitted hyperparameters, which isolates the
# float32 factorization and solve chain from optimizer variance.
# ---------------------------------------------------------------------------

EXACT_CONFIG: dict[str, Any] = {
    "n_train": 32768,
    "n_test": 2048,
    "d": 8,
    "noise": 0.1,
    "seed": 0,
    "max_iter": 40,
    "warm_start_subsample": 2048,
    "kernel": "Matern52",
}


def make_exact_problem(cfg: dict[str, Any] | None = None
                       ) -> dict[str, np.ndarray]:
    """Deterministic synthetic regression at headline-engine scale: smooth
    multi-feature response + observation noise (float64 host arrays)."""
    cfg = {**EXACT_CONFIG, **(cfg or {})}
    rng = np.random.default_rng(cfg["seed"])
    n, m, d = cfg["n_train"], cfg["n_test"], cfg["d"]
    x = rng.normal(size=(n + m, d))

    def f(xx):
        return (np.sin(xx[:, 0]) + 0.5 * np.cos(2.0 * xx[:, 1])
                + 0.3 * np.tanh(xx[:, 2] * xx[:, 3]) + 0.2 * xx[:, 4])

    truth = f(x)
    y = truth + cfg["noise"] * rng.normal(size=n + m)
    return {"x_train": x[:n], "y_train": y[:n],
            "x_test": x[n:], "truth_test": truth[n:],
            "y_test": y[n:]}


def run_exact_path(path: str, workdir: str, cfg: dict[str, Any] | None = None,
                   device: str | torch.device = "cuda") -> dict[str, Any]:
    """One side of the exact-engine comparison, on ``device``; the result is
    also saved as ``exact_{path}.npz`` under ``workdir``.

    ``"f32"``: the production ``GPRAS`` exact fit and its posterior; saves
    the fitted hyperparameters (``param_*``, with the mode axis) for the gold
    path. ``"f64"``: the dense float64 posterior (Cholesky of K + noise I,
    the mean and the full predictive variance) at the hyperparameters of
    mode 0 in ``exact_f32.npz``.
    """
    from gpras_tpu_torch.ops import kernels as K
    from gpras_tpu_torch.ops import linalg

    cfg = {**EXACT_CONFIG, **(cfg or {})}
    prob = make_exact_problem(cfg)
    dev = torch.device(device)
    if path == "f32":
        from gpras_tpu_torch.gp.model import GPRAS

        model = GPRAS(cfg["kernel"], model_type="exact", dtype=torch.float32, device=dev)
        model.fit(prob["x_train"].astype(np.float32), prob["y_train"].astype(np.float32),
                  optimization_method="adam", max_iter=cfg["max_iter"],
                  warm_start_subsample=cfg["warm_start_subsample"])
        mean, var = model.predict(prob["x_test"].astype(np.float32))
        out = {"mean": np.asarray(mean, np.float64).ravel(),
               "var": np.asarray(var, np.float64).ravel(),
               **{f"param_{k}": v.cpu().numpy().astype(np.float64)
                  for k, v in model.params.items()}}
    elif path == "f64":
        params_npz = np.load(os.path.join(workdir, "exact_f32.npz"))
        params = {k[len("param_"):]: torch.as_tensor(params_npz[k][0], device=dev)
                  for k in params_npz.files if k.startswith("param_")}
        x = torch.as_tensor(prob["x_train"], device=dev)
        xq = torch.as_tensor(prob["x_test"], device=dev)
        y = torch.as_tensor(prob["y_train"], device=dev)
        n = x.shape[0]
        noise = torch.exp(params["log_noise_variance"]) + \
            linalg.default_jitter(x.dtype) * torch.exp(params["log_variance"])
        # K in row panels: the covariance's temporaries stay panel-sized
        # beside the (N, N) float64 matrix (8.6 GB at N = 32,768)
        k = torch.empty((n, n), dtype=x.dtype, device=dev)
        for r0 in range(0, n, 4096):
            k[r0:r0 + 4096] = K.gram(cfg["kernel"], params, x[r0:r0 + 4096], x)
        k.diagonal().add_(noise)
        l = torch.linalg.cholesky(k)
        del k
        alpha = torch.cholesky_solve(y[:, None], l)[:, 0]
        ks = K.gram(cfg["kernel"], params, x, xq)  # (N, M)
        mean = ks.T @ alpha
        w = torch.cholesky_solve(ks, l)
        del l
        kss = K.kdiag(cfg["kernel"], params, xq)
        var = torch.clamp_min(kss - torch.sum(ks * w, dim=0), 0.0) + \
            torch.exp(params["log_noise_variance"])
        out = {"mean": mean.cpu().numpy(), "var": var.cpu().numpy()}
    else:
        raise ValueError(f"unknown exact accuracy path {path!r}")
    np.savez(os.path.join(workdir, f"exact_{path}.npz"), **out)
    return out


def summarize_exact(f32: dict[str, np.ndarray], f64: dict[str, np.ndarray],
                    cfg: dict[str, Any] | None = None) -> dict[str, float]:
    """Headline numbers for the exact-engine comparison (noiseless truth)."""
    cfg = {**EXACT_CONFIG, **(cfg or {})}
    prob = make_exact_problem(cfg)
    truth, y_test = prob["truth_test"], prob["y_test"]

    def rmse(a, b):
        return float(np.sqrt(np.mean((np.ravel(a) - np.ravel(b)) ** 2)))

    def coverage(pred, var):
        # against the NOISY held-out observations: the predictive variance
        # includes likelihood noise, so 2-sigma should cover ~95% — the
        # noiseless-truth version saturates at 1.0 and carries no signal
        sig = np.sqrt(np.maximum(np.ravel(var), 0.0))
        return float(np.mean(np.abs(y_test - np.ravel(pred)) <= 2.0 * sig))

    r32, r64 = rmse(f32["mean"], truth), rmse(f64["mean"], truth)
    return {
        "exact_n": int(cfg["n_train"]),
        "exact_rmse_f32_tpu": round(r32, 6),
        "exact_rmse_f64_gold": round(r64, 6),
        "exact_rmse_vs_f64": round(rmse(f32["mean"], f64["mean"]), 6),
        "exact_rmse_ratio_f32_over_f64": round(r32 / max(r64, 1e-300), 4),
        "exact_coverage_2sigma_f32": round(coverage(f32["mean"], f32["var"]), 4),
        "exact_coverage_2sigma_f64": round(coverage(f64["mean"], f64["var"]), 4),
    }
