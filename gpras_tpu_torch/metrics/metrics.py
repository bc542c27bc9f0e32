"""Flood-verification metrics over (timesteps, cells) tensors per event.

Port of ``gpras_tpu/metrics/metrics.py`` (the reference's suite,
gpras/metrics.py): RMSE, MAE and bias at three granularities (per event,
per timestep, per cell), NSE at peaks, the fidelity index with time and
value tolerances, the peak contingency scores (POD, RFA, CSI, F2, F3) and
the mean predicted sigma ("confidence") columns. ``export_metric_summary``
writes the same three SQLite tables (``scalar_metrics``,
``timeseries_metrics``, ``cell_metrics``).

Convention (as in the reference): ``x`` is the observed (high-fidelity)
field, ``y`` the prediction, ``conf`` the predicted standard deviation, and
``*_mts`` the per-cell time index of the peak (the first one on a tie, as
``jnp.argmax``). The functions compute where their tensors lie; the
contingency counts and the fidelity index are in the frames' dtype. F2 and
F3 use ``depth_threshold``, as the reference's documented intent (its
gpras/metrics.py:52-53 binds the peak indices there by position).
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    import pandas as pd

Tensor = torch.Tensor


def _at_peaks(x: Tensor, y: Tensor, x_mts: Tensor, y_mts: Tensor) -> tuple[Tensor, Tensor]:
    cols = torch.arange(x.shape[1], device=x.device)
    return x[x_mts, cols], y[y_mts, cols]


def rmse_aoi_toi(x: Tensor, y: Tensor) -> Tensor:
    """RMSE across all cells and timesteps (gpras/metrics.py:85-87)."""
    return torch.sqrt(torch.mean((x - y) ** 2))


def mae_aoi_toi(x: Tensor, y: Tensor) -> Tensor:
    """MAE across all cells and timesteps (gpras/metrics.py:90-92)."""
    return torch.mean(torch.abs(x - y))


def conf_aoi_toi(conf: Tensor) -> Tensor:
    """Mean predicted sigma over everything (gpras/metrics.py:95-97)."""
    return torch.mean(conf)


def rmse_aoi_ts(x: Tensor, y: Tensor) -> Tensor:
    """Per-timestep RMSE over cells (gpras/metrics.py:100-102)."""
    return torch.sqrt(torch.mean((x - y) ** 2, dim=1))


def rmse_cell_toi(x: Tensor, y: Tensor) -> Tensor:
    """Per-cell RMSE over timesteps (gpras/metrics.py:105-107)."""
    return torch.sqrt(torch.mean((x - y) ** 2, dim=0))


def rmse_aoi_mts(x: Tensor, y: Tensor, x_mts: Tensor, y_mts: Tensor) -> Tensor:
    """RMSE of per-cell peaks (gpras/metrics.py:110-121)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    return torch.sqrt(torch.mean((xp - yp) ** 2))


def err_cell_mts(x: Tensor, y: Tensor, x_mts: Tensor, y_mts: Tensor) -> Tensor:
    """Per-cell peak difference (gpras/metrics.py:124-135)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    return xp - yp


def nse_aoi_mts(x: Tensor, y: Tensor, x_mts: Tensor, y_mts: Tensor) -> Tensor:
    """Nash-Sutcliffe efficiency between per-cell peaks (gpras/metrics.py:138-151)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    num = torch.sum((xp - yp) ** 2)
    denom = torch.sum((xp - torch.mean(xp)) ** 2)
    return 1.0 - num / denom


def err_aoi_toi(x: Tensor, y: Tensor) -> Tensor:
    """Mean bias over everything (gpras/metrics.py:154-156)."""
    return torch.mean(x - y)


def err_aoi_mts(x: Tensor, y: Tensor, x_mts: Tensor, y_mts: Tensor) -> Tensor:
    """Mean bias of per-cell peaks (gpras/metrics.py:159-171)."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    return torch.mean(xp - yp)


def err_aoi_ts(x: Tensor, y: Tensor) -> Tensor:
    """Per-timestep mean bias over cells (gpras/metrics.py:174-176)."""
    return torch.mean(x - y, dim=1)


def conf_aoi_ts(conf: Tensor) -> Tensor:
    """Per-timestep mean sigma (gpras/metrics.py:179-181)."""
    return torch.mean(conf, dim=1)


def err_cell_toi(x: Tensor, y: Tensor) -> Tensor:
    """Per-cell mean bias over timesteps (gpras/metrics.py:184-186)."""
    return torch.mean(x - y, dim=0)


def conf_cell_toi(conf: Tensor) -> Tensor:
    """Per-cell mean sigma (gpras/metrics.py:189-191)."""
    return torch.mean(conf, dim=0)


def fi_aoi_toi(x: Tensor, y: Tensor, t_tol: int, v_tol: float) -> Tensor:
    """Fidelity index: the share of (t, cell) points matched within
    ``v_tol`` at any time shift up to ``t_tol`` (gpras/metrics.py:194-203).
    Each shift ORs into the rows the earlier shifts already updated, as the
    reference does."""
    matching = torch.abs(y - x) <= v_tol
    for i in range(1, t_tol + 1):
        matching[:-i] |= torch.abs(y[:-i, :] - x[i:, :]) <= v_tol
    for i in range(1, t_tol + 1):
        matching[:-i] |= torch.abs(x[:-i, :] - y[i:, :]) <= v_tol
    return torch.sum(matching, dtype=x.dtype) / (matching.shape[0] * matching.shape[1])


def _contingency(x: Tensor, y: Tensor, threshold, x_mts: Tensor, y_mts: Tensor):
    """(detected, false alarms, misses) at the per-cell peaks, counted in
    the frames' dtype."""
    xp, yp = _at_peaks(x, y, x_mts, y_mts)
    x_wet = xp >= threshold
    y_wet = yp >= threshold
    a = torch.sum(x_wet & y_wet, dtype=x.dtype)
    b = torch.sum(~x_wet & y_wet, dtype=x.dtype)
    c = torch.sum(x_wet & ~y_wet, dtype=x.dtype)
    return a, b, c


def pod_mts(x, y, threshold, x_mts, y_mts) -> Tensor:
    """Probability of detection at per-cell peaks (gpras/metrics.py:206-224);
    NaN when no cell is wet in ``x``."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    return a / (a + c)


def rfa_mts(x, y, threshold, x_mts, y_mts) -> Tensor:
    """Rate of false alarm at per-cell peaks (gpras/metrics.py:227-245)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    return b / (a + b)


def csi_mts(x, y, threshold, x_mts, y_mts) -> Tensor:
    """Critical success index, 1 / (1/POD + 1/(1 - RFA) - 1) (gpras/metrics.py:248-262)."""
    pod = pod_mts(x, y, threshold, x_mts, y_mts)
    rfa = rfa_mts(x, y, threshold, x_mts, y_mts)
    return 1.0 / ((1.0 / pod) + (1.0 / (1.0 - rfa)) - 1.0)


def f2_mts(x, y, threshold, x_mts, y_mts) -> Tensor:
    """(a - c) / (a + b + c) at per-cell peaks; 1 when empty (gpras/metrics.py:265-290)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    denom = a + b + c
    return torch.where(denom == 0, 1.0, (a - c) / torch.where(denom == 0, 1.0, denom))


def f3_mts(x, y, threshold, x_mts, y_mts) -> Tensor:
    """(a - b) / (a + b + c) at per-cell peaks; 1 when empty (gpras/metrics.py:293-318)."""
    a, b, c = _contingency(x, y, threshold, x_mts, y_mts)
    denom = a + b + c
    return torch.where(denom == 0, 1.0, (a - b) / torch.where(denom == 0, 1.0, denom))


def compute_event_metrics(x: Tensor, y: Tensor, conf: Tensor, depth_threshold: float = 0.5,
                          t_tol: int = 0, v_tol: float = 0.0,
                          contingency: bool = True) -> dict[str, Tensor]:
    """The whole suite for one event, on the device of ``x``.

    Returns scalars and per-timestep and per-cell tensors; ``contingency=False``
    is the reference's velocity case (POD, RFA and CSI NaN,
    gpras/metrics.py:49-51)."""
    x_mts = torch.argmax(x, dim=0)
    y_mts = torch.argmax(y, dim=0)
    out: dict[str, Tensor] = {
        "rmse_aoi_toi": rmse_aoi_toi(x, y),
        "mae_aoi_toi": mae_aoi_toi(x, y),
        "conf_aoi_toi": conf_aoi_toi(conf),
        "rmse_aoi_mts": rmse_aoi_mts(x, y, x_mts, y_mts),
        "nse_aoi_mts": nse_aoi_mts(x, y, x_mts, y_mts),
        "err_aoi_toi": err_aoi_toi(x, y),
        "err_aoi_mts": err_aoi_mts(x, y, x_mts, y_mts),
        "fi_aoi_toi": fi_aoi_toi(x, y, t_tol, v_tol),
        "f2_mts": f2_mts(x, y, depth_threshold, x_mts, y_mts),
        "f3_mts": f3_mts(x, y, depth_threshold, x_mts, y_mts),
        # timeseries
        "rmse_aoi_ts": rmse_aoi_ts(x, y),
        "err_aoi_ts": err_aoi_ts(x, y),
        "conf_aoi_ts": conf_aoi_ts(conf),
        # cells
        "rmse_cell_toi": rmse_cell_toi(x, y),
        "err_cell_mts": err_cell_mts(x, y, x_mts, y_mts),
        "err_cell_toi": err_cell_toi(x, y),
        "conf_cell_toi": conf_cell_toi(conf),
    }
    if contingency:
        out["pod_mts"] = pod_mts(x, y, depth_threshold, x_mts, y_mts)
        out["rfa_mts"] = rfa_mts(x, y, depth_threshold, x_mts, y_mts)
        out["csi_mts"] = csi_mts(x, y, depth_threshold, x_mts, y_mts)
    else:
        nan = torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
        out["pod_mts"] = nan
        out["rfa_mts"] = nan
        out["csi_mts"] = nan
    return out


SCALAR_COLUMNS = (
    "rmse_aoi_toi", "mae_aoi_toi", "conf_aoi_toi", "rmse_aoi_mts", "nse_aoi_mts",
    "err_aoi_toi", "err_aoi_mts", "fi_aoi_toi", "pod_mts", "rfa_mts", "csi_mts",
    "f2_mts", "f3_mts",
)
TS_COLUMNS = ("rmse_aoi_ts", "err_aoi_ts", "conf_aoi_ts")
CELL_COLUMNS = ("rmse_cell_toi", "err_cell_mts", "err_cell_toi", "conf_cell_toi")


def export_metric_summary(
    x_all: pd.DataFrame,
    y_all: pd.DataFrame,
    conf_all: pd.DataFrame,
    out_path: str | Path,
    depth_threshold: float = 0.5,
    t_tol: int = 0,
    v_tol: float = 0,
    hydraulic_parameter: str = "depth",
    device: str | torch.device = "cuda",
) -> None:
    """Per-event metric tables -> SQLite, signature-compatible with the
    reference (gpras/metrics.py:11-82). Inputs are (event, timestep)-indexed
    frames with one column per cell. Each event's suite is computed on
    ``device``; only its results come back to the host."""
    import pandas as pd

    dev = torch.device(device)
    all_scalar, all_ts, all_cells = [], [], []
    for event in x_all.index.unique(level=0):
        x, y, conf = (torch.tensor(frame.loc[event].to_numpy(), device=dev)
                      for frame in (x_all, y_all, conf_all))
        m = compute_event_metrics(x, y, conf, depth_threshold=depth_threshold, t_tol=t_tol,
                                  v_tol=v_tol, contingency=(hydraulic_parameter != "velocity"))
        m = {k: v.cpu().numpy() for k, v in m.items()}
        tsteps = x_all.loc[event].index.values
        all_scalar.append(pd.DataFrame({"event": [event],
                                        **{c: [float(m[c])] for c in SCALAR_COLUMNS}}))
        all_ts.append(pd.DataFrame({
            "event": np.repeat(event, x.shape[0]), "timestep": tsteps,
            **{c: m[c] for c in TS_COLUMNS},
        }))
        all_cells.append(pd.DataFrame({
            "event": np.repeat(event, x.shape[1]), "cell_id": x_all.columns,
            **{c: m[c] for c in CELL_COLUMNS},
        }))
    with sqlite3.connect(out_path) as con:
        pd.concat(all_scalar).to_sql("scalar_metrics", con, index=False, if_exists="replace")
        pd.concat(all_ts).to_sql("timeseries_metrics", con, index=False, if_exists="replace")
        pd.concat(all_cells).to_sql("cell_metrics", con, index=False, if_exists="replace")
