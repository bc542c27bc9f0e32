"""Diagnostic / QC plotting suite.

Capability parity with the reference's 18-function plotting module
(gpras/utils/plotting.py:24-895): EOF pairplots with inducing points, per-event
EOF timeseries with GPR confidence intervals, LF/HF/upskilled performance
scatter + error CDFs, PCA eigenvalue summaries, temporal-clipping QC, spatial
error maps from the metrics SQLite DB, per-event metric timeseries, box/scatter
summary plots, spatial EOF maps, detection-category maps, rating-curve and
centerline-drop plots.

Spatial maps render true polygon choropleths when the cell table carries a
``geometry`` column of exterior-ring vertex arrays (DataBuilder.hf_geometry_aoi
provides it straight from the mesh facepoints — matplotlib PolyCollection, no
GEOS/geopandas needed, matching the reference's geopandas ``.plot`` maps,
gpras/utils/plotting.py:356-443, 637-859). Tables without geometry (e.g.
rebuilt from the parquet DB) fall back to centroid scatter.

All functions write a PNG and close the figure (headless-safe).

A copy of ``gpras_tpu/plotting.py``, except that matplotlib is imported at
the first plot, not with the module: the port runs where it is not
installed, and only a plot needs it.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import pandas as pd

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend, imported at the first
    plot: the modules that import this one run where matplotlib is not
    installed, and only a plot needs it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def apply_formatting(ax: plt.Axes, title: str | None = None,
                     xlabel: str | None = None, ylabel: str | None = None) -> None:
    """Shared styling (reference gpras/utils/plotting.py:24-51)."""
    if title:
        ax.set_title(title, fontsize=11)
    if xlabel:
        ax.set_xlabel(xlabel, fontsize=9)
    if ylabel:
        ax.set_ylabel(ylabel, fontsize=9)
    ax.tick_params(labelsize=8)
    ax.grid(True, alpha=0.3)


def _save(fig: plt.Figure, out_path: str | Path) -> None:
    plt = _pyplot()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


# --------------------------------------------------------------------- EOF space

def ec_pairplot(x: np.ndarray, y: np.ndarray, n_modes: int,
                out_path: str | Path, inducing: np.ndarray | None = None) -> None:
    """Pairwise scatter of the first n EOF modes, x vs y, optionally overlaying
    inducing-point locations (reference gpras/utils/plotting.py:54-99)."""
    plt = _pyplot()
    n = min(n_modes, x.shape[1])
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n))
    axes = np.atleast_2d(axes)
    for i in range(n):
        for j in range(n):
            ax = axes[i, j]
            if i == j:
                ax.hist(x[:, i], bins=30, alpha=0.6, label="x")
                ax.hist(y[:, i], bins=30, alpha=0.6, label="y")
            else:
                ax.scatter(x[:, j], x[:, i], s=2, alpha=0.4, label="x")
                ax.scatter(y[:, j], y[:, i], s=2, alpha=0.4, label="y")
                if inducing is not None:
                    ax.scatter(inducing[:, j], inducing[:, i], s=12, marker="x",
                               c="k", label="inducing")
            if i == n - 1:
                ax.set_xlabel(f"mode {j}", fontsize=8)
            if j == 0:
                ax.set_ylabel(f"mode {i}", fontsize=8)
            ax.tick_params(labelsize=6)
    _save(fig, out_path)


def ec_timeseries(x: np.ndarray, mean: np.ndarray, var: np.ndarray,
                  n_modes: int, index: Any, out_dir: str | Path) -> None:
    """Per-event EOF-mode timeseries with the GPR 95% band
    (reference gpras/utils/plotting.py:102-152)."""
    plt = _pyplot()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    idx = pd.MultiIndex.from_tuples(index) if not isinstance(index, pd.MultiIndex) else index
    events = idx.get_level_values(0).unique()
    n = min(n_modes, x.shape[1])
    for event in events:
        sel = idx.get_level_values(0) == event
        fig, axes = plt.subplots(n, 1, figsize=(7, 1.8 * n), sharex=True)
        axes = np.atleast_1d(axes)
        t = np.arange(sel.sum())
        for m in range(n):
            ax = axes[m]
            ax.plot(t, x[sel, m], lw=1, label="observed")
            mu = mean[sel, m]
            sd = np.sqrt(var[sel, m])
            ax.plot(t, mu, lw=1, label="GPR mean")
            ax.fill_between(t, mu - 1.96 * sd, mu + 1.96 * sd, alpha=0.25,
                            label="95% CI")
            apply_formatting(ax, ylabel=f"mode {m}")
        axes[0].legend(fontsize=7)
        _save(fig, out / f"{event}.png")


def pca_variance_summary(eigenvalues: np.ndarray, n_retained: int,
                         out_path: str | Path) -> None:
    """Scree + cumulative-variance plot (reference gpras/utils/plotting.py:236-255)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.5))
    k = min(len(eigenvalues), 50)
    ax1.semilogy(np.arange(1, k + 1), eigenvalues[:k], "o-", ms=3)
    ax1.axvline(n_retained + 0.5, color="r", ls="--", label=f"retained={n_retained}")
    apply_formatting(ax1, "Eigen spectrum", "mode", "eigenvalue")
    ax1.legend(fontsize=8)
    frac = np.cumsum(eigenvalues) / np.sum(eigenvalues)
    ax2.plot(np.arange(1, len(frac) + 1)[:k], frac[:k], "o-", ms=3)
    apply_formatting(ax2, "Cumulative explained variance", "mode", "fraction")
    _save(fig, out_path)


# ---------------------------------------------------------------- field accuracy

def performance_scatterplot(lf: np.ndarray, hf: np.ndarray, pred: np.ndarray,
                            out_path: str | Path, depth: bool = False) -> None:
    """LF-vs-HF and upskilled-vs-HF scatter with RMSE annotations
    (reference gpras/utils/plotting.py:155-198)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 4), sharex=True, sharey=True)
    s = np.random.default_rng(0).choice(hf.size, size=min(hf.size, 20000),
                                        replace=False)
    hfv, lfv, prv = hf.ravel()[s], lf.ravel()[s], pred.ravel()[s]
    lims = [min(hfv.min(), lfv.min()), max(hfv.max(), lfv.max())]
    for ax, v, name in ((ax1, lfv, "LF"), (ax2, prv, "Upskilled")):
        ax.scatter(hfv, v, s=2, alpha=0.3)
        ax.plot(lims, lims, "k--", lw=1)
        rmse = float(np.sqrt(np.mean((v - hfv) ** 2)))
        unit = "depth" if depth else "WSE"
        apply_formatting(ax, f"{name} vs HF (RMSE={rmse:.3f})", f"HF {unit}",
                         f"{name} {unit}")
    _save(fig, out_path)


def performance_cdf(lf: np.ndarray, hf: np.ndarray, pred: np.ndarray,
                    out_path: str | Path) -> None:
    """CDF of absolute errors, LF vs upskilled (reference gpras/utils/plotting.py:201-233)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for v, name in ((lf, "LF"), (pred, "Upskilled")):
        err = np.sort(np.abs(v - hf).ravel())
        cdf = np.arange(1, err.size + 1) / err.size
        step = max(err.size // 5000, 1)
        ax.plot(err[::step], cdf[::step], label=name)
    apply_formatting(ax, "Absolute-error CDF", "|error|", "fraction of cells")
    ax.legend(fontsize=8)
    _save(fig, out_path)


def ts_clipping(dx_dt: np.ndarray, cutoffs: tuple[int, int],
                out_path: str | Path) -> None:
    """Temporal-clipping QC: normalized change rate + chosen window
    (reference gpras/utils/plotting.py:302-353)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 3.5))
    rate = np.sum(dx_dt, axis=1) / np.sum(dx_dt)
    ax.plot(rate, lw=1, label="normalized |d/dt|")
    ax.plot(np.cumsum(rate), lw=1, label="cumulative")
    ax.axvline(cutoffs[0], c="g", ls="--", label="start")
    ax.axvline(cutoffs[1], c="r", ls="--", label="stop")
    apply_formatting(ax, "Temporal clipping", "timestep", "rate")
    ax.legend(fontsize=8)
    _save(fig, out_path)


# -------------------------------------------------------------------------- maps

def _cell_polys(cell_table: pd.DataFrame) -> list | None:
    """Per-row polygon rings from the ``geometry`` column (None when absent —
    e.g. cell tables rebuilt from the parquet DB, which keep centroids only)."""
    if "geometry" not in cell_table.columns:
        return None
    polys = list(cell_table["geometry"])
    if not polys or any(p is None or np.ndim(p) != 2 for p in polys):
        return None
    return polys


def _cell_fill(ax, cell_table: pd.DataFrame, values: np.ndarray,
               cmap: str = "RdBu_r", vmin: float | None = None,
               vmax: float | None = None, symmetric: bool | None = None):
    """Choropleth of ``values`` over the mesh: true cell polygons when the
    table carries a ``geometry`` column (reference behavior,
    gpras/utils/plotting.py:356-443 / 637-859 via geopandas .plot — here a
    matplotlib PolyCollection, no GEOS), centroid scatter otherwise."""
    values = np.asarray(values, dtype=float)
    if vmax is None:
        vmax = float(np.nanmax(np.abs(values))) if np.any(np.isfinite(values)) else 1.0
        if not np.isfinite(vmax) or vmax == 0:
            vmax = 1.0
    if symmetric is None:
        # symmetric scale (white at 0) only when the field is actually signed
        symmetric = bool(np.any(values < 0))
    if vmin is None:
        vmin = -vmax if symmetric else float(np.nanmin(values))
    polys = _cell_polys(cell_table)
    if polys is not None:
        from matplotlib.collections import PolyCollection

        pc = PolyCollection(polys, array=values, cmap=cmap, edgecolors="none")
        pc.set_clim(vmin, vmax)
        ax.add_collection(pc)
        ax.autoscale_view()
        ax.set_aspect("equal")
        return pc
    sc = ax.scatter(cell_table["x"], cell_table["y"], c=values, s=18, marker="s",
                    cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_aspect("equal")
    return sc


def _cell_scatter(ax, cell_table: pd.DataFrame, values: np.ndarray,
                  cmap: str = "RdBu_r", vmax: float | None = None):
    return _cell_fill(ax, cell_table, values, cmap=cmap, vmax=vmax)


def map_mesh_errors(cell_table: pd.DataFrame, metrics_db: str | Path,
                    out_dir: str | Path, suffix: str, error_field: str,
                    error_metric: str, cell_id_field: str = "cell_id") -> None:
    """Per-event spatial error maps from the cell_metrics SQLite table
    (reference gpras/utils/plotting.py:356-443); centroid scatter, one PNG per
    event."""
    plt = _pyplot()
    with sqlite3.connect(str(metrics_db)) as con:
        df = pd.read_sql(f"select event, cell_id, {error_field} from cell_metrics", con)
    out = Path(out_dir)
    for event, sub in df.groupby("event"):
        merged = cell_table.merge(sub, left_on=cell_id_field, right_on="cell_id")
        fig, ax = plt.subplots(figsize=(6, 5))
        sc = _cell_scatter(ax, merged, merged[error_field].values)
        fig.colorbar(sc, ax=ax, label=error_metric)
        apply_formatting(ax, f"{error_metric} — {event}", "x", "y")
        _save(fig, out / f"{event}_{suffix}.png")


def map_errors(cell_table: pd.DataFrame, values: np.ndarray, error_metric: str,
               event: str, out_path: str | Path,
               colormap_limits: tuple[float, float] | None = None) -> None:
    """Single-event choropleth of one error array over the mesh centroids
    (reference gpras/utils/plotting.py:410-443; the low-level sibling of
    :func:`map_mesh_errors`)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    vmin, vmax = (colormap_limits if colormap_limits is not None
                  else (float(np.nanmin(values)), float(np.nanmax(values))))
    sc = _cell_fill(ax, cell_table, values, cmap="viridis", vmin=vmin,
                    vmax=vmax, symmetric=False)
    fig.colorbar(sc, ax=ax, label=error_metric)
    apply_formatting(ax, f"{error_metric} Map - {event}", "x", "y")
    _save(fig, out_path)


def ec_timeseries_alt(x: np.ndarray, y: np.ndarray, index: Any,
                      out_dir: str | Path) -> None:
    """Per-event EOF timeseries, alt layout: every LF mode overlaid on every
    HF-mode panel (reference gpras/utils/plotting.py:258-276)."""
    plt = _pyplot()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    idx = pd.MultiIndex.from_tuples(index) if not isinstance(index, pd.MultiIndex) else index
    for event in idx.get_level_values(0).unique():
        sel = idx.get_level_values(0) == event
        n = y.shape[1]
        fig, axes = plt.subplots(n, 1, figsize=(6.5, 2.2 * n), sharex=True)
        axes = np.atleast_1d(axes)
        t = np.arange(int(sel.sum()))
        for m in range(n):
            ax = axes[m]
            ax.plot(t, y[sel, m], c="k", lw=2, label="HF model")
            for j in range(x.shape[1]):
                ax.plot(t, x[sel, j], alpha=0.6, lw=1, label=f"LF mode {j}")
            apply_formatting(ax, ylabel=f"HF mode {m}")
            ax.set_yticks([])
        axes[0].legend(fontsize=6, ncol=2)
        axes[-1].set_xlabel("Timestep")
        fig.suptitle(f"Plan {event}")
        _save(fig, out / f"Plan_{event}.png")


def appr_3_pairplot(x: np.ndarray, y: np.ndarray, index: Any,
                    out_dir: str | Path) -> None:
    """Per-event lower-triangle scatter grid of HF modes vs LF modes
    (reference gpras/utils/plotting.py:279-299)."""
    plt = _pyplot()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    idx = pd.MultiIndex.from_tuples(index) if not isinstance(index, pd.MultiIndex) else index
    rows, cols = y.shape[1], x.shape[1]
    for event in idx.get_level_values(0).unique():
        sel = idx.get_level_values(0) == event
        fig, axes = plt.subplots(rows, cols, figsize=(2.5 * cols, 2.5 * rows),
                                 squeeze=False)
        for ix in range(cols):
            for iy in range(rows):
                if iy > ix:
                    axes[iy, ix].set_axis_off()
                    continue
                axes[iy, ix].scatter(x[sel, ix], y[sel, iy], c="k", alpha=0.5, s=4)
        for iy in range(rows):
            axes[iy, 0].set_ylabel(f"HF mode {iy}", fontsize=8)
        for ix in range(cols):
            axes[-1, ix].set_xlabel(f"LF mode {ix}", fontsize=8)
        fig.suptitle(f"Plan {event}")
        _save(fig, out / f"Plan_{event}.png")


def plot_spatial_eof(plot_dir: str | Path, eof_vector: np.ndarray, mode: int,
                     wet_cell_ids: Any, cell_table: pd.DataFrame,
                     cell_id_field: str = "cell_id",
                     title: str = "Spatial EOF Pattern", cmap: str = "seismic",
                     shared_vmax: float | None = None) -> None:
    """One EOF mode mapped over the mesh with a symmetric color scale
    (reference gpras/utils/plotting.py:637-681; single-mode sibling of
    :func:`plot_eof_maps`)."""
    plt = _pyplot()
    sub = cell_table.set_index(cell_id_field).loc[np.asarray(wet_cell_ids)]
    vmax = shared_vmax if shared_vmax is not None else float(np.max(np.abs(eof_vector))) or 1.0
    fig, ax = plt.subplots(figsize=(7, 5.5))
    sc = _cell_fill(ax, sub, np.asarray(eof_vector), cmap=cmap, vmax=vmax,
                    symmetric=True)
    fig.colorbar(sc, ax=ax, label="EOF Amplitude")
    apply_formatting(ax, title, "X coordinate", "Y coordinate")
    _save(fig, Path(plot_dir) / f"eof_{mode}.png")


def plot_eof_maps(eofs: np.ndarray, wet_cell_ids: list, cell_table: pd.DataFrame,
                  out_dir: str | Path, n_modes: int = 3,
                  cell_id_field: str = "cell_id", cmap: str = "viridis") -> None:
    """Spatial maps of the leading EOFs (reference gpras/utils/plotting.py:637-713)."""
    plt = _pyplot()
    sub = cell_table.set_index(cell_id_field).loc[wet_cell_ids]
    out = Path(out_dir)
    for m in range(min(n_modes, eofs.shape[0])):
        fig, ax = plt.subplots(figsize=(6, 5))
        sc = _cell_fill(ax, sub, eofs[m], cmap=cmap, symmetric=False)
        fig.colorbar(sc, ax=ax, label=f"EOF {m}")
        apply_formatting(ax, f"EOF mode {m}", "x", "y")
        _save(fig, out / f"eof_{m}.png")


def map_detection_categories(cell_table: pd.DataFrame, hf_depth: np.ndarray,
                             pred_depth: np.ndarray, index: Any, columns: Any,
                             output_plot_path: str | Path,
                             include_correct_negative: bool = True,
                             wet_threshold_depth: float = 0.5,
                             cell_id_field: str = "cell_id") -> None:
    """Detected / Miss / FalseAlarm / CorrectNeg at per-cell peak depth, one map
    per event (reference gpras/utils/plotting.py:716-859)."""
    plt = _pyplot()
    idx = pd.MultiIndex.from_tuples(index) if not isinstance(index, pd.MultiIndex) \
        else index
    events = idx.get_level_values(0).unique()
    out = Path(output_plot_path)
    colors = {"Detected": "#2166ac", "Miss": "#b2182b",
              "FalseAlarm": "#f4a582", "CorrectNeg": "#cccccc"}
    table = cell_table.set_index(cell_id_field).loc[list(columns)]  # loop-invariant
    for event in events:
        sel = idx.get_level_values(0) == event
        hf_peak = hf_depth[sel].max(axis=0)
        pr_peak = pred_depth[sel].max(axis=0)
        hf_wet = hf_peak >= wet_threshold_depth
        pr_wet = pr_peak >= wet_threshold_depth
        cat = np.where(hf_wet & pr_wet, "Detected",
                       np.where(hf_wet & ~pr_wet, "Miss",
                                np.where(~hf_wet & pr_wet, "FalseAlarm",
                                         "CorrectNeg")))
        fig, ax = plt.subplots(figsize=(6, 5))
        polys = _cell_polys(table)
        for name, color in colors.items():
            if name == "CorrectNeg" and not include_correct_negative:
                continue
            mask = cat == name
            if polys is not None:
                from matplotlib.collections import PolyCollection

                sel_polys = [p for p, m in zip(polys, mask) if m]
                ax.add_collection(PolyCollection(sel_polys, facecolors=color,
                                                 edgecolors="none", label=name))
            else:
                ax.scatter(table["x"].values[mask], table["y"].values[mask],
                           s=18, marker="s", c=color, label=name)
        if polys is not None:
            ax.autoscale_view()
        ax.set_aspect("equal")
        ax.legend(fontsize=7)
        apply_formatting(ax, f"Detection categories — {event}", "x", "y")
        _save(fig, out / f"{event}_detection.png")


# ------------------------------------------------------------------ metric plots

def plot_timeseries_metrics(metrics_db: str | Path, out_dir: str | Path,
                            metrics_field: list[str], metrics: list[str],
                            overlay: bool = True) -> None:
    """Per-event metric timeseries from the timeseries_metrics table
    (reference gpras/utils/plotting.py:446-530)."""
    plt = _pyplot()
    with sqlite3.connect(str(metrics_db)) as con:
        df = pd.read_sql("select * from timeseries_metrics", con)
    out = Path(out_dir)
    for event, sub in df.groupby("event"):
        if overlay:
            fig, ax = plt.subplots(figsize=(7, 3.5))
            for field, label in zip(metrics_field, metrics):
                ax.plot(sub["timestep"], sub[field], lw=1, label=label)
            apply_formatting(ax, f"Metrics — {event}", "timestep", "value")
            ax.legend(fontsize=8)
        else:
            fig, axes = plt.subplots(len(metrics_field), 1,
                                     figsize=(7, 2.2 * len(metrics_field)),
                                     sharex=True)
            for ax, field, label in zip(np.atleast_1d(axes), metrics_field, metrics):
                ax.plot(sub["timestep"], sub[field], lw=1)
                apply_formatting(ax, ylabel=label)
        _save(fig, out / f"{event}.png")


def summary_plots(metrics_db: str | Path, out_dir: str | Path,
                  metrics: dict[str, dict[str, str]]) -> None:
    """Box/strip summaries across events for each metric table/field
    (reference gpras/utils/plotting.py:533-634)."""
    plt = _pyplot()
    import seaborn as sns

    out = Path(out_dir)
    with sqlite3.connect(str(metrics_db)) as con:
        for table, fields in metrics.items():
            df = pd.read_sql(f"select * from {table}", con)
            for field, label in fields.items():
                if field not in df.columns:
                    continue
                fig, ax = plt.subplots(figsize=(7, 3.5))
                if len(df) > len(df["event"].unique()):
                    sns.boxplot(data=df, x="event", y=field, ax=ax)
                else:
                    ax.scatter(df["event"], df[field])
                apply_formatting(ax, label, "event", label)
                ax.tick_params(axis="x", rotation=45)
                _save(fig, out / f"summary_{table}_{field}.png")


# ----------------------------------------------------------------- miscellaneous

def plot_rating_curve(q: np.ndarray, wse: np.ndarray, q_fit: np.ndarray,
                      wse_fit: np.ndarray, out_path: str | Path,
                      title: str | None = None) -> None:
    """Fitted curve + source scatter (reference gpras/utils/plotting.py:862-881)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter(q, wse, s=4, alpha=0.4, label="observations")
    ax.plot(q_fit, wse_fit, c="r", lw=1.5, label="spline")
    ax.set_xscale("log")
    apply_formatting(ax, title or "Rating curve", "discharge", "WSE")
    ax.legend(fontsize=8)
    _save(fig, out_path)


def plot_centerline_interpolater(stations: np.ndarray, drops: np.ndarray,
                                 out_path: str | Path) -> None:
    """Median fractional WSE drop vs centerline station
    (reference gpras/utils/plotting.py:884-895)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    order = np.argsort(stations)
    ax.plot(stations[order], drops[order], "o-", ms=3)
    apply_formatting(ax, "Centerline drop profile", "station", "fractional drop")
    _save(fig, out_path)
