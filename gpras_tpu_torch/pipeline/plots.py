"""Pipeline diagnostic-plot generation (reference production/analysis/pipeline.py:90-210).

A copy of ``gpras_tpu/pipeline/plots.py``; the inducing points come back from
the model's device before they are drawn.
"""

from __future__ import annotations

from gpras_tpu_torch import plotting as pl
from gpras_tpu_torch.pipeline.config import Config


def gen_plots(config: Config, gpr, extracter, hf_reducer, x, y, x_test, y_test,
              mean_pred, lf_test_df, hf_test_df, y_test_pred,
              lf_test_depth, hf_test_depth, y_test_pred_depth) -> None:
    """All plot families of the reference pipeline, driven by the same artifacts."""
    n_modes = min(hf_reducer.spatial_mode_count, 5)
    plot_dir = config.plot_dir
    inducing = None
    if gpr.params is not None and "z" in gpr.params:
        inducing = gpr.params["z"][0].cpu().numpy()
    pl.ec_pairplot(x, x, n_modes, plot_dir / "inducing_fitted.png", inducing)
    pl.ec_pairplot(x_test, y_test, n_modes, plot_dir / "pairplot_test.png")
    pl.ec_pairplot(x, y, n_modes, plot_dir / "pairplot.png")
    pl.pca_variance_summary(hf_reducer.eigenvalues, hf_reducer.spatial_mode_count,
                            plot_dir / "pca_variance.png")
    if config.lf_model_type == "ras_upskill":
        pl.performance_scatterplot(lf_test_df.values, hf_test_df.values,
                                   y_test_pred, plot_dir / "performance_scatterplot.png")
        pl.performance_cdf(lf_test_df.values, hf_test_df.values, y_test_pred,
                           plot_dir / "performance_cdf.png")
        pl.ec_pairplot(mean_pred, y_test, n_modes,
                       plot_dir / "pairplot_test_predicted.png")
        pl.performance_scatterplot(lf_test_depth, hf_test_depth,
                                   y_test_pred_depth,
                                   plot_dir / "performance_scatterplot_depth.png",
                                   depth=True)
    cell_table = extracter.hf_geometry_aoi
    db = config.metric_db_path
    for suffix, field, label in (
        ("rmse", "rmse_cell_toi", "RMSE"),
        ("mts_error", "err_cell_mts", "Max Depth Error"),
        ("mean_error", "err_cell_toi", "Mean Error"),
    ):
        pl.map_mesh_errors(cell_table, db, plot_dir / "error_maps", suffix,
                           field, label, cell_id_field=config.cell_id_field)
    pl.map_detection_categories(
        cell_table, hf_test_depth, y_test_pred_depth,
        hf_test_df.index.values, hf_test_df.columns.values,
        output_plot_path=plot_dir / "error_maps",
        include_correct_negative=True,
        wet_threshold_depth=config.wet_threshold_depth,
        cell_id_field=config.cell_id_field)
    pl.plot_timeseries_metrics(db, plot_dir / "error_timeseries",
                               metrics_field=["rmse_aoi_ts", "err_aoi_ts"],
                               metrics=["RMSE", "Mean Error"], overlay=True)
    pl.summary_plots(db, plot_dir, metrics={
        "cell_metrics": {"rmse_cell_toi": "Spatial RMSE",
                         "err_cell_mts": "Spatial Mean Error (Max)",
                         "err_cell_toi": "Spatial Mean Error"},
        "scalar_metrics": {"nse_aoi_mts": "NSE", "err_aoi_mts": "Max Error",
                           "fi_aoi_toi": "Fidelity Index"},
        "timeseries_metrics": {"rmse_aoi_ts": "Temporal RMSE",
                               "err_aoi_ts": "Temporal Mean Error"},
    })
    wet_ids = cell_table[config.cell_id_field].values
    if hf_reducer.wetness_classes.size and config.hydraulic_parameter != "velocity":
        wet_ids = wet_ids[~hf_reducer.dry_indices]
    pl.plot_eof_maps(hf_reducer.eofs, list(wet_ids), cell_table, plot_dir,
                     n_modes=3, cell_id_field=config.cell_id_field)
