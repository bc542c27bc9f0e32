"""End-to-end train/predict/evaluate pipeline with artifact caching and timers.

Orchestration parity with the reference ``pipeline(config)``
(production/analysis/pipeline.py:213-318): load (or replay) train/test data ->
fit-or-load EOF preprocessors -> transform to mode space -> fit GPRAS ->
save/load round trip -> batched posterior prediction -> reverse transform with
variance -> depth conversions -> metric export -> ``timers.json`` with the same
four phase keys (load_data / preprocess_data / fit_model / make_predictions,
production/analysis/pipeline.py:289-294) -> optional diagnostic plots.

Port of ``gpras_tpu/pipeline/pipeline.py``. ``pipeline(config, device)`` hands
``device`` to every preprocessor and ``GPRAS`` it makes or loads and to the
metric export. ``config.dtype`` picks the model's torch dtype; there is no
global switch, where the JAX package turns on ``jax_enable_x64``. A phase
timer is read only after the device has finished the phase's queued work,
so each timer holds its own phase's device time. The DB is replayed when it is
valid, before any builder is looked up, so a replay imports neither h5py
nor matplotlib.
"""

from __future__ import annotations

import inspect
import json
import logging
import time
from typing import Any

import numpy as np
import pandas as pd
import torch

from gpras_tpu_torch.eof.preprocessor import HmsPreProcessor, PreProcessor
from gpras_tpu_torch.gp.model import GPRAS
from gpras_tpu_torch.metrics import export_metric_summary
from gpras_tpu_torch.pipeline.config import Config

log = logging.getLogger("gpras_tpu_torch.pipeline")


def _clock(device: torch.device) -> float:
    """``time.perf_counter`` once ``device`` has run all its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def get_data_extracter(config: Config, plans: list[str], db_path: str, save: bool,
                       plot_temporal_clips: bool = False,
                       device: str | torch.device = "cuda"):
    """Replay the parquet DB when valid; otherwise construct the configured
    builder (kwargs wired by signature introspection against the config, the
    same wiring trick as production/analysis/pipeline.py:35-50; a builder
    that takes a ``device`` gets this one)."""
    reader_cls = config.data_reader
    if not reader_cls.is_valid(db_path):
        init_params = inspect.signature(config.data_builder.__init__).parameters
        init_dict = {k: getattr(config, k) for k in init_params
                     if k != "self" and hasattr(config, k)}
        init_dict["plans"] = plans
        if "device" in init_params:
            init_dict["device"] = device
        builder = config.data_builder(**init_dict)
        plot_dir = str(config.plot_dir / "temporal_clipping") if plot_temporal_clips else None
        builder.align_datasets(plot_dir)
        if save:
            builder.export_db(db_path)
        else:
            return builder
    return reader_cls(db_path)


def get_hf_pre_processor(config: Config, data: pd.DataFrame, extracter,
                         device: str | torch.device = "cuda") -> PreProcessor:
    """Fit-or-load the spatial EOF preprocessor (pipeline.py:53-61)."""
    if not config.hf_preprocessor_path.exists():
        reducer = PreProcessor(wet_threshold=config.wet_threshold_depth,
                               hydraulic_parameter=config.hydraulic_parameter, device=device)
        mode_count = config.spatial_mode_count if config.spatial_mode_count > 0 else None
        reducer.fit(data.values, extracter.cell_elevations, extracter.cell_areas,
                    mode_count)
        reducer.to_file(config.hf_preprocessor_path)
    else:
        reducer = PreProcessor.from_file(config.hf_preprocessor_path, device=device)
        # artifact caching keys on file existence only (reference behavior);
        # a stale artifact fit under a different hydraulic parameter would
        # silently wrong-convert every prediction downstream
        if reducer.hydraulic_parameter != config.hydraulic_parameter:
            raise RuntimeError(
                f"cached preprocessor {config.hf_preprocessor_path} was fit "
                f"with hydraulic_parameter={reducer.hydraulic_parameter!r} "
                f"but the config says {config.hydraulic_parameter!r}; delete "
                "the artifact (or use a fresh working_directory) to refit")
    return reducer


def get_hms_preprocessor(config: Config, data: pd.DataFrame,
                         device: str | torch.device = "cuda") -> HmsPreProcessor:
    """Fit-or-load the forcing feature preprocessor (pipeline.py:64-74)."""
    if not config.lf_preprocessor_path.exists():
        reducer = HmsPreProcessor(event_reset=config.api_event_reset, device=device)
        precip_mask = np.array([str(c).startswith("precip_") for c in data.columns])
        mode_count = (config.precip_spatial_mode_count
                      if config.precip_spatial_mode_count > 0 else None)
        reducer.fit(data.values, ~precip_mask, precip_mask, mode_count,
                    event_ids=_event_ids(data, config))
        reducer.to_file(config.lf_preprocessor_path)
    else:
        reducer = HmsPreProcessor.from_file(config.lf_preprocessor_path, device=device)
    return reducer


def _event_ids(df: pd.DataFrame, config: Config) -> np.ndarray | None:
    """Per-row event labels from the aligned frame's (run, t) MultiIndex, when
    the API event-reset flag is on.

    Raises rather than silently returning None when the flag is set but the
    frame cannot supply event boundaries — falling back to a whole-frame
    convolution would reintroduce exactly the cross-event API leakage the
    flag promises to remove."""
    if not config.api_event_reset:
        return None
    if isinstance(df.index, pd.MultiIndex) and "run" in (df.index.names or ()):
        return np.asarray(df.index.get_level_values("run"))
    raise ValueError(
        "api_event_reset=True requires the aligned data frame to carry a "
        f"(run, t) MultiIndex with a 'run' level; got index names "
        f"{list(df.index.names or [])}")


def get_pre_processors(config: Config, hf_data: pd.DataFrame, lf_data: pd.DataFrame,
                       extracter, device: str | torch.device = "cuda"):
    """(hf_reducer, lf_reducer) pair by LF model type (pipeline.py:77-87)."""
    hf_pre = get_hf_pre_processor(config, hf_data, extracter, device)
    if config.lf_model_type in ("ras_upskill", "pseudo_surface", "ras_interpolate"):
        return hf_pre, hf_pre
    if config.lf_model_type == "hms_upskill":
        return hf_pre, get_hms_preprocessor(config, lf_data, device)
    raise RuntimeError(f"No preprocessor setup for LF model type {config.lf_model_type!r}")


def pipeline(config: Config, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run the full workflow on ``device``; returns a summary dict (paths +
    headline metrics)."""
    device = torch.device(device)
    dtype = torch.float64 if config.dtype == "float64" else torch.float32

    # ---------------------------------------------------------------- load data
    t1 = _clock(device)
    log.info("Loading data")
    extracter = get_data_extracter(config, config.train_plans, config.training_data_db,
                                   config.save_dbs, config.generate_plots, device)
    hf_data_df, lf_data_df = extracter.aligned_datasets
    test_extracter = get_data_extracter(config, config.test_plans, config.testing_data_db,
                                        config.save_dbs, config.generate_plots, device)
    hf_test_df, lf_test_df = test_extracter.aligned_datasets

    # --------------------------------------------------------------- preprocess
    t2 = _clock(device)
    log.info("Preprocessing data")
    hf_reducer, lf_reducer = get_pre_processors(config, hf_data_df, lf_data_df, extracter,
                                                device)
    y = hf_reducer.transform(hf_data_df.values)
    if isinstance(lf_reducer, HmsPreProcessor) and lf_reducer.event_reset:
        x = lf_reducer.transform(lf_data_df.values,
                                 event_ids=_event_ids(lf_data_df, config))
        x_test = lf_reducer.transform(lf_test_df.values,
                                      event_ids=_event_ids(lf_test_df, config))
    else:
        x = lf_reducer.transform(lf_data_df.values)
        x_test = lf_reducer.transform(lf_test_df.values)
    # y_test (HF test modes) is only consumed by the diagnostic plots
    y_test = hf_reducer.transform(hf_test_df.values) if config.generate_plots else None

    # ---------------------------------------------------------------------- fit
    t3 = _clock(device)
    log.info("Fitting GPR")
    gpr = GPRAS(config.kernel, model_type=config.model_backend, dtype=dtype, device=device)
    gpr.fit(x, y, config.inducing_pt_count, config.induction_pt_initializer,
            config.optimizer, **config.optimizer_kwargs)
    gpr.to_file(config.model_path)
    gpr = GPRAS.from_file(config.model_path, device=device)  # save->load->predict parity
    # (the reference always reloads before predicting, pipeline.py:254-255)

    # ------------------------------------------------------------------ predict
    t4 = _clock(device)
    log.info("Making predictions")
    mean_pred, var_pred = gpr.predict(x_test)
    y_test_pred, y_test_var = hf_reducer.reverse_transform(mean_pred, var_pred)

    if config.hydraulic_parameter != "velocity":
        if config.hydraulic_parameter == "depth":
            y_test_pred = y_test_pred + hf_reducer.elevations
        lf_test_depth = (hf_reducer.wse_2_depth(lf_test_df.values)
                         if config.lf_model_type in ("ras_upskill", "pseudo_surface",
                                                     "ras_interpolate")
                         else lf_test_df.values)
        hf_test_depth = hf_reducer.wse_2_depth(hf_test_df.values)
        y_test_pred_depth = hf_reducer.wse_2_depth(y_test_pred)
    else:
        lf_test_depth = lf_test_df.values
        hf_test_depth = hf_test_df.values
        y_test_pred_depth = y_test_pred

    # ------------------------------------------------------------------ metrics
    t5 = _clock(device)
    log.info("Calculating metrics")
    export_metric_summary(
        pd.DataFrame(hf_test_depth, index=hf_test_df.index, columns=hf_test_df.columns),
        pd.DataFrame(y_test_pred_depth, index=hf_test_df.index, columns=hf_test_df.columns),
        pd.DataFrame(np.sqrt(y_test_var), index=hf_test_df.index, columns=hf_test_df.columns),
        config.metric_db_path,
        depth_threshold=config.wet_threshold_depth,
        t_tol=config.fi_time_tolerance,
        v_tol=config.fi_value_tolerance,
        hydraulic_parameter=config.hydraulic_parameter,
        device=device,
    )
    timers = {"load_data": t2 - t1, "preprocess_data": t3 - t2,
              "fit_model": t4 - t3, "make_predictions": t5 - t4}
    with open(config.timer_path, "w") as f:
        json.dump(timers, f, indent=4)

    if config.generate_plots:
        from gpras_tpu_torch.pipeline.plots import gen_plots

        gen_plots(config, gpr, extracter, hf_reducer, x, y, x_test, y_test,
                  mean_pred, lf_test_df, hf_test_df, y_test_pred,
                  lf_test_depth, hf_test_depth, y_test_pred_depth)

    rmse = float(np.sqrt(np.mean((hf_test_depth - y_test_pred_depth) ** 2)))
    return {
        "timers": timers,
        "metric_db": str(config.metric_db_path),
        "model_path": str(config.model_path),
        "depth_rmse": rmse,
    }
