"""Cross-validation harness: hyperparameter sweeps over the full pipeline.

Capability parity with the reference harness (production/analysis/
cross_validation.py:13-138): a ``CVConfig`` that re-splits train/test into the
AEP vs Diverse *training* event sets, generic single-parameter and zipped
multi-parameter sweep runners with per-option output dirs and skip-if-exists
resume, and the four canned sweeps (kernels, spatial mode counts, inducing
point counts, optimizer x kwargs).

Port of ``gpras_tpu/pipeline/cross_validation.py``: each entry point takes
the ``device`` the pipeline runs on.
"""

from __future__ import annotations

import json
from functools import cached_property
from pathlib import Path
from typing import Any

import torch

from gpras_tpu_torch.pipeline.config import Config
from gpras_tpu_torch.pipeline.pipeline import (
    get_data_extracter,
    get_pre_processors,
    pipeline,
)


class CVConfig(Config):
    """Cross-validate within the training set: AEP events train, Diverse events
    validate (reference cross_validation.py:13-24)."""

    @cached_property
    def train_plans(self) -> list[str]:
        # deviation from the reference (cross_validation.py:19, which filters
        # set == "AEP" only): the three "Max" preselects are part of the
        # AEP-targeted design and excluding them drops exactly the most
        # extreme training events from every sweep
        return [i["plan_title"] for i in self.event_plan_json
                if i["type"] == "Train" and i["set"] in ("AEP", "Max")]

    @cached_property
    def test_plans(self) -> list[str]:
        return [i["plan_title"] for i in self.event_plan_json
                if i["type"] == "Train" and i["set"] == "Diverse"]


def setup(config_path: str, device: str | torch.device = "cuda") -> None:
    """Pre-extract data and fit preprocessors once for reuse across sweep
    options (reference cross_validation.py:27-33)."""
    config = CVConfig.from_file(config_path)
    extracter = get_data_extracter(config, config.train_plans,
                                   config.training_data_db, True, True, device)
    get_data_extracter(config, config.test_plans, config.testing_data_db, True, True, device)
    hf_df, lf_df = extracter.aligned_datasets
    get_pre_processors(config, hf_df, lf_df, extracter, device)


def run_cv(config: CVConfig, parameter: str, options: list[Any],
           device: str | torch.device = "cuda") -> None:
    """Sweep one config parameter; each option writes to its own directory and
    completed options are skipped on resume (reference cross_validation.py:36-50)."""
    base_dir = Path(config.working_directory) / parameter
    for opt in options:
        out_dir = base_dir / str(opt)
        if out_dir.exists():
            continue
        out_dir.mkdir(parents=True)
        (out_dir / "plots").mkdir()
        config.metric_db_path = out_dir / "performance_metrics.db"
        config.plot_dir = out_dir / "plots"
        setattr(config, parameter, opt)
        pipeline(config, device)


def run_cv_serial(config: CVConfig, options: dict[str, list[Any]],
                  base_dir: Path, device: str | torch.device = "cuda") -> None:
    """Zipped multi-parameter sweep: option i sets every key's i-th value
    (reference cross_validation.py:53-85). The config snapshot is written per
    option; a spatial_mode_count change invalidates the cached preprocessor, so
    the model dir moves under the option dir in that case."""
    base_dir.mkdir(parents=True, exist_ok=True)
    with open(base_dir / "defaults.config.json", "w") as f:
        json.dump(config.to_dict(), f, indent=4, default=str)
    n = len(options[next(iter(options))])
    for i in range(n):
        out_dir = base_dir / str(i)
        if out_dir.exists():
            continue
        out_dir.mkdir()
        (out_dir / "plots").mkdir()
        config.metric_db_path = out_dir / "performance_metrics.db"
        config.plot_dir = out_dir / "plots"
        for k in options:
            setattr(config, k, options[k][i])
            if k == "spatial_mode_count":
                config.model_dir = out_dir / "model"
                config.model_dir.mkdir(exist_ok=True)
                config.hf_preprocessor_path = config.model_dir / "hf_preprocessor.npz"
                if config.lf_model_type == "ras_upskill":
                    config.lf_preprocessor_path = config.hf_preprocessor_path
                else:
                    config.lf_preprocessor_path = config.model_dir / "lf_preprocessor.npz"
                config.model_path = config.model_dir / "gpr.npz"
        pipeline(config, device)
        with open(out_dir / "config.json", "w") as f:
            json.dump(config.to_dict(), f, indent=4, default=str)


def run_kernels(config_path: str, device: str | torch.device = "cuda") -> None:
    """Kernel sweep (reference cross_validation.py:88-93)."""
    config = CVConfig.from_file(config_path)
    run_cv_serial(config,
                  {"kernel": ["Matern12", "Matern32", "Matern52", "RBF",
                              "Exponential"]},
                  Path(config.working_directory) / "kernel", device)


def run_spatial_modes(config_path: str, device: str | torch.device = "cuda") -> None:
    """Spatial-mode-count sweep (reference cross_validation.py:96-102)."""
    config = CVConfig.from_file(config_path)
    run_cv_serial(config,
                  {"spatial_mode_count": [1, 3, 5, 7, 10, 15, 20, 30, 50]},
                  Path(config.working_directory) / "spatial_mode_count", device)


def run_inducing_points(config_path: str, device: str | torch.device = "cuda") -> None:
    """Inducing-point-count sweep (reference cross_validation.py:105-110)."""
    config = CVConfig.from_file(config_path)
    run_cv_serial(config,
                  {"inducing_pt_count": [1, 3, 5, 10, 20, 50, 100, 300]},
                  Path(config.working_directory) / "inducing_pt_count", device)


def run_optimization_method(config_path: str, device: str | torch.device = "cuda") -> None:
    """Optimizer x kwargs sweep (reference cross_validation.py:113-129)."""
    config = CVConfig.from_file(config_path)
    options = {
        "optimizer": ["two-stage", "adam", "L-BFGS-B", "stochastic",
                      "diffential_evolution", "three-stage", "adadelta"],
        "optimizer_kwargs": [
            {"max_iter": 5000},
            {"max_iter": 10000},
            {"max_iter": 10000},
            {"n_starts": 50, "iter_initial": 100, "iter_final": 5000},
            {"popsize": 5, "max_iter": 100},
            {"max_iter": 333},
            {"max_iter": 10000},
        ],
    }
    run_cv_serial(config, options, Path(config.working_directory) / "optimizer", device)
