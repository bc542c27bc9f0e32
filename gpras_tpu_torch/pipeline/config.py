"""JSON-backed, self-documenting pipeline configuration.

Parity with the reference's ``Config`` dataclass (production/analysis/
data_models.py:38-368): per-field ``metadata={"help", "example", "choices"}``
self-documentation, derived paths created in ``__post_init__``, lazy cached
accessors for heavyweight objects, and factory properties dispatching on
``lf_model_type``. Adds TPU-specific knobs: ``model_backend`` (sparse vs exact
GP) and ``dtype``.

The reference's ``lf_model_type`` Literal omits "ras_interpolate" even though its
factory supports it (data_models.py:26 vs 346-347); we include it.

A copy of ``gpras_tpu/pipeline/config.py``, field for field and default for
default (its help texts too), so a config JSON written for one package loads
in the other. The factories return the port's classes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from functools import cached_property
from pathlib import Path
from typing import Any, Literal, Self, TypedDict

LFModelType = Literal["ras_upskill", "ras_interpolate", "pseudo_surface", "hms_upskill"]


class EventPlan(TypedDict):
    """Metadata for a HEC-RAS plan (reference data_models.py:29-36)."""

    plan_title: str
    event_number: int
    type: str
    set: str


@dataclass
class Config:
    """Settings controlling where and how the GP surrogate is fit
    (reference data_models.py:38-262, field for field)."""

    # === Core Paths/IDs ===
    working_directory: str = field(metadata={
        "help": "Root directory for data, metrics, model files, and plots.",
        "example": "/data/ras_upskill"})
    hf_ras_stac_path: str = field(metadata={
        "help": "Path to the STAC item json for the high-fidelity HEC-RAS model.",
        "example": "/data/bridgeport_HF/bridgeport.stac.json"})
    area_of_interest_path: str = field(metadata={
        "help": "Path to the area-of-interest polygon (GeoJSON).",
        "example": "/data/shared/project_area.geojson"})
    event_plan_path: str = field(metadata={
        "help": "Path to the event plan json from automated run creation.",
        "example": "/data/shared/event_plans.json"})
    mesh_id: str = field(metadata={
        "help": "Unique mesh identifier within the HF RAS model.",
        "example": "bridgeport_1"})

    # === Model Setup ===
    hydraulic_parameter: str = field(metadata={
        "help": "Primary hydraulic variable being modeled.",
        "choices": ["wse", "depth", "velocity"], "example": "depth"})
    wet_threshold_depth: float = field(metadata={
        "help": "Depth threshold separating wet from dry cells.", "example": 0.5})
    spatial_mode_count: int = field(metadata={
        "help": "Retained EOF mode count; 0 -> North's rule.", "example": 10})
    kernel: str = field(metadata={
        "help": "GP covariance kernel.",
        "choices": ["Matern12", "Matern32", "Matern52", "RBF", "Linear",
                    "Polynomial", "Periodic", "Exponential"],
        "example": "Matern32"})
    inducing_pt_count: int = field(metadata={
        "help": "Inducing point count for the sparse GP.", "example": 50})
    optimizer: str = field(metadata={
        "help": "Hyperparameter optimization strategy.",
        "choices": ["two-stage", "three-stage", "adam", "adadelta", "L-BFGS-B",
                    "stochastic", "diffential_evolution"],
        "example": "L-BFGS-B"})
    induction_pt_initializer: str = field(metadata={
        "help": "Inducing-point initialization.",
        "choices": ["kmeans", "grid"], "example": "kmeans"})
    optimizer_kwargs: dict[str, Any] = field(metadata={
        "help": "Extra kwargs forwarded to the optimizer.",
        "example": {"max_iter": 1000}})

    # === Outputs ===
    generate_plots: bool = field(metadata={
        "help": "Emit diagnostic plots.", "example": True})
    save_dbs: bool = field(metadata={
        "help": "Persist extracted datasets as parquet DBs for replay.",
        "example": True})

    # === Low-Fidelity Model ===
    lf_model_type: LFModelType = field(metadata={
        "help": "Source of low-fidelity features.",
        "choices": ["ras_upskill", "ras_interpolate", "pseudo_surface", "hms_upskill"],
        "example": "ras_upskill"})
    lf_ras_stac_path: str | None = field(default=None, metadata={
        "help": "STAC item for the LF RAS model (ras_upskill/ras_interpolate).",
        "example": "/data/bridgeport_LF/bridgeport.stac.json"})
    inflow_dss_dir: str | None = field(default=None, metadata={
        "help": "Directory of per-plan HMS DSS inflow files (hms_upskill/pseudo_surface).",
        "example": "data/flow_boundaries"})
    inflow_hms_elements: list[list[str]] | None = field(default=None, metadata={
        "help": "HMS element name/data-type pairs to extract as features.",
        "example": [["west-fork_s340", "FLOW"], ["west-fork_s330", "FLOW"]]})
    precip_dss_dir: str | None = field(default=None, metadata={
        "help": "Directory of per-plan excess-precip DSS files.",
        "example": "data/precip/"})
    precip_spatial_mode_count: int = field(default=0, metadata={
        "help": "EOF mode count for the precip grid (hms_upskill/pseudo_surface).",
        "example": 5})
    api_event_reset: bool = field(default=False, metadata={
        "help": "Restart the antecedent-precipitation convolutions at event "
                "boundaries (no cross-event leakage). Off = reference parity "
                "(gpras/preprocess.py:1251-1256 convolves the concatenated frame).",
        "example": True})
    fluvial_lf_preprocessor_path: str | None = field(default=None, metadata={
        "help": "LF preprocessor from a trained HMS-upskill model (pseudo_surface).",
        "example": "/data/hms_upskill/model/lf_preprocessor.npz"})
    fluvial_hf_preprocessor_path: str | None = field(default=None, metadata={
        "help": "HF preprocessor from a trained HMS-upskill model (pseudo_surface).",
        "example": "/data/hms_upskill/model/hf_preprocessor.npz"})
    fluvial_gpr_path: str | None = field(default=None, metadata={
        "help": "Pre-trained fluvial GPR checkpoint (pseudo_surface).",
        "example": "/data/hms_upskill/model/gpr.npz"})
    us_bc_id_ras: str | None = field(default=None, metadata={
        "help": "Upstream BC id in the RAS model, for rating curves (pseudo_surface).",
        "example": "Inflow1"})
    ds_bc_id_ras: str | None = field(default=None, metadata={
        "help": "Downstream BC id in the RAS model (pseudo_surface).",
        "example": "West_Fork_S020_Inlet|bridgeport_1"})
    us_bc_id_hms: str | None = field(default=None, metadata={
        "help": "Upstream BC id in the HMS model (pseudo_surface).",
        "example": "West_Fork_S020_Outlet|bridgeport_1"})
    ds_bc_id_hms: str | None = field(default=None, metadata={
        "help": "Downstream BC id in the HMS model (pseudo_surface).",
        "example": "Outflow_HMS1"})
    centerline_path: str | None = field(default=None, metadata={
        "help": "River centerline file (GeoJSON linestring; pseudo_surface).",
        "example": "data/centerline.geojson"})

    # === Miscellaneous ===
    cell_id_field: str = field(default="cell_id", metadata={
        "help": "Cell-id field name in the mesh tables.", "example": "cell_id"})

    # === TPU backend knobs (new) ===
    model_backend: str = field(default="sgpr", metadata={
        "help": "GP backend: sparse collapsed-ELBO ('sgpr'), minibatch "
                "uncollapsed-bound sparse GP ('svgp'; unbounded N at O(M^2) "
                "memory), or dense exact GP with custom-VJP NLML ('exact').",
        "choices": ["sgpr", "svgp", "exact"], "example": "sgpr"})
    fi_time_tolerance: int = field(default=0, metadata={
        "help": "Fidelity-index peak-time tolerance in timesteps "
                "(addition over the reference; its fi used 0).",
        "example": 3})
    fi_value_tolerance: float = field(default=0.0, metadata={
        "help": "Fidelity-index value tolerance (same units as the "
                "hydraulic parameter; the reference's fi used 0).",
        "example": 0.1})
    dtype: str = field(default="float32", metadata={
        "help": "Device compute dtype. float32 is the TPU-native default "
                "(the reference runs float64 on CPU).",
        "choices": ["float32", "float64"], "example": "float32"})

    def __post_init__(self) -> None:
        """Derive artifact paths and create output dirs
        (reference data_models.py:264-285)."""
        self.working_directory_path = Path(self.working_directory)
        self.plot_dir = self.working_directory_path / "plots"
        self.model_dir = self.working_directory_path / "model"
        self.metric_dir = self.working_directory_path / "metrics"
        self.testing_data_db = str(self.working_directory_path / "data" / "testing.db")
        self.training_data_db = str(self.working_directory_path / "data" / "training.db")
        self.model_path = self.model_dir / "gpr.npz"
        self.hf_preprocessor_path = self.model_dir / "hf_preprocessor.npz"
        if self.lf_model_type == "ras_upskill":
            self.lf_preprocessor_path = self.hf_preprocessor_path
        else:
            self.lf_preprocessor_path = self.model_dir / "lf_preprocessor.npz"
        self.timer_path = self.model_dir / "timers.json"
        self.metric_db_path = self.metric_dir / "performance_metrics.db"
        self.plot_dir.mkdir(exist_ok=True, parents=True)
        self.model_dir.mkdir(exist_ok=True, parents=True)
        self.metric_dir.mkdir(exist_ok=True, parents=True)

    # ------------------------------------------------------------- constructors

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> Self:
        return cls(**d)

    @classmethod
    def from_file(cls, fpath: str | Path) -> Self:
        with open(fpath) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def to_file(self, fpath: str | Path) -> None:
        with open(fpath, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def describe(cls) -> str:
        """Render the per-field help metadata (the self-documentation surface the
        reference embeds via field metadata)."""
        lines = []
        for f in fields(cls):
            help_ = f.metadata.get("help", "")
            choices = f.metadata.get("choices")
            line = f"{f.name}: {help_}"
            if choices:
                line += f" choices={choices}"
            lines.append(line)
        return "\n".join(lines)

    # ------------------------------------------------------------ lazy accessors

    @cached_property
    def hf_ras(self):
        """High-fidelity RAS model handle (reference data_models.py:299-304)."""
        from gpras_tpu_torch.data.ras_model import RasModel

        return RasModel.from_stac(self.hf_ras_stac_path)

    @cached_property
    def lf_ras(self):
        if self.lf_ras_stac_path is None:
            raise RuntimeError("lf_ras requested but lf_ras_stac_path was not provided")
        from gpras_tpu_torch.data.ras_model import RasModel

        return RasModel.from_stac(self.lf_ras_stac_path)

    @cached_property
    def event_plan_json(self) -> list[EventPlan]:
        with open(self.event_plan_path) as f:
            return json.load(f)

    @cached_property
    def train_plans(self) -> list[str]:
        return [i["plan_title"] for i in self.event_plan_json if i["type"] == "Train"]

    @cached_property
    def test_plans(self) -> list[str]:
        return [i["plan_title"] for i in self.event_plan_json if i["type"] == "Test"]

    @cached_property
    def area_of_interest(self):
        """AOI polygon loaded from GeoJSON (the reference reads a geopackage via
        geopandas, data_models.py:332-335; we read GeoJSON with our own geometry
        toolkit)."""
        from gpras_tpu_torch.data.geometry import Polygon

        return Polygon.from_geojson_file(self.area_of_interest_path)

    # ---------------------------------------------------------------- factories

    @cached_property
    def data_builder(self):
        """Builder class for the LF model type (reference data_models.py:337-347)."""
        from gpras_tpu_torch.data import builders

        return {
            "ras_upskill": builders.RasUpskillDataBuilder,
            "ras_interpolate": builders.RasInterpolaterBuilder,
            "pseudo_surface": builders.PseudoSurfaceDataBuilder,
            "hms_upskill": builders.HmsUpskillDataBuilder,
        }[self.lf_model_type]

    @cached_property
    def data_reader(self):
        from gpras_tpu_torch.data.reader import RasReader

        return RasReader

    @cached_property
    def preprocessor(self):
        from gpras_tpu_torch.eof.preprocessor import HmsPreProcessor, PreProcessor

        if self.lf_model_type == "hms_upskill":
            return HmsPreProcessor
        return PreProcessor
