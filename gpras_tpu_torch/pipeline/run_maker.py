"""HEC-RAS run generation: wire selected SST events into new flow/plan files.

A copy of ``gpras_tpu/pipeline/run_maker.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax), with h5py imported where the
precip HDF is read, so runs without precipitation are made where h5py is not
installed.

Capability parity with the reference run maker
(production/pre_processing/make_ras_runs.py:23-366): a validated ``Settings``
dataclass with derived DSS paths, per-event flow-file construction from a
template (BC rewiring against the event's SST DSS catalog with FFRD id munging
and USACE path-part surgery), HDF->DSS precipitation-grid conversion (last-72h
window), plan-file emission with simulation dates, project registration, and the
``event_plans.json`` manifest consumed by the analysis pipeline. HEC-RAS itself
runs externally (the reference has no execution code either).
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass, field
from datetime import timedelta
from pathlib import Path
from typing import Any

import numpy as np

from gpras_tpu_torch.data.flow_file import FlowHydrographBC, UnsteadyFlowFile
from gpras_tpu_torch.data.plan_file import PlanFile
from gpras_tpu_torch.data.ras_model import RasModel


@dataclass
class Settings:
    """Run-creation settings (reference make_ras_runs.py:23-122)."""

    ras_prj_path: str
    template_flow_path: str
    flow_dss_path_src: str
    precip_hdf_path: str
    flow_title: str
    plan_title: str
    plan_short_id: str
    geom_file_suffix: str = "g01"
    dss_dir: str = "gpr_dss_files"
    flow_bc_dir: str = "flow_boundaries"
    precip_bc_dir: str = "precip_boundaries"
    hdf_data_path: str = "exported_data"
    precip_dss_template_path: str = ""
    precip_dss_data_path: str = "/SHG/PRECIP/EXCESS-PRECIP/{}/{}/GPR/"
    computation_interval: str = "10SEC"
    output_interval: str = "1HOUR"
    instantaneous_interval: str = "1HOUR"
    mapping_interval: str = "1HOUR"
    plan_template_path: str | None = None
    start_time: Any = None
    end_time: Any = None
    flow_file_path: str | None = None
    plan_file_path: str | None = None
    precip_dss_start_path: str = ""
    _ras_model: RasModel | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        required = ("ras_prj_path", "template_flow_path")
        missing = [k for k in required if not getattr(self, k)]
        if missing:
            raise ValueError(f"Settings missing required fields: {missing}")

    @property
    def ras_model(self) -> RasModel:
        if self._ras_model is None:
            self._ras_model = RasModel(self.ras_prj_path)
        return self._ras_model

    @property
    def model_root(self) -> Path:
        return Path(self.ras_prj_path).parent

    @property
    def flow_dss_path_relative(self) -> str:
        return f"./{self.dss_dir}/{self.flow_bc_dir}/{self.flow_title}.dss"

    @property
    def flow_dss_path_absolute(self) -> str:
        return str(self.model_root / self.dss_dir / self.flow_bc_dir /
                   f"{self.flow_title}.dss")

    @property
    def precip_dss_path_relative(self) -> str:
        return f"./{self.dss_dir}/{self.precip_bc_dir}/{self.flow_title}.dss"

    @property
    def precip_dss_path_absolute(self) -> str:
        return str(self.model_root / self.dss_dir / self.precip_bc_dir /
                   f"{self.flow_title}.dss")


def clean_ffrd_bc(idx: str) -> str:
    """RAS BC-line id -> SST.dss element id: strip the 'bc_' prefix and '_base'
    suffix (reference make_ras_runs.py:164-171)."""
    idx = idx.strip()
    if idx.startswith("bc_"):
        idx = idx[3:]
    if idx.endswith("_base"):
        idx = idx[:-5]
    return idx


def copy_file_s3_or_local(from_path: str, to_path: str) -> None:
    Path(to_path).parent.mkdir(parents=True, exist_ok=True)
    if from_path.startswith("s3://"):
        from gpras_tpu_torch.utils import s3_utils

        s3_utils.download_file(s3_utils.get_client(), from_path, to_path)
    else:
        shutil.copy(from_path, to_path)


def load_hdf_data_s3_or_local(hdf_path: str, hdf_data_path: str) -> np.ndarray:
    import h5py

    if hdf_path.startswith("s3://"):
        import tempfile

        from gpras_tpu_torch.utils import s3_utils

        with tempfile.TemporaryDirectory() as tmp:
            local = os.path.join(tmp, "tmp.hdf")
            s3_utils.download_file(s3_utils.get_client(), hdf_path, local)
            with h5py.File(local, "r") as f:
                return f[hdf_data_path][:]
    with h5py.File(hdf_path, "r") as f:
        return f[hdf_data_path][:]


def add_boundary_conditions_to_unsteady_flow(flow: UnsteadyFlowFile,
                                             settings: Settings) -> UnsteadyFlowFile:
    """Rewire each flow-hydrograph BC to its event DSS record; derives the
    simulation window from the first record and patches the D (time window)
    path part, which USACE DSS files write inconsistently
    (reference make_ras_runs.py:174-224)."""
    from gpras_tpu_torch.data.dss import open_dss

    dss = open_dss(settings.flow_dss_path_absolute)
    catalog = list(dss.get_catalog())
    elements = [c.B for c in catalog]
    time_bounds = ""
    first = True
    # never inherit another event's simulation window: a catalog with no
    # matching BC records must fail loudly, not reuse stale times
    settings.start_time = None
    settings.end_time = None
    for bc in flow.boundary_conditions.bcs:
        if bc.bc_line_id.strip() != "":
            ele_id = clean_ffrd_bc(bc.bc_line_id)
            param = "FLOW-BASE"
        elif bc.sa_2d_id.strip() != "":
            ele_id = clean_ffrd_bc(bc.sa_2d_id)
            param = "FLOW"
        else:
            continue
        if ele_id not in elements or not isinstance(bc, FlowHydrographBC):
            continue
        matches = [c for c in catalog if c.B == ele_id and c.C == param]
        if not matches:
            raise RuntimeError(
                f"SST DSS has records for element {ele_id!r} but none with "
                f"C part {param!r} (catalog C parts: "
                f"{sorted({c.C for c in catalog if c.B == ele_id})})")
        path = matches[0]
        if first:
            record = dss.get(str(path))
            times = record.times
            settings.start_time = min(times)
            settings.end_time = max(times)
            if settings.start_time is None or settings.end_time is None:
                raise RuntimeError(
                    "Unable to determine start/end times from SST dss records.")
            # HEC-DSS convention: uppercase date stamps
            time_bounds = (f"{settings.start_time.strftime('%d%b%Y')}-"
                           f"{settings.end_time.strftime('%d%b%Y')}").upper()
            first = False
        parts = str(path).split("/")
        parts[4] = time_bounds
        bc.dss_file = settings.flow_dss_path_relative
        bc.dss_path = "/".join(parts)
        bc.flow_hydrograph_slope = "0.001 "
    if settings.start_time is None:
        raise RuntimeError(
            "No flow-hydrograph BC in the template matched any record in "
            f"{settings.flow_dss_path_absolute}; cannot derive the event's "
            "simulation window")
    if hasattr(dss, "close"):
        dss.close()
    return flow


def add_precipitation_to_unsteady_flow(flow: UnsteadyFlowFile,
                                       settings: Settings) -> UnsteadyFlowFile:
    """Point the gridded-precip met block at the generated DSS
    (reference make_ras_runs.py:227-236)."""
    flow.precipitation.set("Gridded DSS Filename", settings.precip_dss_path_relative)
    flow.precipitation.set("Gridded DSS Pathname", settings.precip_dss_start_path)
    flow.precipitation.set("Mode", "Gridded")
    flow.precipitation.set("Expanded View", "1")
    flow.precipitation.set("Constant Units", "mm/hr")
    flow.precipitation.set("Point Interpolation", "Nearest")
    flow.precip_mode = "Enable"
    return flow


def hdf_2_dss(settings: Settings) -> None:
    """Excess-precip HDF grid -> DSS grid records: clone a template DSS, clear
    its catalog, write the **last 72 hours** of the event with each grid
    flipped north-up (reference make_ras_runs.py:239-282)."""
    from gpras_tpu_torch.data.dss import open_dss

    data = load_hdf_data_s3_or_local(settings.precip_hdf_path,
                                     settings.hdf_data_path)
    if settings.start_time is None or settings.end_time is None:
        raise ValueError("start_time/end_time must be set before hdf_2_dss "
                         "(run add_boundary_conditions first)")
    interval = timedelta(hours=1)
    t_i = settings.start_time
    t_j = t_i + interval
    settings.precip_dss_start_path = settings.precip_dss_data_path.format(
        t_i.strftime("%d%b%Y:%H%M"), t_j.strftime("%d%b%Y:%H%M"))
    if os.path.exists(settings.precip_dss_path_absolute):
        os.remove(settings.precip_dss_path_absolute)
    Path(settings.precip_dss_path_absolute).parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(settings.precip_dss_template_path, settings.precip_dss_path_absolute)
    dss = open_dss(settings.precip_dss_path_absolute)
    catalog = list(dss.get_catalog())
    template = dss.get(str(catalog[0]))
    shape = (template.numberOfCellsY, template.numberOfCellsX)
    if hasattr(dss, "delete"):
        for c in catalog:
            dss.delete(str(c))
    # Reference convention (make_ras_runs.py:274): the LAST 72 hourly grids,
    # stamped from the simulation start — callers size the window to 72 h
    # (the SST event length); shorter records use everything they have.
    n_rows = min(72, data.shape[0])
    for i in np.arange(start=-n_rows, stop=0):
        template.data = np.flipud(np.reshape(data[i, :], shape))
        dss.put(template, settings.precip_dss_data_path.format(
            t_i.strftime("%d%b%Y:%H%M"), t_j.strftime("%d%b%Y:%H%M")))
        t_i += interval
        t_j += interval
    if hasattr(dss, "close"):
        dss.close()


def make_unsteady_flow_file(settings: Settings) -> UnsteadyFlowFile:
    """Template flow file -> event flow file (reference make_ras_runs.py:133-153)."""
    flow = UnsteadyFlowFile.from_file(settings.template_flow_path)
    flow.flow_title = settings.flow_title
    flow.file_description = ""
    if os.path.exists(settings.flow_dss_path_absolute):
        os.remove(settings.flow_dss_path_absolute)
    copy_file_s3_or_local(settings.flow_dss_path_src,
                          settings.flow_dss_path_absolute)
    flow = add_boundary_conditions_to_unsteady_flow(flow, settings)
    if settings.precip_hdf_path:
        hdf_2_dss(settings)
        flow = add_precipitation_to_unsteady_flow(flow, settings)
    return flow


def make_plan_file(settings: Settings) -> PlanFile:
    """Plan file with simulation dates bound to the event window
    (reference make_ras_runs.py:299-317)."""
    if settings.start_time is None or settings.end_time is None:
        raise ValueError("start_time/end_time must be set before make_plan_file")
    if settings.flow_file_path is None:
        raise ValueError("Flow file must be generated before make_plan_file")
    plan = PlanFile(template_path=settings.plan_template_path)
    plan.settings["Plan Title"] = settings.plan_title
    plan.settings["Short Identifier"] = settings.plan_short_id
    plan.settings["Simulation Date"] = (
        f"{settings.start_time.strftime('%d%b%Y,%H%M')},"
        f"{settings.end_time.strftime('%d%b%Y,%H%M')}").upper()
    plan.settings["Geom File"] = settings.geom_file_suffix
    plan.settings["Flow File"] = settings.flow_file_path.split(".")[-1]
    plan.settings["Computation Interval"] = settings.computation_interval
    plan.settings["Output Interval"] = settings.output_interval
    plan.settings["Instantaneous Interval"] = settings.instantaneous_interval
    plan.settings["Mapping Interval"] = settings.mapping_interval
    return plan


def add_run(settings: Settings) -> None:
    """Create and register flow + plan files (reference make_ras_runs.py:125-130)."""
    flow = make_unsteady_flow_file(settings)
    settings.flow_file_path = settings.ras_model.add_text_file(flow)
    plan = make_plan_file(settings)
    settings.plan_file_path = settings.ras_model.add_text_file(plan)


def make_runs_from_selected_events(settings_path: str,
                                   create_runs: bool = True) -> list[dict]:
    """For every event in the selection STAC, build a run and append it to the
    ``event_plans.json`` manifest (reference make_ras_runs.py:320-362)."""
    with open(settings_path) as f:
        base = json.load(f)
    with open(base.pop("events_stac_path")) as f:
        events_stac = json.load(f)
    out_path = base.pop("output_path")
    stac_out = base.pop("model_stac_output_path", None)
    base.update({"flow_dss_path_src": "", "precip_hdf_path": "",
                 "flow_title": "", "plan_title": "", "plan_short_id": ""})
    settings = Settings(**base)
    manifest = []
    for ind, key in enumerate(events_stac["assets"], start=1):
        asset = events_stac["assets"][key]
        settings.flow_dss_path_src = asset["href"]
        settings.precip_hdf_path = asset.get(
            "precip_hdf_href",
            asset["href"].replace("SST.dss", "exported-precip.p01.tmp.hdf"))
        settings.flow_title = f"gpr{ind}"
        settings.plan_title = f"gpr{ind}"
        settings.plan_short_id = f"gpr{ind}"
        if create_runs:
            add_run(settings)
        manifest.append({
            "plan_title": settings.plan_title,
            "event_number": asset["event_id"],
            "type": asset["roles"][0],
            "set": asset["properties"]["Set"],
        })
    with open(out_path, "w") as f:
        json.dump(manifest, f, indent=4)
    if stac_out:
        settings.ras_model.to_stac(stac_out)
    return manifest


def make_stac(prj_path: str, out_path: str) -> None:
    """One-shot project -> STAC item (the capability of
    production/pre_processing/make_ras_stac.py:6-13)."""
    RasModel(prj_path).to_stac(out_path)
