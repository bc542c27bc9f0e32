"""The port's data builders and parquet DB against the JAX package's.

Each builder of ``gpras_tpu_torch/data/builders.py`` runs beside its
``gpras_tpu`` counterpart on the synthetic HEC-RAS projects of
tests/test_builders_pipeline.py and tests/test_hms_pseudo.py (h5py-built,
FakeDss for the HMS forcing), and is held to it exactly: the aligned
frames, the cutoffs, the resamplers, the cell table and the reference-line
frame are host numpy code copied, so they are equal. The pseudo-surface
builder loads fluvial artifacts the JAX package wrote and predicts with the
port's GPRAS (float64, CPU). A DB exported by either package is read by the
other's ``RasReader``.
"""

import json
from datetime import datetime, timedelta

import numpy as np
import pandas as pd
import pytest
import torch_parity  # noqa: F401  (one torch thread)

import fixtures as fx
from gpras_tpu.data import builders as jb
from gpras_tpu.data import dss as jdss
from gpras_tpu.data.geometry import Polygon as JPolygon
from gpras_tpu.data.ras_model import RasModel as JRasModel
from gpras_tpu.data.reader import RasReader as JReader
from gpras_tpu_torch.data import builders as tb
from gpras_tpu_torch.data import dss as tdss
from gpras_tpu_torch.data.geometry import Polygon as TPolygon
from gpras_tpu_torch.data.ras_model import RasModel as TRasModel
from gpras_tpu_torch.data.reader import RasReader as TReader

PLANS = ["e1", "e2", "e3", "e4"]
HMS_PLANS = ["e1", "e2", "e3"]
T_STEPS = 40
#: the pseudo-surface builder's LF field holds the port's GPRAS prediction
#: (float64, CPU) where it tops the rating-curve surface; the JAX package's
#: prediction of the same checkpoint agrees to ~1e-13 relative
PSEUDO_RTOL = 1e-9


@pytest.fixture(scope="module")
def ras(tmp_path_factory):
    root = tmp_path_factory.mktemp("ras")
    hf = fx.make_project(root / "hf", "hfm", nx=8, ny=8, cell=1.0, plans=PLANS, seed=0)
    lf = fx.make_project(root / "lf", "lfm", nx=4, ny=4, cell=2.0, plans=PLANS, seed=0,
                         elevation_fn=lambda c: 1.0 + 0.1 * c[:, 0])
    fx.write_aoi(root / "aoi.geojson", 0.2, 0.2, 7.8, 7.8)
    return {"hf": hf, "lf": lf, "aoi": root / "aoi.geojson"}


def _ras_pair(ras, name, **kwargs):
    """The same builder class of both packages on the same project."""
    out = []
    for mod, model, poly in ((jb, JRasModel, JPolygon), (tb, TRasModel, TPolygon)):
        out.append(getattr(mod, name)(
            hf_ras=model.from_stac(ras["hf"]["stac"]), lf_ras=model.from_stac(ras["lf"]["stac"]),
            mesh_id=fx.MESH_ID, plans=PLANS, area_of_interest=poly.from_geojson_file(ras["aoi"]),
            **kwargs))
    return out


def _same_builders(j, t):
    for a, b in zip(j.aligned_datasets, t.aligned_datasets):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    assert j.cutoffs == t.cutoffs
    np.testing.assert_array_equal(j.hf_resampler, t.hf_resampler)
    pd.testing.assert_frame_equal(j.cell_info_df, t.cell_info_df, check_exact=True)
    pd.testing.assert_frame_equal(j.aligned_ref_line_df, t.aligned_ref_line_df, check_exact=True)
    for name in ("cell_elevations", "cell_areas", "hf_cell_ids_aoi", "hf_centroids_aoi"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))


@pytest.mark.parametrize("hydraulic_parameter", ["wse", "velocity"])
def test_ras_upskill_builder_matches(ras, hydraulic_parameter):
    j, t = _ras_pair(ras, "RasUpskillDataBuilder", hydraulic_parameter=hydraulic_parameter)
    _same_builders(j, t)
    np.testing.assert_array_equal(j.lf_resampler, t.lf_resampler)
    pd.testing.assert_frame_equal(j.lf_geometry_aoi, t.lf_geometry_aoi, check_exact=True)
    a, b = j.hf_geometry_aoi, t.hf_geometry_aoi
    pd.testing.assert_frame_equal(a.drop(columns="geometry"), b.drop(columns="geometry"))
    for ra, rb in zip(a["geometry"], b["geometry"]):
        np.testing.assert_array_equal(ra, rb)


def test_ras_upskill_builder_keeps_given_resamplers(ras):
    """A saved pairing is replayed, not recomputed, in both packages."""
    hf_ids = np.arange(64)
    lf_ids = (np.arange(64) % 16)[::-1].copy()
    j, t = _ras_pair(ras, "RasUpskillDataBuilder", hf_resampler=hf_ids, lf_resampler=lf_ids,
                     cutoffs={p: (3, 30) for p in PLANS})
    _same_builders(j, t)
    np.testing.assert_array_equal(t.lf_resampler, lf_ids)
    assert t.cutoffs == {p: (3, 30) for p in PLANS}


def test_ras_interpolater_builder_matches(ras):
    j, t = _ras_pair(ras, "RasInterpolaterBuilder")
    for a, b in zip(j._barycentric, t._barycentric):
        np.testing.assert_array_equal(a, b)
    pd.testing.assert_frame_equal(j.get_lf_plan_data("e2"), t.get_lf_plan_data("e2"),
                                  check_exact=True)
    _same_builders(j, t)


@pytest.mark.parametrize("center", [0.3, 0.5, 0.8])
def test_cutoff_rule_matches(center):
    t_ = np.linspace(0, 1, 100)
    pulse = np.exp(-((t_ - center) ** 2) / 0.01)[:, None] * np.ones((1, 3))
    pulse[85:, 1] = np.nan
    got = []
    for mod in (jb, tb):
        b = mod.DataBuilder.__new__(mod.DataBuilder)
        b.flow_convergence_threshold = 0.95
        got.append(b.get_cutoff(pulse))
    assert got[0] == got[1]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_db_written_by_either_package_is_read_by_the_other(ras, tmp_path, writer):
    j, t = _ras_pair(ras, "RasUpskillDataBuilder")
    (j if writer == "jax" else t).export_db(str(tmp_path / "train.db"))
    readers = [cls(str(tmp_path / "train.db")) for cls in (JReader, TReader)]
    assert JReader.is_valid(tmp_path / "train.db") and TReader.is_valid(tmp_path / "train.db")
    for a, b in zip(readers[0].aligned_datasets, readers[1].aligned_datasets):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    for a, b in zip(readers[1].aligned_datasets, t.aligned_datasets):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    for name in ("hf_resampler", "lf_resampler", "cell_elevations", "cell_areas"):
        np.testing.assert_array_equal(getattr(readers[0], name), getattr(readers[1], name))
    pd.testing.assert_frame_equal(readers[0].hf_geometry_aoi, readers[1].hf_geometry_aoi)
    pd.testing.assert_frame_equal(readers[0].ref_lines, readers[1].ref_lines)
    assert not TReader.is_valid(tmp_path / "nope")
    (tmp_path / "stray").write_text("not a DB")
    assert not TReader.is_valid(tmp_path / "stray")


# --------------------------------------------------------------- HMS builders

def _register_hms_dss(root):
    """Per-plan inflow + precip-grid DSS contents (tests/test_hms_pseudo.py's),
    registered with both packages' FakeDss."""
    times = [datetime(2020, 1, 1) + timedelta(hours=h) for h in range(T_STEPS)]
    stores = {}
    for i, plan in enumerate(HMS_PLANS):
        q = fx.hydrograph(T_STEPS, peak=100.0 * (1 + i))
        stores[str(root / "inflow_dss" / f"{plan}.dss")] = {
            "/TRIN/west-fork_s340/FLOW/01JAN2020/1HOUR/RUN:X/": dict(values=q, times=times),
            "/TRIN/west-fork_s340/FLOW-BASE/01JAN2020/1HOUR/RUN:X/":
                dict(values=0.2 * q, times=times),
            "/TRIN/outlet_hms/FLOW/01JAN2020/1HOUR/RUN:X/": dict(values=0.9 * q, times=times),
        }
        rng = np.random.default_rng(10 + i)
        stores[str(root / "precip_dss" / f"{plan}.dss")] = {
            f"/SHG/PRECIP/EXCESS/{times[h].strftime('%d%b%Y:%H%M').upper()}/X/GPR/": dict(
                data=np.abs(rng.normal(0.5, 0.2, size=(8, 8))).astype(np.float32),
                cellSize=1.0, numberOfCellsX=8, numberOfCellsY=8, lowerLeftCellX=0,
                lowerLeftCellY=0, srsDefinition="LOCAL")
            for h in range(T_STEPS)}
    for mod in (jdss, tdss):
        for path, records in stores.items():
            mod.FakeDss.register(path, {k: mod.FakeRecord(**v) for k, v in records.items()})
        mod.set_dss_factory(mod.FakeDss)
    return str(root / "inflow_dss"), str(root / "precip_dss")


@pytest.fixture(scope="module")
def hms(tmp_path_factory):
    root = tmp_path_factory.mktemp("hms")
    hf = fx.make_project(root / "hf", "hfm", nx=6, ny=6, cell=1.0, plans=HMS_PLANS)
    inflow, precip = _register_hms_dss(root)
    fx.write_aoi(root / "aoi.geojson", 0.2, 0.2, 5.8, 5.8)
    yield {"root": root, "hf": hf, "inflow": inflow, "precip": precip,
           "aoi": root / "aoi.geojson"}
    for mod in (jdss, tdss):
        mod.set_dss_factory(None)


def _hms_kwargs(hms, elements):
    return dict(inflow_dss_dir=hms["inflow"], inflow_hms_elements=elements,
                precip_dss_dir=hms["precip"], precip_spatial_mode_count=3,
                mesh_id=fx.MESH_ID, plans=HMS_PLANS)


def _hms_pair(hms, elements):
    return [mod.HmsUpskillDataBuilder(hf_ras=model.from_stac(hms["hf"]["stac"]),
                                      area_of_interest=poly.from_geojson_file(hms["aoi"]),
                                      **_hms_kwargs(hms, elements))
            for mod, model, poly in ((jb, JRasModel, JPolygon), (tb, TRasModel, TPolygon))]


@pytest.mark.parametrize("elements", [[["west-fork_s340", "FLOW"]],
                                      [["west-fork_s340", "FLOW"], ["west-fork_s340", "FLOW-BASE"]]])
def test_hms_upskill_builder_matches(hms, elements):
    j, t = _hms_pair(hms, elements)
    np.testing.assert_array_equal(j._aoi_precip_mask, t._aoi_precip_mask)
    pd.testing.assert_frame_equal(j.get_lf_plan_data("e2"), t.get_lf_plan_data("e2"),
                                  check_exact=True)
    _same_builders(j, t)


def test_pseudo_surface_builder_loads_jax_artifacts(hms, tmp_path):
    """Fluvial HMS-upskill artifacts written by the JAX package (SGPR,
    float64) drive both packages' pseudo-surface builders; the port's nested
    estimate runs on its GPRAS on the CPU."""
    import jax.numpy as jnp

    from gpras_tpu.eof.preprocessor import HmsPreProcessor, PreProcessor
    from gpras_tpu.gp.model import GPRAS

    elements = [["west-fork_s340", "FLOW"]]
    hb = _hms_pair(hms, elements)[0]
    hf_df, lf_df = hb.aligned_datasets
    hf_pre = PreProcessor(wet_threshold=0.05, hydraulic_parameter="wse")
    hf_pre.fit(hf_df.values, hb.cell_elevations, hb.cell_areas, 2)
    mask = np.array([str(c).startswith("precip_") for c in lf_df.columns])
    lf_pre = HmsPreProcessor()
    lf_pre.fit(lf_df.values, ~mask, mask, 2)
    gpr = GPRAS("RBF", dtype=jnp.float64)
    gpr.fit(lf_pre.transform(lf_df.values), hf_pre.transform(hf_df.values), n_inducing=8,
            optimization_method="adam", max_iter=20)
    hf_pre.to_file(tmp_path / "hf_pre.npz")
    lf_pre.to_file(tmp_path / "lf_pre.npz")
    gpr.to_file(tmp_path / "gpr.npz")
    centerline = tmp_path / "centerline.geojson"
    centerline.write_text(json.dumps({"type": "Feature", "geometry": {
        "type": "LineString", "coordinates": [[0.1, 3.0], [5.9, 3.0]]}}))
    common = dict(**_hms_kwargs(hms, elements),
                  fluvial_lf_preprocessor_path=str(tmp_path / "lf_pre.npz"),
                  fluvial_hf_preprocessor_path=str(tmp_path / "hf_pre.npz"),
                  fluvial_gpr_path=str(tmp_path / "gpr.npz"), us_bc_id_ras="inflow",
                  ds_bc_id_ras="outflow", us_bc_id_hms="west-fork_s340",
                  ds_bc_id_hms="outlet_hms", centerline_path=str(centerline))
    j = jb.PseudoSurfaceDataBuilder(hf_ras=JRasModel.from_stac(hms["hf"]["stac"]),
                                    area_of_interest=JPolygon.from_geojson_file(hms["aoi"]),
                                    **common)
    t = tb.PseudoSurfaceDataBuilder(hf_ras=TRasModel.from_stac(hms["hf"]["stac"]),
                                    area_of_interest=TPolygon.from_geojson_file(hms["aoi"]),
                                    device="cpu", **common)
    assert str(t.fluvial_gpr.device) == "cpu"
    np.testing.assert_array_equal(j.centerline_cell_ids, t.centerline_cell_ids)
    np.testing.assert_array_equal(j.cl_interpolater, t.cl_interpolater)
    np.testing.assert_array_equal(j.cell_interpolater, t.cell_interpolater)
    np.testing.assert_array_equal(j.cell_stations, t.cell_stations)
    assert j.us_rating_curve.fit_stats == t.us_rating_curve.fit_stats
    est_j, est_t = j.get_lf_fluvial_est("e1"), t.get_lf_fluvial_est("e1")
    np.testing.assert_allclose(est_t, est_j, rtol=PSEUDO_RTOL, atol=0)
    for plan in ("e1", "e3"):
        a, b = j.get_lf_plan_data(plan), t.get_lf_plan_data(plan)
        pd.testing.assert_index_equal(a.index, b.index)
        pd.testing.assert_index_equal(a.columns, b.columns)
        np.testing.assert_allclose(b.values, a.values, rtol=PSEUDO_RTOL, atol=0)
