"""The port's run-generation tooling against the JAX package's, on the same inputs.

``gpras_tpu_torch`` keeps its own copies of ``data/flow_file``,
``data/plan_template``, ``data/plan_file``, ``RasModel``'s run-creation
methods, ``utils/s3_utils``, ``utils/spatial_utils``,
``pipeline/sst_events`` and ``pipeline/run_maker``. They are host code, so
each test builds the same inputs in both packages and holds the port to the
reference exactly: text files byte for byte, HDF contents and DSS records
array for array, frames and manifests equal. The JAX tests' own cases
(tests/test_data_layer.py, tests/test_tooling.py) are run through both.
"""

import json
import shutil
from datetime import datetime, timedelta
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch_parity  # noqa: F401  (one torch thread)

import fixtures as fx
from gpras_tpu.data import dss as jdss
from gpras_tpu.data import flow_file as jff
from gpras_tpu.data import plan_file as jpf
from gpras_tpu.data import plan_template as jpt
from gpras_tpu.data import ras_model as jrm
from gpras_tpu.pipeline import run_maker as jrun
from gpras_tpu.pipeline import sst_events as jsst
from gpras_tpu.utils import s3_utils as js3
from gpras_tpu.utils import spatial_utils as jsp
from gpras_tpu_torch.data import dss as tdss
from gpras_tpu_torch.data import flow_file as tff
from gpras_tpu_torch.data import plan_file as tpf
from gpras_tpu_torch.data import plan_template as tpt
from gpras_tpu_torch.data import ras_model as trm
from gpras_tpu_torch.pipeline import run_maker as trun
from gpras_tpu_torch.pipeline import sst_events as tsst
from gpras_tpu_torch.utils import s3_utils as ts3
from gpras_tpu_torch.utils import spatial_utils as tsp

CEDAR_U01 = Path(__file__).parent / "data" / "cedar_basin.u01"
#: (JAX package, port) module pairs, by role
PKGS = {"jax": dict(ff=jff, pf=jpf, rm=jrm, run=jrun, dss=jdss, sst=jsst, s3=js3),
        "torch": dict(ff=tff, pf=tpf, rm=trm, run=trun, dss=tdss, sst=tsst, s3=ts3)}


@pytest.fixture
def fake_dss():
    """Each package's FakeDss injected, its stores emptied before and after."""
    for m in (jdss, tdss):
        m.FakeDss.stores = {}
        m.set_dss_factory(m.FakeDss)
    yield
    for m in (jdss, tdss):
        m.set_dss_factory(None)
        m.FakeDss.stores = {}


# ------------------------------------------------------------------ flow files

def _synthetic(ff):
    """tests/test_data_layer.py:27's file."""
    f = ff.UnsteadyFlowFile("test storm", file_description="a synthetic event")
    f.initial_conditions.consume("IC Point Elev=ic_a                      ,840.7")
    f.boundary_conditions.bcs.append(ff.NormalDepthBC(
        "0.004", "0", sa_2d_id=" " * 16, mesh_name="mesh1".ljust(16),
        bc_line_id="bc_out".ljust(32)))
    f.boundary_conditions.bcs.append(ff.FlowHydrographBC(
        interval="1HOUR", dss_file="flows.dss", dss_path="//A/FLOW//1HOUR/RUN:X/",
        sa_2d_id=" " * 16, mesh_name="mesh1".ljust(16), bc_line_id="bc_in".ljust(32)))
    return f


def _met_and_ic_names(ff):
    """tests/test_data_layer.py:264's file."""
    f = ff.UnsteadyFlowFile("test")
    f.precipitation = ff.precipitation(mode="Gridded", dss_filename="rain.dss",
                                       dss_pathname="/A/B/PRECIP///1HOUR/RUN/")
    f.initial_conditions.ics.append(ff.InitialCondition("Perimeter 1", "840.7", "2D"))
    bc = ff.FlowHydrographBC(interval="1HOUR", dss_file="flows.dss",
                             dss_path="/X/Y/FLOW//1HOUR/RUN/", sa_2d_id="Perimeter 1",
                             mesh_name="mesh", bc_line_id="Inflow")
    bc.flow_hydrograph_slope = "0.0003"
    f.boundary_conditions.bcs.append(bc)
    return f


def _observed(ff):
    """tests/test_data_layer.py:368's file."""
    f = ff.UnsteadyFlowFile("obs_test")
    f.initial_conditions = ff.InitialConditions([ff.InitialCondition("wet area", "0.5", "2D")])
    f.boundary_conditions.bcs.append(ff.FlowHydrographBC(
        interval="1HOUR", dss_file="ev.dss", dss_path="/A/B/FLOW//1HOUR/RUN/",
        sa_2d_id="wet area", mesh_name="", bc_line_id="inflow"))
    f.observed_time_series.append("Observed Time Series=Gage 1\nObserved DSS File=obs.dss\n"
                                  "Observed DSS Path=/BASIN/GAGE1/STAGE//15MIN/OBS/\n"
                                  "     100.5     101.2     102.9")
    return f


def _fuzzed(ff, seed: int):
    """One file of tests/test_data_layer.py:435's generator, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    safe = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 -_./=")

    def rand_text(lo=1, hi=18, extra=""):
        n = int(rng.integers(lo, hi))
        return "".join(rng.choice(safe + list(extra)) for _ in range(n)).strip() or "x"

    f = ff.UnsteadyFlowFile(
        flow_title=rand_text(1, 30),
        program_version=rng.choice(["6.6", "6.3.1", rand_text(3, 6)]),
        file_description="\n".join("desc " + rand_text() for _ in range(int(rng.integers(0, 3)))))
    f.initial_conditions.use_restart = str(rng.choice(["0", "1"]))
    for _ in range(int(rng.integers(0, 5))):
        f.initial_conditions.ics.append(ff.InitialCondition(
            rand_text(extra=","), f"{rng.uniform(500, 900):.2f}",
            str(rng.choice(["2D", "IC Point"]))))
    for _ in range(int(rng.integers(0, 4))):
        header = dict(sa_2d_id=rand_text(1, 14), mesh_name=rand_text(1, 14),
                      bc_line_id=rand_text(1, 30))
        if rng.random() < 0.5:
            f.boundary_conditions.bcs.append(
                ff.NormalDepthBC(f"{rng.uniform(1e-4, 0.01):.4f}", "0", **header))
        else:
            bc = ff.FlowHydrographBC(
                interval=str(rng.choice(["1HOUR", "15MIN", "1DAY"])),
                dss_file=rand_text(4, 20) + ".dss",
                dss_path=f"//{rand_text(2, 8)}/FLOW//1HOUR/RUN:{rand_text(2, 8)}/", **header)
            if rng.random() < 0.5:
                bc.flow_hydrograph = f" {int(rng.integers(0, 9))} "
            f.boundary_conditions.bcs.append(bc)
    f.precip_mode = str(rng.choice(["Disable", "Enable", "Gridded"]))
    f.wind.mode = str(rng.choice(["No Wind Forces", "Speed/Direction"]))
    if rng.random() < 0.5:
        f.precipitation.set("Mode", "Gridded")
        f.precipitation.set("Gridded DSS Filename", rand_text(4, 20) + ".dss")
        f.precipitation.set("Gridded DSS Pathname", f"//{rand_text(2, 8)}/PRECIP////")
    for _ in range(int(rng.integers(0, 3))):
        f.observed_time_series.append(f"Observed Time Series={rand_text()}\n"
                                      f"  gage {rand_text()}\n  value {rng.uniform(0, 10):.3f}")
    return f


FLOW_CASES = {"synthetic": _synthetic, "met_and_ic_names": _met_and_ic_names,
              "observed": _observed, "empty": lambda ff: ff.UnsteadyFlowFile("t"),
              **{f"fuzz{s}": (lambda ff, s=s: _fuzzed(ff, 20260818 + s)) for s in range(12)}}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_flow_file_emit_parse_and_crlf_file_match(case, tmp_path):
    """Each package builds the same file; the emitted text, its re-parse's
    emission and the CRLF/ASCII file on disk are equal byte for byte, and
    each package parses the other's file to the same text."""
    j, t = (FLOW_CASES[case](ff) for ff in (jff, tff))
    assert t.emit() == j.emit()
    assert tff.UnsteadyFlowFile.from_string(t.emit()).emit() == \
        jff.UnsteadyFlowFile.from_string(j.emit()).emit() == j.emit()
    j.to_file(str(tmp_path / "j.u01"))
    t.to_file(str(tmp_path / "t.u01"))
    raw = (tmp_path / "t.u01").read_bytes()
    assert raw == (tmp_path / "j.u01").read_bytes()
    raw.decode("ascii")
    assert all(ln.endswith(b"\r") for ln in raw.split(b"\n") if ln)
    assert tff.UnsteadyFlowFile.from_file(str(tmp_path / "j.u01")).emit() == j.emit()
    assert t.lines == j.lines


def test_flow_file_golden_cedar_basin_matches():
    """The committed HEC-RAS 6.x fixture parses to the same structure in both
    packages, and the port's emission is the committed bytes."""
    raw = CEDAR_U01.read_bytes()
    j, t = (ff.UnsteadyFlowFile.from_file(str(CEDAR_U01)) for ff in (jff, tff))
    assert t.emit().replace("\n", "\r\n").encode("ascii") == raw
    assert t.emit() == j.emit()
    assert (t.flow_title, t.program_version, t.precip_mode) == \
        (j.flow_title, j.program_version, j.precip_mode) == ("jun2003", "6.50", "Enable")
    for a, b in zip(j.boundary_conditions.bcs, t.boundary_conditions.bcs):
        assert type(a).__name__ == type(b).__name__ and vars(a) == vars(b)
    assert len(t.boundary_conditions.bcs) == 7
    assert [vars(ic) for ic in t.initial_conditions.ics] == \
        [vars(ic) for ic in j.initial_conditions.ics]
    assert t.observed_time_series == j.observed_time_series
    assert t.precipitation.attrs == j.precipitation.attrs


def test_flow_file_module_constants_match():
    assert tff.FLOW_OPTIONS_BLOCK == jff.FLOW_OPTIONS_BLOCK
    assert tff._HEADER_WIDTHS == jff._HEADER_WIDTHS
    for name in ("air_density", "air_pressure", "evapotranspiration"):
        assert getattr(tff, name)().attrs == getattr(jff, name)().attrs
    assert tff.Wind().emit() == jff.Wind().emit()
    with pytest.raises(ValueError):
        tff.InitialCondition("a", "1", "3D")
    with pytest.raises(RuntimeError):
        tff.parse_boundary_condition("Boundary Location=,,,,a,b,,c,\nInterval=1HOUR")


# --------------------------------------------------------- plan files, template

def test_plan_template_and_default_plan_match(tmp_path):
    assert tpt.PLAN_TEMPLATE_650 == jpt.PLAN_TEMPLATE_650
    assert tpt.default_plan_entries() == jpt.default_plan_entries()
    assert tpf.default_plan_settings() == jpf.default_plan_settings()
    j, t = jpf.PlanFile(), tpf.PlanFile()
    assert t.emit() == j.emit() and len(t.entries) == 217
    j.to_file(tmp_path / "j.p01")
    t.to_file(tmp_path / "t.p01")
    assert (tmp_path / "t.p01").read_bytes() == (tmp_path / "j.p01").read_bytes()


@pytest.mark.parametrize("overrides", [
    {"Plan Title": "event_42", "Simulation Date": "01JAN2020,0000,02JAN2020,0000"},
    {"Plan Title": "evt", "Computation Interval": "10SEC", "New Key": "a=b"},
])
def test_plan_file_overrides_round_trip_match(overrides, tmp_path):
    """Overrides, a file on disk (CRLF) and its re-read agree across the
    packages; each reads the other's file; a template path round-trips."""
    for name, pf in (("j", jpf), ("t", tpf)):
        pf.PlanFile(overrides).to_file(tmp_path / f"{name}.p02")
    raw = (tmp_path / "t.p02").read_bytes()
    assert raw == (tmp_path / "j.p02").read_bytes() and b"\r\n" in raw
    back = tpf.PlanFile.from_file(tmp_path / "j.p02")
    assert dict(back.settings) == dict(jpf.PlanFile.from_file(tmp_path / "t.p02").settings)
    for k, v in overrides.items():
        assert back.settings[k] == v
    del back.settings["Plan Title"]
    assert "Plan Title" not in back.settings
    tpl = tpf.PlanFile(template_path=tmp_path / "j.p02")
    assert tpl.emit() == jpf.PlanFile(template_path=tmp_path / "t.p02").emit()


def _hdf_contents(path) -> dict:
    """Every group's and dataset's attributes and every dataset's values."""
    out = {}

    def visit(name, obj):
        out[name] = {"attrs": {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}}
        if isinstance(obj, h5py.Dataset):
            out[name]["data"] = obj[()].tolist()
            out[name]["dtype"] = str(obj.dtype)
    with h5py.File(path, "r") as f:
        out["/"] = {"attrs": {k: np.asarray(v).tolist() for k, v in f.attrs.items()}}
        f.visititems(visit)
    return out


def test_update_hdf_attributes_and_data_match(tmp_path):
    for name, pf in (("j", jpf), ("t", tpf)):
        path = tmp_path / f"{name}.hdf"
        with h5py.File(path, "w") as f:
            g = f.create_group("Plan Data/Plan Information")
            g.attrs["Plan Name"] = np.bytes_(b"old")
            f.create_dataset("Event Conditions/Meteorology/Precipitation/Values",
                             data=np.zeros((3, 4)))
        pf.update_hdf_attributes(str(path), "Plan Data/Plan Information",
                                 {"Plan Name": "new", "Count": 3, "Scale": 0.5})
        pf.update_hdf_data(str(path), "Event Conditions/Meteorology/Precipitation/Values",
                           np.arange(10, dtype=np.float32).reshape(5, 2))
        pf.update_hdf_data(str(path), "Event Conditions/Unsteady/New", np.ones(3))
    got, want = _hdf_contents(tmp_path / "t.hdf"), _hdf_contents(tmp_path / "j.hdf")
    assert got == want
    assert got["Plan Data/Plan Information"]["attrs"]["Plan Name"] == b"new"


def test_plan_boundary_condition_paths_match():
    data = np.ones((2, 2))
    for cls in ("EventCondition", "FlowHydrographBC", "PrecipitationBC", "TemperatureBC"):
        kw = {"idx": "bc_1"} if cls == "FlowHydrographBC" else {}
        assert getattr(tpf, cls)(data, **kw).path == getattr(jpf, cls)(data, **kw).path


# ----------------------------------------------------------------- RasModel

@pytest.fixture
def two_projects(tmp_path):
    """One fixtures.make_project project with a plan text file beside its
    first plan HDF, copied twice: ``jax/`` and ``torch/``."""
    proj = fx.make_project(tmp_path / "src", "mm", nx=2, ny=2, cell=1.0, plans=["a", "b"])
    jpf.PlanFile({"Plan Title": "a"}).to_file(proj["root"] / "mm.p01")
    (proj["root"] / "mm.prj").write_text("Proj Title=synthetic\r\nCurrent Plan=p01\r\n"
                                         "Plan File=p01\r\nGeom File=g01\r\n",
                                         newline="")
    for name in PKGS:
        shutil.copytree(proj["root"], tmp_path / name)
    return {name: tmp_path / name for name in PKGS}


def _tree(root: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if p.is_file() and not p.name.endswith((".hdf", ".json"))}


def test_ras_model_run_creation_matches(two_projects):
    """increment_suffix, add_text_file (a flow file, then two plans) and
    make_new_plan (HDF attributes, a text attribute, two BC datasets) leave
    identical files and a .prj equal byte for byte (CRLF kept)."""
    made = {}
    for name, roots in two_projects.items():
        m = PKGS[name]
        model = m["rm"].RasModel(roots / "mm.prj")
        suffixes = (Path(model.increment_suffix(model.plan_files, "p")).name,
                    Path(model.increment_suffix(model.unsteady_flow_files, "u")).name)
        flow = m["ff"].UnsteadyFlowFile.from_file(str(CEDAR_U01))
        paths = [model.add_text_file(flow),
                 model.add_text_file(m["pf"].PlanFile({"Plan Title": "x"})),
                 model.add_text_file(m["pf"].PlanFile({"Plan Title": "y"}))]
        bcs = [m["pf"].PrecipitationBC(np.arange(12.0).reshape(3, 4)),
               m["pf"].FlowHydrographBC(np.linspace(0, 1, 6).reshape(3, 2), idx="bc_in")]
        hdf, txt = model.make_new_plan("mm.p01.hdf",
                                       {"hdf": {"Plan Name": "new", "Plan ShortID": "n"},
                                        "txt": {"Plan Title": "new", "Short Identifier": "n"}},
                                       bcs)
        with pytest.raises(TypeError):
            model.add_text_file(object())
        made[name] = (suffixes, [Path(p).name for p in paths + [hdf, txt]],
                      sorted(model.assets), _tree(roots), _hdf_contents(hdf))
    assert made["torch"] == made["jax"]
    suffixes, names, _, tree, hdf = made["torch"]
    assert suffixes == ("mm.p02", "mm.u01")
    assert names == ["mm.u01", "mm.p02", "mm.p03", "mm.p04.hdf", "mm.p04"]
    assert tree["mm.prj"].count(b"Plan File=") == 4 and b"\r\n" in tree["mm.prj"]
    assert hdf["Plan Data/Plan Information"]["attrs"]["Plan Name"] == b"new"


def test_prj_and_text_attribute_updates_match(tmp_path):
    """add_file_to_prj_file and update_text_attributes keep the file's
    encoding and newlines, in both packages alike (a latin-1 CRLF file, a
    UTF-8 LF file, a file without the key)."""
    texts = {"crlf.txt": ("Proj Title=caf\xe9\r\nPlan File=p01\r\nPlan Title=old=x\r\n"
                          "Unsteady File=u01\r\n", "latin-1"),
             "lf.txt": ("Proj Title=plain\nGeom File=g01\nShort Identifier=a\n", "utf-8")}
    for name, m in PKGS.items():
        for fname, (text, enc) in texts.items():
            path = tmp_path / f"{name}_{fname}"
            path.write_bytes(text.encode(enc))
            m["rm"].add_file_to_prj_file(str(path), "Plan File=p07")
            m["rm"].add_file_to_prj_file(str(path), "Unsteady File=u09")
            m["rm"].update_text_attributes(str(path), {"Plan Title": "new=1",
                                                       "Short Identifier": "b"})
    for fname in texts:
        assert (tmp_path / f"torch_{fname}").read_bytes() == \
            (tmp_path / f"jax_{fname}").read_bytes()
    assert b"Plan File=p01\r\nPlan File=p07\r\n" in (tmp_path / "torch_crlf.txt").read_bytes()


# ------------------------------------------------------------ s3 and spatial

def test_s3_and_spatial_utils_match():
    for uri in ("s3://bucket/a/b/c.dss", "s3://bucket", "s3://b/"):
        assert ts3.split_uri(uri) == js3.split_uri(uri)
    with pytest.raises(ValueError):
        ts3.split_uri("/local/path")
    assert ts3.HAS_BOTO3 == js3.HAS_BOTO3
    if not ts3.HAS_BOTO3:
        with pytest.raises(ImportError, match="boto3"):
            ts3.get_client()

    class Pages:  # list_objects_v2's paginator over two pages
        def get_paginator(self, _):
            return self

        def paginate(self, Bucket, Prefix):
            yield {"Contents": [{"Key": f"{Prefix}/1/SST.dss"}, {"Key": f"{Prefix}/x.txt"}]}
            yield {"Contents": [{"Key": f"{Prefix}/2/SST.dss"}]}
            yield {}

    args = (Pages(), "bkt", "events", r"SST\.dss$")
    assert ts3.list_keys_regex(*args) == js3.list_keys_regex(*args) == \
        ["events/1/SST.dss", "events/2/SST.dss"]
    attrs = {"Raster Left": "1.5", "Raster Top": 9, "Raster Cellsize": 2000.0,
             "Raster Rows": np.int32(4), "Raster Cols": "5"}
    assert tsp.ras_hdf_precip_grid(attrs) == jsp.ras_hdf_precip_grid(attrs) == \
        ((1.5, 9.0), 2000.0, (4, 5))


# ----------------------------------------------------------------- SST fetch

def _sst_records(event: int, element: str, steps: int = 24) -> dict:
    times = [datetime(2021, 3, 1) + timedelta(hours=h + 30 * event) for h in range(steps)]
    q = 50.0 * (1 + event) * np.exp(-((np.arange(steps) - 9.0) / 4.0) ** 2)
    return {f"/SST/{element}/FLOW/D/1HOUR/RUN:SST/": {"values": q, "times": times},
            f"/SST/{element}/PRECIP-CUM/D/1HOUR/RUN:SST/":
                {"values": np.cumsum(np.full(steps, 0.1 * (1 + event))), "times": times},
            f"/SST/{element}/PRECIP-EXCESS/D/1HOUR/RUN:SST/":
                {"values": q / 40.0, "times": times},
            f"/SST/other/FLOW/D/1HOUR/RUN:SST/": {"values": -q, "times": times}}


def _register(dss, path, records: dict) -> None:
    dss.FakeDss.register(str(path), {k: dss.FakeRecord(**v) for k, v in records.items()})


def test_extract_event_series_matches(fake_dss, tmp_path):
    for name, m in PKGS.items():
        _register(m["dss"], tmp_path / f"{name}.dss", _sst_records(2, "cedar_s120"))
        _register(m["dss"], tmp_path / f"{name}_flow_only.dss",
                  {k: v for k, v in _sst_records(3, "cedar_s120").items() if "/FLOW/" in k})
    for case in ("", "_flow_only"):
        j = jsst.extract_event_series(str(tmp_path / f"jax{case}.dss"), "cedar_s120")
        t = tsst.extract_event_series(str(tmp_path / f"torch{case}.dss"), "cedar_s120")
        pd.testing.assert_frame_equal(t, j)
        assert list(t.columns) == ["datetime", "inflow", "precip-cum", "precip-excess"]
    assert tsst.extract_event_series(str(tmp_path / "torch.dss"), "missing") is None


def test_get_sst_events_matches(fake_dss, tmp_path, monkeypatch):
    """get_sst_events with the S3 client and download monkeypatched in both
    packages to copy local stand-ins (each file names its event, whose
    records a path-free FakeDss serves): equal frames and parquet files, the
    failing event skipped in both."""
    events = [4, 1, 7, 2, 9]

    def download(client, uri, local):
        event = int(uri.split("/")[-3])
        if event == 9:
            raise OSError("no such key")
        Path(local).write_text(str(event))
        return str(local)

    for name, m in PKGS.items():
        class ByContent(m["dss"].FakeDss):
            def __init__(self, path):
                records = _sst_records(int(Path(path).read_text()), "cedar_s120")
                self.stores = {str(path): {k: m["dss"].FakeRecord(**v)
                                           for k, v in records.items()}}
                super().__init__(path)

        m["dss"].set_dss_factory(ByContent)
        monkeypatch.setattr(m["s3"], "get_client", lambda: object())
        monkeypatch.setattr(m["s3"], "download_file", download)
    j = jsst.get_sst_events(events, "s3://bucket/events", "cedar_s120", tmp_path / "j.pq",
                            max_workers=3)
    t = tsst.get_sst_events(events, "s3://bucket/events", "cedar_s120", tmp_path / "t.pq",
                            max_workers=3)
    # the frames' row order is fixed by the sort; their index by completion order
    pd.testing.assert_frame_equal(t.reset_index(drop=True), j.reset_index(drop=True))
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "t.pq").reset_index(drop=True),
                                  pd.read_parquet(tmp_path / "j.pq").reset_index(drop=True))
    assert sorted(set(t.event_id)) == [1, 2, 4, 7] and len(t) == 4 * 24
    with pytest.raises(RuntimeError, match="No events fetched"):
        tsst.get_sst_events([9], "s3://bucket/events", "cedar_s120", tmp_path / "x.pq")


# ----------------------------------------------------------------- run maker

def _template_flow(ff, path):
    """tests/test_tooling.py:68's template: one hydrograph BC, one normal depth."""
    tpl = ff.UnsteadyFlowFile("template")
    tpl.boundary_conditions.bcs.append(ff.FlowHydrographBC(
        interval="1HOUR", dss_file="x.dss", dss_path="//OLD/FLOW-BASE/OLD//",
        sa_2d_id=" " * 16, mesh_name="mesh1".ljust(16),
        bc_line_id="bc_west-fork_s340_base".ljust(32)))
    tpl.boundary_conditions.bcs.append(ff.NormalDepthBC(
        "0.004", "0", sa_2d_id=" " * 16, mesh_name="mesh1".ljust(16),
        bc_line_id="bc_out".ljust(32)))
    tpl.to_file(str(path))


def test_run_maker_add_run_matches(fake_dss, tmp_path):
    """tests/test_tooling.py:68 in both packages: the flow file (its BC
    rewired to the event's record, the D part its window), the plan file and
    the .prj are equal byte for byte."""
    out = {}
    for name, m in PKGS.items():
        root = tmp_path / name
        fx.make_project(root / "model", "mm", nx=2, ny=2, cell=1.0, plans=["base"])
        _template_flow(m["ff"], root / "template.u99")
        (root / "SST.dss").write_bytes(b"fake")
        times = [datetime(2020, 1, 1) + timedelta(hours=h) for h in range(100)]
        _register(m["dss"], root / "model" / "gpr_dss_files" / "flow_boundaries" / "ev1.dss",
                  {"/TRINITY/west-fork_s340/FLOW-BASE/WRONGDATES/1HOUR/RUN:X/":
                   {"values": np.linspace(0, 50, 100), "times": times}})
        settings = m["run"].Settings(
            ras_prj_path=str(root / "model" / "mm.prj"),
            template_flow_path=str(root / "template.u99"), flow_dss_path_src=str(root / "SST.dss"),
            precip_hdf_path="", flow_title="ev1", plan_title="ev1", plan_short_id="ev1")
        m["run"].add_run(settings)
        out[name] = (Path(settings.flow_file_path).name, Path(settings.plan_file_path).name,
                     settings.start_time, settings.end_time, _tree(root / "model"))
    assert out["torch"] == out["jax"]
    flow = tff.UnsteadyFlowFile.from_file(str(tmp_path / "torch" / "model" / "mm.u01"))
    assert "01JAN2020-05JAN2020" in flow.boundary_conditions.bcs[0].dss_path
    assert tpf.PlanFile.from_file(tmp_path / "torch" / "model" / "mm.p01").settings[
        "Flow File"] == "u01"


@pytest.mark.parametrize("case", ["no_matching_bc", "wrong_c_part"])
def test_run_maker_error_paths_match(case, fake_dss, tmp_path):
    """tests/test_tooling.py:310 and :343 in both packages: the same error,
    and the stale window cleared."""
    element = "bc_other_element" if case == "no_matching_bc" else "bc_west-fork_s340_base"
    key = ("/T/unrelated/FLOW-BASE/D/1HOUR/R/" if case == "no_matching_bc"
           else "/T/west-fork_s340/FLOW/D/1HOUR/R/")
    messages = []
    for name, m in PKGS.items():
        tpl = m["ff"].UnsteadyFlowFile("template")
        tpl.boundary_conditions.bcs.append(m["ff"].FlowHydrographBC(
            interval="1HOUR", dss_file="x.dss", dss_path="//OLD/FLOW-BASE///",
            sa_2d_id=" " * 16, mesh_name="m".ljust(16), bc_line_id=element.ljust(32)))
        times = [datetime(2020, 1, 1) + timedelta(hours=h) for h in range(5)]
        settings = m["run"].Settings(
            ras_prj_path=str(tmp_path / name / "x.prj"), template_flow_path="t",
            flow_dss_path_src=str(tmp_path / "src.dss"), precip_hdf_path="",
            flow_title="e", plan_title="e", plan_short_id="e")
        _register(m["dss"], settings.flow_dss_path_absolute,
                  {key: {"values": np.arange(5.0), "times": times}})
        settings.start_time, settings.end_time = datetime(1999, 1, 1), datetime(1999, 1, 4)
        with pytest.raises(RuntimeError) as err:
            m["run"].add_boundary_conditions_to_unsteady_flow(tpl, settings)
        assert settings.start_time is None
        messages.append(str(err.value).replace(str(tmp_path / name), ""))
    assert messages[0] == messages[1]
    assert ("No flow-hydrograph BC" if case == "no_matching_bc" else "west-fork_s340") \
        in messages[1]


def test_run_maker_helpers_match():
    for idx in (" bc_west-fork_s340_base ", "bc_x", "plain", "bc__base", "x_base"):
        assert trun.clean_ffrd_bc(idx) == jrun.clean_ffrd_bc(idx)
    s = {name: m["run"].Settings(ras_prj_path="/p/m.prj", template_flow_path="t.u01",
                                 flow_dss_path_src="", precip_hdf_path="", flow_title="gpr3",
                                 plan_title="", plan_short_id="")
         for name, m in PKGS.items()}
    for prop in ("model_root", "flow_dss_path_relative", "flow_dss_path_absolute",
                 "precip_dss_path_relative", "precip_dss_path_absolute"):
        assert getattr(s["torch"], prop) == getattr(s["jax"], prop)
    with pytest.raises(ValueError, match="template_flow_path"):
        trun.Settings(ras_prj_path="/p/m.prj", template_flow_path="", flow_dss_path_src="",
                      precip_hdf_path="", flow_title="", plan_title="", plan_short_id="")


PRECIP_GRID = (3, 4)  # rows, cols of the stand-in precip raster


def _events_stac(root: Path, events: list[int], steps: int, precip: bool) -> Path:
    """A selection STAC (write_events_stac's layout) over stand-in SST.dss
    files, each with a precip HDF beside it when ``precip``."""
    assets = {}
    for i, e in enumerate(events):
        sst = root / "events" / str(e) / "hydrology" / "SST.dss"
        sst.parent.mkdir(parents=True, exist_ok=True)
        sst.write_text(str(e))
        asset = {"href": str(sst), "type": "application/x.hec-dss",
                 "roles": ["Test" if i == len(events) - 1 else "Train"], "event_id": e,
                 "properties": {"Set": "Test" if i == len(events) - 1 else "AEP"}}
        if precip:
            hdf = sst.parent / "exported-precip.p01.tmp.hdf"
            grid = np.random.default_rng(e).random((steps + 6, PRECIP_GRID[0] * PRECIP_GRID[1]))
            with h5py.File(hdf, "w") as f:
                f.create_dataset("exported_data", data=grid.astype(np.float32))
            asset["precip_hdf_href"] = str(hdf)
        else:
            asset["precip_hdf_href"] = ""
        assets[str(e)] = asset
    path = root / "events.stac.json"
    path.write_text(json.dumps({"type": "Feature", "assets": assets}))
    return path


@pytest.mark.parametrize("precip", [True, False], ids=["precip", "no_precip"])
def test_make_runs_from_selected_events_matches(precip, fake_dss, tmp_path):
    """The whole run maker over a three-event selection on the cedar basin
    template, in both packages: the same manifest, flow and plan files, .prj,
    model STAC (but for its hrefs and date), and, with precipitation, the
    same 72 gridded DSS records per event (hdf_2_dss)."""
    events, steps = [31, 5, 12], 72
    made = {}
    for name, m in PKGS.items():
        root = tmp_path / name
        (root / "model").mkdir(parents=True)
        (root / "model" / "cb.prj").write_text("Proj Title=cedar\nGeom File=g01\n")
        shutil.copy(CEDAR_U01, root / "template.u01")
        (root / "precip_template.dss").write_bytes(b"grid")
        stac = _events_stac(root, events, steps, precip)
        for i, e in enumerate(events, start=1):
            times = [datetime(2019, 5, 1) + timedelta(hours=h + 100 * e) for h in range(steps)]
            q = np.linspace(0.0, 10.0 * e, steps)
            _register(m["dss"], root / "model" / "gpr_dss_files" / "flow_boundaries" /
                      f"gpr{i}.dss",
                      {f"/SST/{el}/FLOW-BASE/X/1HOUR/RUN:SST/": {"values": q, "times": times}
                       for el in ("cedar_s120", "cedar_s110", "salado_s220")})
            _register(m["dss"], root / "model" / "gpr_dss_files" / "precip_boundaries" /
                      f"gpr{i}.dss",
                      {"/SHG/PRECIP/EXCESS/01JAN2000:0000/01JAN2000:0100/TPL/":
                       {"numberOfCellsX": PRECIP_GRID[1], "numberOfCellsY": PRECIP_GRID[0],
                        "data": np.zeros(PRECIP_GRID)}})
        settings = root / "settings.json"
        settings.write_text(json.dumps({
            "events_stac_path": str(stac), "output_path": str(root / "event_plans.json"),
            "model_stac_output_path": str(root / "model.stac.json"),
            "ras_prj_path": str(root / "model" / "cb.prj"),
            "template_flow_path": str(root / "template.u01"),
            "precip_dss_template_path": str(root / "precip_template.dss")}))
        manifest = m["run"].make_runs_from_selected_events(str(settings))
        records = {}
        for path, recs in m["dss"].FakeDss.stores.items():
            if "precip_boundaries" in path:
                records[Path(path).name] = {k: r.data.tolist() for k, r in recs.items()}
        item = json.loads((root / "model.stac.json").read_text())
        item["properties"].pop("datetime")
        hrefs = sorted(Path(a.pop("href")).relative_to(root).as_posix()
                       for a in item["assets"].values())
        made[name] = (manifest, json.loads((root / "event_plans.json").read_text()),
                      _tree(root / "model"), records, item, hrefs)
    assert made["torch"] == made["jax"]
    manifest, _, tree, records, _, _ = made["torch"]
    assert [r["event_number"] for r in manifest] == events
    assert [r["plan_title"] for r in manifest] == ["gpr1", "gpr2", "gpr3"]
    assert sorted(tree) == ["cb.p01", "cb.p02", "cb.p03", "cb.prj", "cb.u01", "cb.u02", "cb.u03"]
    flow = tff.UnsteadyFlowFile.from_string(tree["cb.u02"].decode("ascii").replace("\r\n", "\n"))
    assert all("01JUN2003" not in bc.dss_path for bc in flow.boundary_conditions.bcs
               if isinstance(bc, tff.FlowHydrographBC) and bc.bc_line_id.strip().endswith("_base"))
    if precip:
        assert flow.precipitation.get("Gridded DSS Filename") == \
            "./gpr_dss_files/precip_boundaries/gpr2.dss"
        # the template record plus the event's last 72 grids, flipped north-up
        assert [len(r) for r in records.values()] == [steps + 1] * 3
    else:  # the template's own met block, and no grid written
        assert "Excess_Precipitation.dss" in flow.precipitation.get("Gridded DSS Filename")
        assert records == {f"gpr{i}.dss": {"/SHG/PRECIP/EXCESS/01JAN2000:0000/"
                                           "01JAN2000:0100/TPL/": np.zeros(PRECIP_GRID).tolist()}
                           for i in (1, 2, 3)}


def test_make_stac_matches(tmp_path):
    proj = fx.make_project(tmp_path / "m", "mm", nx=3, ny=2, cell=2.0, plans=["a"])
    jrun.make_stac(str(proj["root"] / "mm.prj"), str(tmp_path / "j.json"))
    trun.make_stac(str(proj["root"] / "mm.prj"), str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_make_runs_cli_matches(fake_dss, tmp_path, capsys):
    """``make-runs`` through both packages' main gives the same manifest."""
    from gpras_tpu.__main__ import main as jmain
    from gpras_tpu_torch.__main__ import main as tmain

    for name, main in (("jax", jmain), ("torch", tmain)):
        root = tmp_path / name
        (root / "model").mkdir(parents=True)
        (root / "model" / "cb.prj").write_text("Proj Title=cedar\n")
        stac = _events_stac(root, [3, 8], 72, precip=False)
        for i, e in enumerate((3, 8), start=1):
            times = [datetime(2019, 5, 1) + timedelta(hours=h + 100 * e) for h in range(72)]
            _register(PKGS[name]["dss"],
                      root / "model" / "gpr_dss_files" / "flow_boundaries" / f"gpr{i}.dss",
                      {"/SST/cedar_s120/FLOW-BASE/X/1HOUR/RUN:SST/":
                       {"values": np.arange(72.0), "times": times}})
        (root / "settings.json").write_text(json.dumps({
            "events_stac_path": str(stac), "output_path": str(root / "plans.json"),
            "ras_prj_path": str(root / "model" / "cb.prj"),
            "template_flow_path": str(CEDAR_U01)}))
        assert main(["make-runs", str(root / "settings.json")]) == 0
        assert capsys.readouterr().out.strip().endswith("created 2 runs")
    assert (tmp_path / "torch" / "plans.json").read_bytes() == \
        (tmp_path / "jax" / "plans.json").read_bytes()
    assert _tree(tmp_path / "torch" / "model") == _tree(tmp_path / "jax" / "model")
