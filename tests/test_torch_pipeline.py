"""The port's pipeline, cross-validation and CLI against the JAX package's.

``gpras_tpu_torch.pipeline.pipeline(config, device="cpu")`` and
``gpras_tpu.pipeline.pipeline.pipeline(config)`` run on the same synthetic
HEC-RAS projects (tests/fixtures.py, tests/test_builders_pipeline.py's and
tests/test_hms_pseudo.py's), each in its own working directory, in float64.
Deterministic cases (the exact GP with Adam; SGPR with grid inducing points;
hms_upskill with and without the API event reset) are held to the reference:
the summary's depth RMSE, the fitted parameters, the served test fields and
the three metric tables agree to ``RTOL`` of each quantity's scale (measured:
1.3e-9 at most, the exact and SGPR cases; 2.5e-14 elsewhere). k-means SGPR is a sanity check only: the port's k-means++ draws
are not ``jax.random``'s. Working directories and artifacts written by either
package are replayed and served by the other; the CLI's text and the plots'
file names are the reference's; and a replay runs in a fresh interpreter
where h5py and matplotlib cannot be imported.
"""

import contextlib
import importlib
import io
import json
import os
import shutil
import sqlite3
import subprocess
import sys
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch_parity  # noqa: F401  (one torch thread)

import fixtures as fx

REPO = Path(__file__).resolve().parents[1]
#: port vs reference, relative to each quantity's largest magnitude (a metric
#: table's column, a parameter array, a served field); measured <= 1.3e-9
RTOL = 1e-6
TABLES = ("scalar_metrics", "timeseries_metrics", "cell_metrics")


def _pkg(name):
    """(config module, pipeline module) of ``gpras_tpu`` or ``gpras_tpu_torch``
    (``pipeline.pipeline`` is also the name of the function the package
    re-exports, so the modules come from importlib)."""
    return (importlib.import_module(f"{name}.pipeline.config"),
            importlib.import_module(f"{name}.pipeline.pipeline"))


JCFG, JPIPE = _pkg("gpras_tpu")
TCFG, TPIPE = _pkg("gpras_tpu_torch")


def _run(side, config):
    return JPIPE.pipeline(config) if side == "jax" else TPIPE.pipeline(config, device="cpu")


@pytest.fixture(scope="module")
def ras(tmp_path_factory):
    root = tmp_path_factory.mktemp("ras")
    plans = ["e1", "e2", "e3", "e4"]
    hf = fx.make_project(root / "hf", "hfm", nx=8, ny=8, cell=1.0, plans=plans, seed=0)
    lf = fx.make_project(root / "lf", "lfm", nx=4, ny=4, cell=2.0, plans=plans, seed=0,
                         elevation_fn=lambda c: 1.0 + 0.1 * c[:, 0])
    fx.write_aoi(root / "aoi.geojson", 0.2, 0.2, 7.8, 7.8)
    fx.write_event_plans(root / "event_plans.json", train=["e1", "e2", "e4"], test=["e3"])
    base = {"hf_ras_stac_path": str(hf["stac"]), "area_of_interest_path": str(root / "aoi.geojson"),
            "event_plan_path": str(root / "event_plans.json"), "mesh_id": fx.MESH_ID,
            "hydraulic_parameter": "wse", "wet_threshold_depth": 0.05, "spatial_mode_count": 3,
            "kernel": "RBF", "inducing_pt_count": 12, "optimizer": "adam",
            "induction_pt_initializer": "grid", "optimizer_kwargs": {"max_iter": 40},
            "generate_plots": False, "save_dbs": True, "lf_model_type": "ras_upskill",
            "lf_ras_stac_path": str(lf["stac"]), "dtype": "float64"}
    return {"root": root, "base": base, "runs": {}}


CASES = {
    "exact": {"model_backend": "exact"},
    "sgpr_grid": {"model_backend": "sgpr", "generate_plots": True},
}


def _case(ras, side, case):
    """Run (once per module) ``case`` with ``side``'s pipeline in its own
    working directory; returns (config, summary)."""
    key = (side, case)
    if key not in ras["runs"]:
        mod = JCFG if side == "jax" else TCFG
        cfg = mod.Config(**{**ras["base"], **CASES[case],
                            "working_directory": str(ras["root"] / f"{case}_{side}")})
        ras["runs"][key] = (cfg, _run(side, cfg))
    return ras["runs"][key]


def _tables(path):
    with sqlite3.connect(path) as con:
        return {name: pd.read_sql(f"select * from {name}", con) for name in TABLES}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(float(np.abs(want[ok]).max()) if ok.any() else 0.0, 1e-300)
    assert float(np.abs(got[ok] - want[ok]).max(initial=0.0)) <= RTOL * scale


def _same_tables(got_path, want_path):
    got, want = _tables(got_path), _tables(want_path)
    for name in TABLES:
        a, b = got[name], want[name]
        assert list(a.columns) == list(b.columns) and len(a) == len(b)
        for col in a.columns:
            if pd.api.types.is_numeric_dtype(b[col]):
                _close(a[col].to_numpy(), b[col].to_numpy())
            else:
                assert a[col].astype(str).tolist() == b[col].astype(str).tolist()


def _served(side, model_dir, lf_field):
    """The LF test field through ``side``'s PosteriorPredictor on the
    artifacts in ``model_dir`` (HF field and variance)."""
    paths = (model_dir / "gpr.npz", model_dir / "hf_preprocessor.npz",
             model_dir / "hf_preprocessor.npz")
    if side == "jax":
        from gpras_tpu.gp.serving import PosteriorPredictor

        return PosteriorPredictor(*paths).predict_field(lf_field)
    from gpras_tpu_torch.gp.serving import PosteriorPredictor

    return PosteriorPredictor(*paths, device="cpu").predict_field(lf_field)


def _lf_test(cfg):
    from gpras_tpu_torch.data.reader import RasReader

    return RasReader(cfg.testing_data_db).aligned_datasets[1].values


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_the_reference(ras, case):
    jcfg, jsum = _case(ras, "jax", case)
    tcfg, tsum = _case(ras, "torch", case)
    assert set(tsum) == set(jsum) == {"timers", "metric_db", "model_path", "depth_rmse"}
    assert set(tsum["timers"]) == set(jsum["timers"]) == {
        "load_data", "preprocess_data", "fit_model", "make_predictions"}
    assert json.loads(tcfg.timer_path.read_text()).keys() == tsum["timers"].keys()
    _close(tsum["depth_rmse"], jsum["depth_rmse"])
    _same_tables(tcfg.metric_db_path, jcfg.metric_db_path)
    with np.load(tcfg.model_path) as a, np.load(jcfg.model_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k.startswith("param_"):
                _close(a[k], b[k])
    lf = _lf_test(tcfg)
    for got, want in zip(_served("torch", tcfg.model_dir, lf), _served("jax", jcfg.model_dir, lf)):
        _close(got, want)


def test_generate_plots_writes_the_reference_files(ras):
    jcfg, _ = _case(ras, "jax", "sgpr_grid")
    tcfg, _ = _case(ras, "torch", "sgpr_grid")
    names = [sorted(str(p.relative_to(c.working_directory_path)) for p in
                    c.working_directory_path.rglob("*.png")) for c in (jcfg, tcfg)]
    assert names[0] == names[1]
    assert any(n.startswith("plots/error_maps/") for n in names[1])
    assert any(n.startswith("plots/temporal_clipping/") for n in names[1])


def test_kmeans_sgpr_pipeline_runs(ras, tmp_path):
    """k-means++ draws differ between the packages: a sanity check only."""
    cfg = TCFG.Config(**{**ras["base"], "induction_pt_initializer": "kmeans",
                         "working_directory": str(tmp_path / "work")})
    summary = _run("torch", cfg)
    lf = _lf_test(cfg)
    from gpras_tpu_torch.eof.preprocessor import PreProcessor

    pre = PreProcessor.from_file(cfg.hf_preprocessor_path, device="cpu")
    from gpras_tpu_torch.data.reader import RasReader

    hf = RasReader(cfg.testing_data_db).aligned_datasets[0].values
    lf_rmse = float(np.sqrt(np.mean((pre.wse_2_depth(hf) - pre.wse_2_depth(lf)) ** 2)))
    assert np.isfinite(summary["depth_rmse"]) and summary["depth_rmse"] < lf_rmse
    assert len(_tables(cfg.metric_db_path)["scalar_metrics"]) == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_working_directory_replays_across_packages(ras, tmp_path, writer):
    """A working directory one package wrote (DBs, preprocessor, checkpoint)
    is replayed by the other's pipeline (it loads the DBs and the
    preprocessor, refits the GP) and served by the other's ``predict``
    command, which equals the writer's own server."""
    reader = "torch" if writer == "jax" else "jax"
    src_cfg, _ = _case(ras, writer, "exact")
    work = tmp_path / "work"
    shutil.copytree(src_cfg.working_directory_path, work)
    mod = TCFG if reader == "torch" else JCFG
    cfg = mod.Config(**{**ras["base"], **CASES["exact"], "working_directory": str(work)})
    pre_bytes = cfg.hf_preprocessor_path.read_bytes()
    summary = _run(reader, cfg)
    assert cfg.hf_preprocessor_path.read_bytes() == pre_bytes  # replayed, not refit
    _close(summary["depth_rmse"], _case(ras, writer, "exact")[1]["depth_rmse"])

    lf = _lf_test(src_cfg)[:7]
    np.savez(tmp_path / "fields.npz", fields=lf)
    args = ["predict", str(src_cfg.model_path), str(tmp_path / "fields.npz"),
            str(tmp_path / "out.npz"), "--hf-pre", str(src_cfg.hf_preprocessor_path),
            "--lf-pre", str(src_cfg.lf_preprocessor_path)]
    if reader == "torch":
        from gpras_tpu_torch.__main__ import main

        args += ["--device", "cpu"]
    else:
        from gpras_tpu.__main__ import main
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(args) == 0
    with np.load(tmp_path / "out.npz") as z:
        got = (z["field"], z["field_var"])
    for g, w in zip(got, _served(writer, src_cfg.model_dir, lf)):
        _close(g, w)


# ------------------------------------------------------------------ hms_upskill

@pytest.fixture(scope="module")
def hms(tmp_path_factory):
    from gpras_tpu.data import dss as jdss
    from gpras_tpu_torch.data import dss as tdss

    root = tmp_path_factory.mktemp("hms")
    plans = ["e1", "e2", "e3"]
    hf = fx.make_project(root / "hf", "hfm", nx=6, ny=6, cell=1.0, plans=plans)
    fx.write_aoi(root / "aoi.geojson", 0.2, 0.2, 5.8, 5.8)
    fx.write_event_plans(root / "ep.json", train=["e1", "e3"], test=["e2"])
    times = [datetime(2020, 1, 1) + timedelta(hours=h) for h in range(40)]
    for mod in (jdss, tdss):
        for i, plan in enumerate(plans):
            q = fx.hydrograph(40, peak=100.0 * (1 + i))
            mod.FakeDss.register(str(root / "inflow" / f"{plan}.dss"), {
                "/TRIN/west-fork_s340/FLOW/01JAN2020/1HOUR/RUN:X/":
                    mod.FakeRecord(values=q, times=times)})
            rng = np.random.default_rng(10 + i)
            mod.FakeDss.register(str(root / "precip" / f"{plan}.dss"), {
                f"/SHG/PRECIP/EXCESS/{t.strftime('%d%b%Y:%H%M').upper()}/X/GPR/":
                    mod.FakeRecord(data=np.abs(rng.normal(0.5, 0.2, size=(8, 8))).astype(
                        np.float32), cellSize=1.0, numberOfCellsX=8, numberOfCellsY=8,
                        srsDefinition="LOCAL") for t in times})
        mod.set_dss_factory(mod.FakeDss)
    yield {"root": root, "base": {
        "hf_ras_stac_path": str(hf["stac"]), "area_of_interest_path": str(root / "aoi.geojson"),
        "event_plan_path": str(root / "ep.json"), "mesh_id": fx.MESH_ID,
        "hydraulic_parameter": "wse", "wet_threshold_depth": 0.05, "spatial_mode_count": 2,
        "kernel": "RBF", "inducing_pt_count": 0, "optimizer": "adam",
        "induction_pt_initializer": "grid", "optimizer_kwargs": {"max_iter": 30},
        "generate_plots": False, "save_dbs": False, "lf_model_type": "hms_upskill",
        "inflow_dss_dir": str(root / "inflow"), "inflow_hms_elements": [["west-fork_s340", "FLOW"]],
        "precip_dss_dir": str(root / "precip"), "precip_spatial_mode_count": 2,
        "model_backend": "exact", "dtype": "float64"}}
    for mod in (jdss, tdss):
        mod.set_dss_factory(None)


@pytest.mark.parametrize("api_event_reset", [False, True])
def test_hms_upskill_pipeline_matches(hms, api_event_reset):
    cfgs, sums = [], []
    for side, mod in (("jax", JCFG), ("torch", TCFG)):
        cfgs.append(mod.Config(**{**hms["base"], "api_event_reset": api_event_reset,
                                  "working_directory": str(hms["root"] /
                                                           f"{side}_{api_event_reset}")}))
        sums.append(_run(side, cfgs[-1]))
    _close(sums[1]["depth_rmse"], sums[0]["depth_rmse"])
    _same_tables(cfgs[1].metric_db_path, cfgs[0].metric_db_path)
    from gpras_tpu.eof.preprocessor import HmsPreProcessor as J
    from gpras_tpu_torch.eof.preprocessor import HmsPreProcessor as T

    j = J.from_file(cfgs[0].lf_preprocessor_path)
    t = T.from_file(cfgs[1].lf_preprocessor_path, device="cpu")
    assert j.event_reset == t.event_reset == api_event_reset
    _close(t.eofs, j.eofs)


def test_event_ids_raise_without_a_run_level():
    class Cfg:
        api_event_reset = True

    df = pd.DataFrame(np.ones((4, 2)))
    with pytest.raises(ValueError, match="run"):
        TPIPE._event_ids(df, Cfg())
    Cfg.api_event_reset = False
    assert TPIPE._event_ids(df, Cfg()) is None


def test_reverse_transform_promotes_a_float32_variance():
    """A float32 posterior (a float32 pipeline's) against a preprocessor fit
    on area-weighted (float64) fields: the port promotes as numpy does, and
    equals the JAX package's reverse_transform."""
    from gpras_tpu.eof.preprocessor import PreProcessor as J
    from gpras_tpu_torch.eof.preprocessor import PreProcessor as T

    rng = np.random.default_rng(0)
    field = (5.0 + rng.normal(size=(40, 30))).astype(np.float32)
    elev, areas = np.zeros(30), rng.uniform(1.0, 2.0, 30)
    mean = rng.normal(size=(6, 3)).astype(np.float32)
    var = rng.uniform(0.1, 1.0, size=(6, 3)).astype(np.float32)
    out = []
    for pre in (J(hydraulic_parameter="wse"), T(hydraulic_parameter="wse", device="cpu")):
        pre.fit(field, elev, areas, 3)
        out.append(pre.reverse_transform(mean, var))
    for got, want in zip(out[1], out[0]):
        assert got.dtype == want.dtype == np.float64
        _close(got, want)


# ------------------------------------------------------------ cross-validation

def test_cv_kernel_sweep_matches(tmp_path):
    """A two-option kernel sweep (tests/test_cross_validation.py's) in each
    package: the same splits and the same metric DB per option."""
    plans = ["e1", "e2", "e3", "e4"]
    hf = fx.make_project(tmp_path / "hf", "hfm", nx=6, ny=6, cell=1.0, plans=plans)
    lf = fx.make_project(tmp_path / "lf", "lfm", nx=3, ny=3, cell=2.0, plans=plans)
    fx.write_aoi(tmp_path / "aoi.geojson", 0.2, 0.2, 5.8, 5.8)
    rows = [{"plan_title": "e1", "event_number": 1, "type": "Train", "set": "AEP"},
            {"plan_title": "e2", "event_number": 2, "type": "Train", "set": "AEP"},
            {"plan_title": "e3", "event_number": 3, "type": "Train", "set": "Diverse"},
            {"plan_title": "e4", "event_number": 4, "type": "Test", "set": "Test"}]
    (tmp_path / "event_plans.json").write_text(json.dumps(rows))
    dirs = []
    for side in ("jax", "torch"):
        cv = importlib.import_module(f"{'gpras_tpu' if side == 'jax' else 'gpras_tpu_torch'}"
                                     ".pipeline.cross_validation")
        config = {"working_directory": str(tmp_path / f"work_{side}"),
                  "hf_ras_stac_path": str(hf["stac"]),
                  "area_of_interest_path": str(tmp_path / "aoi.geojson"),
                  "event_plan_path": str(tmp_path / "event_plans.json"), "mesh_id": fx.MESH_ID,
                  "hydraulic_parameter": "wse", "wet_threshold_depth": 0.05,
                  "spatial_mode_count": 2, "kernel": "RBF", "inducing_pt_count": 8,
                  "optimizer": "adam", "induction_pt_initializer": "grid",
                  "optimizer_kwargs": {"max_iter": 25}, "generate_plots": False,
                  "save_dbs": True, "lf_model_type": "ras_upskill",
                  "lf_ras_stac_path": str(lf["stac"]), "dtype": "float64"}
        path = tmp_path / f"cv_{side}.json"
        path.write_text(json.dumps(config))
        extra = {} if side == "jax" else {"device": "cpu"}
        cv.setup(str(path), **extra)
        c = cv.CVConfig.from_file(str(path))
        assert (c.train_plans, c.test_plans) == (["e1", "e2"], ["e3"])
        base = Path(c.working_directory) / "kernel"
        cv.run_cv_serial(c, {"kernel": ["RBF", "Matern32"]}, base, **extra)
        cv.run_cv_serial(c, {"kernel": ["RBF", "Matern32"]}, base, **extra)  # resumes
        dirs.append(base)
    for i in range(2):
        _same_tables(dirs[1] / str(i) / "performance_metrics.db",
                     dirs[0] / str(i) / "performance_metrics.db")
        got, want = (json.loads((d / str(i) / "config.json").read_text()) for d in dirs)
        assert got["kernel"] == want["kernel"] == ["RBF", "Matern32"][i]
    assert (dirs[1] / "defaults.config.json").exists()


# ------------------------------------------------------------------------- CLI

def test_cli_run_and_describe_config(ras, capsys):
    from gpras_tpu.__main__ import main as jmain
    from gpras_tpu_torch.__main__ import main as tmain

    assert jmain(["describe-config"]) == 0
    want = capsys.readouterr().out
    assert tmain(["describe-config"]) == 0
    assert capsys.readouterr().out == want and "model_backend" in want

    tcfg, tsum = _case(ras, "torch", "exact")
    work = ras["root"] / "cli_work"
    shutil.copytree(tcfg.working_directory_path / "data", work / "data")
    cfg_path = ras["root"] / "cli.json"
    cfg_path.write_text(json.dumps({**ras["base"], **CASES["exact"],
                                    "working_directory": str(work)}))
    assert tmain(["run", str(cfg_path), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    _close(summary["depth_rmse"], tsum["depth_rmse"])
    _same_tables(work / "metrics" / "performance_metrics.db", tcfg.metric_db_path)
    # the run-generation tooling is in the port's CLI too
    from test_tooling import make_sst_parquet

    make_sst_parquet(ras["root"] / "sst.pq", n_events=200)
    stac = ras["root"] / "events.stac.json"
    assert tmain(["select-events", str(ras["root"] / "sst.pq"), str(stac),
                  "--n-train", "20", "--n-test", "6", "--target-rps", "2,5,10,25",
                  "--test-rp-range", "1.2,50", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {stac}"
    assert json.loads(stac.read_text())["properties"]["train_event_count"] == 20


def test_replay_runs_without_h5py_and_matplotlib(ras, tmp_path):
    """A fresh interpreter where h5py and matplotlib cannot be imported runs
    the CLI's ``run`` from a prebuilt DB, and imports neither jax nor the JAX
    package."""
    tcfg, tsum = _case(ras, "torch", "exact")
    shutil.copytree(tcfg.working_directory_path / "data", tmp_path / "work" / "data")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({**ras["base"], **CASES["exact"],
                                    "working_directory": str(tmp_path / "work")}))
    script = (
        "import sys\n"
        "for name in ('h5py', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gpras_tpu_torch.__main__ import main\n"
        f"assert main(['run', {str(cfg_path)!r}, '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'gpras_tpu'))\n"
        "assert not bad, bad\n"
        "print('REPLAY_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REPLAY_OK" in proc.stdout
    summary = json.loads(proc.stdout.split("REPLAY_OK")[0])
    _close(summary["depth_rmse"], tsum["depth_rmse"])
