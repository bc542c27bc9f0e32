"""The port imports no JAX: the machine that runs it on the GPU has none.

A fresh interpreter imports gpras_tpu_torch, serves a tiny exact-GP
checkpoint on the CPU through every module of the serving slice, fits tiny
models through the dense, lean and Hutchinson engines (the lean and the
Hutchinson ones also through the in-place factorization), fits and serves tiny
SGPR and SVGP models, runs the cold exact fit on both of its engines, fits
an ``HmsPreProcessor``, computes an event's metrics, imports
``gpras_tpu_torch.accuracy``, replays a parquet DB through
``python -m gpras_tpu_torch run`` (``__main__.main``), and checks that
neither ``jax`` nor ``gpras_tpu`` was imported along the way. ``chip_smoke.py``,
which runs on that machine too, imports neither. Two more fresh interpreters
have no h5py: one imports ``data/ras_model`` and ``data/builders``, the other
runs the smoke's run-generation phase (``select-events``, ``make-runs``). One
more imports the distributed layer (``parallel/``) and the helpers its
parity tests run on gloo ranks, and fits through each distributed engine at
world size 1."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys, tempfile, pathlib
import numpy as np, torch
torch.set_num_threads(1)
import gpras_tpu_torch
from gpras_tpu_torch import GPRAS, PreProcessor, PosteriorPredictor

rng = np.random.default_rng(0)
field = 5.0 + rng.normal(size=(40, 30)) @ np.diag(np.linspace(1, 2, 30))
elev = np.zeros(30)
out = pathlib.Path(tempfile.mkdtemp())
for name, k in (("lf", 3), ("hf", 2)):
    pre = PreProcessor(hydraulic_parameter="wse", device="cpu")
    pre.fit(field, elev, spatial_mode_count=k)
    pre.to_file(out / f"{name}.npz")
model = GPRAS("RBF", model_type="exact", exact_engine="cg", dtype=torch.float64, device="cpu")
model.x = torch.as_tensor(rng.normal(size=(50, 3)))
model.y = torch.as_tensor(rng.normal(size=(50, 2)))
model.params = {"log_variance": torch.zeros(2, dtype=torch.float64),
                "log_lengthscales": torch.zeros(2, 3, dtype=torch.float64),
                "log_noise_variance": torch.full((2,), -2.0, dtype=torch.float64)}
model.to_file(out / "gp.npz")
pred = PosteriorPredictor(out / "gp.npz", out / "hf.npz", out / "lf.npz", buckets=(8,),
                          device="cpu")
f, v = pred.predict_field(field[:5])
assert f.shape == v.shape == (5, 30) and np.isfinite(f).all() and (v >= 0).all()
x, y = rng.normal(size=(64, 3)), rng.normal(size=(64, 2))
for engine, super_threshold in (("dense", 16384), ("lean", 16384), ("lean", 32),
                                ("hutchinson", 16384)):
    GPRAS.SUPER_THRESHOLD = super_threshold  # below N: lean's in-place factorization
    fitted = GPRAS("Matern52", model_type="exact", exact_engine=engine, dtype=torch.float64,
                   device="cpu")
    fitted.fit(x, y, optimization_method="adam", max_iter=3, learning_rate=0.05)
    assert all(torch.isfinite(v).all() for v in fitted.params.values())
    assert int(fitted.fit_info["iterations"][0]) == 3
GPRAS.SUPER_THRESHOLD = 16384
from gpras_tpu_torch.fit.optimizers import value_and_grad
from gpras_tpu_torch.gp import exact_stochastic
hutch = exact_stochastic.make_hutchinson_training_loss("Matern52", chol="super", chol_w=16,
                                                       chol_strip=24)
xt, yt = torch.as_tensor(x), torch.as_tensor(y[:, 0])
z = exact_stochastic.rademacher_probes(64, 4, dtype=torch.float64)
v, g = value_and_grad(lambda p: hutch(p, xt, yt, z), {k: t[0] for k, t in fitted.params.items()})
assert torch.isfinite(v) and all(torch.isfinite(t).all() for t in g.values())
sparse = GPRAS("Matern52", dtype=torch.float64, device="cpu")
sparse.fit(x, y, n_inducing=8, max_iter=3)
sparse.to_file(out / "sgpr.npz")
mean, var = PosteriorPredictor(out / "sgpr.npz", buckets=(8,), device="cpu").predict_modes(x[:5])
assert mean.shape == var.shape == (5, 2) and np.isfinite(mean).all()
variational = GPRAS("Matern52", model_type="svgp", dtype=torch.float64, device="cpu")
variational.fit(x, y, n_inducing=8, optimization_method="adam", batch_size=16, epochs=2,
                natgrad=0.5)
variational.to_file(out / "svgp.npz")
mean, var = PosteriorPredictor(out / "svgp.npz", buckets=(8,), device="cpu").predict_modes(x[:5])
assert mean.shape == var.shape == (5, 2) and np.isfinite(mean).all()
from gpras_tpu_torch import HmsPreProcessor, accuracy
from gpras_tpu_torch.metrics import compute_event_metrics
hms = HmsPreProcessor(device="cpu")
hms.fit(np.abs(rng.normal(size=(30, 8))), np.arange(8) < 2, np.arange(8) >= 2,
        precip_spatial_mode_count=2)
m = compute_event_metrics(torch.as_tensor(field[:6]), torch.as_tensor(field[1:7]),
                          torch.ones(6, 30, dtype=torch.float64))
assert np.isfinite(float(m["rmse_aoi_toi"])) and accuracy.make_problem({"n_cells_hf": 64, "n_cells_lf": 16})["hf_train"].shape[0] > 0
from gpras_tpu_torch.gp.coldfit import fit_exact
for engine in ("hutchinson", "cg"):
    p, info = fit_exact("Matern52", torch.as_tensor(x), torch.as_tensor(y[:, 0]), engine=engine,
                        max_iter=2, probes=8, cg_iters=16, seg_iters=4, precond_rank=8)
    assert info["iterations"] >= 1 and np.isfinite(float(info["loss"]))
import contextlib, io, json
import pandas as pd
from gpras_tpu_torch.__main__ import main as cli
from gpras_tpu_torch.data.reader import export_db
steps, cells, plans = 24, 30, ["e0", "e1", "e2", "e3"]
hydro = np.exp(-((np.arange(steps)[:, None] - 10.0) / 5.0) ** 2)
wave = np.sin(np.linspace(0, 3, cells))[None, :]
work = out / "work"
for split, names in (("training", plans[:3]), ("testing", plans[3:])):
    hf = np.concatenate([elev + 1.0 + (1 + 0.3 * plans.index(n)) * hydro * (1 + wave)
                         + 0.01 * rng.normal(size=(steps, cells)) for n in names])
    index = pd.MultiIndex.from_arrays([np.repeat(names, steps), np.tile(np.arange(steps),
                                       len(names))], names=["run", "t"])
    cell_info = pd.DataFrame({"hf_cell_id": np.arange(cells), "elevation": elev,
                              "area": np.ones(cells), "x": np.arange(cells) * 1.0,
                              "y": np.zeros(cells), "lf_cell_id": np.arange(cells) // 2})
    export_db(work / "data" / f"{split}.db", pd.DataFrame(hf, index=index),
              pd.DataFrame(hf + 0.1, index=index), cell_info)
(out / "plans.json").write_text(json.dumps([{"plan_title": n, "event_number": i, "set": "AEP",
    "type": "Test" if n == "e3" else "Train"} for i, n in enumerate(plans)]))
(out / "cfg.json").write_text(json.dumps({"working_directory": str(work),
    "hf_ras_stac_path": "unused", "area_of_interest_path": "unused",
    "event_plan_path": str(out / "plans.json"), "mesh_id": "m", "hydraulic_parameter": "wse",
    "wet_threshold_depth": 0.05, "spatial_mode_count": 2, "kernel": "Matern52",
    "inducing_pt_count": 0, "optimizer": "adam", "induction_pt_initializer": "grid",
    "optimizer_kwargs": {"max_iter": 3}, "generate_plots": False, "save_dbs": True,
    "lf_model_type": "ras_upskill", "model_backend": "exact", "dtype": "float64"}))
with contextlib.redirect_stdout(io.StringIO()) as buf:
    assert cli(["run", str(out / "cfg.json"), "--device", "cpu"]) == 0
assert np.isfinite(json.loads(buf.getvalue())["depth_rmse"])
assert (work / "metrics" / "performance_metrics.db").exists()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gpras_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


#: F1: ras_model imported h5py with the module, and every module that imports
#: RasModel failed without it; now h5py is imported where an HDF is first read
NO_H5PY_SCRIPT = r"""
import sys
sys.modules["h5py"] = None
import pathlib, tempfile
import gpras_tpu_torch.data.builders
from gpras_tpu_torch.data.ras_model import PlanHdf, RasModel
root = pathlib.Path(tempfile.mkdtemp())
(root / "m.prj").write_text("Proj Title=m\nPlan File=p01\n")
(root / "m.p01").write_text("Plan Title=a\n")
(root / "m.p01.hdf").write_bytes(b"")
model = RasModel(root / "m.prj")
assert [pathlib.Path(p).name for p in model.plan_files] == ["m.p01"]
assert pathlib.Path(model.increment_suffix(model.plan_files, "p")).name == "m.p02"
try:
    PlanHdf(root / "m.p01.hdf").attrs("Plan Data/Plan Information")
except ImportError:
    print("NO_H5PY_OK")
"""


def test_ras_model_and_builders_import_without_h5py():
    """A fresh interpreter where h5py cannot be imported imports
    ``data/ras_model`` and ``data/builders``, finds a project's text files,
    and raises ImportError (nothing falls back) where an HDF is read."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", NO_H5PY_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_H5PY_OK" in proc.stdout


#: chip_smoke.py's phase 18 on the CPU, at 2,000 events: select-events
#: (--device cpu) and a precip-less make-runs through the port's CLI
TOOLING_SCRIPT = r"""
import sys, time
for name in ("h5py", "matplotlib"):
    sys.modules[name] = None
import pathlib, tempfile
import torch
torch.set_num_threads(1)


class Event:  # the phase times its PCAs with CUDA events
    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


torch.cuda.Event = Event
for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
import chip_smoke
chip_smoke.DEVICE = "cpu"
chip_smoke.SST_EVENTS = 2000
report = chip_smoke.phase_run_tooling(pathlib.Path(tempfile.mkdtemp()))
assert report["runs"] == 49 and report["stac_equal_cpu"] and not report["imported"], report
assert [p["device"] for p in report["pca"]] == ["cpu", "cpu"], report["pca"]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gpras_tpu"))
assert not bad, bad
print("TOOLING_OK")
"""


def test_run_tooling_runs_without_h5py_matplotlib_or_jax():
    """The card's machine has no h5py, matplotlib or JAX: chip_smoke.py's
    run-generation phase (select-events on a seeded catalog, make-runs for
    its 49 storms on stand-in SST.dss files, the checks) passes on the CPU in
    a fresh interpreter where h5py and matplotlib cannot be imported, and
    imports neither jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", TOOLING_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    assert "TOOLING_OK" in proc.stdout


#: the distributed layer and the helpers its parity tests start on gloo ranks
#: (tests/torch_dist.py, tests/torch_dist_cases.py), driven once at world
#: size 1: a distributed fit through GPRAS.fit(mesh="auto") on each engine
PARALLEL_SCRIPT = r"""
import sys, pathlib, tempfile
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, "tests")
import torch_dist, torch_dist_cases
from gpras_tpu_torch.parallel import hybrid, mesh, pcg, pcholesky, pcholesky2d, pexact, pfit
from gpras_tpu_torch.parallel import pgram, ppca, ppredict, psvgp
from gpras_tpu_torch import GPRAS
store = pathlib.Path(tempfile.mkdtemp()) / "store"
dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
rng = np.random.default_rng(0)
x, y = rng.normal(size=(64, 2)), rng.normal(size=(64, 1))
for engine, kw in (("dense", {}), ("hutchinson", {"probes": 4}),
                   ("cg", {"probes": 4, "cg_iters": 8, "precond_rank": 4})):
    m = GPRAS("RBF", model_type="exact", exact_engine=engine, dtype=torch.float64, device="cpu")
    m.fit(x, y, mesh="auto", optimization_method="adam", max_iter=2, **kw)
    assert m.fit_info["dist_engine"] == engine and m.fit_info["dist_mesh_shape"] == (1,)
dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gpras_tpu"))
assert not bad, bad
print("PARALLEL_OK")
"""


def test_parallel_layer_and_its_test_helpers_import_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PARALLEL_OK" in proc.stdout


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "gpras_tpu_torch" in roots  # the scan sees the smoke's imports
    assert not roots & {"jax", "jaxlib", "gpras_tpu", "optax"}, sorted(roots)
