"""The port imports no JAX: the machine that runs it on the GPU has none.

A fresh interpreter imports gpras_tpu_torch, serves a tiny exact-GP
checkpoint on the CPU through every module of the serving slice, fits tiny
models through the dense and the Hutchinson engines, fits and serves tiny
SGPR and SVGP models, runs the cold exact fit on both of its engines, fits
an ``HmsPreProcessor``, computes an event's metrics, imports
``gpras_tpu_torch.accuracy``, and checks that neither
``jax`` nor ``gpras_tpu`` was imported along the way. ``chip_smoke.py``,
which runs on that machine too, imports neither."""

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
for engine in ("dense", "hutchinson"):
    fitted = GPRAS("Matern52", model_type="exact", exact_engine=engine, dtype=torch.float64,
                   device="cpu")
    fitted.fit(x, y, optimization_method="adam", max_iter=3, learning_rate=0.05)
    assert all(torch.isfinite(v).all() for v in fitted.params.values())
    assert int(fitted.fit_info["iterations"][0]) == 3
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
