"""The warm-started exact fit (``GPRAS.fit(..., warm_start_subsample=...)``)
against the plain float64 reference of the benchmark's pipeline cell
(``perfbench/reference/warm_start.py``), stage by stage, on the pipeline's
data recipe at a CPU size (N = 384, D = 4): the rung's losses and optimum,
the certification's caps and losses, and three Adam steps at full N. Also:
the rung's result kept in ``warm_start_info``; a transfer whose clamp binds
and whose certification halves its cap once; the ``fit.warm_start`` and
``fit.certify`` spans and the ``warm.*`` counters; the cell's configuration
and its warm-share reader."""

import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (one torch thread)
from gpras_tpu_torch import GPRAS
from gpras_tpu_torch.gp import warmstart
from gpras_tpu_torch.utils import profiling
from perfbench.drivers import pipe_fit
from perfbench.reference import warm_start as ref_warm
from perfbench.reference.precision import Precision

REPO = Path(__file__).resolve().parents[1]
CFG = json.loads((REPO / "perfbench/configs/pipe-exact-n17k.json").read_text())
TRAFFIC = json.loads((REPO / "perfbench/traffic/pipe-fit-warm30.json").read_text())
TINY = {**CFG, **CFG["tiny"]}
TINY_TRAFFIC = {**TRAFFIC, **TRAFFIC["tiny"]}
SEEDS = (2**31 + 21, 7)

# Stage limits against the float64 reference, for float32 on the CPU at N =
# 384 (readings 3e-7 to 8e-6, the gradient's and the change's to 6e-4 and
# 4e-5): each step loss and the certifying loss, relative, 1e-5 (float32's
# 6e-8 times the Grams' condition, a few hundred); the rung's optimum 1e-4
# of its change after 30 steps; the full-N Hutchinson gradient 3e-3 and the
# change after 3 steps 3e-4, where the gradient of a leaf near zero leaves
# float32 few digits. The TF32 reference fails them (7e-4 and up on the
# losses, 1.6e-2 on the gradient).
LIMITS = {"rung_loss_gap": 1e-5, "rung_param_gap": 1e-4, "cap_mismatch": 0.0,
          "cert_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 3e-3, "change_gap_median": 3e-4}


@pytest.fixture
def ladder(monkeypatch):
    """The engines of the cell's full size at N = 384: the dense engine on
    the 64-point rung, Hutchinson at full N."""
    monkeypatch.setattr(GPRAS, "LEAN_THRESHOLD", 64)
    monkeypatch.setattr(GPRAS, "SUPER_THRESHOLD", 128)
    monkeypatch.setattr(GPRAS, "CG_THRESHOLD", 1 << 30)


@pytest.fixture(autouse=True)
def _empty():
    profiling.clear()
    yield
    profiling.clear()


_DATA: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def pipeline_data(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The cell's (x, y) at its CPU size: the pipeline's EOF stage on the
    seeded training events."""
    if seed not in _DATA:
        _DATA[seed] = pipe_fit.training_data(TINY, seed, "cpu")
    return _DATA[seed]


def _state(seed: int) -> dict:
    x, y = pipeline_data(seed)
    cell = types.SimpleNamespace(config=TINY, traffic=TINY_TRAFFIC, device="cpu", seed=seed)
    model = GPRAS("Matern52", model_type="exact", device="cpu")
    return {"cell": cell, "x": x, "y": y, "model": model, "kwargs": pipe_fit._kwargs(TINY_TRAFFIC),
            "observer": pipe_fit.Observer(model, pipe_fit.FOLLOWED + 1)}


def _within(numbers: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in LIMITS.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_warm_started_fit_matches_the_reference_stage_by_stage(seed, ladder):
    """Rung losses and optimum from the program's x and y; caps and
    certifying losses at the program's rung optimum; 3 Adam steps at full N
    from the parameters the reference certifies: the program's own full-N
    start is checked by the first step's loss."""
    state = _state(seed)
    call = pipe_fit.fit_call(state)
    assert call["rung"] is not None and call["iterations"] == [30] * 4
    assert call["evaluations"] == 4 * (1 + 30 + 1)  # certification, steps, closing
    pipe_fit._inputs(state)
    prog = pipe_fit.program_readings(state, call)
    ref = pipe_fit.reference_readings(state, prog["rung_params"], "f64")
    numbers = pipe_fit.stage_numbers(prog, ref)
    assert _within(numbers), numbers
    assert [ref["cert"][m]["cap"] for m in range(4)] == call["caps"] == [50.0] * 4
    assert [prog["cert"][m]["evals"] for m in range(4)] == [1] * 4
    control = pipe_fit.stage_numbers(pipe_fit.reference_readings(
        state, prog["rung_params"], "tf32"), ref)
    assert not _within(control), control


@pytest.mark.parametrize("fault", ["rung_skipped", "half_rows"])
def test_a_fault_planted_in_the_reference_fails_the_stage_limits(fault, ladder):
    state = _state(SEEDS[0])
    call = pipe_fit.fit_call(state)
    pipe_fit._inputs(state)
    prog = pipe_fit.program_readings(state, call)
    ref = pipe_fit.reference_readings(state, prog["rung_params"], "f64")
    if fault == "half_rows":
        planted = pipe_fit.reference_readings(state, prog["rung_params"], "f64",
                                              rows=state["x32"].shape[0] // 2)
    else:
        planted = pipe_fit.reference_readings(state, prog["rung_params"], "f64", fault=fault)
    numbers = pipe_fit.stage_numbers(planted, ref)
    assert numbers["loss_gap"] > 100 * LIMITS["loss_gap"], numbers


def test_rung_result_is_the_subsample_fit(ladder):
    """``rung_params`` and ``rung_losses`` are those of the same fit run
    alone on every ceil(N / S)-th row."""
    x, y = pipeline_data(SEEDS[0])
    opt = {"optimization_method": "adam", "max_iter": 8, "learning_rate": 0.05}
    model = GPRAS("Matern52", model_type="exact", device="cpu")
    model.fit(x, y, warm_start_subsample=64, **opt)
    stride = -(-x.shape[0] // 64)
    alone = GPRAS("Matern52", model_type="exact", device="cpu")
    alone.fit(np.ascontiguousarray(x[::stride]), np.ascontiguousarray(y[::stride]), **opt)
    info = model.warm_start_info
    assert set(info) >= {"rung_params", "rung_losses", "ratio_caps", "cert_losses",
                         "fell_back_modes"}
    for k, v in alone.params.items():
        assert torch.equal(info["rung_params"][k], v), k
    assert torch.equal(info["rung_losses"]["losses"], alone.fit_info["losses"])
    assert torch.equal(info["rung_losses"]["iterations"], alone.fit_info["iterations"])


def _threshold(p: dict, x: torch.Tensor, jitter: float) -> float:
    """The cap above which the clamped parameters stop factoring in float32
    (the reference's test), by bisection in log space."""
    lo, hi = 2.0, float(torch.exp(p["log_variance"] - p["log_noise_variance"]))
    assert ref_warm.factors_in_float32(ref_warm.clamp(p, lo), x, jitter)
    assert not ref_warm.factors_in_float32(ref_warm.clamp(p, hi), x, jitter)
    for _ in range(40):
        mid = math.sqrt(lo * hi)
        if ref_warm.factors_in_float32(ref_warm.clamp(p, mid), x, jitter):
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def test_clamp_binds_and_certification_halves_once(ladder):
    """Rung parameters whose variance is 1e7 x their noise variance, with
    lengthscales long against the inputs' spread (each of 96 points four
    times): at the cap sqrt(2) above the float32 factorization's threshold
    the clamped Gram does not factor, at half of it it does. The program's
    certification (``GPRAS.fit``'s call, on the model's full-N loss) and the
    reference agree on the caps, and ``warm.cert_evals`` counts the two
    forwards of each mode."""
    gen = np.random.default_rng(5)
    x = torch.tensor(np.repeat(gen.normal(size=(96, 4)), 4, axis=0), dtype=torch.float32)
    y = torch.tensor(np.sin(x.numpy() @ gen.normal(size=(4, 2))), dtype=torch.float32)
    rung = {"log_variance": torch.zeros(2), "log_lengthscales": torch.full((2, 4), math.log(30.0)),
            "log_noise_variance": torch.full((2,), -math.log(1e7))}
    jitter = 1e-6
    p0 = {k: v[0] for k, v in rung.items()}
    cap = math.sqrt(2.0) * _threshold(p0, x, jitter)
    assert cap < 1e7  # the clamp binds

    model = GPRAS("Matern52", model_type="exact", device="cpu")
    model.x, model.y = x, y.contiguous()
    fallback = {k: torch.zeros_like(v) for k, v in rung.items()}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("fit.certify"):
            _, info = warmstart.certify_transfer_batched(
                lambda p, i: model._loss_fn(p, model.y[:, i]), rung, fallback, ratio_cap=cap)
    totals = profiling.totals()
    prec = Precision("f64")
    ref = [ref_warm.certify(prec, {k: v[m] for k, v in rung.items()}, x, y[:, m], jitter,
                            cap=cap) for m in range(2)]
    assert info["ratio_caps"] == [r["cap"] for r in ref] == [cap / 2.0] * 2
    assert info["fell_back_modes"] == []
    assert totals["warm.cert_evals"] == sum(r["evals"] for r in ref) == 4
    assert "warm.fallback_modes" not in totals
    for got, r in zip(info["cert_losses"], ref):
        assert math.isfinite(got) and math.isfinite(r["loss"])


@pytest.mark.parametrize("cap,evals,fallbacks", [(50.0, 4, 0), (1.9, 0, 4)])
def test_warm_start_spans_nest_and_counters_count(cap, evals, fallbacks, ladder):
    """Under a profiler: the rung's ``fit.mode`` and ``fit.eval`` spans sit
    in ``fit.warm_start``; the certifying forwards' ``fit.eval`` in
    ``fit.certify``; ``warm.cert_evals`` counts them and
    ``warm.fallback_modes`` the modes left at the standard init (a cap
    under the certification's floor of 2 certifies nothing)."""
    x, y = pipeline_data(SEEDS[0])
    model = GPRAS("Matern52", model_type="exact", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        model.fit(x, y, optimization_method="adam", max_iter=2, learning_rate=0.05,
                  warm_start_subsample=64, warm_ratio_cap=cap)
    recs = profiling.records()
    totals = profiling.totals()
    warm = [i for i, r in enumerate(recs) if r["name"] == "fit.warm_start"]
    cert = [i for i, r in enumerate(recs) if r["name"] == "fit.certify"]
    assert len(warm) == 1 and len(cert) == 1
    assert recs[warm[0]]["parent"] is None and recs[cert[0]]["parent"] is None
    rung_modes = [r for r in recs if r["name"] == "fit.mode" and r["parent"] == warm[0]]
    assert len(rung_modes) == 4 and all(r["id"] == recs[warm[0]]["id"] for r in rung_modes)
    mode_index = {i for i, r in enumerate(recs) if r["name"] == "fit.mode"}
    rung_evals = [r for r in recs if r["name"] == "fit.eval" and r["parent"] in mode_index
                  and recs[r["parent"]]["parent"] == warm[0]]
    assert len(rung_evals) == 4 * (2 + 1)  # 2 steps and the closing loss a mode
    cert_evals = [r for r in recs if r["name"] == "fit.eval" and r["parent"] == cert[0]]
    assert len(cert_evals) == evals
    assert totals.get("warm.cert_evals", 0) == evals
    assert recs[cert[0]]["counts"].get("warm.cert_evals", 0) == evals
    assert totals.get("warm.fallback_modes", 0) == fallbacks
    assert model.warm_start_info["fell_back_modes"] == list(range(4))[:fallbacks]
    assert recs[warm[0]]["end_ns"] <= recs[cert[0]]["start_ns"]


@pytest.mark.parametrize("cfg", [CFG, TINY], ids=["full", "tiny"])
def test_pipe_configuration_n_train_is_events_times_steps(cfg):
    assert cfg["n_train"] == cfg["events"][0] * cfg["steps"]
    assert cfg["grid"][0] % cfg["lf_block"] == 0 and cfg["grid"][1] % cfg["lf_block"] == 0
    assert cfg["input_dim"] == cfg["hf_modes"]  # ras_upskill: one basis for both fidelities


def _warm_share():
    from perfbench.run import _load

    return _load(REPO / "perfbench/metrics/warm_share.pipe_fit.py",
                 "perfbench.metrics.warm_share.pipe_fit")


def test_warm_share_reads_the_two_spans_over_the_window(monkeypatch):
    from perfbench.metrics import _spans

    reader = _warm_share()
    ctx = {"trace": types.SimpleNamespace(window_s=10.0)}
    spans = [{"name": n, "start_ns": 0, "end_ns": int(s * 1e9)}
             for n, s in (("fit.warm_start", 1.5), ("fit.certify", 0.5), ("fit.eval", 4.0))]
    monkeypatch.setattr(_spans, "program", lambda: (spans, {}))
    assert reader.read(ctx) == pytest.approx(20.0, rel=1e-12)
    monkeypatch.setattr(_spans, "program", lambda: (spans[2:], {}))
    assert reader.read(ctx) is None
    monkeypatch.setattr(_spans, "program", lambda: None)
    assert reader.read(ctx) is None


TINY_RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from gpras_tpu_torch import GPRAS
from perfbench.tests import tiny
GPRAS.LEAN_THRESHOLD, GPRAS.SUPER_THRESHOLD, GPRAS.CG_THRESHOLD = 64, 128, 1 << 30
root = tiny.make_root(Path({tmp!r}))
sys.path.insert(0, str(root))
for name in [m for m in sys.modules if m == "perfbench" or m.startswith("perfbench.")]:
    del sys.modules[name]
import importlib.util
spec = importlib.util.spec_from_file_location("perfbench_run_tiny", root / "perfbench" / "run.py")
run = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
run.require_device = lambda chips: "cpu"
sys.exit(run.main(["--workload", "pipe17k-fit", "--seed", str(2**31 + 33), "--seconds", "0.01",
                   "--trace", "{trace}"], root=root))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_of_the_cell_is_correct_and_reports_its_metrics(trace, tmp_path):
    """``perfbench/run.py`` on the cell at its CPU size, in an interpreter
    without JAX as the benchmark runs it: correct, 128 full-N evaluations a
    call, ``fit_step_s`` and ``setup_s``; traced, the warm share read from
    the program's spans (the device-timed metrics read nothing on the CPU)."""
    import subprocess
    import sys

    code = TINY_RUN.format(repo=str(REPO), tmp=str(tmp_path), trace=trace)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] % 128 == 0 and result["failed"] == 0
    if trace:
        assert 0.0 < result["metrics"]["warm_share.pipe_fit"]["value"] < 100.0
        assert "factor_roofline.pipe_fit" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"setup_s", "fit_step_s", "peak_mem_gb"}
