"""The port's spans and counters (``gpras_tpu_torch/utils/profiling.py``):
off and free without a profiler; under one, spans nest, share their
request's id and appear in the profiler's own trace; the counters count
the factorization's host reads, mbcg's live columns and a served request's
blocking copies; ``profiler_trace`` writes them beside its trace."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (one torch thread)
from gpras_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _empty():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(recs):
    return {r["name"]: (i, r) for i, r in enumerate(recs)}


def test_without_a_profiler_nothing_records(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.tracing()
    with profiling.span("a") as s:
        profiling.count("host_reads", 3)
        with profiling.span("b"):
            profiling.count("host_reads", torch.tensor(2))
    assert s is None
    assert profiling.current() is None
    assert profiling.records() == [] and profiling.totals() == {}


def test_spans_nest_share_ids_and_sit_in_the_profiler_trace():
    with _cpu_profile() as prof:
        with profiling.span("req"):
            with profiling.span("stage1"):
                profiling.count("host_reads", 2)
            with profiling.span("stage2"):
                profiling.count("host_reads", torch.tensor(5))
                with profiling.span("inner"):
                    profiling.count("host_reads")
                handle = profiling.current()

                def other():  # a span on another thread joins through its parent
                    with profiling.span("other_thread", parent=handle):
                        pass

                th = threading.Thread(target=other)
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
        with profiling.span("next"):
            pass
    recs = profiling.records()
    names = [r["name"] for r in recs]
    assert names == ["req", "stage1", "stage2", "inner", "other_thread", "next"]
    by = _by_name(recs)
    assert by["req"][1]["parent"] is None and by["next"][1]["parent"] is None
    for child, parent in (("stage1", "req"), ("stage2", "req"), ("inner", "stage2"),
                          ("other_thread", "stage2")):
        assert by[child][1]["parent"] == by[parent][0]
        assert by[child][1]["id"] == by["req"][1]["id"]
    assert by["next"][1]["id"] != by["req"][1]["id"]
    assert by["stage1"][1]["counts"] == {"host_reads": 2}
    assert by["stage2"][1]["counts"] == {"host_reads": 5}
    assert by["inner"][1]["counts"] == {"host_reads": 1}
    assert by["req"][1]["counts"] == {}
    assert profiling.totals() == {"host_reads": 8}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        assert r["device_s"] is None  # no CUDA device
    starts = {}
    for evt in prof.profiler.kineto_results.events():
        starts.setdefault(evt.name(), []).append(evt.start_ns())
    for r in recs:
        if r["name"] == "other_thread":
            continue
        assert min(abs(s - r["start_ns"]) for s in starts[r["name"]]) < 1_000_000


def test_spans_from_many_threads_keep_their_records():
    """Threads that join one request append their records under the lock:
    none is lost, each points at the request's root."""
    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            with profiling.span("root"):
                handle = profiling.current()

                def work():
                    for _ in range(200):
                        with profiling.span("worker", parent=handle):
                            pass

                threads = [threading.Thread(target=work) for _ in range(8)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    recs = profiling.records()
    assert len(recs) == 1 + 8 * 200
    assert all(r["parent"] == 0 and r["id"] == recs[0]["id"] for r in recs[1:])
    assert all(r["end_ns"] is not None for r in recs)


def _hutchinson_inputs(n, dtype=torch.float64):
    from gpras_tpu_torch.gp import exact_stochastic as es

    gen = np.random.default_rng(3)
    x = torch.as_tensor(gen.normal(size=(n, 3)), dtype=dtype)
    y = torch.as_tensor(gen.normal(size=n), dtype=dtype)
    params = {"log_variance": torch.tensor(0.0, dtype=dtype),
              "log_lengthscales": torch.zeros(3, dtype=dtype),
              "log_noise_variance": torch.tensor(-2.0, dtype=dtype)}
    return params, x, y, es.rademacher_probes(n, 4, dtype=dtype)


@pytest.mark.parametrize("w", [16, 32, 64])
def test_hutchinson_forward_reads_once_per_panel(w):
    """``super_cholesky`` with panels of w <= 512 factors each diagonal block
    by ``safe_cholesky``, whose status is the only host read of a block
    that factors at once; nothing else in the forward blocks."""
    from gpras_tpu_torch.gp import exact_stochastic as es

    n = 128
    params, x, y, z = _hutchinson_inputs(n)
    nlml = es.make_hutchinson_nlml("Matern52", chol="super", chol_w=w)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with _cpu_profile():
        with profiling.span("eval"):
            loss = nlml(leaves, x, y, z)
        loss.backward()
    recs = profiling.records()
    assert profiling.totals() == {"host_reads": n // w}
    by = _by_name(recs)
    assert [r["name"] for r in recs] == ["eval", "fit.gram", "fit.factor", "fit.solve",
                                         "fit.backward"]
    assert by["fit.factor"][1]["counts"] == {"host_reads": n // w}
    for name in ("fit.gram", "fit.factor", "fit.solve", "fit.backward"):
        assert by[name][1]["parent"] == by["eval"][0]
        assert by[name][1]["id"] == by["eval"][1]["id"]
    assert all(v.grad is not None for v in leaves.values())


def test_mbcg_counts_live_column_iterations():
    from gpras_tpu_torch.gp.exact_cg import mbcg

    gen = np.random.default_rng(5)
    # three distinct eigenvalues: CG converges in three iterations, then freezes
    q, _ = torch.linalg.qr(torch.as_tensor(gen.normal(size=(24, 24))))
    a = q @ torch.diag(torch.tensor([1.0, 2.0, 3.0], dtype=q.dtype).repeat(8)) @ q.T
    b = torch.as_tensor(gen.normal(size=(24, 3)))
    b[:, 1] = 0.0  # freezes at the first iteration
    with _cpu_profile():
        _, alphas, _, _ = mbcg(lambda v: a @ v, b, max_iters=12, tol=1e-8)
    tot = profiling.totals()
    assert torch.all(alphas[:, 1] == 0)
    live = int(torch.count_nonzero(alphas))
    assert tot["cg.column_iters"] == 36
    assert tot["cg.live_column_iters"] == live
    assert 0 < live <= 8  # at most four iterations on each of the two other columns


def test_mbcg_counts_nothing_without_a_profiler(monkeypatch):
    from gpras_tpu_torch.gp import exact_cg

    monkeypatch.setattr(exact_cg.torch, "count_nonzero", None)  # a call would raise
    b = torch.ones(8, 2, dtype=torch.float64)
    exact_cg.mbcg(lambda v: 2.0 * v, b, max_iters=3)
    assert profiling.totals() == {}


def _fields(seed, n_events, n_cells=60):
    rng = np.random.default_rng(seed)
    c = np.linspace(0.0, 1.0, n_cells)
    elev = 10.0 * c
    elev[40:44] = 40.0  # always dry
    amps = rng.normal(size=(n_events, 8))
    patterns = np.stack([np.sin((k + 1) * np.pi * c) for k in range(8)])
    return elev + 5.0 + (amps / (1.0 + np.arange(8))) @ patterns, elev


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    from gpras_tpu_torch import GPRAS, PosteriorPredictor, PreProcessor

    out = tmp_path_factory.mktemp("tracing")
    lf, elev = _fields(0, 200)
    hf, _ = _fields(1, 200)
    for name, f, modes in (("lf", lf, 4), ("hf", hf, 2)):
        pre = PreProcessor(hydraulic_parameter="wse", device="cpu")
        pre.fit(f, elev, spatial_mode_count=modes)
        pre.to_file(out / f"{name}.npz")
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(64, 4)))
    model = GPRAS("Matern52", model_type="exact", dtype=torch.float64, device="cpu")
    model.x, model.y = x, torch.sin(x[:, :2])
    model.params = {"log_variance": torch.zeros(2, dtype=x.dtype),
                    "log_lengthscales": torch.zeros(2, 4, dtype=x.dtype),
                    "log_noise_variance": torch.full((2,), -3.0, dtype=x.dtype)}
    model.to_file(out / "gp.npz")
    return PosteriorPredictor(out / "gp.npz", hf_preprocessor_path=out / "hf.npz",
                              lf_preprocessor_path=out / "lf.npz", buckets=(8,),
                              device="cpu")


def test_predict_field_opens_the_five_serve_spans_under_one_id(predictor):
    lf, _ = _fields(9, 5)
    want = predictor.predict_field(lf[:3])  # untraced
    with _cpu_profile():
        got = predictor.predict_field(lf[:3])
        predictor.predict_field(lf[3:5])
    recs = profiling.records()
    np.testing.assert_array_equal(got[0], want[0])
    stages = ["serve.lf_transform", "serve.posterior", "serve.decode", "serve.copy_back"]
    assert [r["name"] for r in recs] == (["serve.request"] + stages) * 2
    first, second = recs[:5], recs[5:]
    assert {r["id"] for r in first} != {r["id"] for r in second}
    for req in (first, second):
        assert len({r["id"] for r in req}) == 1
        root = recs.index(req[0])
        assert req[0]["parent"] is None
        assert all(r["parent"] == root for r in req[1:])
        # the transform's two copies up and its read, predict's copy up and
        # two reads, the decoder's two copies up, the two copies back
        assert [r["counts"].get("host_reads", 0) for r in req[1:]] == [3, 3, 2, 2]
    assert profiling.totals() == {"host_reads": 20}


def test_fit_spans_group_each_mode():
    from gpras_tpu_torch import GPRAS

    gen = np.random.default_rng(4)
    x = torch.as_tensor(gen.normal(size=(40, 2)))
    y = torch.as_tensor(gen.normal(size=(40, 2)))
    model = GPRAS("RBF", model_type="exact", dtype=torch.float64, device="cpu")
    with _cpu_profile():
        model.fit(x, y, optimization_method="adam", max_iter=2, reject_nonfinite=True)
    recs = profiling.records()
    modes = [i for i, r in enumerate(recs) if r["name"] == "fit.mode"]
    assert len(modes) == 2 and len({recs[i]["id"] for i in modes}) == 2
    for i in modes:
        kids = [r["name"] for r in recs if r["parent"] == i]
        # two Adam steps, each an evaluation and its update, then the closing
        # evaluation and its finite check
        assert kids == ["fit.eval", "fit.adam"] * 3
        assert all(r["id"] == recs[i]["id"] for r in recs if r["parent"] == i)


def test_profiler_trace_writes_the_spans(tmp_path):
    with _cpu_profile():
        with profiling.span("before"):
            pass
    with profiling.profiler_trace(tmp_path):
        with profiling.span("inside"):
            profiling.count("host_reads", 4)
    got = json.loads((tmp_path / "spans.json").read_text())
    assert [r["name"] for r in got["spans"]] == ["inside"]
    assert got["totals"] == {"host_reads": 4}
    assert (tmp_path / "trace.json").is_file()


@pytest.mark.cuda
def test_host_reads_equal_the_synchronizing_calls_on_the_card():
    """On the card the counter equals what the sync debug mode reports, for
    a fit of one mode on the in-place route, an SGPR request and a
    matrix-free exact request (examples/torch_sync_counts.py, smaller)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_sync_counts.py"
    spec = importlib.util.spec_from_file_location("torch_sync_counts", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    got = ex.main(n=18432, cells=4096, sgpr_fields=16, exact_fields=64)
    assert got["fit"]["evals"] == 4
    for phase, c in got.items():
        assert c["host_reads"] == c["sync_warnings"] > 0, (phase, c["sites"])
