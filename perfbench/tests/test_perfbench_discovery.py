"""Everything a cell needs is found by name from BENCHMARK.json, and a new
cell, traffic mix, traffic driver and per-layer metric can be added as
files alone. Each check takes a checkout's root, so that it runs on the
repository and on a copy with files added."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
PB = tiny.REPO / "perfbench"


def _module(path: Path):
    """The module at ``path``, executed under a name of its own and not
    registered, so that a copy's module leaves the repository's alone."""
    name = "perfbench_check_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drivers(root: Path) -> list[str]:
    return sorted(p.stem for p in (root / "perfbench" / "drivers").glob("*.py")
                  if p.stem != "__init__")


def check_configuration(root: Path, conf: dict) -> None:
    """The file is found; each key of its ``limits`` names a driver."""
    cfg = json.loads((root / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert conf["file"].startswith("perfbench/configs/")
    assert set(conf["reduced"]) <= set(cfg)
    assert cfg["limits"] and set(cfg["limits"]) <= set(drivers(root)), cfg["limits"]


def check_cell(root: Path, bench: dict, cell: dict) -> None:
    """The cell's traffic names a driver, whose limits its configuration has."""
    assert cell["config"] in {c["name"] for c in bench["configs"]}
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["driver"] in drivers(root)
    cfg = json.loads((root / next(c["file"] for c in bench["configs"]
                                  if c["name"] == cell["config"])).read_text())
    assert traffic["driver"] in cfg["limits"]


def check_driver(root: Path, name: str) -> None:
    """The driver exposes every function of the protocol."""
    protocol = _module(root / "perfbench" / "drivers" / "__init__.py").PROTOCOL
    mod = _module(root / "perfbench" / "drivers" / f"{name}.py")
    missing = [f for f in protocol if not callable(getattr(mod, f, None))]
    assert not missing, f"{name} lacks {missing}"


def check_metric_reader(root: Path, bench: dict, metric: dict) -> None:
    from perfbench.run import reads

    name = reads(root, metric["name"])
    assert callable(_module(root / "perfbench" / "metrics" / f"{name}.py").read)
    assert metric["moves"] in {m["name"] for m in bench["end_to_end"]}


def check_alias(root: Path, bench: dict, name: str) -> None:
    from perfbench.run import reads

    e2e = {m["name"] for m in bench["end_to_end"]}
    assert name in e2e | {m["name"] for m in bench["per_layer"]}
    target = reads(root, name)
    assert target != name
    assert target in e2e if name in e2e else (
        root / "perfbench" / "metrics" / f"{target}.py").is_file()


def check_cell_reports(bench: dict, cell: dict) -> None:
    """setup_s, another end-to-end metric and a per-layer one that moves
    one of them."""
    from perfbench.run import cell_metrics

    e2e = {m["name"] for m in cell_metrics(bench, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell_metrics(bench, cell["name"], "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)


def aliases(root: Path) -> list[str]:
    return sorted(p.stem for p in (root / "perfbench" / "metrics").glob("*.json"))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_found(conf):
    check_configuration(tiny.REPO, conf)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found(cell):
    check_cell(tiny.REPO, BENCH, cell)


@pytest.mark.parametrize("name", drivers(tiny.REPO))
def test_driver_exposes_the_protocol(name):
    check_driver(tiny.REPO, name)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    check_metric_reader(tiny.REPO, BENCH, metric)


@pytest.mark.parametrize("name", aliases(tiny.REPO))
def test_every_alias_names_a_metric_and_a_reader_or_quantity(name):
    check_alias(tiny.REPO, BENCH, name)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    check_cell_reports(BENCH, cell)


@pytest.mark.parametrize("own", [None, {"n_train": 5, "pool": 3}])
def test_tiny_copy_takes_a_file_s_own_overrides(own, tmp_path):
    path = tmp_path / "file.json"
    path.write_text(json.dumps({"n_train": 49152, "pool": 512,
                                **({} if own is None else {"tiny": own})}))
    tiny.shrink(path, lambda obj: {"n_train": tiny.TINY["n_train"]})
    want = {"n_train": tiny.TINY["n_train"], "pool": 512} if own is None else own
    assert json.loads(path.read_text()) == want


def test_added_cell_traffic_and_metric_run_from_files_alone(tmp_path, monkeypatch, capsys):
    """A dummy traffic mix (a data file), a cell using it and a per-layer
    metric (a reader file) are added to a copy; the harness runs them."""
    tiny.patch_program(monkeypatch)
    root = tiny.make_root(tmp_path)
    (root / "perfbench" / "traffic" / "serve-dummy.json").write_text(json.dumps(
        {"driver": "serve", "about": "dummy", "sizes": [3, 5], "pool": 16, "kept_share": 1.0,
         "trace_seconds": 0.01}))
    (root / "perfbench" / "metrics" / "dummy_fields.py").write_text(
        'def read(ctx):\n'
        '    return float(sum(r["fields"] for r in ctx["requests"]))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy", "config": "sgpr-mat52-n49k",
                               "traffic": "serve-dummy", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fields_per_s":
            m["workloads"].append("dummy")
    bench["per_layer"].append({"name": "dummy_fields", "unit": "fields", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "fields_per_s", "workloads": ["dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result, _ = tiny.run(root, monkeypatch, capsys, "dummy", trace=0)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"setup_s", "fields_per_s"}
    rc, result, _ = tiny.run(root, monkeypatch, capsys, "dummy", trace=1)
    assert rc == 0 and result["metrics"]["dummy_fields"]["value"] >= 3
    assert list(result)[-1] == "checks"


DUMMY_DRIVER = '''"""Closed-loop requests of y = A x in float32, judged by the float64
reference; the control is the reference in TF32."""

import time

import torch

from perfbench.reference.precision import Precision


def setup(cell):
    gen = torch.Generator().manual_seed(cell.seed % (1 << 62))
    n, k = cell.config["n"], cell.traffic["columns"]
    a = torch.randn(n, n, generator=gen, dtype=torch.float64)
    x = torch.randn(n, k, generator=gen, dtype=torch.float64)
    return {"a": a, "x": x, "a32": a.float(), "x32": x.float()}


def run_window(state, seconds):
    requests, t0 = [], time.perf_counter()
    while True:
        t = time.perf_counter()
        y = state["a32"] @ state["x32"]
        requests.append({"columns": y.shape[1], "latency_s": time.perf_counter() - t})
        if time.perf_counter() - t0 >= seconds:
            break
    return {"window_s": time.perf_counter() - t0, "requests": requests, "y": y,
            "attempted": len(requests), "failed": 0}


def end_to_end(state, window):
    return {"fields_per_s": sum(r["columns"] for r in window["requests"]) / window["window_s"]}


def layer_context(state, window):
    return {"requests": window["requests"]}


def _reference(state, precision):
    p = Precision(precision)
    return p.mm(p.cast(state["a"]), p.cast(state["x"])).double()


def _gap(y, ref):
    return {"gap": float((y.double() - ref).abs().max() / ref.abs().max())}


def check(state, window, precision="f64"):
    return _gap(window["y"], _reference(state, precision)), {"requests": len(window["requests"])}


def control_unit(state):
    return run_window(state, 0.0)


def control_readings(state, unit, control):
    ref = _reference(state, "f64")
    out = [("program", _gap(unit["y"], ref), {})]
    if control:
        out.append(("control_tf32", _gap(_reference(state, "tf32"), ref), {}))
    return out
'''


def test_added_driver_runs_and_sets_limits_from_files_alone(tmp_path, monkeypatch, capsys):
    """A traffic driver of its own (a module), its configuration (limits
    under the driver's name), a traffic file, a cell and a per-layer metric
    are added to a copy as files and entries alone: ``run.py`` runs the
    cell, ``control.py`` reads its limits' readings, and every discovery
    check holds on the copy."""
    root = tiny.make_root(tmp_path)
    pb = root / "perfbench"
    (pb / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (pb / "configs" / "dummy-matvec.json").write_text(json.dumps(
        {"name": "dummy-matvec", "n": 64, "limits": {"dummy": {"gap": 1e-5}}}))
    (pb / "traffic" / "dummy-matvec.json").write_text(json.dumps(
        {"driver": "dummy", "about": "a test", "columns": 4, "trace_seconds": 0.01}))
    (pb / "metrics" / "dummy_requests.py").write_text(
        'def read(ctx):\n'
        '    return float(len(ctx["requests"]))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-matvec", "source": "a test",
                             "file": "perfbench/configs/dummy-matvec.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy", "config": "dummy-matvec",
                               "traffic": "dummy-matvec", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "fields_per_s")["workloads"].append(
        "dummy")
    bench["per_layer"].append({"name": "dummy_requests", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "fields_per_s",
                               "workloads": ["dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, result, err = tiny.run(root, monkeypatch, capsys, "dummy", trace=0)
    assert rc == 0 and result["correct"] is True, err[-2000:]
    assert set(result["metrics"]) == {"setup_s", "fields_per_s"}
    assert list(result)[-1] == "checks" and set(result["checks"]) == {"gap"}
    rc, result, err = tiny.run(root, monkeypatch, capsys, "dummy", trace=1)
    assert rc == 0 and result["correct"] is True, err[-2000:]
    assert result["metrics"]["dummy_requests"]["value"] >= 1

    from perfbench import compare

    control = tiny.load_control(root, monkeypatch)
    lines = {r["reading"]: r for r in control.readings(root, "dummy", 2**31 + 5, "cpu", True)}
    assert set(lines) == {"program", "control_tf32"}
    limits = {"gap": 1e-5}
    assert compare.judge(lines["program"], limits)[0], lines["program"]
    assert not compare.judge(lines["control_tf32"], limits)[0], lines["control_tf32"]

    for conf in bench["configs"]:
        check_configuration(root, conf)
    for cell in bench["workloads"]:
        check_cell(root, bench, cell)
        check_cell_reports(bench, cell)
    assert "dummy" in drivers(root)
    for name in drivers(root):
        check_driver(root, name)
    for metric in bench["per_layer"]:
        check_metric_reader(root, bench, metric)
    for name in aliases(root):
        check_alias(root, bench, name)
