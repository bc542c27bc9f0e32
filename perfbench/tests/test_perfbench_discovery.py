"""Everything a cell needs is found by name from BENCHMARK.json, and a new
cell, traffic mix and per-layer metric can be added as files alone."""

from __future__ import annotations

import json

import pytest

from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
PB = tiny.REPO / "perfbench"


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_found(conf):
    cfg = json.loads((tiny.REPO / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert conf["file"].startswith("perfbench/configs/")
    assert set(conf["reduced"]) <= set(cfg)
    assert {"fit", "serve"} >= set(cfg["limits"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found(cell):
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "drivers" / f"{traffic['driver']}.py").is_file()
    cfg = json.loads((tiny.REPO / next(c["file"] for c in BENCH["configs"]
                                       if c["name"] == cell["config"])).read_text())
    assert traffic["driver"] in cfg["limits"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    from perfbench.run import _load, reads

    name = reads(tiny.REPO, metric["name"])
    mod = _load(PB / "metrics" / f"{name}.py", f"perfbench.metrics.{name}")
    assert callable(mod.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", sorted(p.stem for p in (PB / "metrics").glob("*.json")))
def test_every_alias_names_a_metric_and_a_reader_or_quantity(name):
    from perfbench.run import reads

    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert name in e2e | {m["name"] for m in BENCH["per_layer"]}
    target = reads(tiny.REPO, name)
    assert target != name
    assert target in e2e if name in e2e else (PB / "metrics" / f"{target}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    from perfbench.run import cell_metrics

    e2e = {m["name"] for m in cell_metrics(BENCH, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell_metrics(BENCH, cell["name"], "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)


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
