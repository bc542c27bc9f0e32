"""The readers of the program's own spans and counters: each fed a record
list made here, and each None where there is nothing to read (no program
spans, or none of the kind it reads); then each cell traced at a tiny size
on the CPU, where every new metric but the device-timed one is read."""

from __future__ import annotations

import json
import types

import pytest

from perfbench import work
from perfbench.metrics import _spans
from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
PB = tiny.REPO / "perfbench"
N = 49152


def _reader(name):
    from perfbench.run import _load

    return _load(PB / "metrics" / f"{name}.py", f"perfbench.metrics.{name}")


def _span(name, ms=0.0, device_s=None, start=0):
    return {"name": name, "id": 0, "parent": None, "start_ns": start,
            "end_ns": start + int(ms * 1e6), "counts": {}, "device_s": device_s}


def _ctx():
    return {"cell": types.SimpleNamespace(config={"n_train": N})}


def _serve_spans():
    spans = []
    for t, lf, post, dec, back in ((0, 4.0, 9.0, 6.0, 3.0), (10**9, 6.0, 11.0, 8.0, 5.0)):
        spans += [_span("serve.request", 30.0, start=t), _span("serve.lf_transform", lf),
                  _span("serve.posterior", post), _span("serve.decode", dec),
                  _span("serve.copy_back", back)]
    return spans


CASES = [
    ("factor_roofline.fit",
     [_span("fit.eval"), _span("fit.factor", device_s=1.0), _span("fit.factor", device_s=3.0)],
     {}, 100.0 * 2 * N ** 3 / 3 / 4.0 / work.COMPUTE_RATE),
    ("host_reads_per_eval.fit", [_span("fit.eval")] * 4, {"host_reads": 402}, 100.5),
    ("cg_live_share.serve", [], {"cg.column_iters": 512, "cg.live_column_iters": 384}, 75.0),
    ("lf_transform_ms.sgpr_serve", _serve_spans(), {}, 5.0),
    ("posterior_ms.sgpr_serve", _serve_spans(), {}, 10.0),
    ("decode_ms.sgpr_serve", _serve_spans(), {}, 7.0),
    ("copy_back_ms.sgpr_serve", _serve_spans(), {}, 4.0),
]


@pytest.mark.parametrize("name,spans,totals,want", CASES, ids=[c[0] for c in CASES])
def test_reader_reads_the_records(name, spans, totals, want, monkeypatch):
    monkeypatch.setattr(_spans, "program", lambda: (spans, totals))
    assert _reader(name).read(_ctx()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_is_none_with_nothing_to_read(name, monkeypatch):
    reader = _reader(name)
    monkeypatch.setattr(_spans, "program", lambda: None)
    assert reader.read(_ctx()) is None
    monkeypatch.setattr(_spans, "program", lambda: ([_span("other", 1.0)], {"other": 1}))
    assert reader.read(_ctx()) is None


def test_factor_roofline_needs_device_times(monkeypatch):
    monkeypatch.setattr(_spans, "program", lambda: ([_span("fit.factor", 1.0)], {}))
    assert _reader("factor_roofline.fit").read(_ctx()) is None


def test_program_without_spans_gives_none(monkeypatch):
    from gpras_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert _spans.program() is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_each_new_metric_is_declared_with_its_cells(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["source"] in ("program_span", "program_counter")
    assert entry["workloads"] and all(
        w in {c["name"] for c in BENCH["workloads"]} for w in entry["workloads"])


@pytest.mark.parametrize("cell,names", [
    ("exact49k-fit", ["host_reads_per_eval.fit"]),
    ("exact49k-serve", ["cg_live_share.serve"]),
    ("sgpr49k-serve", ["lf_transform_ms.sgpr_serve", "posterior_ms.sgpr_serve",
                       "decode_ms.sgpr_serve", "copy_back_ms.sgpr_serve"]),
])
def test_traced_tiny_run_reports_the_program_metrics(cell, names, tmp_path, monkeypatch,
                                                     capsys):
    from gpras_tpu_torch.utils import profiling

    tiny.patch_program(monkeypatch)
    profiling.clear()
    rc, result, err = tiny.run(tiny.make_root(tmp_path), monkeypatch, capsys, cell, trace=1)
    assert rc == 0, err
    for name in names:
        assert result["metrics"][name]["value"] > 0
    if cell == "exact49k-serve":
        assert result["metrics"]["cg_live_share.serve"]["value"] <= 100.0
    assert "factor_roofline.fit" not in result["metrics"]  # no device times on the CPU
