"""The control (the reference one precision lower, TF32, put in the
program's place) comes out not correct, and the program correct, at a size
a test run holds; on the card the same readings are taken at the cells'
own sizes by ``perfbench/control.py``."""

from __future__ import annotations

import json

import pytest

from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_program_passes(cell, tmp_path, monkeypatch):
    tiny.patch_program(monkeypatch)
    root = tiny.make_root(tmp_path)
    control = tiny.load_control(root, monkeypatch)
    from perfbench import compare

    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = cfg["limits"][traffic["driver"]]
    lines = {r["reading"]: r for r in control.readings(root, cell, 2**31 + 5, "cpu", True)}
    assert compare.judge(lines["program"], limits)[0], lines["program"]
    assert not compare.judge(lines["control_tf32"], limits)[0], lines["control_tf32"]
    if "fault_half_rows" in lines:
        assert not compare.judge(lines["fault_half_rows"], limits)[0]
