"""On the card: each cell runs with a short window and comes out correct,
with the result line the contract asks for. Skips without a CUDA device."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "2147483653", "--seconds", "1", "--trace", "0"], cwd=tiny.REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert "setup_s" in result["metrics"] and list(result)[-1] == "checks"


def test_run_without_a_card_exits_without_a_result():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', 'sgpr49k-serve', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']; sys.path.insert(0, '.'); import perfbench.run as r; "
            "sys.exit(r.main())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_without_the_program_exits_without_a_result(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; sys.argv = ['run.py', '--workload', "
            "'sgpr49k-serve', '--seed', '1', '--seconds', '1', '--trace', '0']; "
            "sys.path.insert(0, '.'); import perfbench.run as r; sys.exit(r.main())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "gpras_tpu_torch" in out.stderr
