"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: module names are compared whole,
by their top-level part (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from perfbench.tests import tiny

PB = tiny.REPO / "perfbench"
FILES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts[len(PB.parts):])
BANNED = {"jax", "jaxlib", "flax", "gpras_tpu"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_the_reference_stays_apart(path):
    names = top_level_imports(path)
    assert not names & BANNED, names & BANNED
    if "reference" in path.parts:
        assert "gpras_tpu_torch" not in names
        assert names <= {"__future__", "math", "torch", "collections", "perfbench"}


DRIVERS = sorted(p.stem for p in (PB / "drivers").glob("*.py") if p.stem != "__init__")


def test_modules_loaded_by_the_reference_and_the_harness():
    drivers = "".join(f"perfbench.drivers.{d}, " for d in DRIVERS)
    code = ("import sys, perfbench.reference.exact, perfbench.reference.sgpr, "
            "perfbench.reference.eof, perfbench.reference.adam\n"
            "assert not {m.split('.')[0] for m in sys.modules} & "
            "{'gpras_tpu_torch', 'gpras_tpu', 'jax'}, 'reference'\n"
            f"import perfbench.run, {drivers}perfbench.control, gpras_tpu_torch\n"
            "found = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gpras_tpu'}\n"
            "assert not found, found\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
