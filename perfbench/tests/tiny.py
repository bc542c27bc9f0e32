"""A checkout of the benchmark at a tiny size, for the CPU tests: a copy of
BENCHMARK.json and perfbench/ in a temporary root, with every
configuration and traffic file shrunk, and the program imported from the
repository."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# A file without a ``tiny`` object of its own has these keys shrunk where it
# has them; a traffic file's sizes given as a list (fixed sizes) become [8].
TINY = {"n_train": 384, "grid": [12, 16], "eof_events": 40, "n_inducing": 24}
TINY_TRAFFIC = {"pool": 24, "sizes": {"from": 1, "to": 6}}


def _tiny_config(cfg: dict) -> dict:
    return {k: v for k, v in TINY.items() if k in cfg}


def _tiny_traffic(tr: dict) -> dict:
    out = {k: v for k, v in TINY_TRAFFIC.items() if k in tr}
    if isinstance(tr.get("sizes"), list):
        out["sizes"] = [8]
    return out


def shrink(path: Path, rule) -> None:
    """Rewrites the JSON file ``path`` at its CPU size: its own ``tiny``
    object of overrides where it has one, else ``rule``'s."""
    obj = json.loads(path.read_text())
    own = obj.pop("tiny", None)
    obj.update(rule(obj) if own is None else own)
    path.write_text(json.dumps(obj))


def make_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "perfbench" / "configs").glob("*.json"):
        shrink(path, _tiny_config)
    for path in (root / "perfbench" / "traffic").glob("*.json"):
        shrink(path, _tiny_traffic)
    return root


def patch_program(monkeypatch) -> None:
    """At the tiny size the exact model takes the engines of the full size:
    the Hutchinson engine and matrix-free CG (thresholds lowered)."""
    from gpras_tpu_torch import GPRAS

    monkeypatch.setattr(GPRAS, "LEAN_THRESHOLD", 64)
    monkeypatch.setattr(GPRAS, "SUPER_THRESHOLD", 128)
    monkeypatch.setattr(GPRAS, "CG_THRESHOLD", 1 << 30)


def run(root: Path, monkeypatch, capsys, workload: str, seed: int = 7, seconds: float = 0.01,
        trace: int = 0) -> tuple[int, dict | None, str]:
    """Runs one cell on the CPU; (exit code, result line or None, stderr)."""
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location("perfbench_run_tiny",
                                                  root / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "require_device", lambda chips: "cpu")
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m == "perfbench" or m.startswith("perfbench.")]:
        monkeypatch.delitem(sys.modules, name)
    rc = mod.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.strip()]
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, out.err


def load_control(root: Path, monkeypatch):
    """``perfbench/control.py`` of the checkout ``root``, loaded with that
    checkout's ``perfbench`` first on the path."""
    import importlib.util
    import sys

    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m == "perfbench" or m.startswith("perfbench.")]:
        monkeypatch.delitem(sys.modules, name)
    spec = importlib.util.spec_from_file_location("perfbench_control_tiny",
                                                  root / "perfbench" / "control.py")
    control = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, control)
    spec.loader.exec_module(control)
    return control
