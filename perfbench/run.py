"""The benchmark of gpras_tpu_torch: one cell, one run, one result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration is the file that ``configs`` names, its
traffic ``perfbench/traffic/<traffic>.json``, whose ``driver`` names a module
of ``perfbench/drivers/``; each per-layer metric is read by
``perfbench/metrics/<name>.py`` and each end-to-end metric is the driver's
quantity of its name, unless ``perfbench/metrics/<name>.json`` names another
reader or quantity under ``reads``. Set-up makes the inputs from the seed and
warms up; the window runs the traffic for ``--seconds`` (with ``--trace 1``
for the traffic's ``trace_seconds``, under the profiler); then the program's
state is freed and what the window produced is compared with the plain
reference under ``perfbench/reference/``. The last line of standard output
is the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, last, ``checks``: each compared number beside its limit,
which also end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this directory is sys.path[0]; its modules (trace, data)
# must not shadow others of those names: the checkout's root takes its place
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)
BANNED = ("jax", "jaxlib", "flax", "gpras_tpu")


def _environment(root: Path) -> None:
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds; few host threads."""
    cache = root / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "4"


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    device: str


def require_device(chips: int) -> str:
    """The device the run uses; exits when the cell's chips are not there."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(2)
    return "cuda"


def workload_entry(bench: dict, workload: str) -> dict:
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
    return entry


def load_cell(root: Path, workload: str, seed: int, device: str) -> tuple[Cell, dict, dict]:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = workload_entry(bench, workload)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(workload, config, traffic, seed, device), entry, bench


def driver(root: Path, name: str):
    return _load(root / "perfbench" / "drivers" / f"{name}.py", f"perfbench.drivers.{name}")


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those that list it, and those without a list whose moved
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in cell_metrics(bench, workload, "end_to_end")} \
        if kind == "per_layer" else set()
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reads(root: Path, name: str) -> str:
    """What the metric ``name`` reads: the per-layer reader module or the
    driver's end-to-end quantity that ``perfbench/metrics/<name>.json``
    names (a metric whose cells need a bound of their own carries a shared
    quantity under its own name), else ``name`` itself."""
    alias = root / "perfbench" / "metrics" / f"{name}.json"
    return json.loads(alias.read_text())["reads"] if alias.is_file() else name


def _finite(obj):
    """The result with non-finite numbers (a failed comparison's) as null,
    so that the line is strict JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def main(argv: list[str] | None = None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(root)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))

    import torch

    bench = json.loads((root / "BENCHMARK.json").read_text())
    device = require_device(workload_entry(bench, args.workload)["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    import gpras_tpu_torch  # noqa: F401  (the program; fails where it is absent)

    from perfbench import compare
    from perfbench.trace import DeviceTrace

    cell, entry, bench = load_cell(root, args.workload, args.seed, device)
    drv = driver(root, cell.traffic["driver"])
    t0 = time.perf_counter()
    state = drv.setup(cell)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    trace = None
    if args.trace:
        trace = DeviceTrace(device)
        with trace.window():
            window = drv.run_window(state, min(args.seconds, cell.traffic["trace_seconds"]))
    else:
        window = drv.run_window(state, args.seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    metrics = {}
    if args.trace:
        ctx = {"cell": cell, "trace": trace, "window": window,
               **drv.layer_context(state, window)}
        for m in cell_metrics(bench, args.workload, "per_layer"):
            name = reads(root, m["name"])
            reader = _load(root / "perfbench" / "metrics" / f"{name}.py",
                           f"perfbench.metrics.{name}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = drv.end_to_end(state, window)
        e2e["setup_s"] = setup_s
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            value = e2e.get(reads(root, m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = banned_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3

    t_check = time.perf_counter()
    numbers, about = drv.check(state, window)
    about["check_s"] = time.perf_counter() - t_check
    correct, checks = compare.judge(numbers, cell.config["limits"][cell.traffic["driver"]])
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    print(f"perfbench: {args.workload} seed {args.seed}: {json.dumps(about)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"perfbench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
