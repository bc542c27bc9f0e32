"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

For each seed of ``--seeds``: the cell's set-up, then one unit of its
traffic (the driver's ``control_unit``), and the numbers that ``run.py``
compares, against the float64 reference: the program's readings, whose
largest is a limit's lower reading. For each seed of ``--control-seeds``
besides: the control, the reference computed one precision lower
(``tf32``, reference/precision.py) and put in the program's place, whose
smallest reading is the upper one, and the faults the driver plants in the
reference (``control_readings``, drivers/__init__.py). The benchmark's own
runs do not run this. One JSON line per seed and reading on standard
output; ``--out`` appends them to a file too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)


def readings(root: Path, workload: str, seed: int, device: str, control: bool) -> list[dict]:
    from perfbench.run import driver, load_cell

    cell, _, _ = load_cell(root, workload, seed, device)
    drv = driver(root, cell.traffic["driver"])
    t0 = time.perf_counter()
    state = drv.setup(cell)
    unit = drv.control_unit(state)
    tag = {"workload": workload, "seed": seed}
    out = [{**tag, "reading": reading, **numbers, **extra}
           for reading, numbers, extra in drv.control_readings(state, unit, control)]
    for o in out:
        o["seconds"] = time.perf_counter() - t0
    return out


def main(argv: list[str] | None = None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    from perfbench import run

    run._environment(root)
    import torch

    device = run.require_device(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    for seed in seeds:
        for line in readings(root, args.workload, seed, device, seed in args.control_seeds):
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with args.out.open("a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
