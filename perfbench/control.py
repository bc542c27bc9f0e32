"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

For each seed of ``--seeds``: the cell's set-up, then one full fit call for a
fit cell or one request for a serving cell, and the numbers that ``run.py`` compares, against
the float64 reference: the program's readings, whose largest is a limit's
lower reading. For each seed of ``--control-seeds`` besides: the control,
the reference computed one precision lower (``tf32``, reference/precision.py)
and put in the program's place, whose smallest reading is the upper one;
and, for training cells, the fault of half of the data left out (the
reference on the first N / 2 rows in the program's place). The benchmark's
own runs do not run this. One JSON line per seed and reading on standard
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
    import numpy as np
    import torch

    from perfbench import compare
    from perfbench.run import driver, load_cell

    cell, _, _ = load_cell(root, workload, seed, device)
    drv = driver(root, cell.traffic["driver"])
    t0 = time.perf_counter()
    state = drv.setup(cell)
    window = ({"last": drv.fit_call(state)} if cell.traffic["driver"] == "fit"
              else drv.run_window(state, 0.0))
    out = []
    tag = {"workload": workload, "seed": seed}
    if cell.traffic["driver"] == "fit":
        modes = list(range(cell.config["hf_modes"]))
        prog = drv.program_readings(window["last"], modes, drv.FOLLOWED)
        state["model"] = state["observer"] = None
        if device == "cuda":
            torch.cuda.empty_cache()
        start = {m: {k: v[m] for k, v in state["start"].items()} for m in modes}
        ref = drv.follow_reference(state, modes, "f64")
        out.append({**tag, "reading": "program", **compare.fit_numbers(prog, ref, start),
                    "leaves": compare.fit_detail(prog, ref, start)})
        if control:
            ctrl = drv.follow_reference(state, modes, "tf32")
            out.append({**tag, "reading": "control_tf32", **compare.fit_numbers(ctrl, ref, start),
                        "leaves": compare.fit_detail(ctrl, ref, start)})
            half = drv.follow_reference(state, modes, "f64", rows=state["x"].shape[0] // 2)
            out.append({**tag, "reading": "fault_half_rows",
                        **compare.fit_numbers(half, ref, start)})
    else:
        state["pred"] = None
        if device == "cuda":
            torch.cuda.empty_cache()
        rows = np.unique(np.concatenate([np.arange(o, o + k) for o, k, _, _ in window["kept"]]))
        where = {r: i for i, r in enumerate(rows.tolist())}
        field, fvar, hf = drv.reference_fields(state, rows, "f64")
        args = (hf.wet.cpu().numpy(), hf.elevation.cpu().numpy(), hf.mean_field().cpu().numpy())

        def served(f_of):
            return [(*f_of(off, k, f, v), field[[where[r] for r in range(off, off + k)]],
                     fvar[[where[r] for r in range(off, off + k)]])
                    for off, k, f, v in window["kept"]]

        out.append({**tag, "reading": "program",
                    **compare.serve_numbers(served(lambda o, k, f, v: (f, v)), *args)})
        if control:
            cf, cv, _ = drv.reference_fields(state, rows, "tf32")
            out.append({**tag, "reading": "control_tf32", **compare.serve_numbers(
                served(lambda o, k, f, v: (cf[[where[r] for r in range(o, o + k)]],
                                           cv[[where[r] for r in range(o, o + k)]])), *args)})
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
