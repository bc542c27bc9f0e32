"""Time B3 (``fused_gram.kmv_sym``) against the builds its plan turns down.

At the serving shapes (N = 49,152 training points, D = 8, chip_smoke.py's
random inputs) this times, for each right-hand-side count R, the build
``kmv_sym_plan`` picks and the alternative it rejects, in the same process:
at R up to 16 the tensor-core build (every entry, both halves of the square)
against the symmetric one; above 16 the other split of the column sweep
(1 against 2). Each result is held against the plain version in float64,
and the CUDA grids of a call are the ones the kernel's entry point counts.
``--sass`` also prints, per B3 kernel of the chosen covariance, its registers
and spills (ptxas) and its SASS instruction mix (cuobjdump), the evidence
for what bounds a build. chip_smoke.py times only the planned builds.

Run from the repository root, on the GPU:

    python examples/torch_kmv_sym_timing.py --r 1 64 256 --sass

Prints the card's name and power limit, then one line per (R, build).
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KERNEL_IDS = {"RBF": 0, "Matern12": 1, "Matern32": 2, "Matern52": 3, "Exponential": 4}


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def sass_report(kernel: str, names: tuple[str, ...] = ("kmv_tc", "kmv_sym_tiles")) -> None:
    """Registers, spills and the SASS opcode mix of the kernels whose names
    contain one of ``names`` (B3's by default), instantiated for ``kernel``."""
    from gpras_tpu_torch.ops import _build

    path, log = _build.build()
    log = log or path.with_suffix(".log").read_text()
    tag = f"ILi{KERNEL_IDS[kernel]}E"
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and tag in name and any(w in name for w in names) and (
                "registers" in line or "spill" in line):
            print(f"[ptxas] {name[40:90]}: {line.split(':', 1)[-1].strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        fname = func.split("\n", 1)[0]
        if tag not in fname or not any(w in fname for w in names):
            continue
        ops = collections.Counter(
            m.group(2).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,6}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", func))
        print(f"[sass] {fname[40:90]}: {sum(ops.values())} instructions, "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(16)))


def main() -> int:
    import torch

    from gpras_tpu_torch.ops import fused_gram

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=49_152)
    ap.add_argument("--r", type=int, nargs="+", default=[1, 64, 256])
    ap.add_argument("--kernel", default="Matern52", choices=sorted(KERNEL_IDS))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--sass", action="store_true", help="print ptxas and SASS statistics")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kmv_sym_timing: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.sass:
        sass_report(args.kernel)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    d = 8
    params = {"log_variance": torch.tensor(0.0, device=dev),
              "log_lengthscales": torch.log(torch.tensor([1.0, 0.6, 0.35] + [10.0] * (d - 3),
                                                         device=dev))}
    p64 = {k: v.double() for k, v in params.items()}
    x = torch.randn(args.n, d, generator=gen).to(dev)
    noise = torch.tensor(1e-2, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r in args.r:
        v = torch.randn(args.n, r, generator=gen).to(dev)
        want = fused_gram.kmv_plain(args.kernel, p64, x.double(), v.double(), noise=1e-2)
        planned = fused_gram.kmv_sym_plan(args.n, d, r, sms)
        other = (fused_gram._tc_plan(args.n, d, r, 3 - planned.splits) if planned.tc
                 else fused_gram._tc_plan(args.n, d, r, 1))
        builds = {"planned": planned, "rejected": other}
        runs = {tag: functools.partial(fused_gram._kmv_sym_run, plan, args.kernel, params, x, v,
                                       noise) for tag, plan in builds.items()}
        checked = {}
        for tag, run in runs.items():
            calls, grids = fused_gram.kmv_sym.launches, fused_gram.kmv_sym.grids
            got = run()
            grids = (fused_gram.kmv_sym.grids - grids) // (fused_gram.kmv_sym.launches - calls)
            checked[tag] = (grids, ((got.double() - want).abs().max() / want.abs().max()).item())
        # timed in the order planned, rejected, rejected, planned
        times = {tag: [] for tag in runs}
        for tag in ("planned", "rejected", "rejected", "planned"):
            times[tag].append(cuda_ms(runs[tag], args.reps))
        for tag, plan in builds.items():
            build = f"tensor-core, sweep split {plan.splits}" if plan.tc else "symmetric"
            print(f"{args.kernel} N={args.n} R={r} {tag} ({build}): "
                  + " / ".join(f"{t:.3f}" for t in times[tag])
                  + f" ms, error {checked[tag][1]:.3e} of the scale, {checked[tag][0]} grids",
                  flush=True)
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
