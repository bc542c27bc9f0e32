"""Time B5 (``fused_gram.kgrad_sym``), B4 (``fused_gram.kgrad_dense``) and
B2 (``fused_gram.kmv_dense``) against the designs they replaced, and a
wrapper call against its grids.

At the training path's shape (N = 49,152 points, D = 8, m = 16 probes,
chip_smoke.py's random inputs) this times B5's strips (csrc/kgrad_sym.cu, as
``kgrad_sym_plan`` plans them, and at other segment lengths with ``--per``)
against its first port, one block per upper tile (csrc/kgrad.cu), in the
same process and in turns: first port, strips, strips, first port. At
B4's path shape (N = 3,072) it times B4's strips (``kgrad_dense_plan``'s:
an even share of B5's folded walk per block) against its first port, one
block per tile (csrc/kgrad.cu), in turns. At the serving shapes (64 and 256 queries
against N points, R = 1) it times B2's rows design (``kmv_dense_plan``'s, and at other depths with ``--depth``)
against the tiled design at the same shape, and ``torch.matmul`` on a Gram
built once by B1. Times are of the CUDA grids alone: many launches of the
prepared call between two CUDA events. For the planned designs and for B4
(N = 3,072) it also prints the whole wrapper call, one call between two
events as chip_smoke.py times it, many calls between two events, and the
host's clock per call. Every result is held against the plain version in
float64. ``--ptxas`` prints registers and spills of those kernels and their
SASS instruction mix (the static count of each opcode: what a tile or a stage
costs in issue slots); ``--profile`` runs twenty B4 and twenty B2 wrapper
calls under torch.profiler and prints the device's kernels, busy time and
idle share.

Run from the repository root, on the GPU:

    python examples/torch_kgrad_timing.py --ptxas --profile

Prints the card's name and power limit, then one line per timing.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KERNEL_IDS = {"RBF": 0, "Matern12": 1, "Matern32": 2, "Matern52": 3, "Exponential": 4}


def events_ms(fn, calls: int, reps: int = 5) -> float:
    """Median device time per call of ``fn`` in ms, ``calls`` calls between
    two CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def host_us(fn, calls: int) -> float:
    """Host clock per call of ``fn`` in microseconds (the enqueue, not the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def whole_call(name: str, fn, calls: int) -> None:
    print(f"{name}: whole wrapper call {events_ms(fn, 1, 7):.4f} ms (one call per event pair), "
          f"{events_ms(fn, calls):.4f} ms ({calls} per pair), host clock "
          f"{host_us(fn, calls):.1f} us per call", flush=True)


def ptxas_report(kernel: str) -> None:
    """Registers, spills and the SASS opcode mix of B2's, B4's and B5's kernels for
    ``kernel`` (examples/torch_kmv_sym_timing.py's report, other names)."""
    from torch_kmv_sym_timing import sass_report

    sass_report(kernel, ("kgrad_strips_kernel", "kgrad_kernel", "kmv_rows_kernel",
                         "kmv_dense_kernel"))


def profile_calls(name: str, whole, calls: int = 20) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    whole()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            whole()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    if not events:
        print("[profile] torch.profiler recorded no device event")
        return
    busy = sum(e.time_range.end - e.time_range.start for e in events)
    span = events[-1].time_range.end - events[0].time_range.start
    print(f"[profile] {calls} {name} calls: {len(events) / calls:.1f} device kernels per call, "
          f"span {span:.1f} us, busy {busy:.1f} us, idle share {1 - busy / span:.3f}")
    for e in events[:len(events) // calls]:
        print(f"[profile]   {e.name[:80]:80s} {e.time_range.end - e.time_range.start:8.1f} us")


def main() -> int:
    import torch

    from gpras_tpu_torch.ops import fused_gram

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=49_152)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--kernel", default="Matern52", choices=sorted(KERNEL_IDS))
    ap.add_argument("--per", type=int, nargs="*", default=[],
                    help="B5: other segment lengths (tiles per block) to time")
    ap.add_argument("--depth", type=int, nargs="*", default=[],
                    help="B2: other values of ROWS_DEPTH (blocks wanted per SM) to time")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers, spills and the SASS instruction mix")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler on 20 B4 calls and on 20 B2 calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kgrad_timing: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.ptxas:
        ptxas_report(args.kernel)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n, m, d, kernel = args.n, args.m, 8, args.kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    params = {"log_variance": torch.tensor(0.0, device=dev),
              "log_lengthscales": torch.log(torch.tensor([1.0, 0.6, 0.35] + [10.0] * (d - 3),
                                                         device=dev))}
    p64 = {k: v.double() for k, v in params.items()}

    def flat(grads):
        return torch.cat([grads["log_variance"].reshape(1), grads["log_lengthscales"]])

    # ---- B5 (and B4 at 3,072 points)
    for nn, sym in ((3072, False), (n, True)):
        x = torch.randn(nn, d, generator=gen).to(dev)
        w = torch.randn(nn, m, generator=gen).to(dev)
        z = (2 * torch.randint(0, 2, (nn, m), generator=gen) - 1).float().to(dev)
        alpha = torch.randn(nn, generator=gen).to(dev)
        want = flat(fused_gram.kgrad_plain(kernel, p64, x.double(), w.double(), z.double(),
                                           alpha.double(), 1.3, 1.0 / m))
        common = (kernel, params, x, w, z, alpha, 1.3, 1.0 / m)
        fn = fused_gram.kgrad_sym if sym else fused_gram.kgrad_dense
        calls = 5 if sym else 200
        whole_call(f"{fn.__name__} {kernel} N={nn} m={m}", lambda: fn(*common), calls)
        if args.profile and not sym:
            profile_calls("kgrad_dense", lambda: fn(*common))
        builds = {"planned": fused_gram._kgrad_cuda(sym, *common)}
        builds["first port (a block per tile)"] = fused_gram._kgrad_cuda(sym, *common,
                                                                         tiles=True)
        if not sym:
            print(f"kgrad_dense plan: {fused_gram.kgrad_dense_plan(nn, d, m, sms)}")
        else:
            for per in args.per:
                plan = fused_gram.kgrad_sym_plan(nn, d, m, sms, per=per)
                builds[f"per={plan.per} segs={plan.segs}"] = fused_gram._kgrad_cuda(
                    True, *common, plan=plan)
            print(f"kgrad_sym plan: {fused_gram.kgrad_sym_plan(nn, d, m, sms)}")
        errs, times = {}, {tag: [] for tag in builds}
        for tag, (launch, out) in builds.items():
            assert launch() == 0
            errs[tag] = ((out.double() - want).abs().max() / want.abs().max()).item()
        order = list(builds)
        for tag in order + order[::-1]:  # in turns: a, b, ..., b, a
            times[tag].append(events_ms(builds[tag][0], calls))
        for tag in builds:
            print(f"{fn.__name__} {kernel} N={nn} m={m} {tag}: grids alone "
                  + " / ".join(f"{t:.4f}" for t in times[tag])
                  + f" ms, error {errs[tag]:.3e} of the scale", flush=True)
        del want, builds

    # ---- B2 at the serving shapes
    x2 = torch.randn(n, d, generator=gen).to(dev)
    v = torch.randn(n, 1, generator=gen).to(dev)
    for n1 in (64, 256):
        x1 = torch.randn(n1, d, generator=gen).to(dev)
        want = fused_gram.kmv_plain(kernel, p64, x1.double(), v.double(), x2=x2.double())
        common = (kernel, params, x1, v, x2, None)
        whole = lambda: fused_gram.kmv_dense(kernel, params, x1, v, x2=x2)  # noqa: E731
        whole_call(f"kmv_dense {kernel} {n1}x{n} R=1", whole, 200)
        planned = fused_gram.kmv_dense_plan(n1, n, 1, sms)
        tiles2 = -(-n // fused_gram.TILE)
        tile_splits = max(1, min(tiles2, -(-2 * sms // -(-n1 // fused_gram.TILE))))
        builds = {f"planned {planned}": fused_gram._kmv_dense_cuda(*common),
                  "tiled design": fused_gram._kmv_dense_cuda(
                      *common, plan=fused_gram.KmvPlan(False, tile_splits, tile_splits * n1, 2,
                                                  fused_gram.kmv_dense_smem(False, d, 1)))}
        for depth in args.depth:
            per = -(-tiles2 // -(-depth * sms // -(-n1 // fused_gram.TILE)))
            splits = -(-tiles2 // per)
            builds[f"rows depth={depth} splits={splits}"] = fused_gram._kmv_dense_cuda(
                *common, plan=fused_gram.KmvPlan(True, splits, splits * n1, 2,
                                        fused_gram.kmv_dense_smem(True, d, 1)))
        errs, times = {}, {tag: [] for tag in builds}
        for tag, (launch, out) in builds.items():
            assert launch() == 0
            errs[tag] = ((out.double() - want).abs().max() / want.abs().max()).item()
        order = list(builds)
        for tag in order + order[::-1]:
            times[tag].append(events_ms(builds[tag][0], 200))
        for tag in builds:
            print(f"kmv_dense {kernel} {n1}x{n} R=1 {tag}: grids alone "
                  + " / ".join(f"{t:.4f}" for t in times[tag])
                  + f" ms, error {errs[tag]:.3e} of the scale", flush=True)
        kmat = fused_gram.gram(kernel, params, x1, x2)
        lib = lambda: torch.matmul(kmat, v)  # noqa: E731
        print(f"kmv_dense {kernel} {n1}x{n} R=1 library (torch.matmul on a prebuilt Gram): "
              f"{events_ms(lib, 1, 7):.4f} ms (one call per event pair), "
              f"{events_ms(lib, 200):.4f} ms (200 per pair)", flush=True)
        if args.profile and n1 == 256:
            profile_calls("kmv_dense", whole)
        del kmat, builds
    return 0


if __name__ == "__main__":
    sys.exit(main())
