"""Time B1 (``fused_gram.gram``), the training Gram, against its first design
and against the card's store ceiling.

At the training path's shape (N = 49,152 points, D = 8, noise on the
diagonal, chip_smoke.py's random inputs) this times the symmetric design
(csrc/gram.cu's gram_sym_kernel, as ``gram_plan`` plans it, and at other
block counts with ``--per-sm``) against the first design, a block per 64 x 128
tile of the whole square (``fused_gram._gram_cuda(..., tiles=True)``), and
against ``torch.empty(N, N).fill_(1.0)``: the same 9.66 GB written by a
library kernel that computes nothing, the store ceiling (not a library call
for the same function: none computes a stationary covariance). In the same
process and in turns: first design, symmetric, fill, fill, symmetric, first
design. Times are of the CUDA grids alone, five launches of the prepared
call between two CUDA events, after an untimed one; the whole wrapper call
is timed one call per event pair, as chip_smoke.py times it. The two
designs' outputs are compared bit for bit. ``--cross`` also times the cross
Gram of x and a copy of x (every tile computed, no mirror). ``--ptxas``
prints registers and spills of both designs' kernels and their SASS
instruction mix; ``--profile`` runs five B1 wrapper calls under
torch.profiler and prints the device's kernels per call, busy time and idle
share.

Run from the repository root, on the GPU:

    python examples/torch_gram_timing.py --ptxas --profile

Prints the card's name and power limit, then one line per timing.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_kgrad_timing import KERNEL_IDS, events_ms  # noqa: E402

HBM_BYTES_S = 3.35e12  # the card's published memory rate (H100 SXM)


def profile_gram(whole, calls: int = 5) -> None:
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
    print(f"[profile] {calls} gram calls: {len(events) / calls:.1f} device kernels per call, "
          f"span {span:.1f} us, busy {busy:.1f} us, idle share {1 - busy / span:.3f}")
    for e in events[:len(events) // calls]:
        print(f"[profile]   {e.name[:80]:80s} {e.time_range.end - e.time_range.start:8.1f} us")


def main() -> int:
    import torch

    from gpras_tpu_torch.ops import fused_gram

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=49_152)
    ap.add_argument("--kernel", default="Matern52", choices=sorted(KERNEL_IDS))
    ap.add_argument("--per-sm", type=int, nargs="*", default=[],
                    help="other numbers of persistent blocks per SM to time")
    ap.add_argument("--cross", action="store_true",
                    help="also time the cross Gram of x and a copy of x (all tiles)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers, spills and the SASS instruction mix")
    ap.add_argument("--profile", action="store_true", help="torch.profiler on 5 B1 calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gram_timing: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.ptxas:
        from torch_kmv_sym_timing import sass_report

        sass_report(args.kernel, ("gram_sym_kernel", "gram_kernel"))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n, d, kernel = args.n, 8, args.kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    params = {"log_variance": torch.tensor(0.0, device=dev),
              "log_lengthscales": torch.log(torch.tensor([1.0, 0.6, 0.35] + [10.0] * (d - 3),
                                                         device=dev))}
    x = torch.randn(n, d, generator=gen).to(dev)
    noise = torch.tensor(1e-2, device=dev)
    bound_ms = 4.0 * n * n / HBM_BYTES_S * 1e3
    whole = lambda: fused_gram.gram(kernel, params, x, noise=noise)  # noqa: E731
    print(f"gram {kernel} {n}x{n} +noise: whole wrapper call {events_ms(whole, 1, 7):.4f} ms "
          f"(one call per event pair); bound {bound_ms:.4f} ms (bytes); "
          f"plan {fused_gram.gram_plan(n, n, d, True, sms)}", flush=True)
    builds = {"first design (a block per 64 x 128 tile)":
              fused_gram._gram_cuda(kernel, params, x, None, noise, tiles=True),
              "symmetric (planned)": fused_gram._gram_cuda(kernel, params, x, None, noise)}
    for per_sm in args.per_sm:
        plan = fused_gram.gram_plan(n, n, d, True, sms, per_sm=per_sm)
        builds[f"symmetric, {plan.blocks} blocks"] = fused_gram._gram_cuda(
            kernel, params, x, None, noise, plan=plan)
    if args.cross:  # every tile computed, no mirror
        x2 = x.clone()  # held here: the launch reads it
        builds["cross x vs a copy of x"] = fused_gram._gram_cuda(kernel, params, x, x2, None)
    first = None
    for tag, (launch, out) in builds.items():
        assert launch() == 0
        torch.cuda.synchronize()
        if first is None:
            first = out
            continue
        if tag.startswith("cross"):  # no noise on a cross Gram's diagonal
            out.diagonal().add_(noise)
        same = torch.equal(out, first)
        print(f"gram {kernel} {n}x{n} {tag}: equal to the first design bit for bit: {same}",
              flush=True)
    del first
    torch.cuda.empty_cache()
    fill_buf = torch.empty((n, n), dtype=torch.float32, device=dev)
    runs = {tag: launch for tag, (launch, _) in builds.items()}
    runs["store ceiling (torch fill_ of the same bytes)"] = lambda: fill_buf.fill_(1.0)
    times = {tag: [] for tag in runs}
    order = list(runs)
    for tag in order + order[::-1]:  # in turns: a, b, c, c, b, a
        times[tag].append(events_ms(runs[tag], 5))
    for tag in runs:
        best = min(times[tag])
        print(f"gram {kernel} {n}x{n} {tag}: grids alone "
              + " / ".join(f"{t:.4f}" for t in times[tag])
              + f" ms, {4.0 * n * n / best / 1e9:.3f} TB/s, {bound_ms / best:.3f} of the bound",
              flush=True)
    del fill_buf, builds, runs
    torch.cuda.empty_cache()
    if args.profile:
        profile_gram(whole)
    return 0


if __name__ == "__main__":
    sys.exit(main())
