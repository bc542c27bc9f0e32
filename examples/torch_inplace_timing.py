"""Time the Hutchinson training step on its two factorizations on the GPU.

At each shape (default: the pipeline's 17,920 points at D = 4, the exact
accuracy path's 32,768 and chip_smoke.py's 49,152 at D = 8;
chip_smoke.training_set's inputs and mode 0's serving hyperparameters,
Matern52, 16 probes), in turns (library, in place, in place, library)
``--pairs`` times:

1. one Hutchinson value and gradient, host clock to a synchronize, on the
   route GPRAS took above 16,384 points before the in-place factorization
   (B1's Gram, ``cholesky_ex``, ``cholesky_solve``) and on
   ``default_chol_config``'s (B1's Gram, ``super_cholesky`` in place, the
   blocked solves);
2. the factorizations alone (CUDA events; K restored before each in-place
   call, outside the events) and the solves alone, ``cholesky_solve``
   against ``blocked_cho_solve`` at 1 and 16 right-hand sides;
3. one step of each route under ``torch.profiler``: the device's busy time
   (the union of its operations' intervals) against the step's host clock,
   so the idle share.

Run from the repository root, on the GPU:

    python examples/torch_inplace_timing.py [--shapes 17920:4 32768:8 49152:8] [--pairs 3]

Prints the card's name and power limit, then one line per measurement and a
JSON line with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def events_ms(fn, before=None) -> float:
    """Device time of one ``fn()`` between two CUDA events (``before()``
    runs first, outside them)."""
    import torch

    if before is not None:
        before()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def host_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(fn) -> dict:
    """Host ms of one ``fn()`` under torch.profiler, the device's busy ms
    (the union of its kernels' and copies' intervals: one stream) and the
    idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "device_ops": len(spans),
            "idle_share": 1.0 - busy / wall}


def run_shape(n: int, d: int, pairs: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from gpras_tpu_torch.fit.optimizers import value_and_grad
    from gpras_tpu_torch.gp import exact_stochastic as es
    from gpras_tpu_torch.gp.priors import log_prior
    from gpras_tpu_torch.ops import block_cholesky as bc
    from gpras_tpu_torch.ops import fused_gram
    from gpras_tpu_torch.ops import linalg

    x_np, y_np, p_np = chip_smoke.training_set(n)
    x = torch.as_tensor(np.ascontiguousarray(x_np[:, :d]), device="cuda")
    y = torch.as_tensor(y_np[:, 0], device="cuda").contiguous()
    p = {"log_variance": torch.tensor(float(p_np["log_variance"][0]), device="cuda"),
         "log_lengthscales": torch.as_tensor(p_np["log_lengthscales"][0, :d], device="cuda"),
         "log_noise_variance": torch.tensor(float(p_np["log_noise_variance"][0]),
                                            device="cuda")}
    z = es.rademacher_probes(n, 16, device="cuda")
    cfg = es.default_chol_config(n)
    w, strip = bc.fit_block(n, cfg["chol_w"]), cfg["chol_strip"]
    routes = {"library": es._Factor(True, es._cholesky_ex, es._XLA.solve),
              "in_place": es._super_factor(cfg["chol_w"], strip)}

    def step(route):
        factor = routes[route]

        def loss(q):
            names = tuple(q)
            return es._HutchinsonNLML.apply("Matern52", factor, names, x, y, z,
                                            *(q[k] for k in names)) - log_prior(q)

        return lambda: value_and_grad(loss, p)

    steps = {route: [] for route in routes}
    for route in routes:  # warm-up: cuSOLVER and cuBLAS set-up, the kernels' first calls
        step(route)()
    for _ in range(pairs):
        for route in ("library", "in_place", "in_place", "library"):
            steps[route].append(host_s(step(route)))

    noise = torch.exp(p["log_noise_variance"]) + \
        linalg.default_jitter(torch.float32) * torch.exp(p["log_variance"])
    k0 = fused_gram.gram("Matern52", p, x, noise=noise)
    k = torch.empty_like(k0)
    factor_ms = {"cholesky_ex": [], "super_cholesky": []}
    events_ms(lambda: torch.linalg.cholesky_ex(k0))
    events_ms(lambda: bc.super_cholesky(k, w, strip, zero_upper=False), lambda: k.copy_(k0))
    for _ in range(pairs):
        factor_ms["cholesky_ex"].append(events_ms(lambda: torch.linalg.cholesky_ex(k0)))
        factor_ms["super_cholesky"].append(events_ms(
            lambda: bc.super_cholesky(k, w, strip, zero_upper=False), lambda: k.copy_(k0)))
    l_lib, _ = torch.linalg.cholesky_ex(k0)
    del k0
    l_in = bc.super_cholesky(k, w, strip, zero_upper=False)
    solve_ms = {}
    for r, rhs in (("1", y[:, None]), ("16", z)):
        solve_ms[f"cholesky_solve R={r}"] = statistics.median(
            events_ms(lambda: torch.cholesky_solve(rhs, l_lib)) for _ in range(pairs + 1))
        solve_ms[f"blocked_cho_solve R={r}"] = statistics.median(
            events_ms(lambda: bc.blocked_cho_solve(l_in, rhs, 512)) for _ in range(pairs + 1))
    del l_lib, l_in, k
    torch.cuda.empty_cache()
    prof = {route: profiled(step(route)) for route in routes}
    out = {"n": n, "d": d, "w": w, "strip": strip, "diagonal_blocks": n // w,
           "step_s": {r: statistics.median(v) for r, v in steps.items()},
           "step_s_all": steps,
           "factor_ms": {r: statistics.median(v) for r, v in factor_ms.items()},
           "solve_ms": solve_ms, "profiled": prof}
    print(f"N={n} D={d} (w={w}, strip={strip}): step library {out['step_s']['library']:.4f} s, "
          f"in place {out['step_s']['in_place']:.4f} s (medians of {2 * pairs}); cholesky_ex "
          f"{out['factor_ms']['cholesky_ex']:.2f} ms, super_cholesky "
          f"{out['factor_ms']['super_cholesky']:.2f} ms; "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in solve_ms.items())
          + "; idle share library {:.3f}, in place {:.3f}".format(
              prof["library"]["idle_share"], prof["in_place"]["idle_share"]), flush=True)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["17920:4", "32768:8", "49152:8"],
                    help="N:D pairs")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_inplace_timing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    results = [run_shape(int(s.split(":")[0]), int(s.split(":")[1]), args.pairs)
               for s in args.shapes]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
