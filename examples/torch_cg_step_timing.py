"""Time the matrix-free CG training engine at N = 131,072 on the GPU.

Two measurements, both on chip_smoke.py's seeded problem (mode 0 of its
``training_set`` at N points, D = 8, Matern52):

1. The reference's CG step unit (bench.py ``bench_exact_fit`` with
   GPRAS_BENCH_MODE=cg and 24 iterations: 127 Rademacher probes, no
   preconditioner, Adam at lr 0.02 from ``init_params(noise_variance=0.1)``,
   fresh probes every step), ``--steps`` Adam steps of
   ``make_cg_training_loss`` after one untimed step; the seconds for those
   steps, as bench.py's ELAPSED line reports them. With 128 right-hand
   sides B3 plans its 256-column tensor-core build.
2. B3 (``fused_gram.kmv_sym``) at R = 16 against R = 17 at N: the CG loss's
   mbcg runs y and 16 probes, 17 columns, one above SYM_MAX_R, so the plan
   takes the 64-column tensor-core build instead of the symmetric one. Each
   whole wrapper call (one call between two CUDA events) beside its CUDA
   grids alone (the prepared call, ``--calls`` launches between two events),
   with the scratch each plan allocates and the bound chip_smoke.py
   computes for the same work.

Run from the repository root, on the GPU:

    python examples/torch_cg_step_timing.py [--n 131072] [--steps 10]

Prints the card's name and power limit, then one line per measurement and a
JSON line with all of them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median device time per call of ``fn`` in ms (CUDA events around
    ``calls`` calls), after one warm-up."""
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
    return statistics.median(times)


def bench_unit(x, y, steps: int, probes: int = 127, iters: int = 24) -> dict:
    """bench.py's CG unit on the port: Adam (optax's update, fit/optimizers)
    over make_cg_training_loss with fresh Rademacher probes each step."""
    import torch

    from gpras_tpu_torch.fit import optimizers
    from gpras_tpu_torch.gp import exact as exact_gp
    from gpras_tpu_torch.gp import exact_cg
    from gpras_tpu_torch.ops import fused_gram

    loss = exact_cg.make_cg_training_loss("Matern52", probes=probes, max_iters=iters)
    gen = torch.Generator().manual_seed(0)

    def fresh_probes(p):
        bits = torch.randint(0, 2, (x.shape[0], probes), generator=gen)
        return loss(p, x, y, (2 * bits - 1).to(dtype=x.dtype, device=x.device))

    params = exact_gp.init_params("Matern52", x, noise_variance=0.1)
    params, _ = optimizers.adam_fit(fresh_probes, params, max_iter=1, learning_rate=0.02)
    fused_gram.kmv_sym.launches = fused_gram.kgrad_sym.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = optimizers.adam_fit(fresh_probes, params, max_iter=steps, learning_rate=0.02)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    losses = info["losses"][: int(info["iterations"])].tolist()
    return {"steps": steps, "seconds": elapsed, "seconds_per_step": elapsed / steps,
            "losses": losses, "kmv_sym_calls": fused_gram.kmv_sym.launches,
            "kgrad_sym_calls": fused_gram.kgrad_sym.launches,
            "b3_plan": fused_gram.kmv_sym_plan(x.shape[0], x.shape[1], probes + 1)._asdict()}


def b3_r16_r17(x, calls: int) -> dict:
    """kmv_sym at R = 16 and 17 on the same points: whole call and grids."""
    import torch

    import chip_smoke
    from gpras_tpu_torch.ops import fused_gram

    params = {"log_variance": torch.tensor(0.0, device=x.device),
              "log_lengthscales": torch.log(torch.tensor([3.5, 3.0, 3.0] + [10.0] * 5,
                                                         device=x.device))}
    noise = torch.tensor(0.1, device=x.device)
    gen = torch.Generator().manual_seed(1)
    out = {}
    for r in (16, 17):
        v = torch.randn(x.shape[0], r, generator=gen).to(x.device)
        plan = fused_gram.kmv_sym_plan(x.shape[0], x.shape[1], r)
        whole = cuda_ms(lambda: fused_gram.kmv_sym("Matern52", params, x, v, noise=noise))
        launch, _res, _grids = fused_gram._kmv_sym_cuda(plan, "Matern52", params, x, v, noise)
        grids = cuda_ms(launch, calls=calls)
        scratch_gb = 4 * (plan.npad * plan.dp + plan.npad + plan.vbuf + plan.parts) / 1e9
        bound_ms, bound_by = chip_smoke.bound(*chip_smoke.kmv_work(x.shape[0], x.shape[0], r, True))
        del launch, _res
        torch.cuda.empty_cache()
        out[r] = {"ms": whole, "grids_ms": grids, "scratch_gb": scratch_gb,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "build": "tensor-core" if plan.tc else "symmetric",
                  "columns_computed": 8 * plan.width * plan.chunks if plan.tc else r}
        print(f"[b3] N={x.shape[0]} R={r}: {out[r]['build']} build ({out[r]['columns_computed']} "
              f"columns computed), whole call {whole:.3f} ms, grids alone {grids:.3f} ms "
              f"({calls} launches per event pair), bound {bound_ms:.3f} ms ({bound_by}), "
              f"scratch {scratch_gb:.2f} GB", flush=True)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=131_072)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--calls", type=int, default=5, help="launches per event pair for the grids")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cg_step_timing: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    import chip_smoke

    x_np, y_np, _ = chip_smoke.training_set(args.n)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np[:, 0], device="cuda").contiguous()
    b3 = b3_r16_r17(x, args.calls)
    unit = bench_unit(x, y, args.steps)
    print(f"[unit] N={args.n}, 127 probes, 24 iterations, no preconditioner: {args.steps} Adam "
          f"steps in {unit['seconds']:.3f} s ({unit['seconds_per_step']:.3f} s a step); "
          f"kmv_sym calls {unit['kmv_sym_calls']}, kgrad_sym calls {unit['kgrad_sym_calls']}; "
          f"losses {[f'{v:.3f}' for v in unit['losses']]}", flush=True)
    if not all(math.isfinite(v) for v in unit["losses"]):
        print("torch_cg_step_timing: a loss is not finite", file=sys.stderr)
        return 1
    print(json.dumps({"b3_r16_r17": b3, "bench_unit": unit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
