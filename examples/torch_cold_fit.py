"""Cold exact-GP fit on the port: ``gpras_tpu_torch.gp.coldfit.fit_exact``
alone, on chip_smoke.py's seeded problem (mode 0 of its ``training_set`` at
N points, D = 8, Matern52), from the standard init.

The engine follows N as ``fit_exact``'s "auto" does: Hutchinson below
65,536 points (B1 forward, cuSOLVER Cholesky, B5 backward), the segmented
CG engine at and above (rank-128 preconditioner, 256 iterations in
16-iteration segments with the early exit and the gate abort, 127 probes;
B3 every mbcg iteration, B5 the backward). Prints the card's name and power
limit, one line per L-BFGS iteration, then a JSON line: seconds,
iterations, evaluations, ``stopped_by``, the losses, for CG the segments
every evaluation ran, the kernel launches and the peak device memory.

Run from the repository root:

    python examples/torch_cold_fit.py N MAX_ITER            # on the GPU
    python examples/torch_cold_fit.py 1024 3 --device cpu   # a few seconds here
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n: int, max_iter: int, device: str = "cuda", verbose: bool = True) -> dict:
    import torch

    from chip_smoke import training_set
    from gpras_tpu_torch.gp import coldfit
    from gpras_tpu_torch.ops import fused_gram

    on_card = torch.device(device).type == "cuda"

    def say(msg):
        if verbose:
            print(msg, flush=True)

    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip())
        torch.cuda.reset_peak_memory_stats()
    x, y, _ = training_set(n)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y[:, 0], device=device).contiguous()
    wrappers = (fused_gram.gram, fused_gram.kmv_dense, fused_gram.kmv_sym,
                fused_gram.kgrad_dense, fused_gram.kgrad_sym)
    for fn in wrappers:
        fn.launches = 0

    t0 = time.perf_counter()

    def progress(done, best):
        say(f"  iteration {done:3d}  best loss {best:.4f}  {time.perf_counter() - t0:.1f} s")

    params, info = coldfit.fit_exact("Matern52", x, y, max_iter=max_iter, progress=progress)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    iters = int(info["iterations"])
    out = {"n": n, "max_iter": max_iter, "device": device,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "engine": info["engine"], "seconds": seconds, "stopped_by": info["stopped_by"],
           "iterations": iters, "evals": info["evals"],
           "losses": info["losses"][:iters].tolist(), "best_loss": float(info["loss"]),
           "cg_segments": info.get("segments", []),
           "launches": {fn.__name__: fn.launches for fn in wrappers},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
           "noise_variance": float(torch.exp(params["log_noise_variance"]))}
    say(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("max_iter", type=int)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.n, a.max_iter, a.device)
