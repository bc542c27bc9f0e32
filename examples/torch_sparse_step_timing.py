"""Time the sparse backends' training steps on the card: SGPR's (the
collapsed bound, `fit/optimizers.adam_fit`) and, where the package has it,
SVGP's (`gp/svgp.make_stream_fit`'s step: NGD, the bound's value and
gradient, Adam), at chip_smoke.py's shapes (N = 49,152, D = 8, M = 300;
SVGP batches of 4,096).

Both steps are the host's (PERF.md section 5), so their times follow the
host as much as the code: compare two checkouts only inside one call, in
turns, each run a process of its own:

    for root in parent change change parent; do
        python examples/torch_sparse_step_timing.py --root $root; done

``--root`` is the checkout whose ``gpras_tpu_torch`` is timed (default:
this one). Prints one JSON line: the median ms a step over ``--repeats``
runs of ``--steps`` steps each, after one warm-up run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=49152)
    ap.add_argument("--m", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import numpy as np
    import torch

    from gpras_tpu_torch.fit.optimizers import adam_fit
    from gpras_tpu_torch.gp import sgpr

    dev = torch.device(a.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    x_h = rng.normal(size=(a.n, 8)).astype(np.float32)
    y_h = (np.sin(x_h[:, 0]) + 0.5 * np.sin(2.0 * x_h[:, 1]) + 0.1 * rng.normal(size=a.n))
    x = torch.as_tensor(x_h, device=dev)
    y = torch.as_tensor(y_h.astype(np.float32), device=dev)
    z = x[:: a.n // a.m][: a.m].contiguous()

    def timed(run) -> float:
        run()  # warm-up
        times = []
        for _ in range(a.repeats):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / a.steps)
        return statistics.median(times)

    p_sgpr = sgpr.init_params("Matern52", x, z)
    out = {"root": os.path.abspath(a.root), "n": a.n, "m": a.m, "steps": a.steps,
           "repeats": a.repeats,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           # tol 0: every step runs (no early stop)
           "sgpr_ms_per_step": timed(lambda: adam_fit(
               lambda p: sgpr.training_loss("Matern52", p, x, y), p_sgpr, max_iter=a.steps,
               learning_rate=0.01, tol=0.0, patience=a.steps))}
    try:
        from gpras_tpu_torch.gp import svgp
    except ImportError:  # a checkout from before SVGP was ported
        svgp = None
    if svgp is not None:
        p_svgp = svgp.init_params("Matern52", x, z)
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = a.steps * a.batch
        perm = torch.cat([torch.randperm(a.n, generator=gen, device=dev)
                          for _ in range(-(-rows // a.n))])[:rows]
        xc = x[perm].reshape(a.steps, a.batch, -1)
        yc = y[perm].reshape(a.steps, a.batch, 1)
        init, run_chunk = svgp.make_stream_fit("Matern52", natgrad=0.5)
        out["svgp_ms_per_step"] = timed(lambda: run_chunk(p_svgp, init(p_svgp), xc, yc, a.n))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
