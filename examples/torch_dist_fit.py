"""A distributed exact-GP fit on the port: ``GPRAS.fit(x, y, mesh="auto")``
on every rank of a ``torch.distributed`` job, each engine held to the
one-card engine at the same start.

Every rank builds chip_smoke.py's seeded problem (``training_set``: D = 8,
Matern52) and runs the same program. For each engine of ``--engines``:
``mesh="auto"`` builds the largest 2-D mesh over the ranks ((2, 2) on 4);
the objective GPRAS trains (``parallel/pexact`` dense or Hutchinson, on
(i, j) tiles on a 2-D mesh; ``parallel/pcg`` CG on the mesh flattened to one
axis, kernel B2 on each rank's rows) gives its value and gradient at the
standard init, rank 0 holds them against the one-card engine's (dense:
``gp/exact``; Hutchinson: B1 + B5; CG: B3 + B5; the same fixed probes), and
then ``--steps`` Adam steps of ``--modes`` modes run through
``GPRAS.fit(mesh="auto")``. Limits, relative to the one-card value and to
the largest one-card gradient entry: dense and Hutchinson 1e-5 and 1e-3
(phase 6's), CG 1e-4 and 1e-2 (its 32 iterations do not converge at the
init; B2 and B3 round differently). Rank 0 prints the card's name and power
limit, then one JSON line per engine: mesh, seconds, losses, per-rank peak
device memory and kernel launches, whether every rank holds the same
fitted parameters (bit for bit), the check.

Launch it on every rank (from the repository root):

    python -m torch.distributed.run --nproc_per_node=4 examples/torch_dist_fit.py
    python -m torch.distributed.run --nproc_per_node=4 examples/torch_dist_fit.py \\
        --device cpu --n 1024 2048 1024      # gloo, a few seconds a rank

``--n`` gives N for the dense, Hutchinson and CG engines (defaults 16,384,
32,768 and 65,536). NCCL puts one rank on a card (``LOCAL_RANK``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (loss, gradient) limits against the one-card engine, relative
LIMITS = {"dense": (1e-5, 1e-3), "hutchinson": (1e-5, 1e-3), "cg": (1e-4, 1e-2)}


def _objective(engine: str, mesh, x, y0):
    """The distributed training loss GPRAS.fit(mesh=...) builds for ``engine``
    (its defaults: 16 probes; CG 32 iterations, a rank-64 preconditioner)."""
    from gpras_tpu_torch import GPRAS
    from gpras_tpu_torch.gp import exact_cg, exact_stochastic
    from gpras_tpu_torch.gp.priors import log_prior
    from gpras_tpu_torch.parallel import make_mesh, pcg, pexact
    from gpras_tpu_torch.parallel.mesh import _index

    n = x.shape[0]
    if engine == "cg":
        flat = make_mesh((math.prod(mesh.shape),), ("i",))
        nl = n // math.prod(mesh.shape)
        x_local = x[_index(flat, "i") * nl:][:nl].contiguous()
        draws = exact_cg.precond_probes(n, 64, 16, dtype=x.dtype, device=x.device)
        _, loss = pcg.make_dist_cg_nlml(flat, "Matern52", probes=16, max_iters=32,
                                        precond_rank=64)
        return lambda p: loss(p, x_local, y0, draws)
    b = GPRAS._dist_block(n, mesh)
    if engine == "hutchinson":
        z = exact_stochastic.rademacher_probes(n, 16, dtype=x.dtype, device=x.device)
        nlml = pexact.make_dist_nlml_stochastic(mesh, "Matern52", b=b, probes=16)
        return lambda p: nlml(p, x, y0, z) - log_prior(p)
    nlml = pexact.make_dist_nlml(mesh, "Matern52", b=b)
    return lambda p: nlml(p, x, y0) - log_prior(p)


def run_engine(engine: str, n: int, modes: int, steps: int, device) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from chip_smoke import read_counters, training_set, zero_counters
    from gpras_tpu_torch import GPRAS
    from gpras_tpu_torch.fit.optimizers import value_and_grad
    from gpras_tpu_torch.gp import exact as exact_gp

    on_card = device.type == "cuda"
    x_np, y_np, _ = training_set(n)
    mesh = GPRAS._resolve_mesh("auto")
    x = torch.as_tensor(x_np, device=device)
    y0 = torch.as_tensor(y_np[:, 0], device=device).contiguous()
    p0 = exact_gp.init_params("Matern52", x)
    loss_d, g_d = value_and_grad(_objective(engine, mesh, x, y0), p0)
    check = None
    if dist.get_rank() == 0:
        one = GPRAS("Matern52", model_type="exact", exact_engine=engine, device=device)
        one.x, one.y = x, y0[:, None]
        loss_1, g_1 = value_and_grad(lambda p: one._loss_fn(p, y0), p0)
        flat = lambda g: torch.cat([g[k].double().reshape(-1) for k in sorted(g)])
        loss_err = abs(float(loss_d) - float(loss_1)) / abs(float(loss_1))
        grad_scale = float(flat(g_1).abs().max())
        grad_err = float((flat(g_d) - flat(g_1)).abs().max()) / grad_scale
        limit_loss, limit_grad = LIMITS[engine]
        check = {"loss": float(loss_d), "loss_one_card": float(loss_1), "loss_rel_err": loss_err,
                 "grad_rel_err": grad_err, "limits": [limit_loss, limit_grad],
                 "ok": loss_err <= limit_loss and grad_err <= limit_grad}
        del one
    dist.barrier()
    model = GPRAS("Matern52", model_type="exact", exact_engine=engine, device=device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    model.fit(x_np, y_np[:, :modes], mesh=mesh, optimization_method="adam",
              learning_rate=0.02, max_iter=steps)
    if on_card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fitted = hashlib.sha256(b"".join(model.params[k].cpu().numpy().tobytes()
                                      for k in sorted(model.params))).hexdigest()
    mine = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
            "launches": read_counters(), "params_sha256": fitted}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    losses = model.fit_info["losses"][:, :steps].tolist()
    same = len({r["params_sha256"] for r in everyone}) == 1  # replicated bit for bit
    return {"engine": model.fit_info["dist_engine"], "n": n, "modes": modes, "steps": steps,
            "mesh": list(model.fit_info["dist_mesh_shape"]), "fit_s": fit_s, "losses": losses,
            "finite": bool(np.isfinite(losses).all()) and same, "ranks": everyone,
            "check": check}


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--engines", nargs="+", default=["dense", "hutchinson", "cg"],
                    choices=("dense", "hutchinson", "cg"))
    ap.add_argument("--n", nargs="+", type=int, default=[16384, 32768, 65536])
    ap.add_argument("--modes", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    sizes = dict(zip(("dense", "hutchinson", "cg"), args.n))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        if args.device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        rank0 = dist.get_rank() == 0
        if rank0 and args.device == "cuda":
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout.strip(), flush=True)
        ok = True
        for engine in args.engines:
            report = run_engine(engine, sizes[engine], args.modes, args.steps, device)
            if rank0:
                print(json.dumps({"world": dist.get_world_size(), "backend": dist.get_backend(),
                                  **report}), flush=True)
                ok = ok and report["finite"] and report["check"]["ok"] and \
                    report["engine"] == engine
        flags = [None] * dist.get_world_size()
        dist.all_gather_object(flags, ok)
        return 0 if flags[0] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
