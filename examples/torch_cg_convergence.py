"""How far the matrix-free serving solver is from the exact posterior.

The exact-GP serving path above 16,384 training points (``GPRAS`` with the
CG engine) solves with 64 preconditioned CG iterations and a rank-64
pivoted-Cholesky preconditioner, as the JAX package does. This script serves
one mode of ``chip_smoke.py``'s training set (``bench._make_data_hard``'s
recipe, seed 7, D = 8, Matern52) through the PyTorch port at several fixed
hyperparameter settings, and holds the served mean and variance at 17 query
points against the dense float64 exact posterior (a Cholesky of the full
Gram). It also prints the dense float64 negative log marginal likelihood
(NLML) of each setting, so the settings can be ranked by how well they
explain the data.

Run from the repository root, on the GPU at the serving size:

    python examples/torch_cg_convergence.py --device cuda --n 8192 49152

or on the CPU at a small size (minutes at N = 4,096):

    python examples/torch_cg_convergence.py --device cpu --n 1024 2048

The dense check holds an (N, N) float64 Gram and its factor: ~38 GB of
device memory at N = 49,152. Prints one line per (N, setting) and a JSON
line with every row last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D = 8
#: (lengthscales of the three active inputs, noise variance); the nuisance
#: inputs keep lengthscale 10. The first is the data's generating scales,
#: the last the setting chip_smoke.py serves for mode 0.
SETTINGS = [((1.0, 0.6, 0.35), 0.01), ((1.0, 0.6, 0.35), 0.1), ((1.5, 1.0, 0.8), 0.05),
            ((2.0, 1.5, 1.5), 0.05), ((2.0, 1.5, 1.5), 0.1), ((3.5, 3.0, 3.0), 0.1)]


def training_set(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Mode 0 of chip_smoke.training_set at n points."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.4 * np.sin(4.0 * x[:, 2])
         + 0.1 * rng.normal(size=n))
    return x, y.astype(np.float32)


def dense_posterior(params, x, y, xq, noise, panel: int = 4096):
    """Exact float64 posterior (mean, variance) at xq and the NLML of y."""
    import torch

    from gpras_tpu_torch.ops import kernels as K

    n = x.shape[0]
    kmat = torch.empty((n, n), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, panel):
        kmat[r0:r0 + panel] = K.gram("Matern52", params, x[r0:r0 + panel], x)
    kmat.diagonal().add_(noise)
    chol, info = torch.linalg.cholesky_ex(kmat)
    del kmat
    if int(info) != 0:
        raise RuntimeError(f"dense float64 Cholesky failed (info {int(info)})")
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    nlml = (0.5 * torch.dot(y, alpha) + torch.log(torch.diagonal(chol)).sum()
            + 0.5 * n * math.log(2.0 * math.pi))
    ks = K.gram("Matern52", params, xq, x)
    v = torch.linalg.solve_triangular(chol, ks.T, upper=False)
    var = (torch.clamp_min(K.kdiag("Matern52", params, xq) - (v * v).sum(0), 0.0)
           + torch.exp(params["log_noise_variance"]))
    return (ks @ alpha).cpu().numpy(), var.cpu().numpy(), float(nlml)


def run(n: int, device: str) -> list[dict]:
    import torch

    from gpras_tpu_torch import GPRAS
    from gpras_tpu_torch.ops import linalg

    x_np, y_np = training_set(n)
    xq_np = np.random.default_rng(99).normal(size=(17, D)).astype(np.float32)
    x64 = torch.as_tensor(x_np, dtype=torch.float64, device=device)
    y64 = torch.as_tensor(y_np, dtype=torch.float64, device=device)
    xq64 = torch.as_tensor(xq_np, dtype=torch.float64, device=device)
    rows = []
    for active, noise in SETTINGS:
        ls = list(active) + [10.0] * (D - len(active))
        params = {"log_variance": np.zeros(1, np.float32),
                  "log_lengthscales": np.log(np.asarray([ls], np.float32)),
                  "log_noise_variance": np.full(1, math.log(noise), np.float32)}
        model = GPRAS("Matern52", model_type="exact", exact_engine="cg", device=device)
        model.x = torch.as_tensor(x_np, device=device)
        model.y = torch.as_tensor(y_np[:, None], device=device)
        model.params = {k: torch.as_tensor(v, device=device) for k, v in params.items()}
        t0 = time.perf_counter()
        mean, var = model.predict(xq_np)
        served_s = time.perf_counter() - t0
        p64 = {k: v[0].double() for k, v in model.params.items()}
        # the served model's noise: likelihood noise + the float32 relative jitter
        total_noise = torch.exp(p64["log_noise_variance"]) + \
            linalg.default_jitter(torch.float32) * torch.exp(p64["log_variance"])
        want_mean, want_var, nlml = dense_posterior(p64, x64, y64, xq64, total_noise)
        row = {"n": n, "lengthscales": list(active), "noise": noise,
               "mean_err_over_scale": float(np.abs(mean[:, 0] - want_mean).max()
                                            / np.abs(want_mean).max()),
               "var_max_rel_err": float((np.abs(var[:, 0] - want_var) / want_var).max()),
               "dense_nlml": nlml, "served_s": served_s}
        rows.append(row)
        print(f"N={n} lengthscales {list(active)} noise {noise}: mean err/max|mean| "
              f"{row['mean_err_over_scale']:.4e}, variance max rel err "
              f"{row['var_max_rel_err']:.4e}, dense NLML {nlml:.6e} "
              f"(served in {served_s:.2f} s)", flush=True)
        del model
        if device != "cpu":
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where to run: the card by default, 'cpu' only when asked")
    ap.add_argument("--n", type=int, nargs="+", default=[8192])
    args = ap.parse_args()
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = [row for n in args.n for row in run(n, args.device)]
    print(json.dumps({"cg_convergence": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
