#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (gpras_tpu_torch) on one GPU.

Drives the exact-GP serving path once at full width (N = 49,152 training
points, D = 8 inputs, Matern52, P = 4 EOF modes, 49,152-cell fields) through
the entry points a user calls, and checks every CUDA kernel on that path:

0. device: the card's name and power limit, torch and CUDA versions; TF32 off
1. build: nvcc compiles gpras_tpu_torch/csrc into build/gpras_tpu_torch/
2. kernels vs their plain PyTorch versions (float64 on the same float32
   inputs), for all five stationary covariances, at ragged shapes and at the
   serving shapes, with kernel and plain times
3. serving: write a checkpoint and two EOF preprocessors with the port, load
   them in PosteriorPredictor(device="cuda"), answer two LF-field requests,
   and show through the launch counters that both kernels ran
4. check: the served posterior of mode 0 against the dense float64 exact
   posterior (Cholesky of the full 49,152^2 Gram) on the card

Hyperparameters are fixed, not fitted (training is not ported yet), at
values where the serving solver converges; see training_set. Artifacts go to build/chip_smoke/ in the checkout.
Prints progress, then a JSON line describing the kernels, then as the last
line {"ok": true, "device": {...}}. Any failed phase exits non-zero without
that line; without a CUDA device it exits 2 at once.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
N, D, P = 49_152, 8, 4
GRID = (192, 256)  # 49,152 cells
KERNEL_TOL = 1e-4  # |kernel - plain_f64| <= 1e-4 * max|plain_f64| (see phase 2)
MEAN_TOL = 1e-3    # served mean vs dense f64: 1e-3 * max|mean|
VAR_TOL = 1e-2     # served variance vs dense f64: relative


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from gpras_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, compiler_log = _build.build()
    _build.library()
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in compiler_log.splitlines() if "registers" in line})
    spills = [line for line in compiler_log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s (set-up); "
        f"registers per thread {regs}; spilling kernels: {len(spills)}")


def phase_kernels():
    """Each kernel against its plain version, run in float64 on the same
    float32 inputs. The kernels' own error is fp32 rounding of the tile and
    of sums over up to 49,152 terms, ~1e-6 of the result's scale; the gate
    1e-4 * max|want| catches any wrong tile, mask or mirror (those move a
    result by a whole covariance entry times v, ~1e-2 of the scale)."""
    import torch

    from gpras_tpu_torch.ops import fused_gram
    from gpras_tpu_torch.ops import kernels as K

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(0)
    report = {}

    def inputs(n1, n2, r):
        params = {"log_variance": torch.tensor(0.0, device=dev),
                  "log_lengthscales": torch.log(
                      torch.tensor([1.0, 0.6, 0.35] + [10.0] * (D - 3), device=dev))}
        x1 = torch.randn(n1, D, generator=gen).to(dev)
        x2 = torch.randn(n2, D, generator=gen).to(dev)
        v = torch.randn(n2, r, generator=gen).to(dev)
        return params, x1, x2, v

    def check(name, kernel, shape, run, run_plain, run_plain32, timed):
        got = run()
        want = run_plain()
        torch.cuda.synchronize()
        err = (got.double() - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= KERNEL_TOL * scale
        line = f"[kernels] {name:9s} {kernel:11s} {shape:22s} max_abs_err {err:.3e} " \
               f"(scale {scale:.3e}) {'ok' if ok else 'FAIL'}"
        if timed:
            ms, plain_ms = cuda_ms(run), cuda_ms(run_plain32)
            line += f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
            report.setdefault(name, {})[(kernel, shape)] = (err, ms, plain_ms)
        log(line)
        if not ok:
            raise AssertionError(f"{name} {kernel} {shape}: error {err} > {KERNEL_TOL} * {scale}")

    def f64(params):
        return {k: v.double() for k, v in params.items()}

    for kernel in K.STATIONARY_KERNELS:
        # serving shapes: the posterior mean of a 64- or 256-query bucket
        for (n1, n2, r, timed) in [(4999, 3001, 1, False), (4999, 3001, 7, False),
                                   (64, N, 1, True), (256, N, 1, True)]:
            params, x1, x2, v = inputs(n1, n2, r)
            check("kmv_dense", kernel, f"{n1}x{n2} R={r}",
                  lambda: fused_gram.kmv_dense(kernel, params, x1, v, x2=x2),
                  lambda: fused_gram.kmv_plain(kernel, f64(params), x1.double(), v.double(),
                                               x2=x2.double()),
                  lambda: fused_gram.kmv_plain(kernel, params, x1, v, x2=x2), timed)
        # serving shapes: the alpha solve (R = 1) and the variance solves of a
        # 64- and a 256-query bucket; R picks the kernel's build (1, 4 or 16
        # columns per thread), so each build runs here at the shape it serves
        for (n, r, timed) in [(5003, 1, False), (5003, 7, False), (N, 1, True), (N, 64, True),
                              (N, 256, True)]:
            params, x, _, v = inputs(n, n, r)
            noise = torch.tensor(1e-2, device=dev)
            check("kmv_sym", kernel, f"{n}x{n} R={r}",
                  lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
                  lambda: fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(),
                                               noise=1e-2),
                  lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise), timed)
    return report


def synthetic_fields(rng, n_events: int):
    """LF and HF water-surface fields (events, 49,152 cells) on a 192 x 256
    grid: a sloped bed with a ridge that stays dry, flooded by twelve smooth
    spatial patterns whose per-event amplitudes play the storm parameters."""
    gy, gx = np.meshgrid(np.linspace(0, 1, GRID[0]), np.linspace(0, 1, GRID[1]), indexing="ij")
    ridge = (np.abs(gy - 0.8) < 0.03).ravel()
    elev = (4.0 * gx + 2.0 * gy).ravel() + 30.0 * ridge
    patterns = np.stack([np.sin((k % 4 + 1) * np.pi * gx) * np.cos((k // 4 + 1) * np.pi * gy)
                         for k in range(12)]).reshape(12, -1)
    hf_patterns = patterns + 0.2 * np.roll(patterns, 1, axis=0) * gx.ravel()
    amps = rng.normal(size=(n_events, 12)) / (1.0 + np.arange(12))
    lf = elev + ~ridge * np.maximum(3.0 + amps @ patterns, 0.0)
    hf = elev + ~ridge * np.maximum(3.0 + np.tanh(amps) @ hf_patterns, 0.0)
    return lf, hf, elev


def training_set():
    """bench._make_data_hard's recipe (seed 7) for mode 0, plus three seeded
    smooth responses of the same three active inputs.

    Per-mode Matern52 hyperparameters are fixed, not fitted (training is not
    ported): lengthscales 3-6 on the active inputs, 10 on the nuisance ones,
    noise variance 0.1. They are chosen so that the reference's serving
    solver (64 preconditioned CG iterations, rank-64 pivoted-Cholesky
    preconditioner) converges at N = 49,152; they are not the data's
    likelihood optimum. At the generating scales (0.35-1, noise 0.01) that
    solver misses the dense posterior by O(1), in the JAX package as in the
    port (PERF.md; examples/torch_cg_convergence.py), and the dense check
    below could not tell a fault of the port from that."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ys = [np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.4 * np.sin(4.0 * x[:, 2])
          + 0.1 * rng.normal(size=N)]
    ls = [[3.5, 3.0, 3.0] + [10.0] * (D - 3)]
    for p in range(1, P):
        g = np.random.default_rng(100 + p)
        w = g.normal(size=3)
        ys.append(np.sin(x[:, :3] @ w) + 0.1 * g.normal(size=N))
        ls.append([float(np.clip(3.0 / abs(wd), 3.0, 6.0)) for wd in w] + [10.0] * (D - 3))
    params = {"log_variance": np.zeros(P, np.float32),
              "log_lengthscales": np.log(np.asarray(ls, np.float32)),
              "log_noise_variance": np.full(P, math.log(0.1), np.float32)}
    return x, np.stack(ys, axis=1).astype(np.float32), params


def phase_serving(out: Path):
    import torch

    from gpras_tpu_torch import GPRAS, PosteriorPredictor, PreProcessor
    from gpras_tpu_torch.ops import fused_gram

    rng = np.random.default_rng(11)
    lf, hf, elev = synthetic_fields(rng, 300)
    for name, field, modes in (("lf", lf, 8), ("hf", hf, P)):
        pre = PreProcessor(hydraulic_parameter="wse", device=DEVICE)
        pre.fit(field, elev, spatial_mode_count=modes)
        pre.to_file(out / f"{name}_pre.npz")
    log(f"[serving] preprocessors fitted on 300 events x {lf.shape[1]} cells; "
        f"LF 8 modes, HF {P} modes; dry cells {int(pre.dry_indices.sum())}")
    x, y, params = training_set()
    model = GPRAS("Matern52", model_type="exact", device=DEVICE)
    model.x = torch.as_tensor(x, device=DEVICE)
    model.y = torch.as_tensor(y, device=DEVICE)
    model.params = {k: torch.as_tensor(v, device=DEVICE) for k, v in params.items()}
    model.to_file(out / "gp.npz")
    log(f"[serving] checkpoint N={N} D={D} P={P} Matern52, hyperparameters fixed where the "
        "64-iteration PCG solver converges (not fitted: training is not ported yet)")
    requests = [synthetic_fields(np.random.default_rng(12 + i), n)[0]
                for i, n in enumerate((17, 200))]

    fused_gram.kmv_dense.launches = 0
    fused_gram.kmv_sym.launches = 0
    t0 = time.perf_counter()
    pred = PosteriorPredictor(out / "gp.npz", hf_preprocessor_path=out / "hf_pre.npz",
                              lf_preprocessor_path=out / "lf_pre.npz", buckets=(64, 256),
                              device=DEVICE)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    log(f"[serving] PosteriorPredictor load + cache build {cache_s:.3f} s "
        f"(matrix-free: {pred.model._matrix_free})")
    latencies = []
    for req in requests:
        t0 = time.perf_counter()
        field, var = pred.predict_field(req)
        latencies.append(time.perf_counter() - t0)
        log(f"[serving] request of {req.shape[0]} LF fields -> HF field {field.shape}: "
            f"{latencies[-1]:.3f} s")
        if field.shape != req.shape or var.shape != req.shape:
            raise AssertionError(f"shape {field.shape} / {var.shape} != {req.shape}")
        if not (np.isfinite(field).all() and np.isfinite(var).all() and (var >= 0).all()):
            raise AssertionError("non-finite field or negative variance")
    launches = {"kmv_dense": fused_gram.kmv_dense.launches,
                "kmv_sym": fused_gram.kmv_sym.launches}
    log(f"[serving] kernel launches during the serving run: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return pred, requests[0], launches, cache_s, latencies


def phase_dense_check(pred, request):
    """Mode 0 of the first request against the dense float64 exact posterior
    of the same model, built and factorized on the card (the Gram and its
    factor take ~19 GB each)."""
    import torch

    from gpras_tpu_torch.ops import kernels as K
    from gpras_tpu_torch.ops import linalg

    xq_np = pred.lf_pre.transform(request)
    mean, var = pred.predict_modes(xq_np)
    model = pred.model
    p = {k: v[0].double() for k, v in model.params.items()}
    x = model.x.double()
    xq = torch.as_tensor(xq_np, dtype=torch.float64, device=x.device)
    t0 = time.perf_counter()
    kmat = torch.empty((N, N), dtype=torch.float64, device=x.device)
    for r0 in range(0, N, 4096):
        kmat[r0:r0 + 4096] = K.gram("Matern52", p, x[r0:r0 + 4096], x)
    # the served model's noise: likelihood noise + the float32 relative jitter
    noise = torch.exp(p["log_noise_variance"]) + \
        linalg.default_jitter(torch.float32) * torch.exp(p["log_variance"])
    kmat.diagonal().add_(noise)
    chol, info = torch.linalg.cholesky_ex(kmat)
    del kmat
    if int(info) != 0:
        raise AssertionError(f"dense float64 Cholesky failed (info {int(info)})")
    alpha = torch.cholesky_solve(model.y[:, :1].double(), chol)
    ks = K.gram("Matern52", p, xq, x)
    want_mean = (ks @ alpha)[:, 0].cpu().numpy()
    v = torch.linalg.solve_triangular(chol, ks.T, upper=False)
    want_var = (torch.clamp_min(K.kdiag("Matern52", p, xq) - (v * v).sum(0), 0.0)
                + torch.exp(p["log_noise_variance"])).cpu().numpy()
    del chol, v
    torch.cuda.empty_cache()
    mean_err = float(np.abs(mean[:, 0] - want_mean).max())
    var_err = float((np.abs(var[:, 0] - want_var) / want_var).max())
    log(f"[check] mode 0, {len(want_mean)} queries vs dense float64 posterior "
        f"({time.perf_counter() - t0:.1f} s): mean max abs err {mean_err:.3e} "
        f"(limit {MEAN_TOL} * {np.abs(want_mean).max():.3e}), variance max rel err "
        f"{var_err:.3e} (limit {VAR_TOL})")
    if mean_err > MEAN_TOL * np.abs(want_mean).max() or var_err > VAR_TOL:
        raise AssertionError("served posterior disagrees with the dense float64 posterior")
    return mean_err, var_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    report = phase_kernels()
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    pred, first_request, launches, cache_s, latencies = phase_serving(out)
    phase_dense_check(pred, first_request)

    slice_shape = {"kmv_dense": ("Matern52", f"256x{N} R=1"),
                   "kmv_sym": ("Matern52", f"{N}x{N} R=256")}
    replaces = {"kmv_dense": "gpras_tpu/ops/pallas_gram.py:84 (_kmv_body)",
                "kmv_sym": "gpras_tpu/ops/pallas_gram.py:152 (_kmv_sym_body)"}
    kernels = []
    for name in ("kmv_dense", "kmv_sym"):
        err, ms, plain_ms = report[name][slice_shape[name]]
        # launches counts wrapper calls; the CUDA grids one call issues are
        # in fused_gram's docstring (kmv_sym: 769 at N = 49,152)
        kernels.append({"name": name, "route": "cuda",
                        "source": "gpras_tpu_torch/csrc/kmv.cu", "replaces": replaces[name],
                        "launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "shape": " ".join(slice_shape[name]),
                        "at_serving_shapes": {
                            f"{kernel} {shape}": {"max_abs_err": e, "ms": t, "plain_ms": tp}
                            for (kernel, shape), (e, t, tp) in report[name].items()}})
    log(json.dumps({"serving": {"cache_build_s": cache_s,
                                "request_s": dict(zip(("17", "200"), latencies))}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
