#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (gpras_tpu_torch) on one GPU.

Drives the exact-GP serving path and the exact-GP training path once each at
full width (N = 49,152 training points, D = 8 inputs, Matern52, P = 4 EOF
modes, 49,152-cell fields), the matrix-free CG training path at
N = 131,072, the SGPR backend (fit and serve, N = 49,152), the cold exact
fit (Hutchinson at N = 49,152, CG at N = 65,536), the SVGP backend (fit and
serve at N = 49,152; the archive-scale protocol at N = 2^20), the accuracy
north stars, the metric suite, the pipeline's run path
(``python -m gpras_tpu_torch run`` with the exact backend at N = 17,920 and
16,384 cells) and the run-generation tooling (``select-events`` on a
10,000-event SST catalog, ``make-runs`` for its 49 storms), through the entry
points a user calls, and checks every CUDA kernel on those paths:

0. device: the card's name and power limit, torch and CUDA versions; TF32 off
1. build: nvcc compiles gpras_tpu_torch/csrc into build/gpras_tpu_torch/
2. kernels vs their plain PyTorch versions (float64 on the same float32
   inputs), for all five stationary covariances, at ragged shapes and at the
   shapes the paths give them, with kernel, plain and bound times: the Gram
   (B1), the covariance matvecs (B2, B3), the gradient contraction (B4, B5);
   B2 and B3 also beside torch.matmul on a Gram prebuilt by B1 (fp32, no
   TF32: the library call a user could make instead), B3's CUDA grids
   per call as its entry point counts them, held to the wrapper's plan, and
   for B1, B2, B4 and B5 the time of the CUDA grids alone (many launches of
   the prepared call between two events) beside the whole wrapper call; B1
   also against its first design (a block per 64 x 128 tile of the whole
   output), which must give the same bits, and beside the card's store
   ceiling (torch's fill_ of the same 9.66 GB, timed in turns with B1's
   grids); then the CG training path's shapes, B3 at N = 131,072, R = 17
   (with the library call at N = 49,152, R = 17) and B5 at N = 131,072,
   m = 16; the cold CG fit's shapes, B3 at N = 65,536, R = 128 (beside the
   library call on a 17.2 GB prebuilt Gram) and B5 at m = 127; and every
   kernel at D = 300, past the 128 dimensions a kernel stages in shared
   memory (the kernels' wide path)
3. serving: write a checkpoint and two EOF preprocessors with the port, load
   them in PosteriorPredictor(device="cuda"), answer two LF-field requests,
   and show through the launch counters that B2 and B3 ran (and how many
   CUDA grids B3's calls launched)
4. serving check: the served posterior of mode 0 against the dense float64
   exact posterior (Cholesky of the full 49,152^2 Gram) on the card
5. training: GPRAS(...).fit on the same data, warm-started from a 2,048-point
   rung, then Adam steps on the full-N Hutchinson loss per mode (B1 forward,
   cuSOLVER Cholesky, B5 backward); the launch counters show B1 and B5 ran
6. training checks: mode 0's full-N loss at its certified start against the
   float64 dense NLML minus log prior, and B5 at that point against the
   float64 plain contraction with the same probes; a breakdown of one full-N
   step
7. a 2-step Hutchinson fit at N = 3,072, the path on which B4 runs
8. CG-engine checks at N = 49,152, mode 0, at the serving hyperparameters:
   the CG loss's quad part against the float64 Cholesky's, its SLQ
   log-determinant against the float64 one within 4 standard errors of its
   16 probe terms, and its gradient against the same estimator with exact
   float64 solves; each with what it can see (its reach)
9. the slice at full width: GPRAS(...).fit at N = 131,072 through "auto"
   (a 2,048-point dense rung, one CG forward per mode to certify, 3 Adam
   steps per mode on the CG loss: B3 every mbcg iteration, B5 the backward),
   its launches and peak device memory, and a breakdown of one full-N CG
   step
10. SGPR, the default backend: GPRAS("Matern52").fit with 300 k-means
   inducing points and the default two-stage Adam on phase 5's data, its
   checkpoint served by PosteriorPredictor to phase 3's requests; B1-B5
   launch zero times; the fp32 loss against float64 at the fitted
   parameters and the served posterior against float64 sgpr.predict
11. the cold exact fit at N = 49,152 (mode 0): gp/coldfit.fit_exact with its
   defaults (Hutchinson engine, host L-BFGS) until the band of L*
   (benchmarks/convergence_reference_hard.json); one B1 and one B5 launch
   per evaluation; the final loss against the float64 dense one
12. the cold fit's CG engine at N = 65,536: the segmented step's early exit
   equal bit for bit to the full 256-iteration budget at the initial
   parameters, and fit_exact with max_iter = 2: segments, gate aborts and
   seconds per evaluation, B3 and B5 calls, peak device memory
13. SVGP: GPRAS("Matern52", model_type="svgp") fit on phase 5's data (300
   k-means inducing points, batches of 4,096, 10 epochs, natural-gradient
   steps at 0.5), its checkpoint served by PosteriorPredictor to phase 3's
   requests; B1-B5 launch zero times; the fp32 full-N bound against float64
   in units of eps32 x the sum of its terms, the served posterior against
   float64 svgp.predict; 20 steps traced for the device's idle share
14. SVGP at archive scale (examples/torch_svgp_accuracy.py, the protocol of
   benchmarks/svgp_accuracy.py): N = 2^20, M = 512, B = 8,192, 8 epochs,
   against the collapsed-SGPR gold; RMSE and coverage limits; one epoch
   streamed from pinned host memory equal to the device-resident one; a
   breakdown of one step and the idle share over 20
15. the accuracy north stars (gpras_tpu_torch.accuracy): run_path f32 and
   f64 at DEFAULT_CONFIG, run_exact_path f32 and f64 at EXACT_CONFIG
   (N = 32,768: B1 and B5 once per full-N step, B2 and B3 in the
   prediction), held to the JAX package's recorded accuracy
16. compute_event_metrics on phase 15's predicted depth fields and
   HmsPreProcessor on a seeded forcing frame, on the card against the CPU
17. the pipeline's run path through the CLI (gpras_tpu_torch.__main__.main)
   on a seeded HEC-RAS project written as the builders' parquet DBs (35 train
   / 14 test events x 512 steps x 16,384 cells, float32): "run" cold and
   warm with the exact backend (a 2,048-point rung, then the Hutchinson
   engine at N = 17,920: B1, B5; matrix-free serving: B2, B3), then
   "predict" on 200 LF fields; held to the launch counters (B4 not run), the
   served posterior of every mode against the dense float64 one (phase 4's
   limits), the upskilled depth RMSE below the raw LF field's, the metric
   DB's rows, timers.json's keys, predict against GPRAS.predict, and no
   h5py, matplotlib or jax imported; B1, B2, B3 and B5 are also checked and
   timed at these shapes in phase 2
18. the run-generation tooling through the CLI: "select-events" on a seeded
   SST catalog of 10,000 events x 72 hourly rows (its diversity fill's two
   PCAs on the card, held to the numpy pca_fit_reference, and its STAC item
   byte for byte the CPU path's), then "make-runs" for the 49 selected storms
   on a project with tests/data/cedar_basin.u01 as the template flow file,
   each event's SST.dss a stand-in (a JSON file of its flow records read
   through data/dss.set_dss_factory: the card's machine has no hecdss and no
   DSS files) and no precipitation (hdf_2_dss reads an HDF5 grid; h5py is
   not there); held to 49 flow files and plans registered in the .prj, each
   read back with its event's record window, and the manifest's 35 / 14
   split through the pipeline's event-plan reader; no kernel runs here

Serving uses fixed hyperparameters at values where the serving solver
converges (see training_set); the training phase fits its own. Artifacts go
to build/chip_smoke/ in the checkout. Prints progress, then JSON lines
describing the runs and the kernels, then as the last line {"ok": true,
"device": {...}}. Any failed phase exits non-zero without that line; without
a CUDA device it exits 2 at once.

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
N_CG = 131_072     # the CG training path (exact_engine "auto" above 55,000 points)
R_CG = 17          # its mbcg right-hand sides: y and 16 probes
D_WIDE = 300       # past fused_gram.STAGED_DIM: every kernel's wide path
CG_PEAK_GB = 4.0   # phase 9's and 12's device-memory limit: the engine holds O(N (R + rank))
SGPR_INDUCING = 300  # phase 10: the top of the reference's inducing sweep
SGPR_LOSS_ULPS = 64  # phase 10's loss limit, in eps32 x sum |ELBO terms| (see phase_sgpr)
N_COLD = 65_536      # phase 12: the cold fit's CG engine ("auto" at and above 65,536 points)
R_COLD = 128         # its mbcg right-hand sides: y and 127 probes
COLD_CG_ITERS = 2    # phase 12's L-BFGS iterations
GRID = (192, 256)  # 49,152 cells
M = 16             # Hutchinson probes (the reference's default)
KERNEL_TOL = 1e-4  # |kernel - plain_f64| <= 1e-4 * max|plain_f64| (see phase 2)
MEAN_TOL = 1e-3    # served mean vs dense f64: 1e-3 * max|mean|
VAR_TOL = 1e-2     # served variance vs dense f64: relative
LOSS_TOL = 1e-5    # full-N float32 training loss vs dense f64: relative (see phase 6)
# phase 11's limit at the cold fit's converged parameters (noise ~0.01, var /
# noise ~100): there float32 does not hold LOSS_TOL. The engine's Gram
# entries (r2 = a2 + b2 - 2ab in fp32, as the reference's) and its fp32
# Cholesky miss the float64 NLML by 1.300e-5 relative at this phase's final
# parameters (H100, deterministic) against 1.2e-6 at its start; the limit is
# 7.7x that, and a dropped log prior (1.9e-3 there) stays caught
LOSS_TOL_CONVERGED = 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet): fp32 outside the
# tensor cores, TF32 on them (dense), and HBM3 bandwidth; the bound of a
# kernel is the largest of its operations over the rate of the unit that does
# them and its bytes over the bandwidth
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12
# phase 13, SVGP through GPRAS on phase 5's data
SVGP_INDUCING = 300
SVGP_BATCH = 4096
SVGP_EPOCHS = 10
SVGP_NATGRAD = 0.5
SVGP_LOSS_ULPS = 64  # the fp32 bound's limit, in eps32 x sum |terms| (as phase 10)
SVGP_TRACE_STEPS = 20
# phase 14, benchmarks/svgp_accuracy.py's protocol at archive scale, and its
# limits: RMSE of y within 1.3 x the noise (0.05), coverage of y at 2 sigma,
# RMSE against the gold (the JAX package recorded 0.05721, 0.9838, 0.04629 on
# its own draws, benchmarks/svgp_accuracy_reference.json); the streamed
# epoch's parameters against the device-resident one's (bit for bit expected)
ARCHIVE = {"n": 1 << 20, "m": 512, "b": 8192, "d": 8, "n_test": 8192, "n_sub": 65536,
           "epochs": 8, "hyper_steps": 300, "chunk": 16}
ARCHIVE_RMSE_Y = 0.065
ARCHIVE_COVERAGE = 0.95
ARCHIVE_VS_GOLD = 0.06
STREAM_RTOL = 1e-6
# phase 15, limits from the JAX package's record (benchmarks/accuracy_reference.json:
# ratio 1.027, coverage 0.9957, exact vs f64 8e-6, exact ratio 1.0)
ACC_RATIO = 1.10
ACC_COVERAGE = 0.95
EXACT_VS_F64 = 1e-4
EXACT_RATIO = 1.01
N_ACC = 32_768  # accuracy.EXACT_CONFIG["n_train"]
# phase 16: the card's float64 metrics and HmsPreProcessor against the CPU's
METRIC_RTOL = 1e-10
HMS_RTOL = 1e-8
# phase 17, the pipeline's run path with the exact backend: the CLI's default
# split of 35 train / 14 test events (gpras_tpu/__main__.py:37-38), 512
# steps an event after clipping (5.3 days of 15-minute HEC-RAS output) and
# accuracy.DEFAULT_CONFIG's 16,384 HF cells, so N = 17,920 training
# snapshots: a dense 2,048-point rung, then the Hutchinson engine (B1, B5)
# at full N, and matrix-free serving (B2, B3) above 16,384 points
PIPE_EVENTS = (35, 14)
PIPE_STEPS = 512
PIPE_GRID = (128, 128)
PIPE_BLOCK = 4        # the LF mesh's cells are 4 x 4 HF cells
PIPE_MODES = 4
PIPE_OPTIMIZER = {"max_iter": 30, "learning_rate": 0.05, "warm_start_subsample": 2048}
PIPE_QUERIES = 256    # test queries of the posterior check (phase 4's limits)
PIPE_FIELDS = 200     # LF test fields served by the predict command
PREDICT_RTOL = 1e-5   # predict's output vs GPRAS.predict + reverse_transform, x max|want|
# phase 18, the run-generation tooling: 1,000 catalog years at the reference's
# arrival rate of 10 events a year (gpras_tpu/pipeline/event_selection.py:67),
# 72 hourly rows an event (the SST event length hdf_2_dss assumes,
# gpras_tpu/pipeline/run_maker.py:236-241), the CLI's defaults (35 train and
# 14 test storms at RPs 2-2,000, gpras_tpu/__main__.py:37-41)
SST_EVENTS = 10_000
SST_STEPS = 72
SST_PCA_RTOL = 1e-10  # the card's float64 PCAs vs pca_fit_reference, x max|want|
# the base-flow BCs of tests/data/cedar_basin.u01 (bc_<element>_base) and
# each one's share of the event's inflow in the stand-in records
SST_ELEMENTS = {"cedar_s120": 0.5, "cedar_s110": 0.3, "salado_s220": 0.2}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3, calls: int = 1) -> float:
    """Median device time per call of ``fn`` in ms (CUDA events around
    ``calls`` calls), after one warm-up. One call per event pair includes
    the host's work between the first and the last launch of the call; many
    calls per pair give the device's time per call once its queue is full."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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
    # ptxas names each function, then reports its stack frame and spills
    spills, fn = [], None
    for line in compiler_log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            spills.append(f"{fn}: {line.strip()}")
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s (set-up); "
        f"registers per thread {regs}; spilling kernels: {len(spills)}")
    for line in spills:
        log(f"[build]   {line}")


def bound(flops: float, nbytes: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, what binds it) for work of ``flops`` fp32
    operations on the CUDA cores and ``tc_flops`` TF32 operations on the
    tensor cores (the two run side by side) that must move ``nbytes``
    (inputs read once, outputs written once)."""
    t_ops = max(flops / FP32_FLOPS, tc_flops / TF32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# fp32 operations per covariance entry: the d-wide dot or difference sum,
# r2, and the Matern52 tail (sqrt, exp and ~8 multiply-adds)
def entry_ops(d: int = D) -> int:
    return 2 * d + 12


def gram_work(n1: int, n2: int, d: int = D) -> tuple[float, float]:
    return n1 * n2 * entry_ops(d), 4.0 * (n1 * n2 + (n1 + n2) * d)


def kmv_work(n1: int, n2: int, r: int, sym: bool, d: int = D) -> tuple[float, float, float]:
    """(fp32 operations, bytes, TF32 operations) of (K(x1, x2) [+ noise I]) @ V
    at fp32 accuracy: each distinct covariance entry built once on the CUDA
    cores (half the square when symmetric), the contraction as three TF32
    products (3xTF32) on the tensor cores."""
    tiles = n1 * n2 / 2 if sym else n1 * n2
    return (tiles * entry_ops(d), 4.0 * ((n1 + n2) * d + n2 * r + n1 * r),
            3 * 2.0 * n1 * n2 * r)


def kmv_bound_fp32(n1: int, n2: int, r: int, sym: bool) -> float:
    """The earlier fp32-only bound, kept beside the new one for comparison:
    the contraction as fp32 operations at 67 TFLOP/s too."""
    flops, nbytes, tc_flops = kmv_work(n1, n2, r, sym)
    return bound(flops + tc_flops / 3, nbytes)[0]


def kgrad_work(n: int, d: int = D, m: int = M) -> tuple[float, float]:
    """The function's work, whichever body computes it (B4 and B5 compute the
    same sum). dK is symmetric, so r2 (3d), the lengthscale weights (3d), f
    and f' (~12) and the variance and weight products (~7) are needed once
    per pair i <= j, n(n+1)/2 pairs, with the folded cotangent
    Kbar_ij + Kbar_ji (two rank-m dots, 4m) on each. All of it fp32 on the
    CUDA cores: no kernel here puts the cotangent on the tensor cores."""
    return n * (n + 1) / 2 * (6 * d + 4 * m + 19), 4.0 * n * (d + 2 * m + 1)


def flat(out):
    """A kernel result as one tensor (kgrad returns a dict)."""
    import torch

    if isinstance(out, dict):
        return torch.cat([out["log_variance"].reshape(1), out["log_lengthscales"]])
    return out


def phase_kernels():
    """Each kernel against its plain version, run in float64 on the same
    float32 inputs. The kernels' own error is fp32 rounding of the entries
    and of sums over up to 49,152 terms (B2, B3; B3's 3xTF32 products above
    16 columns miss ~2^-22 of each product) or of 1.2e9 terms taken in
    float64 per tile (B4, B5), ~1e-6 of the result's scale; the gate
    1e-4 * max|want| catches any wrong tile, mask or mirror (those move a
    result by whole tiles of entries, ~1e-2 of the scale)."""
    import torch

    from gpras_tpu_torch.ops import fused_gram
    from gpras_tpu_torch.ops import kernels as K

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # report: measured rows of the kernels line; fp32_bounds: B2's and B3's
    # fp32-only bound (the contraction at the fp32 rate too), printed on
    # a line of its own beside the kernels line
    report, fp32_bounds = {}, {}

    def prebuilt_matmul(kernel, params, x1, x2, noise, v):
        """torch.matmul(K, v) on K = K(x1, x2) [+ noise I] built once by B1:
        the library call that computes the matvec when K fits on the card."""
        kmat = fused_gram.gram(kernel, params, x1, x2, noise=noise)
        return lambda: torch.matmul(kmat, v)

    def inputs(n1, n2, r, d=D):
        scales = ([1.0, 0.6, 0.35] + [10.0] * d)[:d]
        params = {"log_variance": torch.tensor(0.0, device=dev),
                  "log_lengthscales": torch.log(torch.tensor(scales, device=dev))}
        x1 = torch.randn(n1, d, generator=gen).to(dev)
        x2 = torch.randn(n2, d, generator=gen).to(dev)
        v = torch.randn(n2, r, generator=gen).to(dev)
        return params, x1, x2, v

    def check(name, kernel, shape, run, want, run_plain32=None, work=None, library=None,
              grids=None):
        """``want``: the float64 plain result, or a function of the kernel's
        result that returns (max error, scale). ``library``: a function that
        sets up the library call (untimed) and returns it, to be timed beside
        the kernel. ``grids``: a function that prepares the call and returns
        (its launch function, its output): the CUDA grids without the
        wrapper, timed many per event pair into that output."""
        got = run()
        if callable(want):
            err, scale = want(got)
        else:
            torch.cuda.synchronize()
            err = (flat(got).double() - flat(want)).abs().max().item()
            scale = flat(want).abs().max().item()
        del got
        ok = err <= KERNEL_TOL * scale
        line = f"[kernels] {name:11s} {kernel:11s} {shape:22s} max_abs_err {err:.3e} " \
               f"(scale {scale:.3e}) {'ok' if ok else 'FAIL'}"
        if run_plain32 is not None:
            ms, plain_ms = cuda_ms(run), cuda_ms(run_plain32)
            if ms < 1.0:  # a call this short varies with the host: more repetitions
                ms = cuda_ms(run, reps=21)
            bound_ms, bound_by = bound(*work)
            calls = 200 if ms < 1.0 else 5
            grids_ms = None
            if grids is not None:
                launch, _out = grids()
                grids_ms = cuda_ms(launch, calls=calls)
                del launch, _out
                torch.cuda.empty_cache()
            library_ms = library_queued_ms = None
            if library is not None:
                call = library()
                library_ms = cuda_ms(call, reps=21 if ms < 1.0 else 3)
                if grids is not None:
                    library_queued_ms = cuda_ms(call, calls=calls)
                del call
                torch.cuda.empty_cache()
            line += f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  " \
                    f"bound {bound_ms:.4f} ms ({bound_by})"
            if grids_ms is not None:
                line += f"  grids alone {grids_ms:.4f} ms ({calls} launches per event pair)"
            if library_ms is not None:
                line += f"  library {library_ms:.4f} ms"
            if library_queued_ms is not None:
                line += f" ({library_queued_ms:.4f} ms at {calls} per pair)"
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms, "grids_ms": grids_ms,
                   "library_queued_ms": library_queued_ms}
            report.setdefault(name, {})[(kernel, shape)] = row
        log(line)
        if not ok:
            raise AssertionError(f"{name} {kernel} {shape}: error {err} > {KERNEL_TOL} * {scale}")

    def f64(params):
        return {k: v.double() for k, v in params.items()}

    def gram_error(kernel, params, x1, x2, noise, got, panel=2048):
        """max |got - plain_f64| over row panels: no 19 GB float64 Gram."""
        err = scale = 0.0
        for r0 in range(0, x1.shape[0], panel):
            want = K.gram(kernel, params, x1[r0:r0 + panel], x1 if x2 is None else x2)
            if noise is not None:
                idx = torch.arange(want.shape[0], device=want.device)
                want[idx, r0 + idx] += noise
            err = max(err, (got[r0:r0 + panel].double() - want).abs().max().item())
            scale = max(scale, want.abs().max().item())
        return err, scale

    for kernel in K.STATIONARY_KERNELS:
        # B1: ragged cross and square (rows of 3,001 or 5,003 floats are not
        # 16-byte aligned: the 4-byte store path; 3,000 and 5,004 are), and the
        # training Gram K + noise I, timed; each equal bit for bit to the
        # first design
        for n1, n2 in [(4999, 3001), (4999, 3000), (5003, None), (5004, None), (N, None)]:
            params, x1, x2, _ = inputs(n1, n2 or n1, 1)
            x2 = None if n2 is None else x2
            nz = None if n2 else torch.tensor(1e-2, device=dev)
            shape = f"{n1}x{n2 or n1}" + ("" if n2 else " +noise")
            timed = n1 == N
            check("gram", kernel, shape,
                  lambda: fused_gram.gram(kernel, params, x1, x2, noise=nz),
                  lambda got: gram_error(kernel, f64(params), x1.double(),
                                         None if x2 is None else x2.double(),
                                         None if n2 else 1e-2, got),
                  (lambda: fused_gram.gram_plain(kernel, params, x1, x2, noise=nz))
                  if timed else None,
                  gram_work(n1, n2 or n1),
                  grids=lambda: fused_gram._gram_cuda(kernel, params, x1, x2, nz))
            got = fused_gram.gram(kernel, params, x1, x2, noise=nz)
            launch, first = fused_gram._gram_cuda(kernel, params, x1, x2, nz, tiles=True)
            if launch() != 0:
                raise AssertionError(f"gram {kernel} {shape}: the first design did not launch")
            same = torch.equal(got, first)
            del got, first, launch
            torch.cuda.empty_cache()
            log(f"[kernels] gram        {kernel:11s} {shape:22s} equal bit for bit to the first "
                f"design: {same}")
            if not same:
                raise AssertionError(f"gram {kernel} {shape}: not the first design's bits")
            if timed and kernel == "Matern52":
                # the store ceiling: fill_ of the same bytes, in turns with
                # B1's grids (grids, fill_, fill_, grids), each warmed by
                # three untimed calls into its own buffer, 5 calls per pair
                buf = torch.empty((N, N), dtype=torch.float32, device=dev)
                launch, out = fused_gram._gram_cuda(kernel, params, x1, x2, nz)
                runs = {"grids": launch, "fill_": lambda: buf.fill_(1.0)}
                for fn in runs.values():
                    for _ in range(3):
                        fn()
                turns = {name: [] for name in runs}
                for name in ("grids", "fill_", "fill_", "grids"):
                    turns[name].append(cuda_ms(runs[name], calls=5))
                del buf, launch, out, runs
                torch.cuda.empty_cache()
                row = report["gram"][(kernel, shape)]
                row["store_ceiling_ms"] = min(turns["fill_"])
                row["grids_in_turns_ms"] = turns["grids"]
                fills, grids_t = (" / ".join(f"{t:.4f}" for t in turns[name])
                                  for name in ("fill_", "grids"))
                log(f"[kernels] gram        store ceiling: torch fill_ of the same "
                    f"{4 * N * N / 1e9:.2f} GB {fills} ms, in turns with B1's grids {grids_t} ms "
                    "(5 launches per event pair; no library call computes a stationary Gram)")
        # B2. Its rows design (R <= 16, few row tiles): 1 to 300 queries, 1, 7
        # and 16 right-hand sides, cross (3,001 points: 47 stages, the last
        # ragged) and square with noise on the diagonal; its tiled design at
        # R = 33; then the serving shapes, the posterior mean of a 64- or
        # 256-query bucket, timed: the whole wrapper call, the grids alone,
        # and the library call, torch.matmul on K(x1, x2) built by B1
        shapes = [(n1, n2, r, False) for n1 in (1, 17, 64, 256, 300) for r in (1, 7, 16)
                  for n2 in (3001, None)]
        shapes += [(4999, 3001, 1, False), (4999, 3001, 7, False), (4999, 3001, 33, False),
                   (64, N, 1, True), (256, N, 1, True)]
        for (n1, n2, r, timed) in shapes:
            params, x1, x2, v = inputs(n1, n2 or n1, r)
            x2 = None if n2 is None else x2
            nz = None if n2 else torch.tensor(1e-2, device=dev)
            planned = fused_gram.kmv_dense_plan(n1, n2 or n1, r, sms)
            if planned.rows != (r <= 16):
                raise AssertionError(f"kmv_dense {n1}x{n2 or n1} R={r}: unexpected {planned}")
            check("kmv_dense", kernel, f"{n1}x{n2 or n1} R={r}" + ("" if n2 else " +noise"),
                  lambda: fused_gram.kmv_dense(kernel, params, x1, v, x2=x2, noise=nz),
                  fused_gram.kmv_plain(kernel, f64(params), x1.double(), v.double(),
                                       x2=None if x2 is None else x2.double(),
                                       noise=None if n2 else 1e-2),
                  (lambda: fused_gram.kmv_plain(kernel, params, x1, v, x2=x2)) if timed else None,
                  kmv_work(n1, n2 or n1, r, False),
                  library=lambda: prebuilt_matmul(kernel, params, x1, x2, None, v),
                  grids=(lambda: fused_gram._kmv_dense_cuda(kernel, params, x1, v, x2, nz))
                  if timed else None)
            if timed:
                fp32_bounds[f"kmv_dense {kernel} {n1}x{n2} R={r}"] = kmv_bound_fp32(n1, n2, r,
                                                                                     False)
        # B3, at the serving shapes: the alpha solve (R = 1) and the variance
        # solves of a 64- and a 256-query bucket; R picks the kernel's build
        # (symmetric up to 16, tensor-core 64 or 256 columns a block above), so
        # each build runs at the shape it serves, and at ragged edges (5003
        # points; 7, 17 and 300 columns). The grids its calls launched, as the
        # kernel's entry point counts them, must be the plan's
        for (n, r, timed) in [(5003, 1, False), (5003, 7, False), (5003, 17, False),
                              (5003, 300, False), (N, 1, True), (N, 64, True), (N, 256, True)]:
            params, x, _, v = inputs(n, n, r)
            noise = torch.tensor(1e-2, device=dev)
            calls0, grids0 = fused_gram.kmv_sym.launches, fused_gram.kmv_sym.grids
            check("kmv_sym", kernel, f"{n}x{n} R={r}",
                  lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
                  fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(), noise=1e-2),
                  (lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise))
                  if timed else None,
                  kmv_work(n, n, r, True),
                  library=lambda: prebuilt_matmul(kernel, params, x, None, noise, v))
            calls = fused_gram.kmv_sym.launches - calls0
            grids, rest = divmod(fused_gram.kmv_sym.grids - grids0, calls)
            planned = fused_gram.kmv_sym_plan(n, D, r, sms).grids
            log(f"[kernels] kmv_sym     {kernel:11s} {n}x{n} R={r}: {grids} CUDA grids per call "
                f"over {calls} calls (planned {planned}; the former diagonal wavefront: "
                f"ceil(N / 64) + 1 = {-(-n // 64) + 1})")
            if rest or grids != planned:
                raise AssertionError(f"kmv_sym launched {grids * calls + rest} grids in {calls} "
                                     f"calls, the plan has {planned} a call")
            if timed:
                report["kmv_sym"][(kernel, f"{n}x{n} R={r}")]["grids_per_call"] = grids
                fp32_bounds[f"kmv_sym {kernel} {n}x{n} R={r}"] = kmv_bound_fp32(n, n, r, True)
        # B4 (the Hutchinson backward up to 3,584 points; 3,072 is phase 7's
        # path) and B5 (above it; 49,152 is the training path): 1, 7 and 16
        # probes, one input dimension and more than eight, every seventh point
        # a copy of its neighbour (coincident points: r2 == 0 off the
        # diagonal). Timed at the two path shapes only
        shapes = [(3001, False, D, M), (3072, False, D, M), (3584, False, D, M)]
        shapes += [(n, True, D, m) for n in (3585, 5003, N) for m in (1, 7, M)]
        shapes += [(5003, True, 1, M), (5003, True, 11, M)]
        for n, sym, d, m in shapes:
            params, x, _, _ = inputs(n, n, 1, d)
            x[1::7] = x[0::7][:x[1::7].shape[0]]
            w = torch.randn(n, m, generator=gen).to(dev)
            z = (2 * torch.randint(0, 2, (n, m), generator=gen) - 1).float().to(dev)
            alpha = torch.randn(n, generator=gen).to(dev)
            fn = fused_gram.kgrad_sym if sym else fused_gram.kgrad_dense
            timed = (n, d, m) in ((3072, D, M), (N, D, M))
            check(fn.__name__, kernel, f"N={n} m={m}" + ("" if d == D else f" D={d}"),
                  lambda: fn(kernel, params, x, w, z, alpha, 1.3, 1.0 / m),
                  fused_gram.kgrad_plain(kernel, f64(params), x.double(), w.double(),
                                         z.double(), alpha.double(), 1.3, 1.0 / m),
                  (lambda: fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, 1.3, 1.0 / m))
                  if timed else None,
                  kgrad_work(n, d, m),
                  grids=(lambda: fused_gram._kgrad_cuda(sym, kernel, params, x, w, z, alpha, 1.3,
                                                        1.0 / m)) if timed else None)
        torch.cuda.empty_cache()

    # The CG training path (phase 9), Matern52: B3 at N = 131,072 with
    # R = 17 (the target and 16 probes, every mbcg iteration; planned as the
    # 64-column tensor-core build) and B5 at m = 16 (the backward; the path's
    # V = P^-1 z is not +-1, so normal draws), each timed with its grids
    # alone. The library call for B3 at R = 17 runs on a Gram built by B1 at
    # N = 49,152: a prebuilt fp32 Gram at 131,072 would be 68.7 GB.
    kernel = "Matern52"
    noise = torch.tensor(1e-2, device=dev)
    for n, library in ((N_CG, False), (N, True)):
        params, x, _, v = inputs(n, n, R_CG)
        plan = fused_gram.kmv_sym_plan(n, D, R_CG, sms)
        check("kmv_sym", kernel, f"{n}x{n} R={R_CG}",
              lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
              fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(), noise=1e-2),
              lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise),
              kmv_work(n, n, R_CG, True),
              library=(lambda: prebuilt_matmul(kernel, params, x, None, noise, v))
              if library else None,
              grids=lambda: fused_gram._kmv_sym_cuda(plan, kernel, params, x, v, noise)[:2])
        torch.cuda.empty_cache()
    params, x, _, _ = inputs(N_CG, N_CG, 1)
    w, z = (torch.randn(N_CG, M, generator=gen).to(dev) for _ in range(2))
    alpha = torch.randn(N_CG, generator=gen).to(dev)
    check("kgrad_sym", kernel, f"N={N_CG} m={M}",
          lambda: fused_gram.kgrad_sym(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
          fused_gram.kgrad_plain(kernel, f64(params), x.double(), w.double(), z.double(),
                                 alpha.double(), 1.3, 1.0 / M),
          lambda: fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
          kgrad_work(N_CG, D, M),
          grids=lambda: fused_gram._kgrad_cuda(True, kernel, params, x, w, z, alpha, 1.3,
                                               1.0 / M))
    del params, x, w, z, alpha
    torch.cuda.empty_cache()

    # The cold fit's CG path (phase 12), Matern52 at N = 65,536: B3 with
    # R = 128 (y and 127 probes, every mbcg iteration; the 256-column
    # tensor-core build) beside the library call on a Gram prebuilt by B1
    # (17.2 GB), and B5 at m = 127 (the backward, normal draws as the path's
    # V = P^-1 z). The cold Hutchinson fit (phase 11) runs B1 and B5 at
    # phase 5's shapes, checked above.
    params, x, _, v = inputs(N_COLD, N_COLD, R_COLD)
    plan = fused_gram.kmv_sym_plan(N_COLD, D, R_COLD, sms)
    check("kmv_sym", kernel, f"{N_COLD}x{N_COLD} R={R_COLD}",
          lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
          fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(), noise=1e-2),
          lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise),
          kmv_work(N_COLD, N_COLD, R_COLD, True),
          library=lambda: prebuilt_matmul(kernel, params, x, None, noise, v),
          grids=lambda: fused_gram._kmv_sym_cuda(plan, kernel, params, x, v, noise)[:2])
    m = R_COLD - 1
    w, z = (torch.randn(N_COLD, m, generator=gen).to(dev) for _ in range(2))
    alpha = torch.randn(N_COLD, generator=gen).to(dev)
    check("kgrad_sym", kernel, f"N={N_COLD} m={m}",
          lambda: fused_gram.kgrad_sym(kernel, params, x, w, z, alpha, 1.3, 1.0 / m),
          fused_gram.kgrad_plain(kernel, f64(params), x.double(), w.double(), z.double(),
                                 alpha.double(), 1.3, 1.0 / m),
          lambda: fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, 1.3, 1.0 / m),
          kgrad_work(N_COLD, D, m),
          grids=lambda: fused_gram._kgrad_cuda(True, kernel, params, x, w, z, alpha, 1.3,
                                               1.0 / m))
    del params, x, v, w, z, alpha
    torch.cuda.empty_cache()

    # The exact accuracy path (phase 15), Matern52 at N = 32,768: B1 (the
    # Hutchinson forward) and B5 at m = 16 Rademacher probes (its backward)
    # in every full-N step; B2 for the posterior mean of 2,048 test points;
    # B3 for the alpha solve (R = 1) and the variance solves (R = 256, the
    # queries 256 at a time), beside the library call on a prebuilt Gram
    params, x, _, _ = inputs(N_ACC, N_ACC, 1)
    check("gram", kernel, f"{N_ACC}x{N_ACC} +noise",
          lambda: fused_gram.gram(kernel, params, x, noise=noise),
          lambda got: gram_error(kernel, f64(params), x.double(), None, 1e-2, got),
          lambda: fused_gram.gram_plain(kernel, params, x, noise=noise),
          gram_work(N_ACC, N_ACC),
          grids=lambda: fused_gram._gram_cuda(kernel, params, x, None, noise))
    w = torch.randn(N_ACC, M, generator=gen).to(dev)
    z = (2 * torch.randint(0, 2, (N_ACC, M), generator=gen) - 1).float().to(dev)
    alpha = torch.randn(N_ACC, generator=gen).to(dev)
    check("kgrad_sym", kernel, f"N={N_ACC} m={M}",
          lambda: fused_gram.kgrad_sym(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
          fused_gram.kgrad_plain(kernel, f64(params), x.double(), w.double(), z.double(),
                                 alpha.double(), 1.3, 1.0 / M),
          lambda: fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
          kgrad_work(N_ACC, D, M),
          grids=lambda: fused_gram._kgrad_cuda(True, kernel, params, x, w, z, alpha, 1.3,
                                               1.0 / M))
    del w, z, alpha
    params, x1, x2, v = inputs(2048, N_ACC, 1)
    check("kmv_dense", kernel, f"2048x{N_ACC} R=1",
          lambda: fused_gram.kmv_dense(kernel, params, x1, v, x2=x2),
          fused_gram.kmv_plain(kernel, f64(params), x1.double(), v.double(), x2=x2.double()),
          lambda: fused_gram.kmv_plain(kernel, params, x1, v, x2=x2),
          kmv_work(2048, N_ACC, 1, False),
          library=lambda: prebuilt_matmul(kernel, params, x1, x2, None, v),
          grids=lambda: fused_gram._kmv_dense_cuda(kernel, params, x1, v, x2, None))
    for r in (1, 256):
        params, x, _, v = inputs(N_ACC, N_ACC, r)
        plan = fused_gram.kmv_sym_plan(N_ACC, D, r, sms)
        check("kmv_sym", kernel, f"{N_ACC}x{N_ACC} R={r}",
              lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
              fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(), noise=1e-2),
              lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise),
              kmv_work(N_ACC, N_ACC, r, True),
              library=lambda: prebuilt_matmul(kernel, params, x, None, noise, v),
              grids=lambda: fused_gram._kmv_sym_cuda(plan, kernel, params, x, v, noise)[:2])
    del params, x, x1, x2, v
    torch.cuda.empty_cache()

    # The pipeline's run path (phase 17), Matern52 on its D = 4 EOF modes at
    # N = 17,920: B1 (the Hutchinson forward) and B5 at m = 16 Rademacher
    # probes (its backward) every full-N step; B2 for the posterior mean of
    # the 7,168 test snapshots; B3 for the alpha solves (R = 1) and the
    # variance solves (R = 256, the queries 256 at a time), beside the
    # library call on a prebuilt Gram
    n, nq, d = PIPE_EVENTS[0] * PIPE_STEPS, PIPE_EVENTS[1] * PIPE_STEPS, PIPE_MODES
    params, x, _, _ = inputs(n, n, 1, d)
    check("gram", kernel, f"{n}x{n} +noise D={d}",
          lambda: fused_gram.gram(kernel, params, x, noise=noise),
          lambda got: gram_error(kernel, f64(params), x.double(), None, 1e-2, got),
          lambda: fused_gram.gram_plain(kernel, params, x, noise=noise),
          gram_work(n, n, d),
          grids=lambda: fused_gram._gram_cuda(kernel, params, x, None, noise))
    w = torch.randn(n, M, generator=gen).to(dev)
    z = (2 * torch.randint(0, 2, (n, M), generator=gen) - 1).float().to(dev)
    alpha = torch.randn(n, generator=gen).to(dev)
    check("kgrad_sym", kernel, f"N={n} m={M} D={d}",
          lambda: fused_gram.kgrad_sym(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
          fused_gram.kgrad_plain(kernel, f64(params), x.double(), w.double(), z.double(),
                                 alpha.double(), 1.3, 1.0 / M),
          lambda: fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
          kgrad_work(n, d, M),
          grids=lambda: fused_gram._kgrad_cuda(True, kernel, params, x, w, z, alpha, 1.3,
                                               1.0 / M))
    del w, z, alpha
    params, x1, x2, v = inputs(nq, n, 1, d)
    check("kmv_dense", kernel, f"{nq}x{n} R=1 D={d}",
          lambda: fused_gram.kmv_dense(kernel, params, x1, v, x2=x2),
          fused_gram.kmv_plain(kernel, f64(params), x1.double(), v.double(), x2=x2.double()),
          lambda: fused_gram.kmv_plain(kernel, params, x1, v, x2=x2),
          kmv_work(nq, n, 1, False, d),
          library=lambda: prebuilt_matmul(kernel, params, x1, x2, None, v),
          grids=lambda: fused_gram._kmv_dense_cuda(kernel, params, x1, v, x2, None))
    for r in (1, 256):
        params, x, _, v = inputs(n, n, r, d)
        plan = fused_gram.kmv_sym_plan(n, d, r, sms)
        check("kmv_sym", kernel, f"{n}x{n} R={r} D={d}",
              lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
              fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(), noise=1e-2),
              lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise),
              kmv_work(n, n, r, True, d),
              library=lambda: prebuilt_matmul(kernel, params, x, None, noise, v),
              grids=lambda: fused_gram._kmv_sym_cuda(plan, kernel, params, x, v, noise)[:2])
    del params, x, x1, x2, v
    torch.cuda.empty_cache()

    # Every kernel at D = 300 (the wide path: 128 coordinates a point staged,
    # B2's tiled build 128 at a time; its rows design is not planned past 128):
    # B1 a small square, B2 a serving bucket against 8,192 points, B3 through
    # both builds, B4 and B5 at N = 4,096. Lengthscales ~sqrt(D) keep the
    # covariances far from 0 and 1.
    def wide(n1, n2, r):
        params = {"log_variance": torch.tensor(0.0, device=dev),
                  "log_lengthscales": torch.log(math.sqrt(D_WIDE) * torch.linspace(
                      0.8, 1.2, D_WIDE, device=dev))}
        x1, x2, v = (torch.randn(a, b, generator=gen).to(dev)
                     for a, b in ((n1, D_WIDE), (n2, D_WIDE), (n2, r)))
        return params, x1, x2, v

    tag = f" D={D_WIDE}"
    params, x, _, _ = wide(2003, 2003, 1)
    check("gram", kernel, "2003x2003 +noise" + tag,
          lambda: fused_gram.gram(kernel, params, x, noise=noise),
          lambda got: gram_error(kernel, f64(params), x.double(), None, 1e-2, got),
          lambda: fused_gram.gram_plain(kernel, params, x, noise=noise),
          gram_work(2003, 2003, D_WIDE),
          grids=lambda: fused_gram._gram_cuda(kernel, params, x, None, noise))
    params, x1, x2, v = wide(256, 8192, 1)
    check("kmv_dense", kernel, "256x8192 R=1" + tag,
          lambda: fused_gram.kmv_dense(kernel, params, x1, v, x2=x2),
          fused_gram.kmv_plain(kernel, f64(params), x1.double(), v.double(), x2=x2.double()),
          lambda: fused_gram.kmv_plain(kernel, params, x1, v, x2=x2),
          kmv_work(256, 8192, 1, False, D_WIDE),
          library=lambda: prebuilt_matmul(kernel, params, x1, x2, None, v),
          grids=lambda: fused_gram._kmv_dense_cuda(kernel, params, x1, v, x2, None))
    for r in (1, 64):
        params, x, _, v = wide(8192, 8192, r)
        plan = fused_gram.kmv_sym_plan(8192, D_WIDE, r, sms)
        check("kmv_sym", kernel, f"8192x8192 R={r}" + tag,
              lambda: fused_gram.kmv_sym(kernel, params, x, v, noise=noise),
              fused_gram.kmv_plain(kernel, f64(params), x.double(), v.double(), noise=1e-2),
              lambda: fused_gram.kmv_plain(kernel, params, x, v, noise=noise),
              kmv_work(8192, 8192, r, True, D_WIDE),
              library=lambda: prebuilt_matmul(kernel, params, x, None, noise, v),
              grids=lambda: fused_gram._kmv_sym_cuda(plan, kernel, params, x, v, noise)[:2])
    params, x, _, _ = wide(4096, 4096, 1)
    w, z = (torch.randn(4096, M, generator=gen).to(dev) for _ in range(2))
    alpha = torch.randn(4096, generator=gen).to(dev)
    for sym, fn in ((False, fused_gram.kgrad_dense), (True, fused_gram.kgrad_sym)):
        check(fn.__name__, kernel, f"N=4096 m={M}" + tag,
              lambda: fn(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
              fused_gram.kgrad_plain(kernel, f64(params), x.double(), w.double(), z.double(),
                                     alpha.double(), 1.3, 1.0 / M),
              lambda: fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, 1.3, 1.0 / M),
              kgrad_work(4096, D_WIDE, M),
              grids=lambda: fused_gram._kgrad_cuda(sym, kernel, params, x, w, z, alpha, 1.3,
                                                   1.0 / M))
    torch.cuda.empty_cache()
    return report, fp32_bounds


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


def training_set(n: int = N):
    """bench._make_data_hard's recipe (seed 7) for mode 0, plus three seeded
    smooth responses of the same three active inputs, at n points.

    The per-mode Matern52 hyperparameters that serving uses are fixed:
    lengthscales 3-6 on the active inputs, 10 on the nuisance ones,
    noise variance 0.1. They are chosen so that the reference's serving
    solver (64 preconditioned CG iterations, rank-64 pivoted-Cholesky
    preconditioner) converges at N = 49,152; they are not the data's
    likelihood optimum. At the generating scales (0.35-1, noise 0.01) that
    solver misses the dense posterior by O(1), in the JAX package as in the
    port (PERF.md; examples/torch_cg_convergence.py), and the dense check
    below could not tell a fault of the port from that."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, D)).astype(np.float32)
    ys = [np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.4 * np.sin(4.0 * x[:, 2])
          + 0.1 * rng.normal(size=n)]
    ls = [[3.5, 3.0, 3.0] + [10.0] * (D - 3)]
    for p in range(1, P):
        g = np.random.default_rng(100 + p)
        w = g.normal(size=3)
        ys.append(np.sin(x[:, :3] @ w) + 0.1 * g.normal(size=n))
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
        "64-iteration PCG solver converges")
    requests = [synthetic_fields(np.random.default_rng(12 + i), n)[0]
                for i, n in enumerate((17, 200))]

    zero_counters()
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
    sym_grids = fused_gram.kmv_sym.grids
    log(f"[serving] kernel launches during the serving run: {launches}; CUDA grids of those "
        f"kmv_sym calls: {sym_grids}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return pred, requests[0], launches, sym_grids, cache_s, latencies


def dense_posterior64(model, mode: int, xq):
    """The dense float64 exact posterior (mean, variance) of ``model``'s mode
    at the float64 queries ``xq``, as numpy arrays: the Gram built in row
    panels and factorized on the card, with the served model's noise
    (likelihood noise + the float32 relative jitter)."""
    import torch

    from gpras_tpu_torch.ops import kernels as K
    from gpras_tpu_torch.ops import linalg

    p = {k: v[mode].double() for k, v in model.params.items()}
    x = model.x.double()
    n = x.shape[0]
    kmat = torch.empty((n, n), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, 4096):
        kmat[r0:r0 + 4096] = K.gram("Matern52", p, x[r0:r0 + 4096], x)
    noise = torch.exp(p["log_noise_variance"]) + \
        linalg.default_jitter(torch.float32) * torch.exp(p["log_variance"])
    kmat.diagonal().add_(noise)
    chol, info = torch.linalg.cholesky_ex(kmat)
    del kmat
    if int(info) != 0:
        raise AssertionError(f"dense float64 Cholesky failed (info {int(info)})")
    alpha = torch.cholesky_solve(model.y[:, mode:mode + 1].double(), chol)
    ks = K.gram("Matern52", p, xq, x)
    mean = (ks @ alpha)[:, 0].cpu().numpy()
    v = torch.linalg.solve_triangular(chol, ks.T, upper=False)
    var = (torch.clamp_min(K.kdiag("Matern52", p, xq) - (v * v).sum(0), 0.0)
           + torch.exp(p["log_noise_variance"])).cpu().numpy()
    del chol, v
    torch.cuda.empty_cache()
    return mean, var


def phase_dense_check(pred, request):
    """Mode 0 of the first request against the dense float64 exact posterior
    of the same model, built and factorized on the card (the Gram and its
    factor take ~19 GB each)."""
    import torch

    xq_np = pred.lf_pre.transform(request)
    mean, var = pred.predict_modes(xq_np)
    t0 = time.perf_counter()
    xq = torch.as_tensor(xq_np, dtype=torch.float64, device=pred.model.x.device)
    want_mean, want_var = dense_posterior64(pred.model, 0, xq)
    mean_err = float(np.abs(mean[:, 0] - want_mean).max())
    var_err = float((np.abs(var[:, 0] - want_var) / want_var).max())
    log(f"[check] mode 0, {len(want_mean)} queries vs dense float64 posterior "
        f"({time.perf_counter() - t0:.1f} s): mean max abs err {mean_err:.3e} "
        f"(limit {MEAN_TOL} * {np.abs(want_mean).max():.3e}), variance max rel err "
        f"{var_err:.3e} (limit {VAR_TOL})")
    if mean_err > MEAN_TOL * np.abs(want_mean).max() or var_err > VAR_TOL:
        raise AssertionError("served posterior disagrees with the dense float64 posterior")
    return mean_err, var_err


def counters():
    from gpras_tpu_torch.ops import fused_gram

    return {"gram": fused_gram.gram, "kmv_dense": fused_gram.kmv_dense,
            "kmv_sym": fused_gram.kmv_sym, "kgrad_dense": fused_gram.kgrad_dense,
            "kgrad_sym": fused_gram.kgrad_sym}


def zero_counters() -> None:
    from gpras_tpu_torch.ops import fused_gram

    for fn in counters().values():
        fn.launches = 0
    fused_gram.kmv_sym.grids = 0


def read_counters() -> dict[str, int]:
    return {name: fn.launches for name, fn in counters().items()}


def phase_training(x, y, tag="training", need=("gram", "kgrad_sym"), forbid=(),
                   peak_limit_gb=None):
    """GPRAS.fit at full width through "auto": the warm-start rung (2,048
    points, dense engine), one certifying full-N forward per mode, then Adam
    steps on the full-N loss of the engine N selects. Host-clock times of
    each full-N loss evaluation come from a wrapper around the model's loss
    (synchronised before each). Fails on a non-finite loss or parameter, when
    a kernel of ``need`` never launched or one of ``forbid`` did, and when
    the peak device memory exceeds ``peak_limit_gb``."""
    import torch

    from gpras_tpu_torch import GPRAS

    model = GPRAS("Matern52", model_type="exact", device=DEVICE)
    calls = []  # (mode index, gradient on, start time, parameters)
    loss_fn = model._loss_fn

    def timed_loss(p, y_i):
        torch.cuda.synchronize()
        mode = next(i for i in range(P) if model.y[:, i].data_ptr() == y_i.data_ptr())
        calls.append((mode, torch.is_grad_enabled(), time.perf_counter(),
                      {k: v.detach().clone() for k, v in p.items()}))
        return loss_fn(p, y_i)

    model._loss_fn = timed_loss
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(x, y, optimization_method="adam", learning_rate=0.02, max_iter=3,
              warm_start_subsample=2048)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model._loss_fn
    ends = [c[2] for c in calls[1:]] + [t0 + fit_s]
    info = model.warm_start_info
    log(f"[{tag}] fit of {P} modes at N={x.shape[0]} (engine {model._engine()}) in "
        f"{fit_s:.3f} s (warm rung 2,048 points, max_iter 3, lr 0.02); peak device memory "
        f"{peak_gb:.3f} GB; launches {launches}; modes that fell back to the standard init "
        f"{info['fell_back_modes']}")
    per_mode = []
    for i in range(P):
        iters = int(model.fit_info["iterations"][i])
        losses = model.fit_info["losses"][i][:iters].tolist()
        steps = [end - c[2] for c, end in zip(calls, ends) if c[0] == i and c[1]]
        rejected = sum(not math.isfinite(v) for v in losses)
        per_mode.append({"ratio_cap": info["ratio_caps"][i], "cert_loss": info["cert_losses"][i],
                         "fell_back": i in info["fell_back_modes"], "losses": losses,
                         "final_loss": float(model.fit_info["loss"][i]), "rejected": rejected,
                         "step_s": steps})
        log(f"[{tag}] mode {i}: warm start cap {info['ratio_caps'][i]}, cert loss "
            f"{info['cert_losses'][i]:.6f}{' (fell back)' if per_mode[-1]['fell_back'] else ''}; "
            f"losses {[f'{v:.6f}' for v in losses]}; final {per_mode[-1]['final_loss']:.6f}; "
            f"rejected {rejected}; s per full-N step {[f'{t:.3f}' for t in steps]}")
        if rejected or not math.isfinite(per_mode[-1]["final_loss"]) or len(steps) != iters:
            raise AssertionError(f"mode {i}: non-finite losses or missing steps")
    if not all(bool(torch.isfinite(v).all()) for v in model.params.values()):
        raise AssertionError("non-finite fitted parameters")
    if any(launches[k] == 0 for k in need) or any(launches[k] for k in forbid):
        raise AssertionError(f"{tag}: a kernel of the path never launched ({need}) or one "
                             f"off it did ({forbid}): {launches}")
    if peak_limit_gb is not None and peak_gb > peak_limit_gb:
        raise AssertionError(f"{tag}: peak device memory {peak_gb:.3f} GB > {peak_limit_gb} GB")
    start = next(c[3] for c in calls if c[0] == 0 and c[1])  # mode 0's certified start
    return model, launches, {"fit_s": fit_s, "peak_gb": peak_gb, "modes": per_mode}, start


def phase_training_check(model, start):
    """Mode 0 at its certified start parameters: the float32 full-N loss the
    fit took its first step from, against the float64 dense NLML minus log
    prior of the same matrix (K + (noise + 1e-6 var) I), factored on the
    card; and B5 on the path's W = K^-1 Z, Z and alpha against the float64
    plain contraction."""
    import torch

    from gpras_tpu_torch.gp.priors import log_prior
    from gpras_tpu_torch.ops import fused_gram
    from gpras_tpu_torch.ops import linalg

    loss32 = float(model.fit_info["losses"][0][0])
    p64 = {k: v.double() for k, v in start.items()}
    x64, y64 = model.x.double(), model.y[:, 0].double()
    t0 = time.perf_counter()
    chol = dense_chol64(p64, x64)
    alpha64 = torch.cholesky_solve(y64[:, None], chol)[:, 0]
    nlml = 0.5 * torch.dot(y64, alpha64) + linalg.logdet_from_chol(chol) / 2 \
        + 0.5 * N * math.log(2.0 * math.pi)
    prior = float(log_prior(p64))
    loss64 = float(nlml) - prior
    # what the gate must see: dropping the log prior moves the loss by
    # |prior|; dropping the jitter j moves it by ~ j * d loss / d noise =
    # j * (tr(K^-1) - alpha^T alpha) / 2, the trace from the path's probes
    z64 = model._probes.double()
    trace = float((z64 * torch.cholesky_solve(z64, chol)).sum()) / z64.shape[1]
    jitter = linalg.default_jitter(torch.float32) * math.exp(float(p64["log_variance"]))
    jitter_shift = abs(0.5 * jitter * (trace - float(torch.dot(alpha64, alpha64))))
    del chol, alpha64, z64
    torch.cuda.empty_cache()
    loss_err = abs(loss32 - loss64) / abs(loss64)
    log(f"[train-check] mode 0 full-N loss at the certified start: float32 {loss32:.6f}, "
        f"float64 dense {loss64:.6f}, relative error {loss_err:.3e} (limit {LOSS_TOL}; "
        f"{time.perf_counter() - t0:.1f} s); a dropped log prior would move it by "
        f"{abs(prior) / abs(loss64):.3e}, a dropped jitter by ~{jitter_shift / abs(loss64):.3e}")

    noise32 = torch.exp(start["log_noise_variance"]) + \
        linalg.default_jitter(torch.float32) * torch.exp(start["log_variance"])
    k32 = fused_gram.gram("Matern52", start, model.x, noise=noise32)
    l32, info = torch.linalg.cholesky_ex(k32)
    del k32
    alpha = torch.cholesky_solve(model.y[:, :1], l32)[:, 0]
    z = model._probes
    w = torch.cholesky_solve(z, l32).contiguous()
    del l32
    got = flat(fused_gram.kgrad_sym("Matern52", start, model.x, w, z, alpha, 1.0, 1.0 / M))
    want = flat(fused_gram.kgrad_plain("Matern52", p64, x64, w.double(), z.double(),
                                       alpha.double(), 1.0, 1.0 / M))
    grad_err = (got.double() - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[train-check] B5 at the certified start, the path's W, Z, alpha: max_abs_err "
        f"{grad_err:.3e} (scale {scale:.3e}, limit {KERNEL_TOL} * scale)")
    if not loss_err <= LOSS_TOL or not grad_err <= KERNEL_TOL * scale:
        raise AssertionError("training loss or gradient disagrees with float64")
    return {"loss32": loss32, "loss64": loss64, "loss_rel_err": loss_err,
            "prior_rel": abs(prior) / abs(loss64), "jitter_rel": jitter_shift / abs(loss64),
            "b5_max_abs_err": grad_err, "b5_scale": scale}


def phase_step_breakdown(model):
    """One full-N training step of mode 0 at its fitted parameters, piece by
    piece (CUDA events), and whole through the model's loss (host clock)."""
    import torch

    from gpras_tpu_torch.fit.optimizers import value_and_grad
    from gpras_tpu_torch.ops import fused_gram
    from gpras_tpu_torch.ops import linalg

    p = {k: v[0] for k, v in model.params.items()}
    y, z = model.y[:, 0], model._probes
    noise = torch.exp(p["log_noise_variance"]) + \
        linalg.default_jitter(torch.float32) * torch.exp(p["log_variance"])
    parts = {"B1 gram": cuda_ms(lambda: fused_gram.gram("Matern52", p, model.x, noise=noise))}
    k = fused_gram.gram("Matern52", p, model.x, noise=noise)
    parts["Cholesky (cholesky_ex)"] = cuda_ms(lambda: torch.linalg.cholesky_ex(k))
    l, _ = torch.linalg.cholesky_ex(k)
    del k
    parts["solve alpha"] = cuda_ms(lambda: torch.cholesky_solve(y[:, None], l))
    parts["solve W = K^-1 Z"] = cuda_ms(lambda: torch.cholesky_solve(z, l))
    alpha = torch.cholesky_solve(y[:, None], l)[:, 0]
    w = torch.cholesky_solve(z, l).contiguous()
    del l
    parts["B5 kgrad_sym"] = cuda_ms(
        lambda: fused_gram.kgrad_sym("Matern52", p, model.x, w, z, alpha, 1.0, 1.0 / M))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value_and_grad(lambda q: model._loss_fn(q, y), p)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step_ms = min(steps) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rest = step_ms - sum(parts.values())
    log(f"[step] one full-N step (value and gradient, host clock): {step_ms:.1f} ms, peak "
        f"device memory {peak_gb:.2f} GB; " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; the rest (host, small ops) {rest:.1f} ms")
    return {"step_ms": step_ms, "peak_gb": peak_gb, "parts_ms": parts, "rest_ms": rest}


def phase_b4_path(x, y):
    """exact_engine="hutchinson" at N = 3,072: the backward goes through B4
    (fewer than 8 tile rows of 512 in the reference's rule)."""
    import torch

    from gpras_tpu_torch import GPRAS

    model = GPRAS("Matern52", model_type="exact", exact_engine="hutchinson", device=DEVICE)
    zero_counters()
    t0 = time.perf_counter()
    model.fit(x[:3072], y[:3072], optimization_method="adam", learning_rate=0.02, max_iter=2)
    torch.cuda.synchronize()
    launches = read_counters()
    losses = model.fit_info["losses"].tolist()
    log(f"[b4-path] Hutchinson fit at N=3072, {P} modes, 2 steps: {time.perf_counter() - t0:.2f} s;"
        f" losses {losses}; launches {launches}")
    if launches["kgrad_dense"] == 0 or not all(math.isfinite(v) for r in losses for v in r):
        raise AssertionError("B4 did not run on the path, or a loss is not finite")
    return launches


def phase_cg_checks():
    """Mode 0 of training_set at N = 49,152, at its serving hyperparameters
    (where the reference's PCG converges, and a dense float64 factor fits in
    19.3 GB), through the CG engine's forward and backward as GPRAS trains
    with them (rank-64 preconditioner, 16 probes, 32 iterations):
    (a) the quad part against 1/2 y^T K^-1 y from the float64 Cholesky;
    (b) the SLQ log-determinant (logdet P + the mean of 16 probe terms)
        against the float64 one, within 4 standard errors of those terms;
    (c) the gradient against the same estimator with exact solves:
        kgrad_plain in float64 with W = K^-1 z from the float64 factor, the
        path's V = P^-1 z, alpha from the factor, plus the diagonal term.
    32 iterations do not converge here (the 64 of serving do): the limits of
    (a) and (c) add what the truncated solves account for, each derived
    from the solves' own residuals as printed."""
    import torch

    from gpras_tpu_torch.fit.optimizers import value_and_grad
    from gpras_tpu_torch.gp import exact_cg
    from gpras_tpu_torch.gp.priors import log_prior
    from gpras_tpu_torch.ops import kernels as K
    from gpras_tpu_torch.ops import linalg

    x_np, y_np, params_np = training_set(N)
    x = torch.as_tensor(x_np, device=DEVICE)
    y = torch.as_tensor(y_np[:, 0], device=DEVICE).contiguous()
    p = {k: torch.as_tensor(v[0], device=DEVICE) for k, v in params_np.items()}
    draws = exact_cg.precond_probes(N, 64, M, device=DEVICE)
    t0 = time.perf_counter()
    value, alpha, w, v, terms, logdet_p, rel = exact_cg._cg_solves(
        "Matern52", p, x, y, draws, 32, 64, None, 4096)
    noise = exact_cg._noise(p, torch.float32)
    z, _, _ = exact_cg._probe_matrix("Matern52", p, x, draws, noise, 64)
    nlml = exact_cg.make_cg_nlml("Matern52", probes=M, max_iters=32, precond_rank=64)
    _, grads = value_and_grad(lambda q: nlml(q, x, y, draws), p)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    quad = 0.5 * float(torch.dot(y, alpha))
    logdet = float(logdet_p) + float(terms.mean())
    se = float(terms.double().std()) / math.sqrt(M)

    p64 = {k: val.double() for k, val in p.items()}
    x64, y64 = x.double(), y.double()
    t0 = time.perf_counter()
    kmat = torch.empty((N, N), dtype=torch.float64, device=x.device)
    for r0 in range(0, N, 4096):
        kmat[r0:r0 + 4096] = K.gram("Matern52", p64, x64[r0:r0 + 4096], x64)
    sigma2 = float(torch.exp(p64["log_noise_variance"])
                   + linalg.default_jitter(torch.float32) * torch.exp(p64["log_variance"]))
    kmat.diagonal().add_(sigma2)
    resid = float(torch.linalg.vector_norm(y64 - kmat @ alpha.double()))  # the true residual
    chol, info = torch.linalg.cholesky_ex(kmat)
    del kmat
    if int(info) != 0:
        raise AssertionError(f"dense float64 Cholesky failed (info {int(info)})")
    alpha64 = torch.cholesky_solve(y64[:, None], chol)[:, 0]
    quad64 = 0.5 * float(torch.dot(y64, alpha64))
    logdet64 = float(linalg.logdet_from_chol(chol))
    w64 = torch.cholesky_solve(z.double(), chol)
    del chol
    torch.cuda.empty_cache()
    w_resid = torch.linalg.vector_norm(w.double() - w64, dim=0) / \
        torch.linalg.vector_norm(w64, dim=0)
    one = torch.tensor(1.0, dtype=torch.float64, device=x.device)
    want, with_z, at_path = (
        exact_cg._cotangent_grads("Matern52", p64, x64, a, ww, vv, one, 1.0 / M)
        for a, ww, vv in ((alpha64, w64, v.double()), (alpha64, w64, z.double()),
                          (alpha.double(), w.double(), v.double())))
    dense_s = time.perf_counter() - t0
    got_v, want_v, z_v, path_v = (torch.cat([g[k].double().reshape(-1) for k in sorted(p)])
                                  for g in (grads, want, with_z, at_path))
    grad_err = float((got_v - want_v).abs().max())
    grad_scale = float(want_v.abs().max())
    vz_shift = float((z_v - want_v).abs().max())
    # what the truncated solves move the float64 estimator by: evaluated at
    # the path's own alpha and W against at the exact ones
    solve_shift = float((path_v - want_v).abs().max())
    kernel_err = float((got_v - path_v).abs().max())
    grad_limit = 1e-3 * grad_scale + solve_shift
    prior = float(log_prior(p64))

    # (a) CG's iterate is the Galerkin solution on its Krylov space, so its
    # quad falls short of the exact one by 1/2 e^T K e = 1/2 r^T K^-1 r (e the
    # error, r the true residual), at most 1/2 ||r||^2 / sigma2 since
    # lambda_min(K) >= sigma2 (noise + jitter): the limit is 1e-4 relative
    # (rounding) plus that, the latter only when the y column's relative
    # residual exceeds 1e-4
    ynorm = float(torch.linalg.vector_norm(y64))
    rho = resid / ynorm
    quad_limit = 1e-4 * abs(quad64) + (0.0 if rho <= 1e-4 else 0.5 * resid ** 2 / sigma2)
    quad_err = abs(quad - quad64)
    logdet_err = abs(logdet - logdet64)
    log(f"[cg-check] N={N} mode 0 at the serving hyperparameters, CG forward + backward "
        f"{cg_s:.2f} s, dense float64 references {dense_s:.1f} s")
    log(f"[cg-check] (a) quad {quad:.6f} vs float64 {quad64:.6f}: error {quad_err:.3e} (limit "
        f"{quad_limit:.3e}); the y column's relative residual after 32 iterations: solver "
        f"{float(rel[0]):.3e}, true (float64) {rho:.3e}"
        + ("" if rho <= 1e-4 else " > 1e-4, so the limit adds 1/2 ||r||^2 / sigma2, the most "
           "a Galerkin iterate's quad can fall short by"))
    log(f"[cg-check] (b) logdet {logdet:.4f} (logdet P {float(logdet_p):.4f} + SLQ "
        f"{float(terms.mean()):.4f}) vs float64 {logdet64:.4f}: error {logdet_err:.4f}, "
        f"4 SE = {4 * se:.4f} (SE {se:.4f} of the {M} probe terms); reach: a dropped logdet P "
        f"moves it by {abs(float(logdet_p)):.1f} nats ({abs(float(logdet_p)) / (4 * se):.0f} x "
        "the limit, caught)")
    log(f"[cg-check] (c) gradient vs the exact-solve estimator: max_abs_err {grad_err:.3e} "
        f"(scale {grad_scale:.3e}, limit 1e-3 * scale + {solve_shift:.3e} = {grad_limit:.3e}: "
        f"the float64 estimator at the path's own 32-iteration alpha and W moves by "
        f"{solve_shift:.3e} from the exact-solve one, the probe columns' relative solution "
        f"errors up to {float(w_resid.max()):.3e}; against that estimator the CG gradient is "
        f"off by {kernel_err:.3e}); reach: V = z in place of P^-1 z moves "
        f"it by {vz_shift / grad_scale:.3e} of the scale ("
        f"{'caught' if vz_shift > grad_limit else 'NOT caught'}); a dropped log prior "
        f"moves the training loss by {abs(prior):.3e} ({abs(prior) / abs(float(value)):.3e} of "
        "it): not caught here, where the NLML's parts are held without the prior (the CPU "
        "tests hold the training loss, prior included, to the reference)")
    if not (quad_err <= quad_limit and logdet_err <= 4 * se and grad_err <= grad_limit
            and vz_shift > grad_limit):
        raise AssertionError("CG engine disagrees with float64, or a check cannot see V = z")
    return {"quad": quad, "quad64": quad64, "quad_err": quad_err, "quad_limit": quad_limit,
            "y_rel_residual_solver": float(rel[0]), "y_rel_residual_true": rho,
            "logdet": logdet, "logdet64": logdet64, "logdet_err": logdet_err, "slq_se": se,
            "logdet_p": float(logdet_p), "grad_max_abs_err": grad_err, "grad_scale": grad_scale,
            "grad_limit": grad_limit, "grad_solve_shift": solve_shift,
            "grad_err_at_path_solves": kernel_err, "w_rel_err_max": float(w_resid.max()),
            "v_is_z_shift": vz_shift, "log_prior": prior, "cg_s": cg_s}


def phase_cg_fit():
    """The slice at full width: phase 5's fit at N = 131,072, where "auto"
    takes the CG engine (above 55,000 points): B3 every mbcg iteration, B5
    the backward, no B1 (the rung's dense engine builds its 2,048^2 Gram with
    torch ops), peak device memory under CG_PEAK_GB. Then one full-N CG step
    of mode 0 piece by piece (CUDA events, each alone) and whole (host clock)."""
    import torch

    from gpras_tpu_torch.fit.optimizers import value_and_grad
    from gpras_tpu_torch.gp import exact_cg
    from gpras_tpu_torch.ops import fused_gram

    x, y, _ = training_set(N_CG)
    model, launches, fit, _ = phase_training(x, y, "cg-fit", need=("kmv_sym", "kgrad_sym"),
                                             forbid=("gram",), peak_limit_gb=CG_PEAK_GB)
    p = {k: val[0] for k, val in model.params.items()}
    y0 = model.y[:, 0]
    noise = exact_cg._noise(p, torch.float32)
    l_pc = exact_cg.pivoted_cholesky("Matern52", p, model.x, 64)
    pinv, _ = exact_cg.make_woodbury_pinv(l_pc, noise)
    b = torch.randn(N_CG, R_CG, device=model.x.device)
    gen = torch.Generator().manual_seed(1)
    coeffs = torch.rand((32, M), generator=gen).to(model.x.device) + 0.1
    z, _, _ = exact_cg._probe_matrix("Matern52", p, model.x, model._cg_draws, noise, 64)
    w = torch.randn(N_CG, M, device=model.x.device)
    parts = {
        "pivoted Cholesky (rank 64)": cuda_ms(
            lambda: exact_cg.pivoted_cholesky("Matern52", p, model.x, 64)),
        "32 x B3 kmv_sym (R = 17)": 32 * cuda_ms(
            lambda: fused_gram.kmv_sym("Matern52", p, model.x, b, noise=noise)),
        "33 x Woodbury P^-1": 33 * cuda_ms(lambda: pinv(b)),
        "SLQ eigh (16 x 32^2)": cuda_ms(lambda: exact_cg._slq_terms(coeffs, coeffs, coeffs[0])),
        "B5 kgrad_sym (m = 16)": cuda_ms(
            lambda: fused_gram.kgrad_sym("Matern52", p, model.x, w, z, b[:, 0].contiguous(),
                                         1.0, 1.0 / M)),
    }
    steps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value_and_grad(lambda q: model._loss_fn(q, y0), p)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step_ms = min(steps) * 1e3
    rest = step_ms - sum(parts.values())
    log(f"[cg-step] one full-N CG step of mode 0 (value and gradient, host clock): "
        f"{step_ms:.1f} ms; " + ", ".join(f"{k} {val:.2f} ms" for k, val in parts.items())
        + f"; the rest (mbcg's vector updates, host) {rest:.1f} ms")
    return launches, {**fit, "step_ms": step_ms, "step_parts_ms": parts, "step_rest_ms": rest}


def phase_sgpr(out: Path):
    """SGPR, the default backend, at full width: GPRAS("Matern52") with 300
    k-means inducing points (the top of the reference's inducing sweep,
    gpras_tpu/pipeline/cross_validation.py:127) and the default two-stage
    fit, on phase 5's 4-mode training set; then its checkpoint served by
    PosteriorPredictor with phase 3's preprocessors and requests. SGPR runs
    no hand-written kernel: B1-B5 must launch zero times. Checks: mode 0's
    fp32 training loss at the fitted parameters against a float64
    evaluation of the same formula, within SGPR_LOSS_ULPS x eps32 x the sum
    of the ELBO's term magnitudes (see the limit's comment); the served
    mode-0 posterior of the first request against float64 sgpr.predict,
    with phase 4's limits."""
    import torch

    from gpras_tpu_torch import GPRAS, PosteriorPredictor
    from gpras_tpu_torch.gp import sgpr
    from gpras_tpu_torch.ops import kernels as K

    x, y, _ = training_set()
    model = GPRAS("Matern52", device=DEVICE)
    steps = []  # host clock at each loss evaluation with a gradient
    loss_fn = model._loss_fn

    def timed_loss(p, y_i):
        if torch.is_grad_enabled():
            torch.cuda.synchronize()
            steps.append(time.perf_counter())
        return loss_fn(p, y_i)

    model._loss_fn = timed_loss
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(x, y, n_inducing=SGPR_INDUCING)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    del model._loss_fn
    step_s = statistics.median(b - a for a, b in zip(steps, steps[1:]))
    model.to_file(out / "sgpr.npz")
    requests = [synthetic_fields(np.random.default_rng(12 + i), n)[0]
                for i, n in enumerate((17, 200))]
    t0 = time.perf_counter()
    pred = PosteriorPredictor(out / "sgpr.npz", hf_preprocessor_path=out / "hf_pre.npz",
                              lf_preprocessor_path=out / "lf_pre.npz", buckets=(64, 256),
                              device=DEVICE)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    latencies = []
    for req in requests:
        t0 = time.perf_counter()
        field, var = pred.predict_field(req)
        latencies.append(time.perf_counter() - t0)
        if field.shape != req.shape or not (np.isfinite(field).all() and (var >= 0).all()):
            raise AssertionError("SGPR request: wrong shape, non-finite field or negative variance")
    launches = read_counters()
    losses = model.fit_info["losses"]
    log(f"[sgpr] fit of {P} modes at N={N}, M={SGPR_INDUCING} (k-means, two-stage Adam, "
        f"{len(steps)} gradient steps) in {fit_s:.3f} s, {step_s * 1e3:.2f} ms per step (median); "
        f"stage-2 losses first {[f'{v:.3f}' for v in losses[:, 0].tolist()]} last "
        f"{[f'{v:.3f}' for v in model.fit_info['loss'].tolist()]}; cache build {cache_s:.3f} s; "
        f"requests of 17 / 200 LF fields {latencies[0]:.3f} / {latencies[1]:.3f} s; kernel "
        f"launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"SGPR launched a hand-written kernel: {launches}")

    # (a) the fp32 training loss against float64, same formula. fp32 adds
    # ~eps32 of each term's magnitude per rounding, and the largest terms
    # (||y||^2 / 2s2, the trace pair sum kdiag / 2s2 and tr(A A^T) / 2, up
    # to 4e5 at N = 8,192) carry sums over N and M N entries: measured at
    # N = 8,192, M = 300 on the CPU, 0.4-1.1 eps32 x sum |terms|; the limit
    # is 64 x that unit
    p32 = {k: v[0] for k, v in model.params.items()}
    p64 = {k: v.double() for k, v in p32.items()}
    x64, y64 = model.x.double(), model.y[:, 0].double()
    with torch.no_grad():
        loss32 = float(model._loss_fn(p32, model.y[:, 0]))
        loss64 = float(sgpr.training_loss("Matern52", p64, x64, y64))
        sigma, sigma2, _, a, lb = sgpr._common("Matern52", p64, x64)
        c = torch.linalg.solve_triangular(lb, a @ y64[:, None], upper=False) / sigma
        terms = {"n log 2pi / 2": 0.5 * N * math.log(2.0 * math.pi),
                 "log det LB": float(torch.log(torch.diagonal(lb)).sum()),
                 "n log s2 / 2": float(0.5 * N * torch.log(sigma2)),
                 "|y|^2 / 2s2": float(0.5 * (y64 * y64).sum() / sigma2),
                 "|c|^2 / 2": float(0.5 * (c * c).sum()),
                 "kdiag / 2s2": float(0.5 * K.kdiag("Matern52", p64, x64).sum() / sigma2),
                 "tr(A A^T) / 2": float(0.5 * (a * a).sum())}
        from gpras_tpu_torch.gp.priors import log_prior

        prior = float(log_prior(p64))
    unit = 2.0 ** -23 * sum(abs(v) for v in terms.values())
    limit = SGPR_LOSS_ULPS * unit
    loss_err = abs(loss32 - loss64)
    trace = terms["kdiag / 2s2"] - terms["tr(A A^T) / 2"]
    log(f"[sgpr-check] mode 0 training loss at the fitted parameters: float32 {loss32:.6f}, "
        f"float64 {loss64:.6f}, error {loss_err:.4g} = {loss_err / unit:.3f} x eps32 x "
        f"sum|terms| ({unit:.4g}; limit {SGPR_LOSS_ULPS} x = {limit:.4g}); terms "
        + ", ".join(f"{k} {v:.6g}" for k, v in terms.items())
        + f"; reach: a dropped trace term moves the loss by {trace:.6g} "
        f"({'caught' if trace > limit else 'NOT caught'}), a dropped log prior by {abs(prior):.4g} "
        f"({'caught' if abs(prior) > limit else 'NOT caught'})")

    # (b) the served posterior of mode 0 against float64 sgpr.predict
    xq_np = pred.lf_pre.transform(requests[0])
    mean, var = pred.predict_modes(xq_np)
    xq = torch.as_tensor(xq_np, dtype=torch.float64, device=x64.device)
    with torch.no_grad():
        want_mean, want_var = (t.cpu().numpy() for t in sgpr.predict("Matern52", p64, x64, y64,
                                                                      xq))
    mean_err = float(np.abs(mean[:, 0] - want_mean).max())
    var_err = float((np.abs(var[:, 0] - want_var) / want_var).max())
    log(f"[sgpr-check] served mode 0, {len(want_mean)} queries vs float64 sgpr.predict: mean "
        f"max abs err {mean_err:.3e} (limit {MEAN_TOL} * {np.abs(want_mean).max():.3e}), variance "
        f"max rel err {var_err:.3e} (limit {VAR_TOL})")
    if not (loss_err <= limit and mean_err <= MEAN_TOL * np.abs(want_mean).max()
            and var_err <= VAR_TOL):
        raise AssertionError("SGPR loss or served posterior disagrees with float64")
    return {"fit_s": fit_s, "steps": len(steps), "step_s": step_s, "cache_build_s": cache_s,
            "request_s": dict(zip(("17", "200"), latencies)), "launches": launches,
            "final_loss": model.fit_info["loss"].tolist(), "loss32": loss32, "loss64": loss64,
            "loss_err": loss_err, "loss_limit": limit, "loss_err_in_units": loss_err / unit,
            "trace_term": trace, "log_prior": prior, "mean_err": mean_err, "var_err": var_err}


def dense_chol64(p64, x64):
    """Float64 Cholesky factor of the matrix the float32 engines factor,
    K + (noise + 1e-6 variance) I, built on the card in row panels."""
    import torch

    from gpras_tpu_torch.ops import kernels as K
    from gpras_tpu_torch.ops import linalg

    n = x64.shape[0]
    kmat = torch.empty((n, n), dtype=torch.float64, device=x64.device)
    for r0 in range(0, n, 4096):
        kmat[r0:r0 + 4096] = K.gram("Matern52", p64, x64[r0:r0 + 4096], x64)
    kmat.diagonal().add_(torch.exp(p64["log_noise_variance"]) + linalg.default_jitter(
        torch.float32) * torch.exp(p64["log_variance"]))
    chol, info = torch.linalg.cholesky_ex(kmat)
    del kmat
    if int(info) != 0:
        raise AssertionError(f"dense float64 Cholesky failed (info {int(info)})")
    return chol


def dense_loss64(p32, x, y):
    """Float64 dense NLML minus log prior of mode ``y`` at the float32
    parameters ``p32`` (``dense_chol64``'s matrix)."""
    import torch

    from gpras_tpu_torch.gp.priors import log_prior
    from gpras_tpu_torch.ops import linalg

    p64 = {k: v.double() for k, v in p32.items()}
    y64 = y.double()
    n = x.shape[0]
    chol = dense_chol64(p64, x.double())
    alpha = torch.cholesky_solve(y64[:, None], chol)[:, 0]
    nlml = 0.5 * torch.dot(y64, alpha) + linalg.logdet_from_chol(chol) / 2 \
        + 0.5 * n * math.log(2.0 * math.pi)
    del chol, alpha
    torch.cuda.empty_cache()
    return float(nlml) - float(log_prior(p64))


def phase_cold_hutchinson(x, y):
    """The cold exact fit at N = 49,152 (mode 0): gp/coldfit.fit_exact with
    its defaults (engine "auto" takes Hutchinson below 65,536 points: host
    L-BFGS, 16 fixed probes, noise floor 1e-4), stopping at the band of L*,
    the converged loss of benchmarks/convergence_reference_hard.json, whose
    problem training_set reproduces. Checks: the final loss finite and
    below the initial one; the fp32 loss against the float64 dense NLML
    minus log prior of the same matrix, within LOSS_TOL (phase 6's check) at
    the cold start and within LOSS_TOL_CONVERGED at the final parameters;
    each evaluation fit_exact counts one B1 and one B5 launch, and nothing
    else launches. Band entry is reported, not required."""
    import torch

    from gpras_tpu_torch.gp import coldfit, exact, exact_stochastic
    from gpras_tpu_torch.gp.priors import log_prior

    l_star = json.loads((ROOT / "benchmarks" / "convergence_reference_hard.json").read_text())[
        "l_star"]
    x_t = torch.as_tensor(x, device=DEVICE)
    y0 = torch.as_tensor(y[:, 0], device=DEVICE).contiguous()
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, info = coldfit.fit_exact("Matern52", x_t, y0, stop_loss=l_star)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evals = info["evals"]
    loss = exact_stochastic.make_hutchinson_training_loss("Matern52", fused_gram=True)
    z = exact_stochastic.rademacher_probes(N, 16, device=DEVICE)
    params0 = exact.init_params("Matern52", x_t, noise_variance=0.1)
    with torch.no_grad():
        initial = float(loss(params0, x_t, y0, z))
        final32 = float(loss(params, x_t, y0, z))
    t0 = time.perf_counter()
    initial64 = dense_loss64(params0, x_t, y0)
    final64 = dense_loss64(params, x_t, y0)
    rel0 = abs(initial - initial64) / abs(initial64)
    rel = abs(final32 - final64) / abs(final64)
    prior = abs(float(log_prior({k: v.double() for k, v in params.items()})))
    tol_band = 1e-5 * abs(l_star)
    bench_band = 50 * tol_band  # patience x tol x |L*|, the bench's band
    iters = int(info["iterations"])
    log(f"[cold-hutch] fit_exact at N={N}, mode 0: stopped_by {info['stopped_by']} after {iters} "
        f"iterations, {evals} evaluations, {fit_s:.3f} s ({fit_s / evals:.3f} s per evaluation); "
        f"peak device memory {peak_gb:.2f} GB; launches {launches}; losses "
        f"{[f'{v:.2f}' for v in info['losses'][:iters].tolist()]}")
    log(f"[cold-hutch] initial loss {initial:.4f} (float64 dense {initial64:.4f}, relative error "
        f"{rel0:.3e}), final {final32:.4f} (float64 dense {final64:.4f}, relative error "
        f"{rel:.3e}); limits {LOSS_TOL} at the start, {LOSS_TOL_CONVERGED} at the converged "
        f"parameters; {time.perf_counter() - t0:.1f} s; reach: a dropped log prior moves the "
        f"final loss by {prior:.4g} nats ({prior / abs(final64):.3e}, "
        f"{'caught' if prior > LOSS_TOL_CONVERGED * abs(final64) else 'NOT caught'}); final - L* = "
        f"{final32 - l_star:.4f} nats (L* {l_star}); inside tol*|L*| = "
        f"{tol_band:.3f}: {final32 <= l_star + tol_band}; inside the bench's {bench_band:.2f}-nat "
        f"band: {final32 <= l_star + bench_band}")
    expect = {"gram": evals, "kgrad_sym": evals, "kmv_dense": 0, "kmv_sym": 0, "kgrad_dense": 0}
    if not (math.isfinite(final32) and final32 < initial and rel0 <= LOSS_TOL
            and rel <= LOSS_TOL_CONVERGED and launches == expect):
        raise AssertionError(f"cold Hutchinson fit: loss {final32} (initial {initial}, float64 "
                             f"{final64}) or launches {launches} != {expect}")
    return {"fit_s": fit_s, "stopped_by": info["stopped_by"], "iterations": iters,
            "evals": evals, "s_per_eval": fit_s / evals, "peak_gb": peak_gb,
            "launches": launches, "initial_loss": initial, "initial_loss64": initial64,
            "initial_rel_err": rel0, "final_loss32": final32, "final_loss64": final64,
            "loss_rel_err": rel, "log_prior_abs": prior, "l_star": l_star,
            "final_minus_l_star": final32 - l_star, "in_tol_band": final32 <= l_star + tol_band,
            "in_bench_band": final32 <= l_star + bench_band}


def phase_cold_cg():
    """The cold exact fit's CG engine at N = 65,536 (training_set, mode 0),
    where "auto" takes CG: rank-128 preconditioner, 256 iterations in
    16-iteration segments, 127 probes, residual gate 0.1, per-column
    tolerance 0.02. First, at the initial parameters: the segmented step with
    the early exit against the same step with early_exit=False, bit for bit
    in loss and gradients; and the frozen carry a fixed point (the segments
    the early exit skips, run on the carry, change no output finish reads).
    Then fit_exact with max_iter=COLD_CG_ITERS: segments per evaluation,
    gate aborts, s per evaluation, B3 calls (16 per segment), B5 calls (one
    per evaluation), peak device memory under CG_PEAK_GB; and one evaluation
    at the fitted parameters, whole and piece by piece."""
    import logging

    import torch

    from gpras_tpu_torch.fit.optimizers import _apply_floors
    from gpras_tpu_torch.gp import coldfit, exact, exact_cg
    from gpras_tpu_torch.ops import fused_gram

    x, y, _ = training_set(N_COLD)
    x_t = torch.as_tensor(x, device=DEVICE)
    y0 = torch.as_tensor(y[:, 0], device=DEVICE).contiguous()
    opts = dict(probes=R_COLD - 1, max_iters=256, seg_iters=16, precond_rank=128,
                residual_gate=0.1, tol=0.02)
    p0 = exact.init_params("Matern52", x_t, noise_variance=0.1)
    draws = exact_cg.precond_probes(N_COLD, 128, R_COLD - 1, device=DEVICE)
    step = exact_cg.make_cg_step_chunked("Matern52", **opts)
    full = exact_cg.make_cg_step_chunked("Matern52", early_exit=False, gate_abort=False, **opts)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_e, grads_e = step(p0, x_t, y0, draws)
    torch.cuda.synchronize()
    early_s = time.perf_counter() - t0
    early_b3 = fused_gram.kmv_sym.launches
    early_segments = step.last_segments
    loss_f, grads_f = full(p0, x_t, y0, draws)
    same = bool(torch.equal(loss_e, loss_f)) and all(torch.equal(grads_e[k], grads_f[k])
                                                      for k in grads_e)
    # the invariant, on the carry itself: segments until every column is
    # frozen, then the rest of the budget
    with torch.no_grad():
        noise = exact_cg._noise(p0, torch.float32)
        z, pinv, _ = exact_cg._probe_matrix("Matern52", p0, x_t, draws, noise, 128)
        b = torch.cat([y0[:, None], z], dim=1)
        carry, _, stop2 = exact_cg._mbcg_init(b, 256, 0.02, pinv)

        def mv(v):
            return exact_cg.kmv("Matern52", p0, x_t, v, noise)

        i0 = 0
        while i0 < 256 and not bool(carry[6].all()):
            carry = exact_cg._mbcg_run(mv, carry, i0, i0 + 16, stop2, pinv)
            i0 += 16
        frozen = tuple(t.clone() for t in carry)
        carry = exact_cg._mbcg_run(mv, carry, i0, 256, stop2, pinv)
        fixed = all(torch.equal(carry[j], frozen[j]) for j in (0, 2, 3, 4, 5, 6))
        del carry, frozen, z, b
    log(f"[cold-cg] N={N_COLD} at the initial parameters: the step stopped after "
        f"{early_segments} of 16 segments ({early_b3} B3 calls, {early_s:.3f} s), loss "
        f"{float(loss_e):.4f}; equal bit for bit to the full budget's loss and gradients: {same}; "
        f"all columns frozen after {i0 // 16} segments, and the {(256 - i0) // 16} segments "
        f"after change no output finish reads: {fixed}")
    if not (same and fixed and early_b3 == 16 * early_segments):
        raise AssertionError("cold CG: the early exit is not the full budget's result")

    aborts = []

    class Aborts(logging.Handler):
        def emit(self, record):
            aborts.append(record.getMessage())

    handler = Aborts(logging.INFO)
    cg_log = logging.getLogger(exact_cg.__name__)
    cg_log.addHandler(handler)
    cg_log.setLevel(logging.INFO)
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        params, info = coldfit.fit_exact("Matern52", x_t, y0, max_iter=COLD_CG_ITERS)
    finally:
        cg_log.removeHandler(handler)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    segments = info["segments"]
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    iters = int(info["iterations"])
    log(f"[cold-cg] fit_exact at N={N_COLD}, mode 0, max_iter {COLD_CG_ITERS}: engine "
        f"{info['engine']}, stopped_by {info['stopped_by']} after {iters} iterations, "
        f"{info['evals']} evaluations in {fit_s:.3f} s ({fit_s / info['evals']:.3f} s per "
        f"evaluation); segments per evaluation {segments}; gate aborts {len(aborts)}; losses "
        f"{[f'{v:.3f}' for v in info['losses'][:iters].tolist()]}; launches {launches} (B3 = 16 x "
        f"{sum(segments)} segments = {16 * sum(segments)}); peak device memory {peak_gb:.3f} GB")
    for msg in aborts:
        log(f"[cold-cg]   {msg}")

    # one evaluation at the fitted parameters, whole (host clock) and piece
    # by piece (CUDA events, each alone), at the segments it ran
    p = _apply_floors(params, {"log_noise_variance": math.log(1e-3)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(p, x_t, y0, draws)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    iters_run = 16 * step.last_segments
    noise = exact_cg._noise(p, torch.float32)
    l_pc = exact_cg.pivoted_cholesky("Matern52", p, x_t, 128)
    pinv, _ = exact_cg.make_woodbury_pinv(l_pc, noise)
    gen = torch.Generator().manual_seed(2)
    b = torch.randn(N_COLD, R_COLD, generator=gen).to(DEVICE)
    w, v = (torch.randn(N_COLD, R_COLD - 1, generator=gen).to(DEVICE) for _ in range(2))
    coeffs = torch.rand((256, R_COLD - 1), generator=gen).to(DEVICE) + 0.1
    parts = {
        "pivoted Cholesky (rank 128)": cuda_ms(
            lambda: exact_cg.pivoted_cholesky("Matern52", p, x_t, 128)),
        f"{iters_run} x B3 kmv_sym (R = {R_COLD})": iters_run * cuda_ms(
            lambda: fused_gram.kmv_sym("Matern52", p, x_t, b, noise=noise)),
        f"{iters_run + 1} x Woodbury P^-1": (iters_run + 1) * cuda_ms(lambda: pinv(b)),
        f"SLQ eigh ({R_COLD - 1} x 256^2)": cuda_ms(
            lambda: exact_cg._slq_terms(coeffs, coeffs, coeffs[0])),
        f"B5 kgrad_sym (m = {R_COLD - 1})": cuda_ms(
            lambda: fused_gram.kgrad_sym("Matern52", p, x_t, w, v, b[:, 0].contiguous(), 1.0,
                                         1.0 / (R_COLD - 1))),
    }
    rest_ms = one_s * 1e3 - sum(parts.values())
    log(f"[cold-cg] one evaluation at the fitted parameters ({step.last_segments} segments, host "
        f"clock): {one_s * 1e3:.1f} ms; " + ", ".join(f"{k} {val:.2f} ms" for k, val in parts.items())
        + f"; the rest (mbcg's vector updates, the host's segment reads) {rest_ms:.1f} ms")
    del l_pc, b, w, v
    torch.cuda.empty_cache()
    finite = [v for v in info["losses"][:iters].tolist() if math.isfinite(v)]
    if not (info["engine"] == "cg_hostls" and len(segments) == info["evals"]
            and launches["kmv_sym"] == 16 * sum(segments)
            and launches["kgrad_sym"] == info["evals"] and launches["gram"] == 0
            and peak_gb <= CG_PEAK_GB and finite
            and all(bool(torch.isfinite(v).all()) for v in params.values())):
        raise AssertionError(f"cold CG fit: launches {launches}, segments {segments}, peak "
                             f"{peak_gb} GB, losses {info['losses'][:iters].tolist()}")
    return {"early_exit_segments": early_segments, "early_exit_s": early_s,
            "bit_identical": same, "frozen_fixed_point": fixed, "fit_s": fit_s,
            "stopped_by": info["stopped_by"], "iterations": iters, "evals": info["evals"],
            "segments": segments, "s_per_eval": fit_s / info["evals"],
            "gate_aborts": len(aborts),
            "launches": launches, "peak_gb": peak_gb,
            "losses": info["losses"][:iters].tolist(),
            "eval_at_fit": {"segments": step.last_segments, "ms": one_s * 1e3,
                            "parts_ms": parts, "rest_ms": rest_ms}}


def device_trace(fn):
    """``fn`` once under torch.profiler: (host-clock ms of the traced run,
    ms during which the device ran at least one recorded event, the number
    of events). The idle share is 1 - busy / host ms; None when the
    profiler recorded no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
    if not spans:
        return wall_ms, None, 0
    busy, end = 0.0, -math.inf
    for a, b in spans:  # the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall_ms, busy / 1e3, len(spans)


def svgp_step_breakdown(p, xc, yc, n_total: int, tag: str):
    """One SVGP training step at ``p`` on the batches ``xc``, ``yc``
    (n_batches, B, .): its pieces (CUDA events around one call each: the
    natural-gradient step, the loss and its gradient, Adam's update), the
    host's reads of cholesky_ex's status a step (one per safe_cholesky
    call), the host-clock time of the batches as one chunk untraced, and the
    same chunk under torch.profiler for the device's idle share."""
    import torch

    from gpras_tpu_torch.fit.optimizers import _adam_update, value_and_grad
    from gpras_tpu_torch.gp import svgp
    from gpras_tpu_torch.ops import linalg

    xb, yb = xc[0], yc[0]

    def loss_grad(q):
        return value_and_grad(lambda r: svgp.training_loss("Matern52", r, xb, yb, n_total), q)

    p_ng = svgp.natgrad_step("Matern52", p, xb, yb, n_total, lr=SVGP_NATGRAD)
    _, g = loss_grad(p_ng)
    state = svgp._adam_init(p)
    parts = {"natgrad_step": cuda_ms(lambda: svgp.natgrad_step("Matern52", p, xb, yb, n_total,
                                                               lr=SVGP_NATGRAD)),
             "loss and gradient": cuda_ms(lambda: loss_grad(p_ng)),
             "Adam update": cuda_ms(lambda: _adam_update(g, state, 0.01, svgp.ADAM_B1,
                                                         svgp.ADAM_B2, svgp.ADAM_EPS))}
    init, run_chunk = svgp.make_stream_fit("Matern52", learning_rate=0.01, natgrad=SVGP_NATGRAD)
    run_chunk(p, init(p), xc[:2], yc[:2], n_total)  # warm-up
    reads = [0]
    safe_cholesky = linalg.safe_cholesky

    def counted(*args, **kwargs):
        reads[0] += 1
        return safe_cholesky(*args, **kwargs)

    linalg.safe_cholesky = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_chunk(p, init(p), xc, yc, n_total)
        torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t0) * 1e3
    finally:
        linalg.safe_cholesky = safe_cholesky
    steps = xc.shape[0]
    traced_ms, busy_ms, events = device_trace(lambda: run_chunk(p, init(p), xc, yc, n_total))
    idle = None if busy_ms is None else 1.0 - busy_ms / traced_ms
    log(f"[{tag}] one step (B = {xb.shape[0]}, M = {p['z'].shape[0]}), pieces by CUDA events: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f"; {reads[0] / steps:.0f} host reads of a Cholesky status a step; {steps} steps "
        f"untraced {steps_ms:.1f} ms ({steps_ms / steps:.3f} ms a step); traced {traced_ms:.1f} ms, "
        f"the device busy {'not measured' if busy_ms is None else f'{busy_ms:.1f} ms'} over "
        f"{events} device events: idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    return {"parts_ms": parts, "host_reads_per_step": reads[0] / steps, "steps": steps,
            "untraced_ms_per_step": steps_ms / steps, "traced_ms": traced_ms,
            "device_busy_ms": busy_ms, "device_events": events, "idle_share": idle}


def svgp_bound_terms(p64, x64, y64) -> dict[str, float]:
    """The magnitudes of the full-N SVGP bound's terms, in float64: the data
    term's per-point pieces (which cancel: var_f = kdiag - |a|^2 +
    |q_sqrt^T a|^2), the KL's and the log prior's. float32 rounds each at
    ~eps32 of its size, so their sum scales the limit."""
    import torch

    from gpras_tpu_torch.gp import svgp
    from gpras_tpu_torch.gp.priors import log_prior
    from gpras_tpu_torch.ops import kernels as K

    n = x64.shape[0]
    a = svgp._whitened_projection("Matern52", p64, x64)
    mean, _ = svgp._f_moments(p64, a, K.kdiag("Matern52", p64, x64))
    q = svgp.q_sqrt_from_raw(p64["q_raw"])
    qa = torch.einsum("pkm,kb->pmb", q, a)
    s2 = float(torch.exp(p64["log_noise_variance"]))
    return {"n log(2 pi s2) / 2": 0.5 * n * abs(math.log(2 * math.pi * s2)),
            "|y - mean|^2 / 2s2": float(((y64 - mean[:, 0]) ** 2).sum()) / (2 * s2),
            "kdiag / 2s2": float(K.kdiag("Matern52", p64, x64).sum()) / (2 * s2),
            "|a|^2 / 2s2": float((a * a).sum()) / (2 * s2),
            "|q_sqrt^T a|^2 / 2s2": float((qa * qa).sum()) / (2 * s2),
            "KL": 0.5 * float((p64["q_mu"] ** 2).sum() + (q * q).sum() + q.shape[-1]
                              + 2 * p64["q_raw"].diagonal(0, -2, -1).abs().sum()),
            "log prior": abs(float(log_prior(p64)))}


def phase_svgp(out: Path):
    """SVGP through GPRAS on phase 5's 4-mode training set: 300 k-means
    inducing points, batches of 4,096, 10 epochs, natural-gradient steps at
    0.5 with Adam; saved and served by PosteriorPredictor with phase 3's
    preprocessors and requests. SVGP runs no hand-written kernel: B1-B5
    must launch zero times. Checks: mode 0's fp32 full-N bound (the
    model's full-batch training loss) against float64 of the same formula,
    within SVGP_LOSS_ULPS x eps32 x the sum of its term magnitudes; the
    served mode-0 posterior of the first request against float64
    svgp.predict of the same parameters, with phase 4's limits."""
    import torch

    from gpras_tpu_torch import GPRAS, PosteriorPredictor
    from gpras_tpu_torch.gp import svgp

    x, y, _ = training_set()
    model = GPRAS("Matern52", model_type="svgp", device=DEVICE)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(x, y, n_inducing=SVGP_INDUCING, optimization_method="adam",
              batch_size=SVGP_BATCH, epochs=SVGP_EPOCHS, natgrad=SVGP_NATGRAD)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    GPRAS._create_inducing(model.x, SVGP_INDUCING, "kmeans")  # the fit's k-means, again
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    steps = P * SVGP_EPOCHS * (N // SVGP_BATCH)
    train_s = fit_s - kmeans_s
    model.to_file(out / "svgp.npz")
    requests = [synthetic_fields(np.random.default_rng(12 + i), n)[0]
                for i, n in enumerate((17, 200))]
    t0 = time.perf_counter()
    pred = PosteriorPredictor(out / "svgp.npz", hf_preprocessor_path=out / "hf_pre.npz",
                              lf_preprocessor_path=out / "lf_pre.npz", buckets=(64, 256),
                              device=DEVICE)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    latencies = []
    for req in requests:
        t0 = time.perf_counter()
        field, var = pred.predict_field(req)
        latencies.append(time.perf_counter() - t0)
        if field.shape != req.shape or not (np.isfinite(field).all() and (var >= 0).all()):
            raise AssertionError("SVGP request: wrong shape, non-finite field or negative variance")
    launches = read_counters()
    losses = model.fit_info["losses"]
    log(f"[svgp] fit of {P} modes at N={N}, M={SVGP_INDUCING} (k-means {kmeans_s:.3f} s), "
        f"B={SVGP_BATCH}, {SVGP_EPOCHS} epochs, natgrad {SVGP_NATGRAD}: {fit_s:.3f} s, "
        f"{train_s / (P * SVGP_EPOCHS):.3f} s per epoch, {train_s / steps * 1e3:.2f} ms per step "
        f"({steps} steps); epoch losses of mode 0 {[f'{v:.1f}' for v in losses[0].tolist()]}; "
        f"cache build {cache_s:.3f} s; requests of 17 / 200 LF fields {latencies[0]:.3f} / "
        f"{latencies[1]:.3f} s; kernel launches {launches}")
    if any(launches.values()) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"SVGP launched a hand-written kernel ({launches}) or a loss is "
                             "not finite")

    # (a) the fp32 full-N bound against float64 of the same formula
    p32 = {k: v[0] for k, v in model.params.items()}
    p64 = {k: v.double() for k, v in p32.items()}
    x64, y64 = model.x.double(), model.y[:, 0].double()
    with torch.no_grad():
        loss32 = float(model._loss_fn(p32, model.y[:, 0]))
        loss64 = float(svgp.training_loss("Matern52", p64, x64, y64, N))
        terms = svgp_bound_terms(p64, x64, y64)
    unit = 2.0 ** -23 * sum(terms.values())
    limit = SVGP_LOSS_ULPS * unit
    loss_err = abs(loss32 - loss64)
    log(f"[svgp-check] mode 0 full-N bound at the fitted parameters: float32 {loss32:.6f}, "
        f"float64 {loss64:.6f}, error {loss_err:.4g} = {loss_err / unit:.3f} x eps32 x sum|terms| "
        f"({unit:.4g}; limit {SVGP_LOSS_ULPS} x = {limit:.4g}); terms "
        + ", ".join(f"{k} {v:.6g}" for k, v in terms.items())
        + f"; reach: a dropped KL moves the loss by {terms['KL']:.4g} "
        f"({'caught' if terms['KL'] > limit else 'NOT caught'})")

    # (b) the served posterior of mode 0 against float64 svgp.predict
    xq_np = pred.lf_pre.transform(requests[0])
    mean, var = pred.predict_modes(xq_np)
    with torch.no_grad():
        want_mean, want_var = (t.cpu().numpy() for t in svgp.predict(
            "Matern52", p64, torch.as_tensor(xq_np, dtype=torch.float64, device=x64.device)))
    mean_err = float(np.abs(mean[:, 0] - want_mean).max())
    var_err = float((np.abs(var[:, 0] - want_var) / want_var).max())
    log(f"[svgp-check] served mode 0, {len(want_mean)} queries vs float64 svgp.predict: mean "
        f"max abs err {mean_err:.3e} (limit {MEAN_TOL} * {np.abs(want_mean).max():.3e}), variance "
        f"max rel err {var_err:.3e} (limit {VAR_TOL})")
    if not (loss_err <= limit and mean_err <= MEAN_TOL * np.abs(want_mean).max()
            and var_err <= VAR_TOL):
        raise AssertionError("SVGP bound or served posterior disagrees with float64")

    # 20 steps of the fit's step at the fitted parameters, traced (two
    # epochs' batches: one epoch has 12)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    rows = SVGP_TRACE_STEPS * SVGP_BATCH
    perm = torch.cat([torch.randperm(N, generator=gen, device=DEVICE)
                      for _ in range(-(-rows // N))])[:rows]
    xc = model.x[perm].reshape(SVGP_TRACE_STEPS, SVGP_BATCH, D)
    yc = model.y[perm, :1].reshape(SVGP_TRACE_STEPS, SVGP_BATCH, 1)
    step = svgp_step_breakdown(p32, xc, yc, N, "svgp-step")
    return {"fit_s": fit_s, "kmeans_s": kmeans_s, "steps": steps,
            "s_per_epoch": train_s / (P * SVGP_EPOCHS), "s_per_step": train_s / steps,
            "cache_build_s": cache_s, "request_s": dict(zip(("17", "200"), latencies)),
            "launches": launches, "epoch_losses": losses.tolist(), "loss32": loss32,
            "loss64": loss64, "loss_err": loss_err, "loss_limit": limit,
            "loss_err_in_units": loss_err / unit, "kl": terms["KL"], "mean_err": mean_err,
            "var_err": var_err, "step": step}


def phase_svgp_archive():
    """examples/torch_svgp_accuracy.py's protocol (benchmarks/svgp_accuracy.py
    in torch) at ARCHIVE: the gold, the 8-epoch SVGP fit, the accuracy
    limits, one epoch streamed from pinned host memory against the same
    epoch device-resident; then one step at the fitted parameters, piece by
    piece, and 20 traced for the idle share. B1-B5 launch zero times."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "torch_svgp_accuracy", ROOT / "examples" / "torch_svgp_accuracy.py")
    protocol = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(protocol)
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep = protocol.run(**ARCHIVE, device=DEVICE)
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p_fit = rep.pop("params")
    log(f"[svgp-archive] N={rep['n']} M={rep['m']} B={rep['b']} D={rep['d']}, {rep['epochs']} "
        f"epochs: SVGP fit {rep['svgp_fit_s']:.3f} s ({rep['svgp_s_per_epoch']:.3f} s per epoch, "
        f"{rep['svgp_s_per_step'] * 1e3:.2f} ms per step); gold {rep['gold_s']:.3f} s "
        f"({rep['hyper_steps']} SGPR steps on {rep['n_sub']} points, optimal_q over N); peak "
        f"device memory {peak_gb:.2f} GB; launches {launches}")
    log(f"[svgp-archive] RMSE vs f: SVGP {rep['svgp_rmse_f']:.5f}, gold {rep['gold_rmse_f']:.5f}; "
        f"vs y: SVGP {rep['svgp_rmse_y']:.5f} (limit {ARCHIVE_RMSE_Y}), gold "
        f"{rep['gold_rmse_y']:.5f}; SVGP vs gold {rep['svgp_vs_gold_mean_rmse']:.5f} (limit "
        f"{ARCHIVE_VS_GOLD}); 2-sigma coverage of y: SVGP {rep['svgp_coverage_2sd']:.4f} (limit "
        f"{ARCHIVE_COVERAGE}), gold {rep['gold_coverage_2sd']:.4f}; noise sigma SVGP "
        f"{rep['svgp_noise_sigma']:.5f}, gold {rep['gold_noise_sigma']:.5f} (true 0.05)")
    log(f"[svgp-archive] one epoch device-resident {rep['device_epoch_s']:.3f} s "
        f"({rep['device_points_per_s']:.0f} points/s); streamed from pinned host memory in "
        f"chunks of {rep['stream_chunk_batches']} batches {rep['stream_epoch_s']:.3f} s "
        f"({rep['stream_points_per_s']:.0f} points/s); parameters max relative difference "
        f"{rep['stream_vs_device_max_rel_err']:.3e} (limit {STREAM_RTOL}), bit for bit: "
        f"{rep['stream_bit_identical']}")
    if not (rep["svgp_rmse_y"] <= ARCHIVE_RMSE_Y and rep["svgp_coverage_2sd"] >= ARCHIVE_COVERAGE
            and rep["svgp_vs_gold_mean_rmse"] <= ARCHIVE_VS_GOLD
            and rep["stream_vs_device_max_rel_err"] <= STREAM_RTOL and not any(launches.values())):
        raise AssertionError("SVGP at archive scale missed a limit, the stream differs from the "
                             f"device-resident epoch, or a kernel launched ({launches})")
    x_h, _, y_h = protocol.make_data(ARCHIVE["n"], ARCHIVE["n_test"], ARCHIVE["d"], 0)
    rows = SVGP_TRACE_STEPS * ARCHIVE["b"]  # iid draws: any rows are a uniform batch
    xc = torch.as_tensor(x_h[:rows], device=DEVICE).reshape(SVGP_TRACE_STEPS, ARCHIVE["b"], -1)
    yc = torch.as_tensor(y_h[:rows], device=DEVICE).reshape(SVGP_TRACE_STEPS, ARCHIVE["b"], 1)
    step = svgp_step_breakdown(p_fit, xc, yc, ARCHIVE["n"], "svgp-archive-step")
    return {**rep, "launches": launches, "peak_gb": peak_gb, "step": step}


def phase_accuracy(out: Path):
    """gpras_tpu_torch.accuracy on the card: run_path f32 (SGPR) and f64
    (the dense exact GP in float64) at DEFAULT_CONFIG, then run_exact_path
    f32 (the production exact fit at N = 32,768: a dense 2,048-point rung,
    the Hutchinson engine, CG serving) and f64 (the dense float64 posterior
    at the fitted hyperparameters), held to the limits set from the JAX
    package's record. One B1 launch per full-N loss evaluation and one B5
    per full-N gradient step (each evaluation counted by a wrapper of
    GPRAS._loss_fn), B2 and B3 in the prediction (timed by a wrapper of
    GPRAS.predict)."""
    import torch

    from gpras_tpu_torch import accuracy
    from gpras_tpu_torch.gp.model import GPRAS

    t0 = time.perf_counter()
    f32 = accuracy.run_path("f32", device=DEVICE)
    path_f32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f64 = accuracy.run_path("f64", device=DEVICE)
    path_f64_s = time.perf_counter() - t0
    summary = accuracy.summarize(f32, f64)
    log(f"[accuracy] run_path f32 (SGPR, M={accuracy.DEFAULT_CONFIG['n_inducing']}) "
        f"{path_f32_s:.3f} s, f64 (dense exact) {path_f64_s:.3f} s, {int(f32['n_modes'][0])} HF "
        f"modes: {summary}")

    work = out / "accuracy"
    work.mkdir(parents=True, exist_ok=True)
    evals, times = [], {}
    loss_fn, predict = GPRAS._loss_fn, GPRAS.predict

    def counted_loss(self, params, y_i):
        if self.x.shape[0] == N_ACC:
            evals.append(torch.is_grad_enabled())
        return loss_fn(self, params, y_i)

    def timed_predict(self, x):
        t = time.perf_counter()
        result = predict(self, x)  # host arrays: the device's work is done
        times["predict_s"] = time.perf_counter() - t
        return result

    GPRAS._loss_fn, GPRAS.predict = counted_loss, timed_predict
    zero_counters()
    try:
        t0 = time.perf_counter()
        e32 = accuracy.run_exact_path("f32", str(work), device=DEVICE)
        exact_f32_s = time.perf_counter() - t0
    finally:
        GPRAS._loss_fn, GPRAS.predict = loss_fn, predict
    launches = read_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e64 = accuracy.run_exact_path("f64", str(work), device=DEVICE)
    exact_f64_s = time.perf_counter() - t0
    gold_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    exact = accuracy.summarize_exact(e32, e64)
    steps = sum(evals)
    fit_s = exact_f32_s - times["predict_s"]
    log(f"[accuracy] run_exact_path f32 at N={N_ACC}: fit {fit_s:.3f} s ({len(evals)} full-N loss "
        f"evaluations, {steps} with a gradient), prediction of {accuracy.EXACT_CONFIG['n_test']} "
        f"queries {times['predict_s']:.3f} s; f64 gold {exact_f64_s:.3f} s (peak "
        f"{gold_peak_gb:.2f} GB); launches {launches}; {exact}")
    expect_ok = (launches["gram"] == len(evals) and launches["kgrad_sym"] == steps > 0
                 and launches["kmv_dense"] > 0 and launches["kmv_sym"] > 0
                 and launches["kgrad_dense"] == 0)
    limits = {"depth_rmse_ratio_f32_over_f64 <= 1.10":
              summary["depth_rmse_ratio_f32_over_f64"] <= ACC_RATIO,
              "coverage_2sigma_f32 >= 0.95": summary["coverage_2sigma_f32"] >= ACC_COVERAGE,
              "exact_rmse_vs_f64 <= 1e-4": exact["exact_rmse_vs_f64"] <= EXACT_VS_F64,
              "exact_rmse_ratio_f32_over_f64 <= 1.01":
              exact["exact_rmse_ratio_f32_over_f64"] <= EXACT_RATIO}
    log(f"[accuracy] limits {limits}; B1 once per full-N evaluation, B5 once per full-N step, "
        f"B2 and B3 in the prediction: {expect_ok}")
    if not (all(limits.values()) and expect_ok):
        raise AssertionError("accuracy limits missed or the kernels did not run as stated")
    return {"summary": summary, "exact": exact, "path_f32_s": path_f32_s,
            "path_f64_s": path_f64_s, "exact_fit_s": fit_s, "exact_predict_s": times["predict_s"],
            "exact_f64_s": exact_f64_s, "gold_peak_gb": gold_peak_gb,
            "full_n_evaluations": len(evals), "full_n_steps": steps, "launches": launches,
            "f32_paths": f32}


def forcing_frame(n_events: int = 35, steps: int = 200, n_bc: int = 4, side: int = 64,
                  seed: int = 21):
    """A seeded HMS forcing frame: per event, six storm cells moving over a
    side x side precip grid and four inflow hydrographs driven by them."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side), indexing="ij")
    centers = rng.uniform(0.2, 0.8, size=(6, 2))
    cells = np.stack([np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / 0.05)
                      for cx, cy in centers]).reshape(6, -1)
    t = np.arange(steps) / steps
    route = rng.uniform(0.0, 1.0, size=(6, n_bc))
    rows, events = [], []
    for e in range(n_events):
        storm = rng.uniform(0.0, 3.0, 6) * np.exp(
            -((t[:, None] - rng.uniform(0.2, 0.6, 6)) ** 2) / rng.uniform(0.002, 0.02, 6))
        precip = np.maximum(storm @ cells + 0.02 * rng.normal(size=(steps, side * side)), 0.0)
        inflow = 20.0 + 200.0 * storm @ route
        rows.append(np.concatenate([inflow, precip], axis=1))
        events += [e] * steps
    bc_mask = np.arange(n_bc + side * side) < n_bc
    return np.concatenate(rows), bc_mask, ~bc_mask, np.asarray(events)


def phase_metrics_hms(paths):
    """compute_event_metrics per test event of phase 15's f32 depth fields
    (truth, prediction, predicted sigma; 48 steps x 16,384 cells), with
    t_tol = 3, v_tol = 0.1 and with the defaults, on the card against the
    same call on the CPU (float64 on both, within METRIC_RTOL of each
    output's scale, NaN where the CPU has NaN); then HmsPreProcessor's fit
    and transform (event_reset on) on a seeded forcing frame, the card
    against the CPU within HMS_RTOL."""
    import torch

    from gpras_tpu_torch import HmsPreProcessor, accuracy
    from gpras_tpu_torch.metrics import compute_event_metrics

    steps = accuracy.DEFAULT_CONFIG["t_steps"]
    truth, field = paths["truth"], paths["field"]
    sigma = np.sqrt(np.maximum(paths["field_var"], 0.0))
    n_events = truth.shape[0] // steps
    worst, card_s = 0.0, 0.0
    for kwargs in (dict(t_tol=3, v_tol=0.1), dict()):
        for e in range(n_events):
            rows = slice(e * steps, (e + 1) * steps)
            args = (truth[rows], field[rows], sigma[rows])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = compute_event_metrics(*(torch.as_tensor(a, device=DEVICE) for a in args),
                                        **kwargs)
            got = {k: v.cpu() for k, v in got.items()}
            card_s += time.perf_counter() - t0
            want = compute_event_metrics(*(torch.as_tensor(a) for a in args), **kwargs)
            for k, w in want.items():
                nan = torch.isnan(w)
                if not torch.equal(torch.isnan(got[k]), nan):
                    raise AssertionError(f"metric {k}: NaN where the CPU has none, or not")
                if not bool(nan.all()):
                    scale = max(float(w[~nan].abs().max()), 1e-300)
                    worst = max(worst, float((got[k][~nan] - w[~nan]).abs().max()) / scale)
    log(f"[metrics] compute_event_metrics on {n_events} events of {steps} x {truth.shape[1]} "
        f"cells, twice (t_tol 3 / v_tol 0.1 and the defaults): card {card_s:.3f} s with the "
        f"copies back; max relative difference to the CPU {worst:.3e} (limit {METRIC_RTOL})")

    x, bc_mask, precip_mask, events = forcing_frame()
    outs, fit_s = {}, {}
    for dev in (DEVICE, "cpu"):
        pre = HmsPreProcessor(event_reset=True, device=dev)
        if dev == DEVICE:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre.fit(x, bc_mask, precip_mask, event_ids=events)
        feats = pre.transform(x, event_ids=events)
        fit_s[dev] = time.perf_counter() - t0
        outs[dev] = (pre.precip_spatial_mode_count, feats)
    modes, got = outs[DEVICE]
    want = outs["cpu"][1]
    hms_err = float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))
    same_nan = bool(np.array_equal(np.isnan(got), np.isnan(want)))
    log(f"[hms] HmsPreProcessor fit + transform on {x.shape[0]} rows ({events.max() + 1} events), "
        f"{int(bc_mask.sum())} inflow columns, {int(precip_mask.sum())} precip cells, event_reset: "
        f"{modes} precip modes (CPU {outs['cpu'][0]}); card {fit_s[DEVICE]:.3f} s, CPU "
        f"{fit_s['cpu']:.3f} s; features {got.shape}, max relative difference {hms_err:.3e} "
        f"(limit {HMS_RTOL}), NaN in the same places: {same_nan}")
    if not (worst <= METRIC_RTOL and modes == outs["cpu"][0] and same_nan
            and hms_err <= HMS_RTOL):
        raise AssertionError("metrics or HmsPreProcessor on the card disagree with the CPU")
    return {"metrics_card_s": card_s, "metrics_max_rel_err": worst, "hms_modes": modes,
            "hms_card_s": fit_s[DEVICE], "hms_cpu_s": fit_s["cpu"], "hms_max_rel_err": hms_err}


def pipeline_project(root: Path, seed: int = 17) -> Path:
    """A seeded HEC-RAS project written as the builders would leave it, and
    its run config; returns the config's path.

    The HF water surface on a PIPE_GRID valley (a sloped bed, the channel
    along its middle) is the channel's resting level plus three flood-wave
    patterns (upstream, middle, downstream) whose hydrographs pass one after
    the other with an event's peak, timing, width and lag, plus noise: a
    random kick of each wave's amplitude every step (what the LF model does
    not resolve) and 5 mm per cell; clamped at the ground. The
    ``ras_upskill`` LF field is the wave without the kicks at 0.9 of its
    amplitude on a mesh of PIPE_BLOCK x PIPE_BLOCK HF cells, resampled onto
    the HF cells as builders.py:363-377 returns it, 0.1-0.15 m high, clamped
    at the ground. float32, as HEC-RAS's HDF holds them. Written with the
    port's export_db as the two parquet DBs of the config's working
    directory, with the cell table and reference lines, and the event plans.
    The RAS models, the AOI and the STAC items the config names are never
    read: the DBs are valid, so the pipeline builds nothing."""
    from concurrent.futures import ThreadPoolExecutor

    import pandas as pd
    import torch
    import torch.nn.functional as F

    from gpras_tpu_torch.data.reader import export_db

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ny, nx = PIPE_GRID
    cells, steps, b = ny * nx, PIPE_STEPS, PIPE_BLOCK
    gy, gx = torch.meshgrid(*(torch.linspace(0, 1, k, device=DEVICE, dtype=torch.float64)
                              for k in (ny, nx)), indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    elev = 2.0 * gx + 3.0 * (gy - 0.5).abs() + 0.05 * torch.sin(25 * gx) * torch.sin(25 * gy)
    rest = 2.0 * gx + 0.2
    waves = torch.stack([torch.exp(-((gx - c) / 0.3) ** 2) * (1.0 - 0.6 * (gy - 0.5).abs())
                         for c in (0.15, 0.5, 0.85)])
    lf_bias = 0.125 + 0.025 * torch.sin(2 * math.pi * gy)
    t = torch.arange(steps, device=DEVICE, dtype=torch.float64)[:, None]

    def coarse(w):  # the LF mesh's value on each HF cell
        w = F.avg_pool2d(w.reshape(-1, 1, ny, nx), b)
        return w.repeat_interleave(b, 2).repeat_interleave(b, 3).reshape(-1, cells)

    n_train, n_test = PIPE_EVENTS
    frames = {f"{f}_{split}": np.empty((n * steps, cells), np.float32)
              for f in ("hf", "lf") for split, n in (("train", n_train), ("test", n_test))}
    plans, ref = [], []
    for e in range(n_train + n_test):
        peak, t0, width, lag = (rng.uniform(0.5, 1.5), rng.uniform(0.25, 0.45) * steps,
                                rng.uniform(0.08, 0.16) * steps, rng.uniform(0.04, 0.1) * steps)
        hydro = torch.cat([s * peak * torch.exp(-((t - t0 - k * lag) / width) ** 2)
                           for k, s in enumerate((1.0, 0.85, 0.7))], dim=1)
        kicks = 0.08 * torch.randn(steps, 3, generator=gen, device=DEVICE, dtype=torch.float64)
        hf = rest + (hydro + kicks) @ waves
        hf += 0.005 * torch.randn(steps, cells, generator=gen, device=DEVICE, dtype=torch.float64)
        lf = coarse(rest + 0.9 * hydro @ waves) + lf_bias
        split, row = ("train", e) if e < n_train else ("test", e - n_train)
        rows = slice(row * steps, (row + 1) * steps)
        frames[f"hf_{split}"][rows] = torch.maximum(hf, elev).float().cpu().numpy()
        frames[f"lf_{split}"][rows] = torch.maximum(lf, elev).float().cpu().numpy()
        title = f"e{e:03d}"
        plans.append({"plan_title": title, "event_number": e,
                      "type": "Train" if split == "train" else "Test", "set": "AEP"})
        stamps = pd.date_range("2020-01-01", periods=steps, freq="15min") + pd.Timedelta(days=7 * e)
        q = (100.0 * hydro).cpu().numpy()
        ref.append(pd.DataFrame({"inflow_flows": q[:, 0], "outflow_flows": q[:, 2],
                                 "inflow_wse": 0.2 + 0.5 * np.log1p(q[:, 0]),
                                 "outflow_wse": 2.2 + 0.5 * np.log1p(q[:, 2])}, index=stamps))
    cent = torch.stack([gx, gy], 1).cpu().numpy() * (nx - 1) * 10.0  # 10 m cells
    lf_cell = ((gy * (ny - 1)).round().long() // b * (nx // b)
               + (gx * (nx - 1)).round().long() // b).cpu().numpy()
    cell_info = pd.DataFrame({"hf_cell_id": np.arange(cells), "elevation": elev.cpu().numpy(),
                              "area": np.full(cells, 100.0), "x": cent[:, 0], "y": cent[:, 1],
                              "lf_cell_id": lf_cell})
    root.mkdir(parents=True, exist_ok=True)
    config = {"working_directory": str(root / "work"),
              "hf_ras_stac_path": str(root / "hf" / "hf.stac.json"),
              "area_of_interest_path": str(root / "aoi.geojson"),
              "event_plan_path": str(root / "event_plans.json"), "mesh_id": "mesh1",
              "hydraulic_parameter": "wse", "wet_threshold_depth": 0.1,
              "spatial_mode_count": PIPE_MODES, "kernel": "Matern52", "inducing_pt_count": 0,
              "optimizer": "adam", "induction_pt_initializer": "kmeans",
              "optimizer_kwargs": PIPE_OPTIMIZER, "generate_plots": False, "save_dbs": True,
              "lf_model_type": "ras_upskill", "lf_ras_stac_path": str(root / "lf" / "lf.stac.json"),
              "model_backend": "exact", "dtype": "float32"}
    (root / "event_plans.json").write_text(json.dumps(plans))
    (root / "config.json").write_text(json.dumps(config, indent=2))
    def write(split: str) -> None:
        titles = [p["plan_title"] for p in plans if (p["type"] == "Train") == (split == "train")]
        index = pd.MultiIndex.from_arrays([np.repeat(titles, steps),
                                           np.tile(np.arange(steps), len(titles))],
                                          names=["run", "t"])
        frame = {f: pd.DataFrame(frames[f"{f}_{split}"], index=index, columns=np.arange(cells))
                 for f in ("hf", "lf")}
        first = 0 if split == "train" else n_train
        db = {"train": "training.db", "test": "testing.db"}[split]
        export_db(root / "work" / "data" / db, frame["hf"], frame["lf"], cell_info,
                  pd.concat(ref[first:first + len(titles)]))

    # the two DBs side by side: pyarrow writes outside the interpreter's lock
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(write, ("train", "test")))
    return root / "config.json"


def phase_pipeline(out: Path):
    """The pipeline's run path through the CLI on pipeline_project's DBs:
    ``main(["run", config])`` cold (the DBs exist; the preprocessor is fit)
    and warm (the DBs and the preprocessor replayed, the GP refit), then
    ``main(["predict", ...])`` on PIPE_FIELDS LF test fields. Held to: B1,
    B2, B3 and B5 launched in the cold run and B4 not; the served posterior
    of every mode on PIPE_QUERIES test queries against the dense float64
    posterior of the saved checkpoint (phase 4's limits); the upskilled
    depth RMSE on the test events below the raw LF field's; the metric DB's
    three tables, a row a test event; timers.json's four keys; predict's
    output against GPRAS.predict + reverse_transform of the same fields
    (PREDICT_RTOL x max|want|); and no h5py, matplotlib or jax imported."""
    import contextlib
    import io
    import shutil
    import sqlite3

    import pandas as pd
    import torch

    from gpras_tpu_torch import GPRAS, PreProcessor
    from gpras_tpu_torch.__main__ import main as cli
    from gpras_tpu_torch.data.reader import RasReader
    from gpras_tpu_torch.pipeline.config import Config

    root = out / "pipeline"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    cfg_path = pipeline_project(root)
    setup_s = time.perf_counter() - t0
    config = Config.from_file(cfg_path)
    test = RasReader(config.testing_data_db)
    hf_test, lf_test = test.aligned_datasets
    n_train = PIPE_EVENTS[0] * PIPE_STEPS
    log(f"[pipeline] project: {PIPE_EVENTS[0]} train / {PIPE_EVENTS[1]} test events x "
        f"{PIPE_STEPS} steps x {hf_test.shape[1]} cells (N = {n_train}), written as parquet "
        f"DBs in {setup_s:.1f} s (set-up)")

    runs = {}
    for run in ("cold", "warm"):
        zero_counters()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(["run", str(cfg_path), "--device", DEVICE])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_counters()
        summary = json.loads(buf.getvalue())
        timers = json.loads(config.timer_path.read_text())
        runs[run] = {"total_s": total_s, "timers": timers, "depth_rmse": summary["depth_rmse"],
                     "launches": launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[pipeline] run {run}: rc {rc}, {total_s:.3f} s; timers "
            f"{ {k: round(v, 3) for k, v in timers.items()} }; depth RMSE "
            f"{summary['depth_rmse']:.5f}; launches {launches}; peak device memory "
            f"{runs[run]['peak_gb']:.3f} GB")
        if rc != 0 or set(timers) != {"load_data", "preprocess_data", "fit_model",
                                      "make_predictions"}:
            raise AssertionError(f"run {run}: rc {rc}, timers {sorted(timers)}")
    cold = runs["cold"]["launches"]
    if min(cold[k] for k in ("gram", "kgrad_sym", "kmv_sym", "kmv_dense")) == 0 \
            or cold["kgrad_dense"] != 0:
        raise AssertionError(f"the cold run's launches are not the path's: {cold}")

    pre = PreProcessor.from_file(config.hf_preprocessor_path, device=DEVICE)
    hf_depth, lf_depth = pre.wse_2_depth(hf_test.values), pre.wse_2_depth(lf_test.values)
    lf_rmse = float(np.sqrt(np.mean((hf_depth - lf_depth) ** 2)))
    gp_rmse = runs["warm"]["depth_rmse"]
    log(f"[pipeline] test depth RMSE: upskilled {gp_rmse:.5f} (cold run "
        f"{runs['cold']['depth_rmse']:.5f}), raw LF field {lf_rmse:.5f}")
    if not (gp_rmse < lf_rmse and runs["cold"]["depth_rmse"] < lf_rmse):
        raise AssertionError("the upskilled field is no better than the raw LF field")

    with sqlite3.connect(config.metric_db_path) as con:
        tables = {name: pd.read_sql(f"select * from {name}", con)
                  for name in ("scalar_metrics", "timeseries_metrics", "cell_metrics")}
    events = sorted(set(hf_test.index.get_level_values("run")))
    rows = {name: len(df) for name, df in tables.items()}
    log(f"[pipeline] metric DB rows {rows} for {len(events)} test events")
    if (sorted(tables["scalar_metrics"]["event"]) != events
            or rows["timeseries_metrics"] != len(events) * PIPE_STEPS
            or rows["cell_metrics"] != len(events) * hf_test.shape[1]):
        raise AssertionError("the metric DB does not hold a row set per test event")

    model = GPRAS.from_file(config.model_path, device=DEVICE)
    x_test = pre.transform(lf_test.values)
    pick = np.linspace(0, len(x_test) - 1, PIPE_QUERIES).astype(int)
    mean, var = model.predict(x_test[pick])
    xq = torch.as_tensor(x_test[pick], dtype=torch.float64, device=DEVICE)
    mean_err = var_err = 0.0
    for i in range(PIPE_MODES):
        want_mean, want_var = dense_posterior64(model, i, xq)
        mean_err = max(mean_err, float(np.abs(mean[:, i] - want_mean).max())
                       / float(np.abs(want_mean).max()))
        var_err = max(var_err, float((np.abs(var[:, i] - want_var) / want_var).max()))
    noise = torch.exp(model.params["log_noise_variance"]).tolist()
    log(f"[pipeline] served posterior of {PIPE_MODES} modes at {PIPE_QUERIES} test queries vs "
        f"dense float64: mean max err {mean_err:.3e} x max|mean| (limit {MEAN_TOL}), variance "
        f"max rel err {var_err:.3e} (limit {VAR_TOL}); fitted noise variances "
        f"{[f'{v:.4g}' for v in noise]}")
    if mean_err > MEAN_TOL or var_err > VAR_TOL:
        raise AssertionError("the pipeline's served posterior disagrees with dense float64")

    pick = np.linspace(0, len(lf_test) - 1, PIPE_FIELDS).astype(int)
    fields = lf_test.values[pick]
    np.savez(root / "fields.npz", fields=fields)
    served = root / "served.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["predict", str(config.model_path), str(root / "fields.npz"), str(served),
                  "--hf-pre", str(config.hf_preprocessor_path),
                  "--lf-pre", str(config.lf_preprocessor_path), "--device", DEVICE])
    predict_s = time.perf_counter() - t0
    with np.load(served) as z:
        got = (z["field"], z["field_var"])
    # the server pads the request with zero queries to a bucket of 256; on the
    # card each query's solve is independent of the others in its batch
    want = pre.reverse_transform(*model.predict(pre.transform(fields)))
    predict_err = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
                      for g, w in zip(got, want))
    log(f"[pipeline] predict command: {PIPE_FIELDS} LF fields in {predict_s:.3f} s (rc {rc}); "
        f"against GPRAS.predict + reverse_transform: max err {predict_err:.3e} x max|want| "
        f"(limit {PREDICT_RTOL})")
    if rc != 0 or got[0].shape != fields.shape or predict_err > PREDICT_RTOL:
        raise AssertionError("the predict command disagrees with GPRAS.predict")
    loaded = sorted(m for m in ("h5py", "matplotlib", "jax") if m in sys.modules)
    if loaded:
        raise AssertionError(f"the pipeline's run path imported {loaded}")
    return {"setup_s": setup_s, "n_train": n_train, "cells": int(hf_test.shape[1]), **runs,
            "gp_depth_rmse": gp_rmse, "lf_depth_rmse": lf_rmse, "metric_rows": rows,
            "posterior_mean_err": mean_err, "posterior_var_err": var_err,
            "noise_variances": noise, "predict_s": predict_s, "predict_err": predict_err}


def sst_catalog(path: Path, n_events: int = SST_EVENTS, steps: int = SST_STEPS,
                seed: int = 18) -> dict[str, np.ndarray]:
    """A seeded SST storm catalog in EventSelection's schema (event_id,
    datetime, precip-cum, precip-excess, inflow; one row an event-hour),
    written as parquet; returns its columns as (events, steps) arrays.

    As tests/test_tooling.py::make_sst_parquet makes them: a lognormal scale
    an event, a cumulative precip of |N(scale, 0.3)| increments, an inflow
    pulse of 100 x scale and a precip excess that follows the rain; here the
    pulses' shapes vary too (a lognormal width, a lognormal lag of the inflow
    behind the rain and a lognormal spread of its pulse), so each hydrograph
    pivot has a spectrum whose first five components are well apart (every
    gap above 1e-3 of the first at 2,000 and 10,000 events) and the PCA is
    well posed. Events start four days apart, at a random hour, from 1979."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    scale = np.exp(rng.normal(0.0, 1.0, n_events))[:, None]
    t = np.linspace(0.0, 1.0, steps)[None, :]
    peak = rng.uniform(0.2, 0.6, n_events)[:, None]
    width = np.exp(rng.normal(np.log(0.08), 0.35, n_events))[:, None]
    lag = np.exp(rng.normal(np.log(0.1), 0.3, n_events))[:, None]
    spread = np.exp(rng.normal(np.log(1.8), 0.2, n_events))[:, None]
    cols = {"event_id": np.repeat(np.arange(1, n_events + 1), steps).reshape(n_events, steps),
            "precip-cum": np.cumsum(np.abs(rng.normal(scale, 0.3, (n_events, steps))), axis=1),
            "precip-excess": 2.0 * scale * np.exp(-((t - peak) / width) ** 2),
            "inflow": 100.0 * scale * np.exp(-((t - peak - lag) / (spread * width)) ** 2)}
    hours = np.arange(n_events) * 96 + rng.integers(0, 24, n_events)
    cols["datetime"] = (np.datetime64("1979-01-01T00", "h") + hours[:, None]
                        + np.arange(steps)[None, :]).astype("datetime64[ns]")
    pd.DataFrame({k: cols[k].reshape(-1) for k in
                  ("event_id", "datetime", "precip-cum", "precip-excess", "inflow")}
                 ).to_parquet(path)
    return cols


def stand_in_dss():
    """A FakeDss whose records live in the file it opens (a JSON map of DSS
    path to times and values), so a copied file carries its records: the
    stand-in for an event's SST.dss, which make-runs copies into the
    project and opens there. The card's machine has no hecdss."""
    from datetime import datetime

    from gpras_tpu_torch.data.dss import FakeDss, FakeRecord

    class StandInDss(FakeDss):
        def __init__(self, path: str):
            with open(path) as f:
                records = json.load(f)
            self.stores = {str(path): {
                FakeDss._normalize(k): FakeRecord(
                    values=np.asarray(v["values"]),
                    times=[datetime.fromisoformat(s) for s in v["times"]])
                for k, v in records.items()}}
            super().__init__(path)

    return StandInDss


def phase_run_tooling(out: Path):
    """The run-generation tooling through the CLI. ``main(["select-events",
    catalog, stac, "--device", DEVICE])`` at the CLI's defaults on
    sst_catalog's 10,000 events, its two PCAs recorded and timed on the card;
    held to: each PCA against pca_fit_reference on the same input
    (SST_PCA_RTOL x max|want| on components and explained variance, both
    float64), the STAC item byte for byte what EventSelection(...,
    device="cpu") and write_events_stac write from the same file, 35 Train
    and 14 Test storms without overlap, and the Sets Max, AEP and Diverse.
    Then ``main(["make-runs", settings])`` on a project holding a .prj and
    tests/data/cedar_basin.u01 as the template flow file, the STAC's hrefs on
    stand-in SST.dss files (stand_in_dss) and no precip grid; held to 49 flow
    files and 49 plans registered in the .prj, each flow file's base-flow BCs
    pointed at the event's record window (the DSS path's D part) and each
    plan's Simulation Date on it, and the manifest's 35 Train and 14 Test
    titles through the pipeline's event-plan reader (Config.train_plans,
    Config.test_plans); and no h5py or jax imported."""
    import contextlib
    import importlib.util
    import io
    import shutil

    import torch

    from gpras_tpu_torch.__main__ import main as cli
    from gpras_tpu_torch.data import dss
    from gpras_tpu_torch.data.flow_file import FlowHydrographBC, UnsteadyFlowFile
    from gpras_tpu_torch.data.plan_file import PlanFile
    from gpras_tpu_torch.eof.pca import pca_fit_reference
    from gpras_tpu_torch.pipeline import event_selection as es
    from gpras_tpu_torch.pipeline.config import Config

    probe = {m: importlib.util.find_spec(m) is not None for m in ("hecdss", "boto3", "h5py")}
    log(f"[run tooling] importable here: {probe}; the SST.dss files below are stand-ins "
        f"(JSON records through data/dss.set_dss_factory), not HEC-DSS files")
    root = out / "run_tooling"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    catalog = sst_catalog(root / "sst.pq", SST_EVENTS)
    catalog_s = time.perf_counter() - t0
    rows = SST_EVENTS * SST_STEPS
    log(f"[run tooling] SST catalog: {SST_EVENTS} events x {SST_STEPS} hourly rows "
        f"({rows} rows) written as parquet in {catalog_s:.2f} s (set-up)")

    events_dir = root / "events"
    pcas = []
    pca_fit = es.pca_fit

    def recording(x, k):  # the diversity fill's PCA, timed on the card
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        comps, explained = pca_fit(x, k)
        end.record()
        end.synchronize()
        pcas.append((x.cpu().numpy(), comps.cpu().numpy(), explained.cpu().numpy(),
                     start.elapsed_time(end), x.device.type, x.dtype))
        return comps, explained

    stac = root / "events.stac.json"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    es.pca_fit = recording
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli(["select-events", str(root / "sst.pq"), str(stac),
                      "--s3-prefix", str(events_dir), "--device", DEVICE])
        torch.cuda.synchronize()
        select_s = time.perf_counter() - t0
    finally:
        es.pca_fit = pca_fit
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pca = []
    for x, comps, explained, ms, where, dtype in pcas:
        want_c, want_e = pca_fit_reference(x, comps.shape[0])
        pca.append({"shape": list(x.shape), "device": where, "dtype": str(dtype), "ms": ms,
                    "components_err": float(np.abs(comps - want_c).max() / np.abs(want_c).max()),
                    "explained_err": float(np.abs(explained - want_e).max()
                                           / np.abs(want_e).max()),
                    "explained_variance": explained.tolist()})
    errs = ", ".join(f"{p['components_err']:.3e} / {p['explained_err']:.3e}" for p in pca)
    log(f"[run tooling] select-events on the card: rc {rc}, {select_s:.3f} s; PCAs "
        f"{[(p['shape'], p['device'], round(p['ms'], 3)) for p in pca]} (ms on the card); "
        f"against pca_fit_reference (components / explained variance, x max|want|, limit "
        f"{SST_PCA_RTOL}): {errs}; peak device memory {peak_gb:.4f} GB")
    if rc != 0 or len(pca) != 2 or any(
            p["device"] != torch.device(DEVICE).type or p["dtype"] != "torch.float64"
            or max(p["components_err"], p["explained_err"]) > SST_PCA_RTOL for p in pca):
        raise AssertionError("select-events' PCAs on the card disagree with pca_fit_reference")

    t0 = time.perf_counter()  # the same selection on the CPU, at the CLI's defaults
    cpu_stac = root / "events_cpu.stac.json"
    sel = es.EventSelection(str(root / "sst.pq"), test_rp_range=[5.0, 2000.0], device="cpu")
    storms, _ = sel.run_selection(35, 14, [2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 200.0, 500.0,
                                           1000.0, 2000.0])
    es.write_events_stac(storms, str(events_dir), str(cpu_stac))
    cpu_s = time.perf_counter() - t0
    item = json.loads(stac.read_text())
    assets = item["assets"]
    roles = [a["roles"][0] for a in assets.values()]
    sets = sorted({a["properties"]["Set"] for a in assets.values()})
    same = stac.read_bytes() == cpu_stac.read_bytes()
    log(f"[run tooling] the STAC item ({stac.stat().st_size} bytes) equals the CPU path's "
        f"({cpu_s:.3f} s) byte for byte: {same}; {roles.count('Train')} Train, "
        f"{roles.count('Test')} Test, Sets {sets}")
    if not same or roles.count("Train") != 35 or roles.count("Test") != 14 \
            or len(assets) != 49 or not {"Max", "AEP", "Diverse"} <= set(sets):
        raise AssertionError("select-events' selection is not the CPU path's or not the split")

    # stand-in SST.dss files at the STAC's hrefs, and no precip grid
    window = {}
    for key, asset in assets.items():
        e = int(asset["event_id"]) - 1
        times = [str(s) for s in catalog["datetime"][e].astype("datetime64[s]")]
        Path(asset["href"]).parent.mkdir(parents=True, exist_ok=True)
        Path(asset["href"]).write_text(json.dumps({
            f"/SST/{el}/FLOW-BASE/01JAN1900-02JAN1900/1HOUR/RUN:SST/":
                {"times": times, "values": (share * catalog["inflow"][e]).tolist()}
            for el, share in SST_ELEMENTS.items()}))
        asset["precip_hdf_href"] = ""
        start, end = catalog["datetime"][e][[0, -1]].astype("datetime64[s]").tolist()
        window[key] = (f"{start:%d%b%Y}-{end:%d%b%Y}".upper(),
                       f"{start:%d%b%Y,%H%M},{end:%d%b%Y,%H%M}".upper())
    stac.write_text(json.dumps(item, indent=2))
    model = root / "model"
    model.mkdir()
    (model / "cedar.prj").write_text("Proj Title=cedar basin\nCurrent Plan=p01\n"
                                     "Geom File=g01\n")
    settings = root / "settings.json"
    settings.write_text(json.dumps({
        "events_stac_path": str(stac), "output_path": str(root / "event_plans.json"),
        "ras_prj_path": str(model / "cedar.prj"),
        "template_flow_path": str(ROOT / "tests" / "data" / "cedar_basin.u01")}))
    dss.set_dss_factory(stand_in_dss())
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli(["make-runs", str(settings)])
        make_s = time.perf_counter() - t0
    finally:
        dss.set_dss_factory(None)

    prj = (model / "cedar.prj").read_text()
    flows = sorted(model.glob("cedar.u[0-9][0-9]"))
    plans = sorted(model.glob("cedar.p[0-9][0-9]"))
    manifest = json.loads((root / "event_plans.json").read_text())
    bad = []
    for i, (key, row) in enumerate(zip(assets, manifest), start=1):
        flow = UnsteadyFlowFile.from_file(str(model / f"cedar.u{i:02d}"))
        plan = PlanFile.from_file(model / f"cedar.p{i:02d}")
        parts = {bc.dss_path.split("/")[4] for bc in flow.boundary_conditions.bcs
                 if isinstance(bc, FlowHydrographBC) and bc.bc_line_id.strip().endswith("_base")}
        if (str(row["event_number"]) != key or parts != {window[key][0]}
                or plan.settings["Simulation Date"] != window[key][1]
                or plan.settings["Flow File"] != f"u{i:02d}"):
            bad.append((i, key, sorted(parts), plan.settings["Simulation Date"], window[key]))
    config = Config(working_directory=str(root / "work"), hf_ras_stac_path="unused",
                    area_of_interest_path="unused",
                    event_plan_path=str(root / "event_plans.json"), mesh_id="mesh1",
                    hydraulic_parameter="wse", wet_threshold_depth=0.1, spatial_mode_count=4,
                    kernel="Matern52", inducing_pt_count=0, optimizer="adam",
                    induction_pt_initializer="kmeans", optimizer_kwargs={},
                    generate_plots=False, save_dbs=True, lf_model_type="ras_upskill")
    n_runs = len(manifest)
    ms_per_run = 1e3 * make_s / max(n_runs, 1)
    log(f"[run tooling] make-runs: rc {rc}, {n_runs} runs in {make_s:.3f} s "
        f"({ms_per_run:.2f} ms a run); {len(flows)} flow files, "
        f"{len(plans)} plans, .prj rows {prj.count('Unsteady File=')} / "
        f"{prj.count('Plan File=')}; runs off their event's window: {bad[:3]}; the pipeline "
        f"reads {len(config.train_plans)} Train / {len(config.test_plans)} Test plans")
    if (rc != 0 or n_runs != 49 or len(flows) != 49 or len(plans) != 49 or bad
            or prj.count("Unsteady File=") != 49 or prj.count("Plan File=") != 49
            or len(config.train_plans) != 35 or len(config.test_plans) != 14):
        raise AssertionError("make-runs did not write the selection's 49 runs")
    loaded = sorted(m for m in ("h5py", "jax") if sys.modules.get(m) is not None)
    if loaded:
        raise AssertionError(f"the run-generation tooling imported {loaded}")
    return {"catalog_events": SST_EVENTS, "catalog_rows": rows, "catalog_setup_s": catalog_s,
            "importable": probe, "sst_dss": "stand-ins (JSON records), not HEC-DSS files",
            "select_events_s": select_s, "pca": pca, "peak_device_gb": peak_gb,
            "cpu_select_events_s": cpu_s, "stac_equal_cpu": same,
            "train": 35, "test": 14, "sets": sets, "make_runs_s": make_s,
            "make_runs_ms_per_run": ms_per_run, "runs": n_runs,
            "imported": loaded}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    wall0 = time.perf_counter()
    phase_device()
    phase_build()
    report, fp32_bounds = phase_kernels()
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    pred, first_request, serving_launches, sym_grids, cache_s, latencies = phase_serving(out)
    phase_dense_check(pred, first_request)
    del pred
    torch.cuda.empty_cache()
    x, y, _ = training_set()
    model, train_launches, training, start = phase_training(x, y)
    checks = phase_training_check(model, start)
    step = phase_step_breakdown(model)
    del model
    torch.cuda.empty_cache()
    b4_launches = phase_b4_path(x, y)
    cg_checks = phase_cg_checks()
    torch.cuda.empty_cache()
    cg_launches, cg_fit = phase_cg_fit()
    torch.cuda.empty_cache()
    sgpr_run = phase_sgpr(out)
    torch.cuda.empty_cache()
    cold_cg = phase_cold_cg()
    torch.cuda.empty_cache()
    cold_hutch = phase_cold_hutchinson(x, y)
    torch.cuda.empty_cache()
    svgp_run = phase_svgp(out)
    torch.cuda.empty_cache()
    archive = phase_svgp_archive()
    torch.cuda.empty_cache()
    acc = phase_accuracy(out)
    torch.cuda.empty_cache()
    metrics_hms = phase_metrics_hms(acc.pop("f32_paths"))
    torch.cuda.empty_cache()
    pipe = phase_pipeline(out)
    torch.cuda.empty_cache()
    tooling = phase_run_tooling(out)

    launches = {"kmv_dense": serving_launches["kmv_dense"],
                "kmv_sym": serving_launches["kmv_sym"], "gram": train_launches["gram"],
                "kgrad_sym": train_launches["kgrad_sym"], "kgrad_dense": b4_launches["kgrad_dense"]}
    path_shape = {"gram": ("Matern52", f"{N}x{N} +noise"),
                  "kmv_dense": ("Matern52", f"256x{N} R=1"),
                  "kmv_sym": ("Matern52", f"{N}x{N} R=256"),
                  "kgrad_dense": ("Matern52", f"N=3072 m={M}"),
                  "kgrad_sym": ("Matern52", f"N={N} m={M}")}
    sources = {"gram": ("gpras_tpu_torch/csrc/gram.cu",
                        "gpras_tpu/ops/pallas_gram.py:77 (_tile_body, pallas_gram :268)"),
               "kmv_dense": ("gpras_tpu_torch/csrc/kmv.cu",
                             "gpras_tpu/ops/pallas_gram.py:84 (_kmv_body)"),
               "kmv_sym": ("gpras_tpu_torch/csrc/kmv_sym.cu",
                           "gpras_tpu/ops/pallas_gram.py:152 (_kmv_sym_body, pallas_kmv :376)"),
               "kgrad_dense": ("gpras_tpu_torch/csrc/kgrad_dense.cu",
                               "gpras_tpu/ops/pallas_gram.py:534 (_kgrad_body, pallas_kgrad :701)"),
               "kgrad_sym": ("gpras_tpu_torch/csrc/kgrad_sym.cu",
                             "gpras_tpu/ops/pallas_gram.py:606 "
                             "(_kgrad_sym_body, pallas_kgrad :701)")}
    kernels = []
    for name in ("gram", "kmv_dense", "kmv_sym", "kgrad_dense", "kgrad_sym"):
        row = report[name][path_shape[name]]
        # launches counts wrapper calls on the path (kmv_sym's CUDA grids on
        # the path are on the line before, counted by its entry point; per
        # call in at_checked_shapes). library_ms: torch.matmul on a Gram prebuilt
        # by B1 for the matvecs B2 and B3; null for B1, B4 and B5, which no
        # PyTorch call computes (a stationary Gram, a covariance-derivative
        # contraction). ms: the whole wrapper call, one per event pair;
        # grids_ms (B1, B2, B4, B5): its CUDA grids alone, many launches per pair,
        # and library_queued_ms the library call timed the same way
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name], **row,
                        "shape": " ".join(path_shape[name]),
                        "at_checked_shapes": {f"{kernel} {shape}": r for (kernel, shape), r
                                              in report[name].items()}})
        if name in ("kmv_sym", "kgrad_sym"):  # wrapper calls in phase 9's CG fit
            kernels[-1]["launches_cg_training"] = cg_launches[name]
        # wrapper calls in the cold fits, phase 11 (Hutchinson) and 12 (CG)
        kernels[-1]["launches_cold_hutchinson"] = cold_hutch["launches"][name]
        kernels[-1]["launches_cold_cg"] = cold_cg["launches"][name]
        # wrapper calls in phase 15's exact accuracy path (N = 32,768)
        kernels[-1]["launches_accuracy_exact"] = acc["launches"][name]
        # wrapper calls in phase 17's cold pipeline run (N = 17,920)
        kernels[-1]["launches_pipeline"] = pipe["cold"]["launches"][name]
    log(json.dumps({"serving": {"cache_build_s": cache_s,
                                "request_s": dict(zip(("17", "200"), latencies))}}))
    log(json.dumps({"training": training, "training_checks": checks, "step": step}))
    log(json.dumps({"cg_training": {"checks_n49152": cg_checks, "fit_n131072": cg_fit}}))
    log(json.dumps({"sgpr": sgpr_run}))
    log(json.dumps({"cold_fit": {"hutchinson_n49152": cold_hutch, "cg_n65536": cold_cg}}))
    log(json.dumps({"svgp": svgp_run, "svgp_archive": archive}))
    log(json.dumps({"accuracy": acc, "metrics_hms": metrics_hms}))
    log(json.dumps({"pipeline": pipe}))
    log(json.dumps({"run_tooling": tooling}))
    log(json.dumps({"kmv_sym_on_serving_path": {"calls": serving_launches["kmv_sym"],
                                                "cuda_grids": sym_grids}}))
    log(json.dumps({"bound_fp32_only_ms_computed": fp32_bounds}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"wall_s": time.perf_counter() - wall0}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
