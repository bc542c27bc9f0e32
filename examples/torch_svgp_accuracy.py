"""SVGP at archive scale on the port: benchmarks/svgp_accuracy.py's protocol
in PyTorch, with the streamed epoch of benchmarks/svgp_throughput.py.

1. Data: N training and ``n_test`` held-out points in D dimensions,
   y = sin(2 x0) + 0.5 tanh(x1 x2) + 0.05 eps, drawn with numpy from
   ``seed`` (float32; the reference draws with jax.random, so the numbers
   differ and the statistics do not).
2. Gold: SGPR hyperparameters fit on a uniform ``n_sub``-point subsample
   with the collapsed bound (full-batch Adam at lr 0.02, optax's update, for
   ``hyper_steps`` steps), then the collapsed-optimal q over the full N
   (``gp/svgp.optimal_q``): the SGPR posterior.
3. SVGP: ``make_minibatch_fit`` from the standard init (noise 0.1, the first
   M points as Z), natural-gradient steps on q at lr 0.5 and Adam at lr 0.01
   on the rest, ``epochs`` epochs over the device-resident data.
4. Held-out RMSE against f and against y, SVGP against the gold, and the
   2-sigma coverage of y, for both.
5. One more epoch from the same init and one permutation, twice: device-
   resident (``make_minibatch_fit``) and streamed from pinned host memory in
   chunks of ``chunk`` batches (``make_stream_fit``; the next chunk is copied
   on a side stream while the current one computes). Both must give the
   same parameters; their points per second are reported.

Run on the card: ``python examples/torch_svgp_accuracy.py`` (N = 2^20,
M = 512, B = 8,192, D = 8, 8 epochs); at a small size on the CPU:
``python examples/torch_svgp_accuracy.py --n 16384 --m 64 --b 1024
--n-sub 4096 --hyper-steps 50 --epochs 2 --device cpu``. Prints one JSON
line. ``chip_smoke.py`` phase 14 runs the same functions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpras_tpu_torch.fit.optimizers import _adam_update, value_and_grad  # noqa: E402
from gpras_tpu_torch.gp import sgpr, svgp  # noqa: E402

KERNEL = "Matern52"
LEARNING_RATE = 0.01  # Adam on the hyperparameters and Z
NATGRAD = 0.5         # the natural-gradient step's rate on q


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_data(n: int, n_test: int, d: int, seed: int):
    """Host float32 arrays: x (n + n_test, d), the latent f and the noisy y."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + n_test, d), dtype=np.float32)
    f = np.sin(2.0 * x[:, 0]) + 0.5 * np.tanh(x[:, 1] * x[:, 2])
    y = (f + 0.05 * rng.standard_normal(n + n_test, dtype=np.float32)).astype(np.float32)
    return x, f.astype(np.float32), y


def fit_gold(x: torch.Tensor, y: torch.Tensor, m: int, n_sub: int, hyper_steps: int):
    """SGPR hyperparameters on the subsample, then optimal q over all of x."""
    n = x.shape[0]
    stride = max(1, n // n_sub)
    x_s, y_s = x[::stride].contiguous(), y[::stride].contiguous()
    p = sgpr.init_params(KERNEL, x_s, x[:m], noise_variance=0.1)
    state = svgp._adam_init(p)
    for _ in range(hyper_steps):
        _, g = value_and_grad(lambda q: sgpr.training_loss(KERNEL, q, x_s, y_s), p)
        u, state = _adam_update(g, state, 0.02, svgp.ADAM_B1, svgp.ADAM_B2, svgp.ADAM_EPS)
        p = {k: v + u[k] for k, v in p.items()}
    p["q_mu"] = torch.zeros((m, 1), dtype=x.dtype, device=x.device)
    p["q_raw"] = torch.zeros((1, m, m), dtype=x.dtype, device=x.device)
    with torch.no_grad():
        return svgp.optimal_q(KERNEL, p, x, y)


def stream_epoch(params, x_host: np.ndarray, y_host: np.ndarray, perm: np.ndarray, b: int,
                 chunk: int, device: torch.device):
    """One epoch of ``make_stream_fit`` from host memory, ``chunk`` batches a
    transfer, in the order of ``perm``: the host gathers and pins the epoch's
    batches, and on the card each chunk is copied on a side stream while the
    one before it computes. Returns (params, losses)."""
    init, run_chunk = svgp.make_stream_fit(KERNEL, learning_rate=LEARNING_RATE, natgrad=NATGRAD)
    n, d = x_host.shape
    n_chunks = (n // b) // chunk
    used = perm[: n_chunks * chunk * b]
    xs = torch.from_numpy(x_host[used].reshape(n_chunks, chunk, b, d))
    ys = torch.from_numpy(y_host[used].reshape(n_chunks, chunk, b, 1))
    cuda = device.type == "cuda"
    if cuda:
        xs, ys = xs.pin_memory(), ys.pin_memory()
        copies = torch.cuda.Stream(device)

    def upload(i):
        if not cuda:
            return xs[i].to(device), ys[i].to(device), None
        with torch.cuda.stream(copies):
            xc = xs[i].to(device, non_blocking=True)
            yc = ys[i].to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copies)
        return xc, yc, done

    p, state = params, init(params)
    losses = []
    pending = upload(0)
    for i in range(n_chunks):
        xc, yc, done = pending
        if cuda:
            torch.cuda.current_stream(device).wait_event(done)
            xc.record_stream(torch.cuda.current_stream(device))
            yc.record_stream(torch.cuda.current_stream(device))
        if i + 1 < n_chunks:
            pending = upload(i + 1)
        p, state, ls = run_chunk(p, state, xc, yc, n)
        losses.append(ls)
    return p, torch.cat(losses)


def run(n: int = 1 << 20, m: int = 512, b: int = 8192, d: int = 8, n_test: int = 8192,
        n_sub: int = 65536, epochs: int = 8, hyper_steps: int = 300, chunk: int = 16,
        seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """The whole protocol; returns the report (the JSON line's fields) and,
    under ``"params"``, the fitted SVGP parameters."""
    dev = torch.device(device)
    x_h, f_h, y_h = make_data(n, n_test, d, seed)
    t0 = time.perf_counter()
    x = torch.as_tensor(x_h[:n], device=dev)
    y = torch.as_tensor(y_h[:n], device=dev)
    x_t = torch.as_tensor(x_h[n:], device=dev)
    sync(dev)
    upload_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    p_gold = fit_gold(x, y, m, min(n, n_sub), hyper_steps)
    with torch.no_grad():
        gold_mu, gold_var = svgp.predict(KERNEL, p_gold, x_t)
    sync(dev)
    gold_s = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    perms = torch.stack([torch.randperm(n, generator=gen, device=dev) for _ in range(epochs + 1)])
    p0 = svgp.init_params(KERNEL, x, x[:m], noise_variance=0.1)
    fit = svgp.make_minibatch_fit(KERNEL, batch_size=b, epochs=epochs,
                                  learning_rate=LEARNING_RATE, natgrad=NATGRAD)
    sync(dev)
    t0 = time.perf_counter()
    p_fit, hist = fit(p0, x, y, perms[:epochs])
    sync(dev)
    svgp_s = time.perf_counter() - t0
    with torch.no_grad():
        svgp_mu, svgp_var = svgp.predict(KERNEL, p_fit, x_t)

    # one epoch, device-resident and streamed, on the same permutation
    one = svgp.make_minibatch_fit(KERNEL, batch_size=b, epochs=1, learning_rate=LEARNING_RATE,
                                  natgrad=NATGRAD)
    sync(dev)
    t0 = time.perf_counter()
    p_dev, _ = one(p0, x, y, perms[epochs:])
    sync(dev)
    device_epoch_s = time.perf_counter() - t0
    del x, y
    t0 = time.perf_counter()
    p_stream, _ = stream_epoch(p0, x_h[:n], y_h[:n], perms[epochs].cpu().numpy(), b, chunk, dev)
    sync(dev)
    stream_epoch_s = time.perf_counter() - t0
    stream_err = max(float((p_stream[k] - p_dev[k]).abs().max())
                     / max(float(p_dev[k].abs().max()), 1e-30) for k in p_dev)
    stream_bits = all(torch.equal(p_stream[k], p_dev[k]) for k in p_dev)

    f_t, y_t = f_h[n:].astype(np.float64), y_h[n:].astype(np.float64)
    smu, ssd = svgp_mu.double().cpu().numpy(), np.sqrt(svgp_var.double().cpu().numpy())
    gmu, gsd = gold_mu.double().cpu().numpy(), np.sqrt(gold_var.double().cpu().numpy())

    def rmse(a, c):
        return float(np.sqrt(np.mean((a - c) ** 2)))

    def cov2(mu, sd):
        return float(np.mean(np.abs(y_t - mu) <= 2.0 * sd))

    used = (n // b) * b
    chunked = ((n // b) // chunk) * chunk * b
    return {
        "n": n, "m": m, "b": b, "d": d, "n_test": n_test, "n_sub": min(n, n_sub),
        "epochs": epochs, "hyper_steps": hyper_steps, "kernel": KERNEL, "seed": seed,
        "svgp_rmse_f": rmse(smu, f_t), "gold_rmse_f": rmse(gmu, f_t),
        "svgp_rmse_y": rmse(smu, y_t), "gold_rmse_y": rmse(gmu, y_t),
        "svgp_vs_gold_mean_rmse": rmse(smu, gmu),
        "svgp_coverage_2sd": cov2(smu, ssd), "gold_coverage_2sd": cov2(gmu, gsd),
        "noise_sigma_true": 0.05,
        "svgp_noise_sigma": math.exp(0.5 * float(p_fit["log_noise_variance"])),
        "gold_noise_sigma": math.exp(0.5 * float(p_gold["log_noise_variance"])),
        "epoch_losses": hist.tolist(),
        "upload_s": upload_s, "gold_s": gold_s, "svgp_fit_s": svgp_s,
        "svgp_s_per_epoch": svgp_s / epochs, "svgp_s_per_step": svgp_s / (epochs * (n // b)),
        "device_epoch_s": device_epoch_s, "device_points_per_s": used / device_epoch_s,
        "stream_chunk_batches": chunk, "stream_epoch_s": stream_epoch_s,
        "stream_points_per_s": chunked / stream_epoch_s,
        "stream_vs_device_max_rel_err": stream_err, "stream_bit_identical": stream_bits,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "params": p_fit,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--b", type=int, default=8192)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=8192)
    ap.add_argument("--n-sub", type=int, default=65536)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--hyper-steps", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = run(a.n, a.m, a.b, a.d, a.n_test, a.n_sub, a.epochs, a.hyper_steps, a.chunk, a.seed,
              a.device)
    out.pop("params")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
