"""The cold exact fit and SGPR on the card, against the port's own float64
CPU path on the same inputs.

Marked ``cuda``: they skip where no CUDA device is present (the CPU suite).
The machine with the card has no JAX, so run them there without the suite's
conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_coldfit_sgpr.py

Limits: float32 on the card against float64 on the CPU. The segmented
step's loss is held to 1e-4 relative and its gradient to 1e-3 x max|want|
(fp32 solves of well-conditioned systems reach ~1e-6; SLQ's quadrature and
the 4,096-term sums add ~1e-5); a loss at given parameters (Hutchinson's
against the dense float64 NLML of the same matrix, SGPR's against its
float64 formula) to chip_smoke.py phase 6's 1e-5 relative, or 1e-4 at the
cold fit's converged parameters (its LOSS_TOL_CONVERGED: fp32 misses
float64 by 1.3e-5 there); posteriors to phase 4's limits (mean
1e-3 x max|mean|, variance 1e-2 relative).
"""

import math

import numpy as np
import pytest
import torch

from gpras_tpu_torch.gp import coldfit, exact, exact_cg, exact_stochastic, sgpr
from gpras_tpu_torch.gp.model import GPRAS
from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.ops import fused_gram

pytestmark = pytest.mark.cuda

N = 4096  # at and above 2,048 points the kernel route runs (B3, B5)
WRAPPERS = (fused_gram.gram, fused_gram.kmv_dense, fused_gram.kmv_sym,
            fused_gram.kgrad_dense, fused_gram.kgrad_sym)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fn in WRAPPERS:
        fn.launches = 0
    return torch.device("cuda")


def _data(n=N, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _params(device, dtype, d=3, noise=1.0, variance=0.3):
    rng = np.random.default_rng(1)
    p = {"log_variance": math.log(variance), "log_noise_variance": math.log(noise),
         "log_lengthscales": np.log(rng.uniform(0.6, 1.6, d))}
    return {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in p.items()}


def _launches():
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def test_segmented_step_on_the_card_matches_its_cpu_float64_self(device):
    x, y = _data()
    draws = exact_cg.precond_probes(N, 16, 15, dtype=torch.float64)
    opts = dict(probes=15, max_iters=32, seg_iters=4, tol=1e-4, precond_rank=16,
                residual_gate=0.1)
    want_l, want_g = exact_cg.make_cg_step_chunked("Matern52", **opts)(
        _params("cpu", torch.float64), torch.as_tensor(x), torch.as_tensor(y), draws)
    args = (_params(device, torch.float32), torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(y, dtype=torch.float32, device=device),
            tuple(d.float().to(device) for d in draws))
    step = exact_cg.make_cg_step_chunked("Matern52", **opts)
    got_l, got_g = step(*args)
    assert _launches()["kmv_sym"] == 4 * step.last_segments and _launches()["kgrad_sym"] == 1
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    scale = max(float(v.abs().max()) for v in want_g.values())
    for k, v in want_g.items():
        np.testing.assert_allclose(got_g[k].double().cpu().numpy(), v.numpy(), rtol=0,
                                   atol=1e-3 * scale, err_msg=k)
    # the early exit, bit for bit against the full budget, on the card: at
    # the cold fit's column tolerance, 0.02 (fp32 columns do not all reach
    # 1e-4 inside 32 iterations, so no segment is skipped there)
    opts["tol"] = 0.02
    early = exact_cg.make_cg_step_chunked("Matern52", **opts)
    full = exact_cg.make_cg_step_chunked("Matern52", early_exit=False, gate_abort=False, **opts)
    (early_l, early_g), (full_l, full_g) = early(*args), full(*args)
    assert early.last_segments < full.last_segments == 8
    assert torch.equal(full_l, early_l) and all(torch.equal(full_g[k], early_g[k])
                                                for k in early_g)


def test_fit_exact_hutchinson_on_the_card(device):
    x, y = _data()
    xt = torch.tensor(x, dtype=torch.float32, device=device)
    yt = torch.tensor(y, dtype=torch.float32, device=device)
    p, info = coldfit.fit_exact("Matern52", xt, yt, engine="hutchinson", max_iter=12)
    assert info["engine"] == "hutchinson"
    launches = _launches()
    # below 16,384 points the forward Gram is plain torch; B5 runs every backward
    assert launches["gram"] == 0 and 1 <= launches["kgrad_sym"] <= info["evals"]
    loss = exact_stochastic.make_hutchinson_training_loss("Matern52")
    z = exact_stochastic.rademacher_probes(N, 16, device=device)
    with torch.no_grad():
        initial = float(loss(exact.init_params("Matern52", xt, noise_variance=0.1), xt, yt, z))
        final = float(loss(p, xt, yt, z))
    # the float64 dense loss of the matrix the float32 engine factors
    # (jitter 1e-6 x variance on the diagonal, float32's)
    p64 = {k: v.double().cpu() for k, v in p.items()}
    k64 = exact.build_train_gram("Matern52", p64, torch.as_tensor(x), jitter=1e-6)
    want = float(exact.quad_logdet(k64, torch.as_tensor(y)[:, None])[0]) \
        + 0.5 * N * math.log(2.0 * math.pi) - float(log_prior(p64))
    assert final < initial
    # at converged parameters (noise ~0.01) fp32 misses float64 by ~1e-5:
    # chip_smoke.py's LOSS_TOL_CONVERGED
    np.testing.assert_allclose(final, want, rtol=1e-4)
    _, cpu = coldfit.fit_exact("Matern52", torch.as_tensor(x), torch.as_tensor(y),
                               engine="hutchinson", max_iter=12)
    assert final <= float(cpu["loss"]) + 1e-3 * abs(float(cpu["loss"]))


def test_fit_exact_cg_on_the_card(device):
    x, y = _data()
    xt = torch.tensor(x, dtype=torch.float32, device=device)
    yt = torch.tensor(y, dtype=torch.float32, device=device)
    p, info = coldfit.fit_exact("Matern52", xt, yt, engine="cg", max_iter=3)
    assert info["engine"] == "cg_hostls"
    launches = _launches()
    assert launches["kgrad_sym"] == info["evals"] and launches["kmv_sym"] % 16 == 0
    assert launches["kmv_sym"] >= 16 * info["evals"] and launches["gram"] == 0
    losses = info["losses"][:int(info["iterations"])]
    assert bool(torch.isfinite(losses).any())
    assert all(bool(torch.isfinite(v).all()) for v in p.values())
    assert float(p["log_noise_variance"]) >= math.log(1e-3) - 1e-6


def test_sgpr_fit_and_predict_on_the_card(device):
    """GPRAS's default backend on the card (k-means inducing points, the
    two-stage fit), then its loss and its posterior at the fitted parameters
    against float64 on the CPU."""
    x, y = _data()
    y2 = np.stack([y, np.cos(x[:, 2])], axis=1)
    card = GPRAS("Matern52", device=device)
    card.fit(x, y2, n_inducing=40, max_iter=30, learning_rate=0.02)
    assert not any(_launches().values())  # SGPR runs no hand-written kernel
    losses = card.fit_info["losses"]
    assert bool(torch.isfinite(losses).all()) and bool((losses[:, -1] < losses[:, 0]).all())
    xs = np.random.default_rng(3).normal(size=(37, 3))
    mean, var = card.predict(xs)
    x64, xs64 = torch.as_tensor(x), torch.as_tensor(xs)
    for i in range(2):
        p32 = {k: v[i] for k, v in card.params.items()}
        p64 = {k: v.double().cpu() for k, v in p32.items()}
        y64 = torch.as_tensor(y2[:, i])
        with torch.no_grad():
            got = float(card._loss_fn(p32, card.y[:, i]))
            want = float(sgpr.training_loss("Matern52", p64, x64, y64))
            want_mean, want_var = (t.numpy() for t in sgpr.predict("Matern52", p64, x64, y64,
                                                                   xs64))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert np.abs(mean[:, i] - want_mean).max() <= 1e-3 * np.abs(want_mean).max()
        assert (np.abs(var[:, i] - want_var) / want_var).max() <= 1e-2
