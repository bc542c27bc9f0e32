"""SVGP and the metric suite on the card, against the port's own float64 CPU
path on the same inputs.

Marked ``cuda``: they skip where no CUDA device is present (the CPU suite).
The machine with the card has no JAX, so run them there without the suite's
conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_svgp.py

Limits: float32 on the card against float64 on the CPU. The bound is held
in units of eps32 x the sum of its terms' magnitudes (64 units, as
chip_smoke.py phases 10 and 13: the data term's per-point pieces cancel, so
its rounding scales with them, not with the total); the natural-gradient
step's q to 1e-3 x max|want| (two fp32 Cholesky factorizations and a
triangular inverse of a well-conditioned q); the posterior to phase 4's
limits (mean 1e-3 x max|mean|, variance 1e-2 relative). The stream and
minibatch trainers on the card: 1e-6 relative (the same kernels on the same
operands; bit for bit is expected). Metrics in float64 on the card against
the CPU: 1e-10 relative (reductions in another order).
"""

import math

import numpy as np
import pytest
import torch

from gpras_tpu_torch.gp import svgp
from gpras_tpu_torch.metrics import compute_event_metrics

pytestmark = pytest.mark.cuda

EPS32 = 2.0 ** -23
UNITS = 64


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(n=4096, m=64, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(2.0 * x[:, 0]) + 0.5 * np.tanh(x[:, 1] * x[:, 2]) + 0.05 * rng.normal(size=n)
    z = x[rng.choice(n, m, replace=False)]
    p = svgp.init_params("Matern52", torch.as_tensor(x), torch.as_tensor(z), noise_variance=0.1)
    p["q_mu"] = torch.as_tensor(rng.normal(size=(m, 1)))
    p["q_raw"] = torch.as_tensor(0.1 * np.tril(rng.normal(size=(1, m, m))))
    return x, y, p


def _on(p, device, dtype):
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}


def _bound_unit(p64, x64, y64, n_total):
    """eps32 x the sum of the bound's term magnitudes, per point and in the KL."""
    a = svgp._whitened_projection("Matern52", p64, x64)
    mean, _ = svgp._f_moments(p64, a, svgp.K.kdiag("Matern52", p64, x64))
    sa = torch.einsum("pkm,kb->pmb", svgp.q_sqrt_from_raw(p64["q_raw"]), a)
    s2 = torch.exp(p64["log_noise_variance"])
    per_point = (0.5 * abs(math.log(2 * math.pi)) + 0.5 * torch.abs(torch.log(s2))
                 + ((y64 - mean[:, 0]) ** 2 + 1.0 + (a * a).sum(0) + (sa * sa).sum(1)[0])
                 / (2 * s2))
    q = svgp.q_sqrt_from_raw(p64["q_raw"])
    kl = (p64["q_mu"] ** 2).sum() + (q ** 2).sum() + q.shape[-1] + 2 * p64["q_raw"].diagonal(
        0, -2, -1).abs().sum()
    return EPS32 * float(n_total / x64.shape[0] * per_point.sum() + 0.5 * kl)


def test_elbo_natgrad_and_predict_in_float32_on_the_card(device):
    x, y, p = _problem()
    xb, yb = x[:1024], y[:1024]
    p64 = _on(p, "cpu", torch.float64)
    p32 = _on(p, device, torch.float32)
    x32, y32 = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (xb, yb))
    x64, y64 = torch.as_tensor(xb), torch.as_tensor(yb)
    got = float(svgp.elbo("Matern52", p32, x32, y32, 4096))
    want = float(svgp.elbo("Matern52", p64, x64, y64, 4096))
    unit = _bound_unit(p64, x64, y64, 4096)
    assert abs(got - want) <= UNITS * unit, (got, want, unit)

    got_q = svgp.natgrad_step("Matern52", p32, x32, y32, 4096, lr=0.5)
    want_q = svgp.natgrad_step("Matern52", p64, x64, y64, 4096, lr=0.5)
    for k in ("q_mu", "q_raw"):
        err = (got_q[k].double().cpu() - want_q[k]).abs().max().item()
        assert err <= 1e-3 * want_q[k].abs().max().item(), (k, err)

    xs = np.random.default_rng(3).normal(size=(300, 4))
    m32, v32 = svgp.predict("Matern52", p32, torch.as_tensor(xs, dtype=torch.float32,
                                                             device=device))
    m64, v64 = svgp.predict("Matern52", p64, torch.as_tensor(xs))
    assert (m32.double().cpu() - m64).abs().max() <= 1e-3 * m64.abs().max()
    assert ((v32.double().cpu() - v64).abs() / v64).max() <= 1e-2


def test_stream_fit_equals_minibatch_fit_on_the_card(device):
    x, y, p = _problem(n=8192, m=64, seed=1)
    p = svgp.init_params("Matern52", torch.as_tensor(x, dtype=torch.float32, device=device),
                         p["z"].to(device=device, dtype=torch.float32), noise_variance=0.1)
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    perms = torch.stack([torch.randperm(8192, generator=gen, device=device) for _ in range(2)])
    want, hist = svgp.make_minibatch_fit("Matern52", batch_size=512, epochs=2, natgrad=0.5)(
        p, xt, yt, perms)
    init, run_chunk = svgp.make_stream_fit("Matern52", natgrad=0.5)
    got, state = p, init(p)
    for perm in perms:
        xc, yc = xt[perm].reshape(16, 512, 4), yt[:, None][perm].reshape(16, 512, 1)
        for c in range(0, 16, 4):
            got, state, _ = run_chunk(got, state, xc[c:c + 4], yc[c:c + 4], 8192)
    assert bool(torch.isfinite(hist).all())
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= 1e-6 * max(want[k].abs().max().item(), 1e-30), (k, err)


@pytest.mark.parametrize("kwargs", [dict(), dict(t_tol=3, v_tol=0.1)])
def test_event_metrics_on_the_card_equal_the_cpu(device, kwargs):
    rng = np.random.default_rng(4)
    x = np.maximum(rng.normal(size=(48, 4096)), 0.0)
    y = np.maximum(x + 0.1 * rng.normal(size=x.shape), 0.0)
    conf = rng.uniform(0.05, 0.2, size=x.shape)
    got = compute_event_metrics(*(torch.as_tensor(a, device=device) for a in (x, y, conf)),
                                **kwargs)
    want = compute_event_metrics(*(torch.as_tensor(a) for a in (x, y, conf)), **kwargs)
    for k, w in want.items():
        g = got[k].cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(w)), k
        ok = ~torch.isnan(w)
        assert torch.allclose(g[ok], w[ok], rtol=1e-10, atol=1e-10 * w[ok].abs().max()), k
