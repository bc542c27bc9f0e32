"""Plain versions of the port's Gram kernel (B1) and gradient contraction
(B4, B5) against the JAX package's Pallas kernels, run here in interpret
mode, and against the JAX float64 autodiff contraction. The CUDA kernels
themselves are held to these plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.ops import kernels as JK
from gpras_tpu.ops.pallas_gram import _pad_rows, pallas_gram, pallas_kgrad
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from torch_parity import t32, t64

STATIONARY = K.STATIONARY_KERNELS


def _params(rng, d, dtype=np.float32):
    return {"log_variance": np.asarray(0.3, dtype),
            "log_lengthscales": np.log(rng.uniform(0.5, 2.0, d)).astype(dtype)}


@pytest.mark.parametrize("kernel", STATIONARY)
@pytest.mark.parametrize("shape", [(300, None), (520, 300)], ids=["square_noise", "cross"])
def test_gram_plain_matches_pallas_gram(kernel, shape):
    """float32 on both sides, tolerance as the reference's own Pallas-vs-plain
    matvec test (tests/test_kernels.py:119): both sides round the same
    expanded r2 = a2 + b2 - 2ab in float32, in another order."""
    n1, n2 = shape
    rng = np.random.default_rng(n1 + (n2 or 0))
    params = _params(rng, 3)
    x1 = rng.normal(size=(n1, 3)).astype(np.float32)
    x2 = None if n2 is None else rng.normal(size=(n2, 3)).astype(np.float32)
    noise = None if n2 else np.float32(0.25)
    want = np.asarray(pallas_gram(kernel, {k: jnp.asarray(v) for k, v in params.items()},
                                  jnp.asarray(x1), None if x2 is None else jnp.asarray(x2),
                                  noise, interpret=True))
    got = fused_gram.gram_plain(kernel, {k: t32(v) for k, v in params.items()}, t32(x1),
                                None if x2 is None else t32(x2), noise)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    if x2 is None and kernel in ("Matern12", "Exponential"):
        # a point against itself: plain float32 rounds r2 to ~1e-7 instead
        # of 0 (Pallas' dot happens to cancel exactly), and these kernels
        # are linear in r = sqrt(r2) there, so the diagonal moves by ~1e-3
        # (measured 9.3e-4); the off-diagonal entries keep 2e-4
        np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0, atol=2e-3)
        np.fill_diagonal(got, 0.0)
        want = want.copy()
        np.fill_diagonal(want, 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _kgrad_problem(n, d, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(n, m)).astype(np.float32)
    z = rng.choice([-1.0, 1.0], size=(n, m)).astype(np.float32)
    alpha = rng.normal(size=n).astype(np.float32)
    return _params(rng, d), x, w, z, alpha


def _torch64(params, *arrays):
    return ({k: t64(v) for k, v in params.items()}, *(t64(a) for a in arrays))


@pytest.mark.parametrize("kernel", STATIONARY)
@pytest.mark.parametrize("n", [640, 1100])
def test_kgrad_plain_matches_pallas_kgrad(kernel, n):
    """The plain contraction in float64 on the float32 inputs against both
    Pallas bodies (interpret mode, tile 128: a padded multi-tile grid).
    Tolerances are the reference's (tests/test_kernels.py:172-180): the
    Pallas bodies expand (a - b)^2 and contract W Z^T in bf16_3x, ~0.3% off
    float64 for the r-singular kernels."""
    params, x, w, z, alpha = _kgrad_problem(n, 4, 8, seed=n)
    g, inv_m = 1.7, 1.0 / 8
    want = fused_gram.kgrad_plain(kernel, *_torch64(params, x, w, z, alpha), g, inv_m)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for sym in (False, True):
        got = pallas_kgrad(kernel, jp, jnp.asarray(x), jnp.asarray(w), jnp.asarray(z),
                           jnp.asarray(alpha), g=g, inv_m=inv_m, interpret=True, tile=128,
                           sym=sym)
        np.testing.assert_allclose(float(got["log_variance"]), float(want["log_variance"]),
                                   rtol=5e-3, err_msg=f"sym={sym}")
        wl = want["log_lengthscales"].numpy()
        np.testing.assert_allclose(np.asarray(got["log_lengthscales"], np.float64), wl,
                                   atol=8e-3 * max(np.abs(wl).max(), 1e-3), rtol=5e-3,
                                   err_msg=f"sym={sym}")


@pytest.mark.parametrize("kernel", K.KERNEL_NAMES)
def test_kgrad_plain_matches_jax_f64_autodiff(kernel):
    """float64 on both sides: the JAX vjp of the dense Gram contracted with
    the same rank-(m+1) cotangent (tests/test_kernels.py:157-169), for every
    covariance (the plain version serves the non-stationary ones too). Same
    arithmetic in another order: 1e-10 relative."""
    rng = np.random.default_rng(11)
    n, d, m = 300, 3, 6
    x = rng.normal(size=(n, d))
    w = rng.normal(size=(n, m))
    z = rng.choice([-1.0, 1.0], size=(n, m))
    alpha = rng.normal(size=n)
    params = {k: np.asarray(v, np.float64)
              for k, v in JK.init_params(kernel, d, dtype=jnp.float64).items()}
    params["log_variance"] = np.float64(0.2)
    if "log_lengthscales" in params:
        params["log_lengthscales"] = np.log(rng.uniform(0.5, 2.0, d))
    g, inv_m = 1.3, 1.0 / m
    kbar = 0.5 * g * (inv_m * w @ z.T - alpha[:, None] * alpha[None, :])
    _, pullback = jax.vjp(lambda p: JK.gram(kernel, p, jnp.asarray(x)),
                          {k: jnp.asarray(v) for k, v in params.items()})
    (want,) = pullback(jnp.asarray(kbar))
    got = fused_gram.kgrad_plain(kernel, *_torch64(params, x, w, z, alpha), g, inv_m,
                                 col_panel=128)
    # Matern12 and Exponential have f' ~ 1/r, and the diagonal's r2 rounds
    # to ~1e-16 in either package's expansion: the lengthscale gradient then
    # agrees to ~1e-9 (measured 1.9e-9), not to float64's last digits
    rtol = 1e-7 if kernel in ("Matern12", "Exponential") else 1e-10
    for k in params:
        if k == "degree":
            continue
        wk = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), wk, rtol=rtol,
                                   atol=rtol * max(np.abs(wk).max(), 1.0), err_msg=k)


@pytest.mark.parametrize("n", [3584, 3585])
def test_kgrad_body_choice_is_the_references(n, monkeypatch):
    """B5 (symmetric) exactly where pallas_kgrad picks its symmetric body:
    ceil(N / 512) >= 8 tile rows (pallas_gram.py:741-742)."""
    called = []
    monkeypatch.setattr(fused_gram, "kgrad_sym", lambda *a: called.append("sym"))
    monkeypatch.setattr(fused_gram, "kgrad_dense", lambda *a: called.append("dense"))
    x = torch.zeros((n, 2))
    fused_gram.kgrad("RBF", {}, x, x, x, x[:, 0], 1.0, 0.5)
    ref_sym = _pad_rows(jnp.zeros((n, 1)), 512).shape[0] // 512 >= 8
    assert called == ["sym" if ref_sym else "dense"]
    assert ref_sym == (n == 3585)


def test_kgrad_on_cpu_returns_the_stationary_gradients():
    params, x, w, z, alpha = _kgrad_problem(200, 3, 4, seed=2)
    args = _torch64(params, x, w, z, alpha)
    got = fused_gram.kgrad("Matern32", *args, 0.5, 0.25)
    want = fused_gram.kgrad_plain("Matern32", *args, 0.5, 0.25)
    assert sorted(got) == ["log_lengthscales", "log_variance"]
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
