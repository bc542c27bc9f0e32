"""The port's lean exact engine (gpras_tpu_torch/gp/exact_lean.py) and the
Hutchinson engine's in-place and blocked factorizations against the JAX
package's, on the same seeded numpy inputs, in float64 on the CPU.

Every case of tests/test_exact_lean.py, run on both packages: the lean
NLML's value and gradient for the five stationary kernels x the three
factorizations (the library's, "blocked", "super"), at a panel width that
divides N and at one that must shrink; the training loss's prior. Then
``make_hutchinson_nlml(chol="super" | "blocked")`` against the JAX one with
the JAX engine's own probes (tests/test_exact_stochastic.py's case), and
``GPRAS`` fits whose ladder takes the lean rung, step for step against the
JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.gp import exact as JE
from gpras_tpu.gp import exact_lean as JLean
from gpras_tpu.gp import exact_stochastic as JS
from gpras_tpu.gp.model import GPRAS as JGPRAS
from gpras_tpu_torch.fit.optimizers import value_and_grad
from gpras_tpu_torch.gp import exact as TE
from gpras_tpu_torch.gp import exact_lean as TLean
from gpras_tpu_torch.gp import exact_stochastic as TS
from gpras_tpu_torch.gp.model import GPRAS as TGPRAS
from torch_parity import np_params, t64

STATIONARY = ("RBF", "Matern12", "Matern32", "Matern52", "Exponential")
#: float64, the same operations in another order
RTOL = 1e-9
#: the reference test's gradient limits (tests/test_exact_lean.py)
GRAD_RTOL, GRAD_ATOL = 1e-8, 1e-10
#: Matern12 and Exponential are linear in r at r = 0: the expanded r2 of a
#: point against itself rounds to ~1e-16, not 0, differently in the two
#: packages' matmuls, and d r / d r2 there is large, so their lengthscale
#: gradients agree to ~2e-8 (measured up to 2.1e-8; the values to 2e-16):
#: tests/test_torch_exact_train.py's RTOL_R_SINGULAR
RTOL_R_SINGULAR = 1e-7


def _grad_tols(kernel):
    if kernel in ("Matern12", "Exponential"):
        return RTOL_R_SINGULAR, RTOL_R_SINGULAR
    return GRAD_RTOL, GRAD_ATOL


def make_data(n=48, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def _params(kernel, x, noise):
    return np_params(JE.init_params(kernel, jnp.asarray(x), noise_variance=noise))


def _jax_value_and_grad(nlml, params, x, y):
    v, g = jax.value_and_grad(lambda p: nlml(p, jnp.asarray(x), jnp.asarray(y)))(
        {k: jnp.asarray(a) for k, a in params.items()})
    return float(v), np_params(g)


def _torch_value_and_grad(nlml, params, x, y):
    v, g = value_and_grad(lambda p: nlml(p, t64(x), t64(y)),
                          {k: t64(a) for k, a in params.items()})
    return float(v), np_params(g)


def _assert_grads(got, want, rtol, atol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _engine_kwargs(engine, n):
    """The three factorizations at a small size: the library's, blocks of
    16 (14 when 16 does not divide N) and super-panels of 16 with strips of
    24 that are not aligned to them."""
    if engine == "blocked":
        return {"blocked": 16 if n % 16 == 0 else 14}
    if engine == "super":
        return {"engine": "super", "chol_w": 16, "chol_strip": 24}
    return {}


@pytest.mark.parametrize("n", [48, 42])  # 42 % 16 != 0: the panels shrink to 14
@pytest.mark.parametrize("engine", [None, "blocked", "super"])
@pytest.mark.parametrize("kernel", STATIONARY)
def test_lean_nlml_value_and_gradient_match_jax(kernel, engine, n):
    x, y = make_data(n, seed=STATIONARY.index(kernel))
    params = _params(kernel, x, 0.2)
    kw = _engine_kwargs(engine, n)
    wv, wg = _jax_value_and_grad(JLean.make_lean_nlml(kernel, col_panel=16, **kw), params, x, y)
    tv, tg = _torch_value_and_grad(TLean.make_lean_nlml(kernel, col_panel=16, **kw),
                                   params, x, y)
    np.testing.assert_allclose(tv, wv, rtol=RTOL)
    _assert_grads(tg, wg, *_grad_tols(kernel))
    # and the port's lean engine against its own dense one (the reference
    # test's claim, at its limits)
    dv, dg = _torch_value_and_grad(lambda p, xx, yy: TE.nlml(kernel, p, xx, yy), params, x, y)
    np.testing.assert_allclose(tv, dv, rtol=1e-9)
    _assert_grads(tg, dg, 1e-7, 1e-9)


def test_lean_nlml_gradient_of_y_matches_jax():
    x, y = make_data(seed=4)
    params = _params("RBF", x, 0.3)
    p_j = {k: jnp.asarray(a) for k, a in params.items()}
    want = jax.grad(JLean.make_lean_nlml("RBF", col_panel=16), argnums=2)(
        p_j, jnp.asarray(x), jnp.asarray(y))
    yt = t64(y).requires_grad_(True)
    TLean.make_lean_nlml("RBF", col_panel=16)({k: t64(a) for k, a in params.items()},
                                              t64(x), yt).backward()
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_lean_training_loss_includes_prior():
    x, y = make_data(seed=3)
    params = _params("RBF", x, 1.0)
    want = float(JLean.make_lean_training_loss("RBF", col_panel=16)(
        {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(x), jnp.asarray(y)))
    got = float(TLean.make_lean_training_loss("RBF", col_panel=16)(
        {k: t64(a) for k, a in params.items()}, t64(x), t64(y)))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    dense = float(TE.training_loss("RBF", {k: t64(a) for k, a in params.items()}, t64(x),
                                   t64(y)))
    np.testing.assert_allclose(got, dense, rtol=1e-10)


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        TLean.make_lean_nlml("RBF", engine="cusolver")
    with pytest.raises(ValueError, match="chol"):
        TS.make_hutchinson_nlml("RBF", chol="cusolver")


@pytest.mark.parametrize("chol", ["super", "blocked"])
def test_hutchinson_chol_engines_match_jax(chol):
    """tests/test_exact_stochastic.py's case: n = 64, 4 probes from
    PRNGKey(5) (the port is handed the JAX engine's own draws), panels of
    16 and strips of 24; the port's engine against the JAX one of the same
    ``chol``, and against the port's library engine at the reference
    test's limits (1e-8 value, 1e-6 gradients)."""
    x, y = make_data(n=64, seed=3)
    params = _params("Matern52", x, 0.2)
    key = jax.random.PRNGKey(5)
    z = t64(np.array(jax.random.rademacher(key, (64, 4), dtype=jnp.float64)))
    kw = {"chol": chol, "chol_w": 16, "chol_strip": 24}
    jn = JS.make_hutchinson_nlml("Matern52", probes=4, col_panel=16, **kw)
    wv, wg = _jax_value_and_grad(lambda p, xx, yy: jn(p, xx, yy, key), params, x, y)
    tn = TS.make_hutchinson_nlml("Matern52", **kw)
    tv, tg = _torch_value_and_grad(lambda p, xx, yy: tn(p, xx, yy, z), params, x, y)
    np.testing.assert_allclose(tv, wv, rtol=RTOL)
    _assert_grads(tg, wg, GRAD_RTOL, GRAD_ATOL)
    xla = TS.make_hutchinson_nlml("Matern52")
    rv, rg = _torch_value_and_grad(lambda p, xx, yy: xla(p, xx, yy, z), params, x, y)
    np.testing.assert_allclose(tv, rv, rtol=1e-8)
    _assert_grads(tg, rg, 1e-6, 0.0)


@pytest.mark.parametrize("case", ["auto", "lean-super"])
def test_gpras_lean_fit_matches_jax(case, monkeypatch):
    """GPRAS fits whose ladder takes the lean rung at N = 512, 2 modes, 6
    Adam steps, float64: "auto" with LEAN_THRESHOLD lowered below N (the
    reference's rung between LEAN_THRESHOLD and SUPER_THRESHOLD, the
    library factorization), and exact_engine="lean" with SUPER_THRESHOLD
    lowered below N (its in-place "super" route). Losses and fitted
    parameters step for step against the JAX package's (1e-8)."""
    for cls in (JGPRAS, TGPRAS):
        monkeypatch.setattr(cls, "LEAN_THRESHOLD", 256)
        if case == "lean-super":
            monkeypatch.setattr(cls, "SUPER_THRESHOLD", 256)
    engine = "auto" if case == "auto" else "lean"
    rng = np.random.default_rng(21)
    x = rng.normal(size=(512, 3))
    y = np.stack([np.sin(x[:, 0]) + 0.1 * rng.normal(size=512),
                  np.cos(x[:, 1]) + 0.1 * rng.normal(size=512)], axis=1)
    jm = JGPRAS("Matern52", model_type="exact", dtype=jnp.float64, exact_engine=engine)
    tm = TGPRAS("Matern52", model_type="exact", dtype=torch.float64, exact_engine=engine,
                device="cpu")
    kw = {"optimization_method": "adam", "max_iter": 6, "learning_rate": 0.05}
    jm.fit(x, y, **kw)
    tm.fit(x, y, **kw)
    assert tm._engine() == "lean"
    assert tm._lean_loss is not None and tm._hutch_loss is None
    np.testing.assert_allclose(tm.fit_info["losses"].numpy(),
                               np.asarray(jm.fit_info["losses"]), rtol=1e-8)
    for k, v in np_params(jm.params).items():
        np.testing.assert_allclose(tm.params[k].numpy(), v, rtol=1e-8, atol=1e-8, err_msg=k)
