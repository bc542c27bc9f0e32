"""Exact-GP training on the port (gpras_tpu_torch) against the JAX package
(gpras_tpu): the dense NLML and its gradient, the Hutchinson engine, Adam,
the warm-start protocol, and ``GPRAS.fit`` end to end, on the same seeded
numpy inputs, in float64 unless a case says otherwise."""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.fit import optimizers as JO
from gpras_tpu.gp import exact as JE
from gpras_tpu.gp import exact_stochastic as JS
from gpras_tpu.gp import warmstart as JW
from gpras_tpu.gp.model import GPRAS as JGPRAS
from gpras_tpu.ops import linalg as JL
from gpras_tpu_torch.eof.preprocessor import PreProcessor as TPre
from gpras_tpu_torch.fit import optimizers as TO
from gpras_tpu_torch.gp import exact as TE
from gpras_tpu_torch.gp import exact_stochastic as TS
from gpras_tpu_torch.gp import warmstart as TW
from gpras_tpu_torch.gp.model import GPRAS as TGPRAS
from gpras_tpu_torch.gp.serving import PosteriorPredictor, make_field_decoder
from gpras_tpu_torch.ops import linalg as TL
from torch_parity import np_params, t64

STATIONARY = ("RBF", "Matern12", "Matern32", "Matern52", "Exponential")
# float64, the same operations in another order (LAPACK blocking,
# reductions): far below any algorithmic difference, far above rounding
RTOL = 1e-9
# Matern12 and Exponential are linear in r = sqrt(r2) at r = 0, and the
# expanded r2 of a point against itself rounds to ~1e-16, not 0, differently
# in the two packages' matmuls: the Gram's diagonal then moves by ~1e-8 of
# the variance, and the loss and its gradient by a few 1e-9 (measured 4e-9
# and 6e-9); those two kernels are held to 1e-7
RTOL_R_SINGULAR = 1e-7


def _rtol(kernel):
    return RTOL_R_SINGULAR if kernel in ("Matern12", "Exponential") else RTOL


def _data(n, d=3, p=1, seed=0):
    """chip_smoke.py's recipe at a small size: three active inputs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    cols = [np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.1 * rng.normal(size=n)]
    for j in range(1, p):
        cols.append(np.cos(x[:, j % d]) + 0.1 * rng.normal(size=n))
    return x, np.stack(cols, axis=1)


def _params(kernel, d, seed=1, noise=0.1):
    rng = np.random.default_rng(seed)
    p = {"log_variance": np.float64(0.2), "log_noise_variance": np.float64(math.log(noise))}
    p["log_lengthscales"] = np.log(rng.uniform(0.6, 1.6, d))
    return p


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _torch(params, dtype=torch.float64):
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype) for k, v in params.items()}


def _value_and_grad_torch(loss, params):
    return TO.value_and_grad(loss, _torch(params))


def _assert_grads(got, want, rtol=RTOL):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1.0), err_msg=k)


# ------------------------------------------------------------ dense engine


@pytest.mark.parametrize("kernel", STATIONARY)
def test_dense_training_loss_and_gradient_match_jax(kernel):
    x, y = _data(200)
    params = _params(kernel, 3)
    wv, wg = jax.value_and_grad(
        lambda p: JE.training_loss(kernel, p, jnp.asarray(x), jnp.asarray(y[:, 0])))(
        _jax(params))
    tv, tg = _value_and_grad_torch(
        lambda p: TE.training_loss(kernel, p, t64(x), t64(y[:, 0])), params)
    np.testing.assert_allclose(float(tv), float(wv), rtol=_rtol(kernel))
    _assert_grads(tg, wg, _rtol(kernel))


def test_non_pd_gram_gives_nan_not_an_exception():
    """float32, 200 coincident-ish points, noise 1e-12: K + noise I does not
    factor. The reference's Cholesky returns NaN; the port's cholesky_ex
    failure must do the same, for the loss and every gradient, in both the
    dense and the Hutchinson engine."""
    x = np.repeat(np.random.default_rng(0).normal(size=(20, 2)), 10, axis=0)
    y = np.ones(200)
    params = {"log_variance": np.float32(3.0), "log_lengthscales": np.full(2, 3.0, np.float32),
              "log_noise_variance": np.float32(math.log(1e-12))}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    xj, yj = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    jv, jg = jax.value_and_grad(lambda p: JE.training_loss("RBF", p, xj, yj))(jp)
    assert np.isnan(float(jv)) and all(np.isnan(np.asarray(g)).all() for g in jg.values())
    xt, yt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    for loss in (lambda p: TE.training_loss("RBF", p, xt, yt),
                 lambda p: TS.make_hutchinson_training_loss("RBF")(
                     p, xt, yt, TS.rademacher_probes(200, 4))):
        tv, tg = TO.value_and_grad(loss, _torch(params, torch.float32))
        assert torch.isnan(tv) and all(torch.isnan(g).all() for g in tg.values())


def test_safe_cholesky_gradient_matches_jax():
    """The escalation's gradient: one factorization at the final jitter,
    differentiated (linalg.py:99-117). The matrix needs two escalations."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 3))
    k = a @ a.T  # rank 3: the first attempts fail
    w = rng.normal(size=(6, 6))

    def jloss(kk):
        return jnp.sum(jnp.tril(JL.safe_cholesky(kk, jitter=0.0)) * w)

    want = jax.grad(jloss)(jnp.asarray(k))
    kt = t64(k).requires_grad_(True)
    loss = torch.sum(torch.tril(TL.safe_cholesky(kt, jitter=0.0)) * t64(w))
    (got,) = torch.autograd.grad(loss, kt)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(k))), rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=1e-9)


# -------------------------------------------------------- Hutchinson engine


def _jax_probes(n, m=16):
    return np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (n, m), dtype=jnp.float64))


@pytest.mark.parametrize("kernel", ["Matern52", "Matern12", "Periodic"])
def test_hutchinson_loss_and_gradient_match_jax(kernel):
    """N = 640, float64: on the CPU both packages take the panel loop, so
    this holds the port's whole backward (probes, cotangent, diagonal term,
    prior) against the reference's, with the reference's probes."""
    n = 640
    x, y = _data(n, seed=5)
    params = _params(kernel, 3, seed=6)
    if kernel == "Periodic":
        params["log_period"] = np.log(np.full(3, 2.5))
    jloss = JS.make_hutchinson_training_loss(kernel, **JS.default_chol_config(n))
    wv, wg = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x), jnp.asarray(y[:, 0]),
                                                jax.random.PRNGKey(0)))(_jax(params))
    tloss = TS.make_hutchinson_training_loss(kernel, **TS.default_chol_config(n))
    z = t64(_jax_probes(n))
    tv, tg = _value_and_grad_torch(lambda p: tloss(p, t64(x), t64(y[:, 0]), z), params)
    np.testing.assert_allclose(float(tv), float(wv), rtol=_rtol(kernel))
    _assert_grads(tg, wg, _rtol(kernel))


def test_rademacher_probes_are_fixed_signs():
    z = TS.rademacher_probes(1000, 16, dtype=torch.float64)
    assert z.shape == (1000, 16) and set(z.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(z, TS.rademacher_probes(1000, 16, dtype=torch.float64))
    assert abs(float(z.mean())) < 0.05


# ------------------------------------------------------------- optimizers


def _quadratic_problem(n=60):
    x, y = _data(n, seed=8)
    params = _params("Matern52", 3, seed=9, noise=0.5)

    def jloss(p):
        return JE.training_loss("Matern52", p, jnp.asarray(x), jnp.asarray(y[:, 0]))

    def tloss(p):
        return TE.training_loss("Matern52", p, t64(x), t64(y[:, 0]))

    return params, jloss, tloss


def _nan_below(threshold, jloss, tloss):
    """The same loss, NaN once the noise crosses below ``threshold`` (a
    factorization that fails mid-fit)."""
    def j(p):
        return jnp.where(p["log_noise_variance"] < threshold, jnp.nan, jloss(p))

    def t(p):
        return torch.where(p["log_noise_variance"] < threshold, math.nan, tloss(p))

    return j, t


@pytest.mark.parametrize("case", ["plain", "lower_bounds", "nonfinite_rejected",
                                  "nonfinite_stops", "early_stop", "two_stage",
                                  "mask_only", "mask_except"])
def test_adam_matches_optax_step_for_step(case):
    params, jloss, tloss = _quadratic_problem()
    kw = {"max_iter": 40, "learning_rate": 0.05}
    jkw, tkw = {}, {}
    fit_j, fit_t = JO.adam_fit, TO.adam_fit
    if case == "lower_bounds":
        kw["lower_bounds"] = {"log_noise_variance": math.log(0.3)}
    elif case.startswith("nonfinite"):
        jloss, tloss = _nan_below(math.log(0.3), jloss, tloss)
        kw["reject_nonfinite"] = case == "nonfinite_rejected"
        kw["patience"] = 5
    elif case == "early_stop":
        kw.update(tol=0.2, patience=3)
    elif case == "two_stage":
        fit_j, fit_t = JO.two_stage_fit, TO.two_stage_fit
    elif case.startswith("mask"):
        keys = ("log_noise_variance",) if case == "mask_only" else ("log_lengthscales",)
        jkw["mask"] = getattr(JO, case)(_jax(params), keys)
        tkw["mask"] = getattr(TO, case)(_torch(params), keys)
    pj, ij = fit_j(jloss, _jax(params), **kw, **jkw)
    pt, it = fit_t(tloss, _torch(params), **kw, **tkw)
    assert int(it["iterations"]) == int(ij["iterations"])
    if case in ("nonfinite_stops", "early_stop", "nonfinite_rejected"):
        assert int(it["iterations"]) < kw["max_iter"]  # the rule fired
    np.testing.assert_allclose(it["losses"].numpy(), np.asarray(ij["losses"]), rtol=RTOL)
    np.testing.assert_allclose(float(it["loss"]), float(ij["loss"]), rtol=RTOL)
    _assert_grads(pt, pj)
    if case.startswith("mask"):  # the masked-out parameters never moved
        frozen = [k for k, v in tkw["mask"].items() if float(v) == 0.0]
        assert frozen and all(torch.equal(pt[k], _torch(params)[k]) for k in frozen)


def test_unported_fitters_raise_naming_the_roadmap():
    # every fitter is ported now (ROADMAP.md A2, tests/test_torch_optimizer_zoo.py):
    # the keys are the reference's and none raises any more
    assert sorted(TO.FITTERS) == sorted(JO.FITTERS)
    p, _ = TO.FITTERS["L-BFGS-B"](lambda p: (p["a"] - 1.0) ** 2,
                                  {"a": torch.zeros((), dtype=torch.float64)})
    assert abs(float(p["a"]) - 1.0) < 1e-6


# -------------------------------------------------------------- warm start


def test_transfer_clamp_and_certify_match_jax():
    """A loss that is NaN above var/noise = 20 (the float32 wall moved):
    mode 0 certifies at a halved cap, mode 1 (NaN everywhere) falls back."""
    p = {"log_variance": np.array([math.log(1e3), math.log(5.0)]),
         "log_noise_variance": np.array([0.0, -1.0]),
         "log_lengthscales": np.array([[0.1, 0.2], [0.3, 0.4]])}
    fallback = {"log_variance": np.array([0.5, 0.7]), "log_noise_variance": np.array([-1.0, -1.2]),
                "log_lengthscales": np.zeros((2, 2))}

    def make(lib, where, exp):
        def loss(pp, i):
            r = exp(pp["log_variance"] - pp["log_noise_variance"])
            return where((r <= 20.0) & (i == 0), r + 1.0, float("nan"))
        return loss

    jout, jinfo = JW.certify_transfer_batched(make(jnp, jnp.where, jnp.exp), _jax(p),
                                              _jax(fallback), ratio_cap=50.0)
    tout, tinfo = TW.certify_transfer_batched(make(torch, torch.where, torch.exp), _torch(p),
                                              _torch(fallback), ratio_cap=50.0)
    assert tinfo["fell_back_modes"] == jinfo["fell_back_modes"] == [1]
    np.testing.assert_allclose(tinfo["ratio_caps"], jinfo["ratio_caps"], rtol=0)
    np.testing.assert_allclose(tinfo["cert_losses"], jinfo["cert_losses"], rtol=RTOL)
    _assert_grads(tout, jout)
    for cap in (50.0, 3.0):
        _assert_grads(TW.transfer_clamp(_torch(p), cap), JW.transfer_clamp(_jax(p), cap))


# ------------------------------------------------------------ GPRAS.fit


def _fit_both(x, y, dtype_j, dtype_t, **kw):
    jm = JGPRAS("Matern52", model_type="exact", dtype=dtype_j,
                exact_engine=kw.pop("exact_engine", "auto"))
    tm = TGPRAS("Matern52", model_type="exact", dtype=dtype_t, exact_engine=jm.exact_engine,
                device="cpu")
    jm.fit(x, y, **kw)
    tm.fit(x, y, **kw)
    return jm, tm


def _check_fit(jm, tm, rtol, tmp_path):
    np.testing.assert_allclose(tm.fit_info["losses"].numpy(), np.asarray(jm.fit_info["losses"]),
                               rtol=rtol)
    np.testing.assert_array_equal(tm.fit_info["iterations"].numpy(),
                                  np.asarray(jm.fit_info["iterations"]))
    for k, v in np_params(jm.params).items():
        np.testing.assert_allclose(tm.params[k].numpy(), v, rtol=rtol, atol=rtol, err_msg=k)
    # the port's checkpoint loads in the JAX package and predicts the same
    tm.to_file(tmp_path / "port_fit.npz")
    back = JGPRAS.from_file(tmp_path / "port_fit.npz")
    xq = np.random.default_rng(42).normal(size=(9, tm.x.shape[1]))
    (bm, bv), (pm, pv) = back.predict(xq), tm.predict(xq)
    np.testing.assert_allclose(pm, bm, rtol=1e-6, atol=1e-6 * np.abs(bm).max())
    np.testing.assert_allclose(pv, bv, rtol=1e-6)


def test_fit_dense_engine_matches_jax(tmp_path):
    x, y = _data(512, p=2, seed=12)
    jm, tm = _fit_both(x, y, jnp.float64, torch.float64, optimization_method="adam",
                       max_iter=12, learning_rate=0.05)
    _check_fit(jm, tm, 1e-8, tmp_path)


def test_fit_hutchinson_engine_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(TS, "rademacher_probes", lambda n, probes=16, dtype=None, device=None:
                        torch.as_tensor(_jax_probes(n, probes), dtype=dtype, device=device))
    x, y = _data(640, p=2, seed=13)
    jm, tm = _fit_both(x, y, jnp.float64, torch.float64, exact_engine="hutchinson",
                       optimization_method="two-stage", max_iter=6, learning_rate=0.05)
    _check_fit(jm, tm, 1e-8, tmp_path)


def test_fit_warm_start_float32_matches_jax(tmp_path):
    """float32 on both sides, with the float32 guards and the clamp + certify
    transfer. The two packages round each Cholesky differently (~1e-6 of
    the loss), and Adam's normalised steps carry that into the parameters
    step after step: 1e-4 relative on losses and parameters."""
    x, y = _data(1024, p=2, seed=14)
    x, y = x.astype(np.float32), y.astype(np.float32)
    jm, tm = _fit_both(x, y, jnp.float32, torch.float32, optimization_method="adam",
                       max_iter=6, learning_rate=0.05, warm_start_subsample=256,
                       warm_ratio_cap=25.0)
    assert tm.warm_start_info["fell_back_modes"] == jm.warm_start_info["fell_back_modes"]
    np.testing.assert_allclose(tm.warm_start_info["ratio_caps"],
                               jm.warm_start_info["ratio_caps"], rtol=0)
    np.testing.assert_allclose(tm.warm_start_info["cert_losses"],
                               jm.warm_start_info["cert_losses"], rtol=1e-4)
    _check_fit(jm, tm, 1e-4, tmp_path)


def test_fit_refuses_what_is_not_ported():
    x, y = _data(64)
    # the CG engine is ported and fits (tests/test_torch_cg_train.py holds it
    # to the reference step for step); the mesh-distributed fit is ported
    # too (tests/test_torch_parallel_model.py) and, without a process group,
    # says how to start one
    cg = TGPRAS("RBF", model_type="exact", exact_engine="cg", device="cpu")
    cg.fit(x, y, optimization_method="adam", max_iter=2)
    assert torch.isfinite(cg.fit_info["losses"]).all() and cg._engine() == "cg"
    with pytest.raises(RuntimeError, match="torchrun"):
        TGPRAS("RBF", model_type="exact", device="cpu").fit(x, y, mesh="auto")
    model = TGPRAS("RBF", model_type="exact", device="cpu")
    model.x = torch.zeros((60_000, 1))
    assert model._engine() == "cg"
    model.x = torch.zeros((20_000, 1))
    assert model._engine() == "hutchinson"
    model.x = torch.zeros((10_000, 1))
    assert model._engine() == "lean"


def test_entry_points_default_to_the_card():
    """Every entry point runs on the card unless the caller asks for the CPU;
    without a card the default raises torch's own error, never falls back."""
    assert TGPRAS("RBF", model_type="exact").device == torch.device("cuda")
    assert TPre(hydraulic_parameter="wse").device == torch.device("cuda")
    for fn in (TGPRAS.from_file, PosteriorPredictor, make_field_decoder):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TGPRAS("RBF", model_type="exact").fit(*_data(16))
