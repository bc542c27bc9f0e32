"""SVGP on the port (gpras_tpu_torch.gp.svgp, the svgp branch of GPRAS, its
checkpoint and PosteriorPredictor) against the JAX package (gpras_tpu), on
the same seeded numpy inputs, in float64.

Limits, each for a reason:
- 1e-10 relative on ``elbo``, ``training_loss``, ``kl_to_prior``,
  ``predict``, ``optimal_q`` and ``natgrad_step`` (the same algorithm in
  float64, operations in another order: ~1e-14 apart); 1e-9 on the loss's
  gradient, as tests/test_torch_sgpr.py holds SGPR's.
- 1e-15 on the q_sqrt parametrization and its round trip (one exp or log
  per diagonal entry; the strict lower triangle passes through unchanged).
- 1e-8 on the trainers against JAX's, epoch for epoch over 3 epochs, fed
  the same permutations: the loss's rounding differences compound over the
  steps, as in the SGPR and Adam tests.
- 1e-12 between the port's stream and minibatch trainers on the same batch
  stream: the same arithmetic in the same order, identical in practice.
- The reference's own anchors (tests/test_svgp.py) at its limits: any q is
  dominated by SGPR's collapsed bound, ``optimal_q`` attains it (1e-8) and a
  natural-gradient step at lr 1 over the full batch is ``optimal_q`` (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.gp import svgp as JV
from gpras_tpu.gp.model import GPRAS as JGPRAS
from gpras_tpu_torch.gp import sgpr as TS
from gpras_tpu_torch.gp import svgp as TV
from gpras_tpu_torch.gp.model import GPRAS as TGPRAS
from gpras_tpu_torch.gp.serving import PosteriorPredictor
from torch_parity import np_params, t64

RTOL = 1e-10
RTOL_FIT = 1e-8


def _data(n=96, m=12, d=3, p=1, seed=0):
    """The reference test's problem (tests/test_svgp.py), P response columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    cols = [np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)]
    for j in range(1, p):
        cols.append(np.cos(x[:, j % d]) + 0.1 * rng.normal(size=n))
    y = np.stack(cols, axis=1)
    return x, (y[:, 0] if p == 1 else y), x[:: n // m][:m]


def _params(kernel, x, z, p=1, noise=0.3, seed=1, q_scale=0.3):
    """SVGP parameters (the JAX package's init) with a random q."""
    rng = np.random.default_rng(seed)
    out = np_params(JV.init_params(kernel, jnp.asarray(x), jnp.asarray(z), noise_variance=noise,
                                   outputs=p))
    if "log_lengthscales" in out:
        out["log_lengthscales"] = np.log(rng.uniform(0.6, 1.6, x.shape[1]))
    if q_scale:
        out["q_mu"] = rng.normal(size=out["q_mu"].shape)
        out["q_raw"] = q_scale * rng.normal(size=out["q_raw"].shape)
    return out


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: t64(v) for k, v in p.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _close_params(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol)


# ------------------------------------------------------------- the functions


def test_q_sqrt_parametrization_matches_jax_and_round_trips():
    raw = np.random.default_rng(5).normal(size=(2, 6, 6))
    qs = TV.q_sqrt_from_raw(t64(raw))
    _close(qs, JV.q_sqrt_from_raw(jnp.asarray(raw)), 1e-15)
    assert torch.equal(torch.tril(qs, -1), torch.tril(t64(raw), -1))
    assert bool((torch.triu(qs, 1) == 0).all()) and bool((torch.diagonal(qs, 0, -2, -1) > 0).all())
    back = TV.raw_from_q_sqrt(qs)
    _close(back, JV.raw_from_q_sqrt(JV.q_sqrt_from_raw(jnp.asarray(raw))), 1e-15)
    _close(TV.q_sqrt_from_raw(back), qs.numpy(), 1e-15)


def test_init_params_matches_jax_and_has_zero_kl():
    x, _, z = _data()
    got = TV.init_params("Matern52", t64(x), t64(z), noise_variance=0.3, outputs=2)
    want = np_params(JV.init_params("Matern52", jnp.asarray(x), jnp.asarray(z),
                                    noise_variance=0.3, outputs=2))
    _close_params(got, want, 1e-15)
    assert got["q_mu"].shape == (12, 2) and got["q_raw"].shape == (2, 12, 12)
    assert float(TV.kl_to_prior(got)) == 0.0


@pytest.mark.parametrize("kernel", ["RBF", "Matern32", "Matern52", "Linear"])
@pytest.mark.parametrize("outputs", [1, 2])
def test_elbo_kl_and_loss_match_jax(kernel, outputs):
    x, y, z = _data(p=outputs)
    p = _params(kernel, x, z, p=outputs)
    _close(TV.kl_to_prior(_torch(p)), JV.kl_to_prior(_jax(p)))
    for lo, hi, n_total in ((0, 96, 96), (16, 48, 96), (0, 32, 1000)):  # full and minibatch
        xb, yb = x[lo:hi], y[lo:hi]
        _close(TV.elbo(kernel, _torch(p), t64(xb), t64(yb), n_total),
               JV.elbo(kernel, _jax(p), jnp.asarray(xb), jnp.asarray(yb), n_total))
        _close(TV.training_loss(kernel, _torch(p), t64(xb), t64(yb), n_total),
               JV.training_loss(kernel, _jax(p), jnp.asarray(xb), jnp.asarray(yb), n_total))


def test_training_loss_gradient_matches_jax():
    from gpras_tpu_torch.fit.optimizers import value_and_grad

    x, y, z = _data()
    p = _params("Matern52", x, z)
    want, want_g = jax.value_and_grad(lambda q: JV.training_loss(
        "Matern52", q, jnp.asarray(x[:48]), jnp.asarray(y[:48]), 96))(_jax(p))
    got, got_g = value_and_grad(
        lambda q: TV.training_loss("Matern52", q, t64(x[:48]), t64(y[:48]), 96), _torch(p))
    _close(got, want)
    for k in want_g:
        _close(got_g[k], want_g[k], rtol=1e-9)


@pytest.mark.parametrize("include_noise", [True, False])
@pytest.mark.parametrize("outputs", [1, 2])
def test_predict_matches_jax(include_noise, outputs):
    x, _, z = _data(p=outputs)
    p = _params("Matern52", x, z, p=outputs)
    xs = np.random.default_rng(4).normal(size=(17, 3))
    got = TV.predict("Matern52", _torch(p), t64(xs), include_noise)
    want = JV.predict("Matern52", _jax(p), jnp.asarray(xs), include_noise)
    assert got[0].shape == ((17,) if outputs == 1 else (17, 2))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("outputs", [1, 2])
def test_optimal_q_matches_jax(outputs):
    x, y, z = _data(p=outputs, seed=2)
    p = _params("Matern52", x, z, p=outputs)
    _close_params(TV.optimal_q("Matern52", _torch(p), t64(x), t64(y)),
                  np_params(JV.optimal_q("Matern52", _jax(p), jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("outputs, lr, batch", [(1, 0.5, 32), (2, 0.5, 32), (1, 1.0, 96),
                                                (2, 0.1, 96)])
def test_natgrad_step_matches_jax(outputs, lr, batch):
    x, y, z = _data(p=outputs, seed=11)
    p = _params("Matern52", x, z, p=outputs, q_scale=0.5)
    got = TV.natgrad_step("Matern52", _torch(p), t64(x[:batch]), t64(y[:batch]), 96, lr=lr)
    want = JV.natgrad_step("Matern52", _jax(p), jnp.asarray(x[:batch]), jnp.asarray(y[:batch]),
                           96, lr=lr)
    _close_params(got, np_params(want))
    assert not any(v.requires_grad for v in got.values())


# -------------------------------------------------------- the reference's anchors


def test_any_q_is_dominated_by_the_collapsed_bound():
    x, y, z = _data()
    p = _torch(_params("RBF", x, z, noise=0.2))
    assert float(TV.elbo("RBF", p, t64(x), t64(y), 96)) <= float(
        TS.elbo("RBF", p, t64(x), t64(y))) + 1e-9


def test_optimal_q_attains_the_collapsed_bound():
    x, y, z = _data(seed=2)
    p = _torch(_params("Matern52", x, z, q_scale=0))
    p_opt = TV.optimal_q("Matern52", p, t64(x), t64(y))
    np.testing.assert_allclose(float(TV.elbo("Matern52", p_opt, t64(x), t64(y), 96)),
                               float(TS.elbo("Matern52", p, t64(x), t64(y))), rtol=1e-8)
    # at the optimal q the variational posterior is SGPR's, without the data
    xs = t64(np.random.default_rng(4).normal(size=(17, 3)))
    for g, w in zip(TV.predict("Matern52", p_opt, xs),
                    TS.predict("Matern52", p, t64(x), t64(y), xs)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-7, atol=1e-9)


def test_natgrad_at_lr_one_over_the_full_batch_is_optimal_q():
    x, y, z = _data(seed=11)
    p = _torch(_params("Matern52", x, z, q_scale=0.5))
    p_ng = TV.natgrad_step("Matern52", p, t64(x), t64(y), 96, lr=1.0)
    p_opt = TV.optimal_q("Matern52", p, t64(x), t64(y))
    np.testing.assert_allclose(float(TV.elbo("Matern52", p_ng, t64(x), t64(y), 96)),
                               float(TS.elbo("Matern52", p, t64(x), t64(y))), rtol=1e-8)
    np.testing.assert_allclose(p_ng["q_mu"].numpy(), p_opt["q_mu"].numpy(), rtol=1e-6,
                               atol=1e-10)
    s_ng, s_opt = (TV.q_sqrt_from_raw(q["q_raw"]) for q in (p_ng, p_opt))
    np.testing.assert_allclose((s_ng @ s_ng.mT).numpy(), (s_opt @ s_opt.mT).numpy(), rtol=1e-6,
                               atol=1e-10)


def test_n_total_scaling_is_unbiased():
    x, y, z = _data(n=64, m=8, seed=8)
    p = _torch(_params("RBF", x, z, noise=0.2))
    full = float(TV.elbo("RBF", p, t64(x), t64(y), 64))
    parts = [float(TV.elbo("RBF", p, t64(x[i:i + 16]), t64(y[i:i + 16]), 64))
             for i in range(0, 64, 16)]
    np.testing.assert_allclose(np.mean(parts), full, rtol=1e-10)


def test_safe_cholesky_escalates_each_matrix_of_a_batch_alone():
    """natgrad_step factors its outputs as one batch: a matrix that needs
    jitter escalates with its own scale, and the others keep their plain
    factor, as the reference's loop does under jax.vmap."""
    from gpras_tpu.ops import linalg as JL
    from gpras_tpu_torch.ops import linalg as TL

    rng = np.random.default_rng(3)
    good = rng.normal(size=(5, 5))
    good = good @ good.T + 5 * np.eye(5)
    bad = np.ones((5, 5)) * 7.0  # rank one: needs jitter
    batch = np.stack([good, bad])
    got = TL.safe_cholesky(t64(batch), jitter=0.0)
    want = jax.vmap(lambda k: JL.safe_cholesky(k, jitter=0.0))(jnp.asarray(batch))
    _close(got, want, 1e-12)
    _close(got[0], np.linalg.cholesky(good), 1e-14)


# ----------------------------------------------------------------- the trainers


def _jax_perms(key, epochs, n):
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(key, epochs)])


@pytest.mark.parametrize("natgrad", [None, 0.5])
def test_minibatch_fit_matches_jax_epoch_for_epoch(natgrad):
    x, y, z = _data(n=128, m=8, seed=21)
    p = _params("RBF", x, z, q_scale=0)
    key = jax.random.PRNGKey(5)
    want_p, want_h = JV.make_minibatch_fit("RBF", batch_size=32, epochs=3, learning_rate=0.02,
                                           natgrad=natgrad)(_jax(p), jnp.asarray(x),
                                                            jnp.asarray(y), key)
    perms = torch.as_tensor(_jax_perms(key, 3, 128))
    got_p, got_h = TV.make_minibatch_fit("RBF", batch_size=32, epochs=3, learning_rate=0.02,
                                         natgrad=natgrad)(_torch(p), t64(x), t64(y), perms)
    _close(got_h, want_h, RTOL_FIT)
    _close_params(got_p, np_params(want_p), RTOL_FIT)


def test_minibatch_fit_draws_from_a_generator_and_checks_its_inputs():
    x, y, z = _data(n=64, m=6)
    p = _torch(_params("RBF", x, z, q_scale=0))
    fit = TV.make_minibatch_fit("RBF", batch_size=16, epochs=2, natgrad=0.5)
    runs = [fit(p, t64(x), t64(y), torch.Generator().manual_seed(3)) for _ in range(2)]
    assert runs[0][1].shape == (2,) and bool(torch.isfinite(runs[0][1]).all())
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in p)  # one seed, one fit
    with pytest.raises(ValueError, match="exceeds dataset size"):
        TV.make_minibatch_fit("RBF", batch_size=65, epochs=1)(p, t64(x), t64(y),
                                                              torch.Generator())
    with pytest.raises(ValueError, match="permutations of shape"):
        fit(p, t64(x), t64(y), torch.zeros((3, 64), dtype=torch.long))


def test_stream_fit_equals_minibatch_fit_on_the_same_batch_stream():
    n, bsz, epochs = 128, 32, 3
    x, y, z = _data(n=n, m=8, seed=21)
    p = _torch(_params("RBF", x, z, q_scale=0))
    perms = torch.as_tensor(_jax_perms(jax.random.PRNGKey(5), epochs, n))
    want_p, want_h = TV.make_minibatch_fit("RBF", batch_size=bsz, epochs=epochs,
                                           learning_rate=0.01, natgrad=0.5)(p, t64(x), t64(y),
                                                                            perms)
    init, run_chunk = TV.make_stream_fit("RBF", learning_rate=0.01, natgrad=0.5)
    got, state, hist = p, init(p), []
    for perm in perms:
        xc = t64(x)[perm].reshape(n // bsz, bsz, 3)
        yc = t64(y)[:, None][perm].reshape(n // bsz, bsz, 1)
        # two chunks of two batches an epoch
        losses = []
        for c in range(0, n // bsz, 2):
            got, state, ls = run_chunk(got, state, xc[c:c + 2], yc[c:c + 2], n)
            losses.append(ls)
        hist.append(torch.cat(losses).mean())
    _close(torch.stack(hist), want_h.numpy(), 1e-12)
    _close_params(got, {k: v.numpy() for k, v in want_p.items()}, 1e-12)


# ---------------------------------------------------------------------- GPRAS


@pytest.fixture(scope="module")
def fitted():
    """Both packages' GPRAS(model_type="svgp") fit from the JAX package's
    initial parameters (the two packages' k-means draws differ), at
    batch_size = N: every epoch sees the same points, so the packages'
    different permutations change only the order of the sums."""
    x, y, _ = _data(n=80, m=8, p=2, seed=4)
    jm = JGPRAS("Matern52", model_type="svgp", dtype=jnp.float64)
    jm.x, jm.n_inducing = jnp.asarray(x), 8
    p0 = np_params(jm._init_params("kmeans"))
    batched = {k: np.broadcast_to(v, (2,) + v.shape).copy() for k, v in p0.items()}
    opts = dict(optimization_method="adam", batch_size=80, epochs=4, learning_rate=0.05,
                natgrad=0.5)
    jm.fit(x, y, n_inducing=8, initial_params=_jax(batched), **opts)
    tm = TGPRAS("Matern52", model_type="svgp", dtype=torch.float64, device="cpu")
    tm.fit(x, y, n_inducing=8, initial_params=batched, **opts)
    return x, y, jm, tm


def test_gpras_svgp_fit_matches_jax(fitted):
    _, _, jm, tm = fitted
    _close(tm.fit_info["losses"], jm.fit_info["losses"], RTOL_FIT)
    _close_params(tm.params, np_params(jm.params), RTOL_FIT)
    assert tm.params["q_mu"].shape == (2, 8, 1) and tm.params["q_raw"].shape == (2, 1, 8, 8)


def test_gpras_svgp_predictions_and_full_batch_loss_match_jax(fitted):
    x, y, jm, tm = fitted
    xs = np.random.default_rng(9).normal(size=(11, 3))
    for g, w in zip(tm.predict(xs), jm.predict(xs)):
        assert g.shape == (11, 2)
        np.testing.assert_allclose(g, w, rtol=RTOL_FIT, atol=RTOL_FIT * np.abs(w).max())
    for i in range(2):
        _close(tm._loss_fn({k: v[i] for k, v in tm.params.items()}, tm.y[:, i]),
               jm._loss_fn({k: v[i] for k, v in jm.params.items()}, jm.y[:, i]), RTOL)


def test_svgp_checkpoints_load_in_either_package(fitted, tmp_path):
    _, _, jm, tm = fitted
    xs = np.random.default_rng(10).normal(size=(7, 3))
    tm.to_file(tmp_path / "t.npz")
    jm.to_file(tmp_path / "j.npz")
    from_t = JGPRAS.from_file(tmp_path / "t.npz")
    from_j = TGPRAS.from_file(tmp_path / "j.npz", device="cpu")
    assert from_t.model_type == from_j.model_type == "svgp"
    for a, b in ((from_t.predict(xs), tm.predict(xs)), (from_j.predict(xs), jm.predict(xs))):
        for g, w in zip(a, b):
            np.testing.assert_allclose(g, w, rtol=RTOL)


def test_posterior_predictor_serves_an_svgp_checkpoint(fitted, tmp_path):
    _, _, _, tm = fitted
    tm.to_file(tmp_path / "svgp.npz")
    pred = PosteriorPredictor(tmp_path / "svgp.npz", buckets=(8, 16), device="cpu")
    assert pred.model._cache == ()  # the variational posterior is the state
    xs = np.random.default_rng(11).normal(size=(13, 3))
    mean, var = pred.predict_modes(xs)
    want_mean, want_var = tm.predict(xs)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(var, want_var, rtol=1e-12)


def test_gpras_svgp_fits_from_its_own_init_with_a_seed():
    x, y, _ = _data(n=64, m=8, p=2, seed=6)
    runs = []
    for _ in range(2):
        m = TGPRAS("RBF", model_type="svgp", dtype=torch.float64, device="cpu")
        m.fit(x, y, n_inducing=6, optimization_method="adam", batch_size=16, epochs=3, seed=2)
        runs.append(m)
    assert runs[0].fit_info["losses"].shape == (2, 3)
    assert torch.equal(runs[0].fit_info["losses"], runs[1].fit_info["losses"])
    mean, var = runs[0].predict(x[:5])
    assert mean.shape == var.shape == (5, 2) and np.isfinite(mean).all() and (var > 0).all()


@pytest.mark.parametrize("kwargs, error", [
    (dict(n_inducing=0, optimization_method="adam"), "n_inducing > 0"),
    (dict(n_inducing=4), "minibatch Adam"),  # the default "two-stage"
    (dict(n_inducing=4, optimization_method="L-BFGS-B"), "minibatch Adam"),
    (dict(n_inducing=4, optimization_method="adam", tol=1e-3), "unsupported svgp fit options"),
    (dict(n_inducing=4, optimization_method="adam", mesh="auto"), "mesh-distributed"),
    (dict(n_inducing=4, optimization_method="nope"), "Unknown optimizer"),
])
def test_wrong_svgp_options_raise_as_in_jax(kwargs, error):
    x, y, _ = _data(n=16, m=4)
    for model in (JGPRAS("RBF", model_type="svgp", dtype=jnp.float64),
                  TGPRAS("RBF", model_type="svgp", dtype=torch.float64, device="cpu")):
        with pytest.raises(ValueError, match=error):
            model.fit(x, y, **kwargs)
