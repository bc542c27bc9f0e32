"""SGPR and k-means on the port (gpras_tpu_torch.gp.sgpr, ops.kmeans, the
sgpr branch of GPRAS, its checkpoint and PosteriorPredictor) against the JAX
package (gpras_tpu), on the same seeded numpy inputs, in float64.

Limits: 1e-10 relative on the ELBO, the loss, the posterior and Kuu (the
same algorithm in float64, operations in another order: ~1e-14 apart);
1e-8 relative step for step on Adam's losses and parameters (the loss's
rounding differences compound over the steps); 1e-12 on k-means centers
from the same seeds (sums of the same points in another order); the grid
inducing points to 1e-15 (two linspace formulas). Matern12 and
Exponential are linear in r at r = 0, and Kuu's diagonal (each inducing
point against itself) rounds r2 to ~1e-16 differently in the two packages:
those two kernels are held to 1e-7, as tests/test_torch_exact_train.py
states."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.gp import sgpr as JS
from gpras_tpu.gp.model import GPRAS as JGPRAS
from gpras_tpu.ops import kmeans as JK
from gpras_tpu_torch.gp import exact as TE
from gpras_tpu_torch.gp import sgpr as TS
from gpras_tpu_torch.gp.model import GPRAS as TGPRAS
from gpras_tpu_torch.gp.serving import PosteriorPredictor
from gpras_tpu_torch.ops import kmeans as TK
from gpras_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from torch_parity import np_params, t64

RTOL = 1e-10
RTOL_R_SINGULAR = 1e-7
STATIONARY = ("RBF", "Matern12", "Matern32", "Matern52", "Exponential")


def _data(n=120, d=3, p=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    cols = [np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.1 * rng.normal(size=n)]
    for j in range(1, p):
        cols.append(np.cos(x[:, j % d]) + 0.1 * rng.normal(size=n))
    return x, np.stack(cols, axis=1)


def _params(kernel, x, m, seed=1, noise=0.1):
    """SGPR parameters with Z drawn near the data (both packages' init)."""
    rng = np.random.default_rng(seed)
    z = x[rng.choice(x.shape[0], m, replace=False)] + 0.05 * rng.normal(size=(m, x.shape[1]))
    p = np_params(JS.init_params(kernel, jnp.asarray(x), jnp.asarray(z), noise_variance=noise))
    if "log_lengthscales" in p:
        p["log_lengthscales"] = np.log(rng.uniform(0.6, 1.6, x.shape[1]))
    return p


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: t64(v) for k, v in p.items()}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


# --------------------------------------------------------------------- SGPR


@pytest.mark.parametrize("kernel", STATIONARY + ("Linear", "Polynomial", "Periodic"))
def test_kuu_and_elbo_match_jax(kernel):
    x, y = _data()
    p = _params(kernel, x, 12)
    rtol = RTOL_R_SINGULAR if kernel in ("Matern12", "Exponential") else RTOL
    _close(TS.kuu_gram(kernel, _torch(p), t64(p["z"])),
           JS.kuu_gram(kernel, _jax(p), jnp.asarray(p["z"])), rtol)
    _close(TS.elbo(kernel, _torch(p), t64(x), t64(y[:, 0])),
           JS.elbo(kernel, _jax(p), jnp.asarray(x), jnp.asarray(y[:, 0])), rtol)


def test_kuu_jitter_scales_with_dtype():
    """1e-6 (1 + variance) in float32, 1e-9 (1 + variance) in float64, to
    the rounding of the diagonal (variance 2: one ulp of 2 in the dtype)."""
    z = np.random.default_rng(2).normal(size=(5, 2))
    p = {"log_variance": np.float64(math.log(2.0)), "log_lengthscales": np.zeros(2)}
    for dtype, jitter in ((torch.float64, 1e-9), (torch.float32, 1e-6)):
        pt = {k: torch.as_tensor(v, dtype=dtype) for k, v in p.items()}
        zt = torch.as_tensor(z, dtype=dtype)
        diag = torch.diagonal(TS.kuu_gram("RBF", pt, zt) - TS.K.gram("RBF", pt, zt))
        np.testing.assert_allclose(diag.double().numpy(), jitter * 3.0, rtol=0,
                                   atol=2.0 * torch.finfo(dtype).eps)


def test_elbo_multi_output_sums_columns():
    x, y = _data(p=3)
    p = _params("Matern52", x, 10)
    got = TS.elbo("Matern52", _torch(p), t64(x), t64(y))
    _close(got, JS.elbo("Matern52", _jax(p), jnp.asarray(x), jnp.asarray(y)))
    cols = sum(TS.elbo("Matern52", _torch(p), t64(x), t64(y[:, j])) for j in range(3))
    _close(got, cols.detach().numpy(), rtol=1e-12)


def test_training_loss_and_gradient_match_jax():
    import jax

    x, y = _data()
    p = _params("Matern52", x, 10)
    want, want_g = jax.value_and_grad(
        lambda q: JS.training_loss("Matern52", q, jnp.asarray(x), jnp.asarray(y[:, 0])))(_jax(p))
    from gpras_tpu_torch.fit.optimizers import value_and_grad

    got, got_g = value_and_grad(lambda q: TS.training_loss("Matern52", q, t64(x), t64(y[:, 0])),
                                _torch(p))
    _close(got, want)
    for k in want_g:
        _close(got_g[k], want_g[k], rtol=1e-9)


@pytest.mark.parametrize("include_noise", [True, False])
@pytest.mark.parametrize("outputs", [1, 2])
def test_predict_matches_jax(include_noise, outputs):
    x, y = _data(p=outputs)
    y = y[:, 0] if outputs == 1 else y
    p = _params("Matern32", x, 15)
    xs = np.random.default_rng(5).normal(size=(9, 3))
    got = TS.predict("Matern32", _torch(p), t64(x), t64(y), t64(xs), include_noise)
    want = JS.predict("Matern32", _jax(p), jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs),
                      include_noise)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_z_equal_x_is_the_exact_gp():
    """The Titsias bound is tight with Z = X: -ELBO is the exact NLML and the
    posteriors agree (up to Kuu's 1e-9 jitter)."""
    x, y = _data(n=40, seed=3)
    x, y = t64(x), t64(y[:, 0])
    p = TS.init_params("RBF", x, x, noise_variance=0.05)
    exact = {k: v for k, v in p.items() if k != "z"}
    np.testing.assert_allclose(float(-TS.elbo("RBF", p, x, y)),
                               float(TE.nlml("RBF", exact, x, y)), rtol=1e-7)
    xs = t64(np.random.default_rng(4).normal(size=(12, 3)))
    for g, w in zip(TS.predict("RBF", p, x, y, xs), TE.predict("RBF", exact, x, y, xs)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)


def test_init_params_matches_jax():
    x, _ = _data()
    z = x[:7]
    want = np_params(JS.init_params("Matern52", jnp.asarray(x), jnp.asarray(z), noise_variance=0.3))
    got = TS.init_params("Matern52", t64(x), t64(z), noise_variance=0.3)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-15)


# ------------------------------------------------------------------ k-means


@pytest.mark.parametrize("n, k, d", [(300, 8, 3), (500, 25, 2)])
def test_kmeans_from_jax_seeds_matches_jax(n, k, d):
    import jax

    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)) + 4.0 * rng.integers(0, 3, size=(n, 1))
    init = np.asarray(JK._kmeans_pp_init(jax.random.PRNGKey(0), jnp.asarray(x), k))
    want_c, want_l = JK.kmeans(jnp.asarray(x), k)
    got_c, got_l = TK.kmeans(t64(x), k, init=t64(init))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_kmeans_seeding_and_clusters():
    """The port's own seeding: reproducible for a seed, centers on data
    points, and well separated clusters recovered."""
    rng = np.random.default_rng(0)
    truth = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 5.0]])
    pts = t64(np.concatenate([c + 0.1 * rng.normal(size=(30, 2)) for c in truth]))
    seeds = TK._kmeans_pp_init(torch.Generator().manual_seed(0), pts, 3)
    assert all(bool((pts == s).all(dim=1).any()) for s in seeds)
    c1, l1 = TK.kmeans(pts, 3, seed=0)
    c2, _ = TK.kmeans(pts, 3, seed=0)
    assert torch.equal(c1, c2) and l1.shape == (90,)
    for c in truth:
        assert np.min(np.linalg.norm(c1.numpy() - c, axis=1)) < 0.2


def test_kmeans_empty_cluster_keeps_its_center_and_max_iter_stops():
    x = t64(np.array([[0.0], [0.1], [5.0], [5.1]]))
    init = t64(np.array([[0.0], [5.0], [100.0]]))
    centers, labels = TK.kmeans(x, 3, init=init)
    np.testing.assert_allclose(centers.numpy()[:, 0], [0.05, 5.05, 100.0])
    assert labels.tolist() == [0, 0, 1, 1]
    moved, _ = TK.kmeans(x, 3, init=t64(np.array([[0.0], [0.1], [5.0]])), max_iter=0)
    np.testing.assert_array_equal(moved.numpy()[:, 0], [0.0, 0.1, 5.0])


def test_grid_inducing_matches_jax():
    x = np.random.default_rng(2).normal(size=(40, 3))
    np.testing.assert_allclose(TK.grid_inducing(t64(x), 7).numpy(),
                               np.asarray(JK.grid_inducing(jnp.asarray(x), 7)),
                               rtol=0, atol=1e-15)


# -------------------------------------------------------- GPRAS sgpr branch


@pytest.fixture(scope="module")
def fitted():
    """Both packages' GPRAS (SGPR, the default backend), two-stage Adam from
    JAX's initial parameters (its k-means inducing points), 2 modes."""
    x, y = _data(n=150, p=2, seed=7)
    z = JK.kmeans_inducing(jnp.asarray(x), 12)
    init = np_params(JS.init_params("Matern52", jnp.asarray(x), z))
    batched = {k: np.broadcast_to(v, (2,) + v.shape).copy() for k, v in init.items()}
    jm = JGPRAS("Matern52", dtype=jnp.float64)
    jm.fit(x, y, n_inducing=12, initial_params=_jax(batched), max_iter=25,
           learning_rate=0.05)
    tm = TGPRAS("Matern52", dtype=torch.float64, device="cpu")
    tm.fit(x, y, n_inducing=12, initial_params=params_from_numpy(batched), max_iter=25,
           learning_rate=0.05)
    return x, y, jm, tm


def test_gpras_two_stage_matches_jax_step_for_step(fitted):
    _, _, jm, tm = fitted
    assert tm.model_type == "sgpr" and tm.n_inducing == 12
    want = np.asarray(jm.fit_info["losses"])
    got = tm.fit_info["losses"].numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-8)
    for k, v in jm.params.items():
        np.testing.assert_allclose(tm.params[k].numpy(), np.asarray(v), rtol=1e-8, atol=1e-10,
                                   err_msg=k)


def test_gpras_predictions_match_jax(fitted):
    _, _, jm, tm = fitted
    xs = np.random.default_rng(8).normal(size=(20, 3))
    jmean, jvar = jm.predict(xs)
    # the port's predict at JAX's fitted parameters: the cache and the
    # posterior alone, not the fit's rounding
    tm.params = params_from_numpy(np_params(jm.params))
    tm._cache = None
    tmean, tvar = tm.predict(xs)
    assert tmean.shape == (20, 2) == tvar.shape
    np.testing.assert_allclose(tmean, jmean, rtol=RTOL, atol=RTOL * np.abs(jmean).max())
    np.testing.assert_allclose(tvar, jvar, rtol=RTOL)


def test_sgpr_checkpoints_load_in_either_package(fitted, tmp_path):
    x, _, jm, tm = fitted
    xs = np.random.default_rng(9).normal(size=(6, 3))
    jm.to_file(tmp_path / "jax.npz")
    from_jax = TGPRAS.from_file(tmp_path / "jax.npz", device="cpu")
    assert from_jax.model_type == "sgpr" and from_jax.n_inducing == 12
    for g, w in zip(from_jax.predict(xs), jm.predict(xs)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-12)
    tm.to_file(tmp_path / "torch.npz")
    from_torch = JGPRAS.from_file(tmp_path / "torch.npz")
    assert from_torch.model_type == "sgpr" and from_torch.n_inducing == 12
    np.testing.assert_array_equal(np.asarray(from_torch.params["z"]), tm.params["z"].numpy())
    for g, w in zip(from_torch.predict(xs), tm.predict(xs)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL, atol=1e-12)


def test_posterior_predictor_serves_an_sgpr_checkpoint(fitted, tmp_path):
    _, _, jm, _ = fitted
    jm.to_file(tmp_path / "gp.npz")
    pred = PosteriorPredictor(tmp_path / "gp.npz", buckets=(8, 32), device="cpu")
    pred.warmup()
    xs = np.random.default_rng(10).normal(size=(13, 3))
    mean, var = pred.predict_modes(xs)
    jmean, jvar = jm.predict(xs)
    assert mean.shape == (13, 2) == var.shape
    np.testing.assert_allclose(mean, jmean, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(var, jvar, rtol=RTOL)


def test_params_from_numpy_carries_z(fitted):
    _, _, jm, _ = fitted
    p = np_params(jm.params)
    t = params_from_numpy(p, device="cpu", dtype=torch.float32)
    assert t["z"].dtype == torch.float32 and t["z"].shape == p["z"].shape
    np.testing.assert_array_equal(params_to_numpy(params_from_numpy(p))["z"], p["z"])


def test_gpras_sgpr_fits_from_its_own_init():
    """The default path a user takes: k-means inducing points from the
    port's seeding, then the default two-stage fit; and the grid init and
    the sparse backends' n_inducing check."""
    x, y = _data(n=100, p=2, seed=11)
    model = TGPRAS("Matern52", dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="n_inducing"):
        model.fit(x, y)
    model.fit(x, y, n_inducing=10, max_iter=10)
    assert model.params["z"].shape == (2, 10, 3)
    losses = model.fit_info["losses"]
    assert torch.isfinite(losses).all() and bool((losses[:, -1] < losses[:, 0]).all())
    grid = TGPRAS("RBF", dtype=torch.float64, device="cpu")
    grid.fit(x, y, n_inducing=6, inducing_initializer="grid", max_iter=2)
    with pytest.raises(ValueError, match="initializer"):
        grid.fit(x, y, n_inducing=6, inducing_initializer="random", max_iter=2)
