"""The port's distributed layer (gpras_tpu_torch/parallel) against the JAX
package's, part 1: the sharded Gram, the distributed Cholesky, solves and
log-determinant, the distributed NLML and its exact and Hutchinson
gradients, the Adam step, sharded PCA, prediction and hyperparameter search.

Mirrors tests/test_parallel.py at its tolerances: the JAX side runs here on
its 8 virtual devices, the port's on 8 gloo ranks in float64
(tests/torch_dist.py, tests/torch_dist_cases.py), fed the same inputs; the
probes and restarts the JAX functions draw inside are drawn here with JAX
and handed to the port. tests/test_torch_parallel_engines.py holds the CG
engine and the 2-D fit steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from torch_dist_cases import B, D, N, make_spd, make_xy

from gpras_tpu.gp import exact
from gpras_tpu.ops import kernels as K
from gpras_tpu.parallel import make_mesh


def _restarts():
    from gpras_tpu.fit import optimizers as fitters
    from gpras_tpu.gp import sgpr

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(32, 2)))
    params = sgpr.init_params("RBF", x, x[:6], noise_variance=0.5)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    starts = jax.vmap(lambda k: fitters._sample_restart(k, params, x))(keys)
    return {k: np.asarray(v) for k, v in starts.items()}


def _predict_models():
    """The JAX package's fitted models (as test_parallel.py fits them), whose
    parameters the port's models take."""
    from gpras_tpu.gp.model import GPRAS

    rng = np.random.default_rng(17)
    x = rng.normal(size=(96, 2)).astype(np.float64)
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1])], axis=1)
    xq = rng.normal(size=(64, 2)).astype(np.float64)
    out = {}
    for backend, kwargs in (("sgpr", {"n_inducing": 12}), ("exact", {})):
        m = GPRAS("RBF", model_type=backend, dtype=jnp.float64)
        m.fit(x, y, optimization_method="adam", max_iter=5, **kwargs)
        out[backend] = {"x": x, "y": y, "xq": xq,
                        "params": {k: np.asarray(v) for k, v in m.params.items()}}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {"restarts": _restarts(), "predict_models": _predict_models(),
              "stoch_z": np.asarray(jax.random.rademacher(jax.random.PRNGKey(7), (64, 1024),
                                                          dtype=jnp.float64))}
    return torch_dist.Ranks("parallel", inputs, tmp_path_factory.mktemp("parallel"))


def _rows(per_rank, key):
    return np.concatenate([r[key] for r in per_rank])


def _tiles(per_rank, key, shape):
    di, dj = shape
    return np.block([[per_rank[i * dj + j][key] for j in range(dj)] for i in range(di)])


def test_mesh_has_8_devices(ranks):
    assert make_mesh().devices.size == 8
    got = ranks.case("mesh")
    assert [r["size"] for r in got] == [8] * 8
    assert [r["coords"] for r in got] == [(r,) for r in range(8)]


def test_pgram_rows_matches_single_device(ranks):
    from gpras_tpu.parallel.pgram import pgram_rows

    x, _ = make_xy()
    params = K.init_params("Matern52", D, variance=1.3, lengthscales=0.8, dtype=jnp.float64)
    want = np.asarray(pgram_rows(make_mesh(), "Matern52", params, jnp.asarray(x), noise=0.25))
    got = _rows(ranks.case("pgram_rows"), "strip")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    dense = np.asarray(K.gram("Matern52", params, jnp.asarray(x))) + 0.25 * np.eye(N)
    np.testing.assert_allclose(got, dense, rtol=1e-12, atol=1e-12)


def test_pgram_2d_matches_single_device(ranks):
    from gpras_tpu.parallel.pgram import pgram_2d

    x, _ = make_xy()
    params = K.init_params("RBF", D, dtype=jnp.float64)
    want = np.asarray(pgram_2d(make_mesh((4, 2), ("i", "j")), "RBF", params, jnp.asarray(x)))
    got = _tiles(ranks.case("pgram_2d"), "tile", (4, 2))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_pgram_2d_noise_diagonal(ranks):
    from gpras_tpu.parallel.pgram import pgram_2d

    x = jnp.asarray(np.random.default_rng(5).normal(size=(N, D)))
    params = K.init_params("RBF", D, dtype=jnp.float64)
    want = np.asarray(pgram_2d(make_mesh((4, 2), ("i", "j")), "RBF", params, x, noise=0.37))
    got = _tiles(ranks.case("pgram_2d"), "tile_noise", (4, 2))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(K.gram("RBF", params, x)) + 0.37 * np.eye(N),
                               rtol=1e-12, atol=1e-12)


def test_dist_cholesky_matches_dense(ranks):
    from gpras_tpu.parallel.pcholesky import dist_cholesky

    k = make_spd()
    want = np.asarray(dist_cholesky(make_mesh(), jnp.asarray(k), b=B))
    got = _rows(ranks.case("cholesky"), "l")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)


def test_dist_cholesky_block_spanning_devices(ranks):
    """b = 16 over a 4-rank mesh on the 8-rank world (ranks 4-7 outside it)."""
    from gpras_tpu.parallel.pcholesky import dist_cholesky

    k = make_spd()
    want = np.asarray(dist_cholesky(make_mesh((4,), ("i",)), jnp.asarray(k), b=16))
    per_rank = ranks.case("cholesky")
    assert all("l_b16" not in r for r in per_rank[4:])
    got = _rows(per_rank[:4], "l_b16")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_dist_solve_matches_dense(ranks):
    from gpras_tpu.parallel.pcholesky import dist_cho_solve, dist_cholesky

    mesh = make_mesh()
    k = make_spd(seed=2)
    rhs = np.random.default_rng(3).normal(size=(N, 4))
    l = dist_cholesky(mesh, jnp.asarray(k), b=B)
    want = np.asarray(dist_cho_solve(mesh, l, jnp.asarray(rhs), b=B))
    for r in ranks.case("solve"):  # whole on every rank
        np.testing.assert_allclose(r["x"], want, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(r["x1"], want[:, 0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(want, np.linalg.solve(k, rhs), rtol=1e-8, atol=1e-8)


def test_dist_logdet_matches_dense(ranks):
    from gpras_tpu.parallel.pcholesky import dist_cholesky, dist_logdet_from_chol

    mesh = make_mesh()
    k = make_spd(seed=4)
    want = float(dist_logdet_from_chol(mesh, dist_cholesky(mesh, jnp.asarray(k), b=B)))
    for r in ranks.case("solve"):
        np.testing.assert_allclose(r["logdet"], want, rtol=1e-10)
    np.testing.assert_allclose(want, np.linalg.slogdet(k)[1], rtol=1e-10)


def test_dist_nlml_matches_single_device(ranks):
    from gpras_tpu.parallel.pexact import make_dist_nlml

    x, y = (jnp.asarray(a) for a in make_xy())
    params = exact.init_params("RBF", x, noise_variance=0.2)
    want = float(make_dist_nlml(make_mesh(), "RBF", b=B)(params, x, y))
    for r in ranks.case("nlml"):
        np.testing.assert_allclose(r["value"], want, rtol=1e-9)
    np.testing.assert_allclose(want, float(exact.nlml("RBF", params, x, y)), rtol=1e-9)


def test_dist_nlml_gradient_matches_single_device(ranks):
    from gpras_tpu.parallel.pexact import make_dist_nlml

    x, y = (jnp.asarray(a) for a in make_xy(seed=5))
    params = exact.init_params("Matern32", x, noise_variance=0.3)
    nlml = make_dist_nlml(make_mesh(), "Matern32", b=B, col_batch=16)
    v_dist, g_dist = jax.value_and_grad(nlml)(params, x, y)
    for r in ranks.case("nlml"):
        np.testing.assert_allclose(r["grad_value"], float(v_dist), rtol=1e-9)
        for k in g_dist:
            np.testing.assert_allclose(r["grads"][k], np.asarray(g_dist[k]), rtol=1e-7,
                                       atol=1e-9, err_msg=k)


def test_dist_fit_step_decreases_loss(ranks):
    from gpras_tpu.parallel.pexact import make_dist_fit_step

    x, y = (jnp.asarray(a) for a in make_xy(seed=6))
    params = exact.init_params("RBF", x, noise_variance=0.5)
    init, step = make_dist_fit_step(make_mesh(), "RBF", b=B, learning_rate=0.05)
    opt_state, losses = init(params), []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    for r in ranks.case("nlml"):
        assert r["step_losses"][-1] < r["step_losses"][0], r["step_losses"]
        np.testing.assert_allclose(r["step_losses"], losses, rtol=1e-9)
        for k in params:
            np.testing.assert_allclose(r["step_params"][k], np.asarray(params[k]), rtol=1e-8,
                                       atol=1e-12, err_msg=k)


def test_ppca_matches_single_device(ranks):
    from gpras_tpu.eof.pca import pca_fit
    from gpras_tpu.parallel.ppca import ppca_fit, ppca_inverse, ppca_transform

    mesh = make_mesh()
    rng = np.random.default_rng(7)
    s, c, k = 24, 64, 5
    x = rng.normal(size=(s, c))
    x = x - x.mean(axis=0)
    xj = jnp.asarray(x)
    comps_d, expl_d = ppca_fit(mesh, xj, k)
    modes_d = ppca_transform(mesh, xj, comps_d)
    recon_d = ppca_inverse(mesh, modes_d, comps_d)
    per_rank = ranks.case("ppca")
    comps = np.concatenate([r["comps"] for r in per_rank], axis=1)
    recon = np.concatenate([r["recon"] for r in per_rank], axis=1)
    np.testing.assert_allclose(comps, np.asarray(comps_d), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(recon, np.asarray(recon_d), rtol=1e-8, atol=1e-8)
    for r in per_rank:
        np.testing.assert_allclose(r["expl"], np.asarray(expl_d), rtol=1e-8)
        np.testing.assert_allclose(r["expl"], np.asarray(pca_fit(xj, k)[1])[:k], rtol=1e-8)
        np.testing.assert_allclose(r["modes"], np.asarray(modes_d), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(r["modes"], x @ comps.T, rtol=1e-8, atol=1e-8)
        # the port's one-device PCA, sign rule included
        scale = np.abs(r["comps_one"]).max()
        np.testing.assert_allclose(comps, r["comps_one"], rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(r["expl"], r["expl_one"], rtol=1e-10)


def test_sharded_multi_start_improves_loss(ranks):
    """The same restarts (drawn by the JAX package's sampler) fit to the same
    losses on both sides; the L-BFGS polish is the port's host core, held by
    the reference test's own claim (it beats the start)."""
    from gpras_tpu.gp import sgpr
    from gpras_tpu.parallel.pfit import sharded_multi_start

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(32, 2)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.05 * rng.normal(size=32))
    params = sgpr.init_params("RBF", x, x[:6], noise_variance=0.5)
    _, info = sharded_multi_start(make_mesh(), lambda p: sgpr.training_loss("RBF", p, x, y),
                                  params, x=x, n_starts=8, iter_initial=5, iter_final=20)
    for r in ranks.case("multi_start"):
        assert r["loss"] < r["before"]
        assert r["restart_losses"].shape == (8,)
        np.testing.assert_allclose(r["restart_losses"], np.asarray(info["restart_losses"]),
                                   rtol=1e-8)


def test_sharded_de_matches_de_fit(ranks):
    """DE's energies split over the 8 ranks take the same steps as the
    port's one-process de_fit on the same population (the JAX package's DE
    draws from its own PRNG, so the port is held to its own)."""
    for r in ranks.case("de"):
        np.testing.assert_array_equal(r["losses"], r["losses_one"])
        for k, v in r["params_one"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def test_sharded_predict_matches_single_device(ranks):
    from gpras_tpu.gp.model import GPRAS
    from gpras_tpu.parallel.ppredict import sharded_predict

    mesh = make_mesh((8,), ("i",))
    models = ranks.case("predict")
    for backend, model_in in _predict_models().items():
        m = GPRAS("RBF", model_type=backend, dtype=jnp.float64)
        m.x, m.y = jnp.asarray(model_in["x"]), jnp.asarray(model_in["y"])
        m.params = {k: jnp.asarray(v) for k, v in model_in["params"].items()}
        want_mean, want_var = (np.asarray(a) for a in sharded_predict(mesh, m, model_in["xq"]))
        for r in models:
            got = r[backend]
            np.testing.assert_allclose(got["mean"], want_mean, rtol=1e-8, err_msg=backend)
            np.testing.assert_allclose(got["var"], want_var, rtol=1e-8, err_msg=backend)
            np.testing.assert_allclose(got["mean"], got["mean_one"], rtol=1e-8, err_msg=backend)
            np.testing.assert_allclose(got["var"], got["var_one"], rtol=1e-8, err_msg=backend)


def test_dist_stochastic_backward_matches_exact(ranks):
    """Both layouts: the exact and the Hutchinson backward against the JAX
    package's on the same 1,024 probes, and the reference test's claim
    (the Hutchinson gradient within 0.15 of the exact one's scale)."""
    from gpras_tpu.parallel.pexact import make_dist_nlml, make_dist_nlml_stochastic

    x, y = (jnp.asarray(a) for a in make_xy(64))
    params = exact.init_params("Matern52", x, noise_variance=0.3)
    key = jax.random.PRNGKey(7)
    for mesh, layout in ((make_mesh((8,), ("i",)), "1d"), (make_mesh((4, 2), ("i", "j")), "2d")):
        nlml_e = make_dist_nlml(mesh, "Matern52", b=8, col_batch=16, layout=layout)
        val_e, grads_e = jax.value_and_grad(nlml_e)(params, x, y)
        nlml_s = make_dist_nlml_stochastic(mesh, "Matern52", b=8, col_batch=16, layout=layout,
                                           probes=1024)
        val_s, grads_s = jax.value_and_grad(nlml_s)(params, x, y, key)
        for r in ranks.case("stochastic"):
            got = r[layout]
            np.testing.assert_allclose(got["value_stoch"], float(val_s), rtol=1e-12)
            np.testing.assert_allclose(got["value_exact"], float(val_e), rtol=1e-12)
            for k in grads_e:
                ge, gs = np.asarray(grads_e[k]), np.asarray(grads_s[k])
                np.testing.assert_allclose(got["grads_exact"][k], ge, rtol=1e-8, atol=1e-10,
                                           err_msg=f"{layout}:{k}")
                np.testing.assert_allclose(got["grads_stoch"][k], gs, rtol=1e-8, atol=1e-10,
                                           err_msg=f"{layout}:{k}")
                scale = max(np.max(np.abs(ge)), 1e-3)
                np.testing.assert_allclose(got["grads_stoch"][k], got["grads_exact"][k],
                                           atol=0.15 * scale, err_msg=f"{layout}:{k}")
