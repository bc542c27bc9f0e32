"""The port's distributed layer against the JAX package's, part 2: the
row-sharded matrix-free CG engine (parallel/pcg) and the 2-D distributed
fit step at N = 2,048 (float64) and 4,096 (float32).

Mirrors the rest of tests/test_parallel.py at its tolerances, as
tests/test_torch_parallel.py does: JAX on its 8 virtual devices here, the
port on 8 gloo ranks (tests/torch_dist.py), the CG probes drawn here with
JAX from the reference test's keys and handed to the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from torch_dist_cases import D

from gpras_tpu.gp import exact
from gpras_tpu.ops import kernels as K
from gpras_tpu.ops import linalg
from gpras_tpu.parallel import make_mesh


def _draws(key, n, rank, probes):
    """The reference's in-engine draws (pcg.make_dist_cg_nlml): Rademacher z
    without a preconditioner; with one, u1 and u2 from the key's split."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.rademacher(key, (n, probes), dtype=jnp.float64)),
            np.asarray(jax.random.normal(k1, (rank, probes), jnp.float64)),
            np.asarray(jax.random.normal(k2, (n, probes), jnp.float64)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cg_z, cg_u1, cg_u2 = _draws(jax.random.PRNGKey(3), 128, 16, 8)
    sn_z, sn_u1, sn_u2 = _draws(jax.random.PRNGKey(11), 128, 64, 8)
    inputs = {"cg_z": cg_z, "cg_u1": cg_u1, "cg_u2": cg_u2,
              "sn_z": sn_z, "sn_u1": sn_u1, "sn_u2": sn_u2}
    return torch_dist.Ranks("parallel_engines", inputs, tmp_path_factory.mktemp("engines"))


def test_dist_cg_nlml_matches_single_chip(ranks):
    """The port's row-sharded CG NLML against the JAX package's, fed the same
    probes: the plain engine at 96 iterations, the preconditioned one's
    value and gradient; and the reference test's claim that the gradient
    estimates the exact dense one."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpras_tpu.parallel.pcg import make_dist_cg_nlml

    mesh = make_mesh((8,), ("i",))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(128, 3)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=128))
    params = exact.init_params("Matern52", x, noise_variance=0.3)
    key = jax.random.PRNGKey(3)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("i")))
    nlml_d, _ = make_dist_cg_nlml(mesh, "Matern52", probes=8, max_iters=96, row_panel=8)
    want_plain = float(nlml_d(params, x_sh, y, key))
    nlml_pc, _ = make_dist_cg_nlml(mesh, "Matern52", probes=8, max_iters=32, row_panel=8,
                                   precond_rank=16)
    want_pc, g_want = jax.value_and_grad(lambda p: nlml_pc(p, x_sh, y, key))(params)
    g_exact = jax.grad(lambda p: exact.nlml("Matern52", p, x, y))(params)
    for r in ranks.case("cg"):
        np.testing.assert_allclose(r["plain"], want_plain, rtol=1e-4)
        np.testing.assert_allclose(r["pc"], float(want_pc), rtol=1e-6)
        for name in g_want:
            np.testing.assert_allclose(r["pc_grads"][name], np.asarray(g_want[name]),
                                       rtol=1e-4, atol=1e-10, err_msg=name)
            ge = np.asarray(g_exact[name])
            scale = max(np.max(np.abs(ge)), 1.0)
            np.testing.assert_allclose(r["pc_grads"][name], ge, atol=0.2 * scale, err_msg=name)


def test_dist_cg_preconditioner_survives_small_noise(ranks):
    """At noise 1e-3 the plain engine stalls within 16 iterations and the
    rank-64 preconditioned one converges, in the port as in the reference;
    the converged value matches the JAX package's on the same draws. (The
    stalled one is not compared: unconverged CG amplifies rounding, see
    tests/test_torch_cg_train.py.)"""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpras_tpu.parallel.pcg import make_dist_cg_nlml

    mesh = make_mesh((8,), ("i",))
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(128, 2)))
    y = jnp.asarray(np.sin(2.0 * np.asarray(x)[:, 0]) + 0.03 * rng.normal(size=128))
    params = exact.init_params("RBF", x, noise_variance=1e-3)
    key = jax.random.PRNGKey(11)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("i")))
    want = float(exact.nlml("RBF", params, x, y))
    nlml_plain, _ = make_dist_cg_nlml(mesh, "RBF", probes=8, max_iters=16, row_panel=8)
    nlml_pc, _ = make_dist_cg_nlml(mesh, "RBF", probes=8, max_iters=16, row_panel=8,
                                   precond_rank=64)
    jax_pc = float(nlml_pc(params, x_sh, y, key))
    assert abs(jax_pc - want) < 0.25 * abs(float(nlml_plain(params, x_sh, y, key)) - want)
    for r in ranks.case("cg_small_noise"):
        np.testing.assert_allclose(r["pc"], jax_pc, rtol=1e-6)
        err_plain, err_pc = abs(r["plain"] - want), abs(r["pc"] - want)
        assert err_pc < abs(want) * 0.02, (err_pc, want)
        assert err_pc < 0.25 * err_plain, (err_pc, err_plain)


def _dense_nlml64(params, x, y):
    n = x.shape[0]
    k = np.array(K.gram("Matern52", params, x), dtype=np.float64)
    noise = float(np.exp(params["log_noise_variance"]))
    jit = linalg.default_jitter(x.dtype) * float(np.exp(params["log_variance"]))
    k += (noise + jit) * np.eye(n)
    l = np.linalg.cholesky(k)
    alpha = np.linalg.solve(k, np.asarray(y, np.float64))
    return (0.5 * float(np.dot(np.asarray(y, np.float64), alpha))
            + float(np.sum(np.log(np.diag(l)))) + 0.5 * n * math.log(2.0 * math.pi))


def _jax_step_2d(n, dtype, b):
    from gpras_tpu.parallel.pexact import make_dist_fit_step

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, D)), dtype)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=n), dtype)
    params = exact.init_params("Matern52", x, noise_variance=0.1)
    init, step = make_dist_fit_step(make_mesh((4, 2), ("i", "j")), "Matern52", b=b,
                                    learning_rate=0.05)
    p1, _, loss = step(params, init(params), x, y)
    return params, p1, float(loss), _dense_nlml64(params, x, y)


def test_dist_fit_step_2d_default_suite(ranks):
    """One Adam step at N = 2,048 (b = 128) on the (4, 2) mesh, the 2-D
    engine: the loss against the JAX package's and the dense float64 NLML,
    and the stepped parameters against the JAX package's."""
    params, p1, loss, want = _jax_step_2d(2048, jnp.float64, 128)
    for r in ranks.case("step_2d"):
        assert r["layout"] == "2d"
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-9)
        np.testing.assert_allclose(r["loss"], want, rtol=1e-9)
        for name, v in r["p1"].items():
            assert np.all(np.isfinite(v)), f"{name} non-finite after step"
            assert np.any(v != r["p0"][name]), f"{name} did not move"
            np.testing.assert_allclose(v, np.asarray(p1[name]), rtol=1e-8, atol=1e-12,
                                       err_msg=name)


def test_dist_fit_step_2d_at_4k_f32_loss_vs_dense(ranks):
    """The same step at N = 4,096 in float32 (b = 256): the loss against the
    dense float64 NLML at the reference test's 2e-4, and the JAX package's."""
    _, _, loss, want = _jax_step_2d(4096, jnp.float32, 256)
    for r in ranks.case("step_2d_f32"):
        assert r["layout"] == "2d"
        np.testing.assert_allclose(r["loss"], want, rtol=2e-4)
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-4)
        for name, v in r["p1"].items():
            assert np.all(np.isfinite(v)), f"{name} non-finite after step"
            assert np.any(v != r["p0"][name]), f"{name} did not move"
