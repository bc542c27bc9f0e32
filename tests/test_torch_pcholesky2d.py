"""The port's 2-D tiled Cholesky, solves and log-determinant
(gpras_tpu_torch/parallel/pcholesky2d) and the 2-D distributed NLML against
the JAX package's, on 4x2 / 2x4 / 8x1 / 1x8 meshes.

Mirrors tests/test_pcholesky2d.py at its tolerances: the JAX side on its 8
virtual devices here, the port on 8 gloo ranks in float64
(tests/torch_dist.py, tests/torch_dist_cases.py). The 2-D gradient is held
to the 1-D one, as the reference holds its own: the 2-D backward sums each
rank's tile contraction once over the whole mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from torch_dist_cases import N, make_spd

from gpras_tpu.parallel import make_mesh
from gpras_tpu.parallel.pcholesky2d import (
    dist_cho_solve_2d,
    dist_cholesky_2d,
    dist_logdet_from_chol_2d,
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_dist.Ranks("pcholesky2d", {}, tmp_path_factory.mktemp("pcholesky2d"))


def _tiles(per_rank, key, shape):
    di, dj = shape
    return np.block([[per_rank[i * dj + j][key] for j in range(dj)] for i in range(di)])


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_cholesky_2d_matches_dense(ranks, shape):
    k = make_spd()
    want = np.asarray(dist_cholesky_2d(make_mesh(shape, ("i", "j")), jnp.asarray(k), b=8))
    got = _tiles([r[shape] for r in ranks.case("cholesky")], "l", shape)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)


def test_cholesky_2d_block_equals_local_extent(ranks):
    """b equal to the smaller local extent (nc = 64/4 = 16)."""
    k = make_spd(seed=5)
    want = np.asarray(dist_cholesky_2d(make_mesh((2, 4), ("i", "j")), jnp.asarray(k), b=16))
    got = _tiles([r["b16"] for r in ranks.case("cholesky")], "l", (2, 4))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)


def test_cholesky_2d_rejects_straddling_blocks(ranks):
    mesh = make_mesh((4, 2), ("i", "j"))
    with pytest.raises(ValueError, match="block size"):
        dist_cholesky_2d(mesh, make_spd(), b=24)
    with pytest.raises(ValueError, match="divide"):
        dist_cholesky_2d(mesh, make_spd(n=60), b=4)
    for r in ranks.case("rejects"):
        straddle, ragged = r["errors"]
        assert straddle is not None and "block size" in straddle
        assert ragged is not None and "divide" in ragged


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_solve_2d_matches_dense(ranks, shape):
    mesh = make_mesh(shape, ("i", "j"))
    k = make_spd(seed=2)
    rhs = np.random.default_rng(3).normal(size=(N, 4))
    l = dist_cholesky_2d(mesh, jnp.asarray(k), b=8)
    want = np.asarray(dist_cho_solve_2d(mesh, l, jnp.asarray(rhs), b=8))
    for r in ranks.case("solve"):  # whole on every rank
        np.testing.assert_allclose(r[shape]["x"], want, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(r[shape]["x1"], want[:, 0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(want, np.linalg.solve(k, rhs), rtol=1e-8, atol=1e-8)


def test_logdet_2d_matches_dense(ranks):
    mesh = make_mesh((4, 2), ("i", "j"))
    k = make_spd(seed=4)
    want = float(dist_logdet_from_chol_2d(mesh, dist_cholesky_2d(mesh, jnp.asarray(k), b=8)))
    for r in ranks.case("solve"):
        np.testing.assert_allclose(r["logdet"], want, rtol=1e-10)
    np.testing.assert_allclose(want, np.linalg.slogdet(k)[1], rtol=1e-10)


def test_2d_composes_with_pgram_2d(ranks):
    """2-D sharded Gram -> 2-D Cholesky -> solve == dense GP linear algebra."""
    from gpras_tpu.ops import kernels as K
    from gpras_tpu.parallel.pgram import pgram_2d

    mesh = make_mesh((4, 2), ("i", "j"))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(N, 3)))
    y = np.sin(np.asarray(x)[:, 0])
    params = K.init_params("Matern52", 3, dtype=jnp.float64)
    kmat = pgram_2d(mesh, "Matern52", params, x) + 0.1 * jnp.eye(N, dtype=jnp.float64)
    want = np.asarray(dist_cho_solve_2d(mesh, dist_cholesky_2d(mesh, kmat, b=8),
                                        jnp.asarray(y), b=8))
    kd = np.asarray(K.gram("Matern52", params, x)) + 0.1 * np.eye(N)
    for r in ranks.case("composes"):
        np.testing.assert_allclose(r["alpha"], want, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(r["alpha"], np.linalg.solve(kd, y), rtol=1e-8, atol=1e-8)


def test_dist_nlml_2d_matches_1d_and_grads(ranks):
    """The 2-D layout's value and gradient match the 1-D layout's, in the
    port as in the reference, and the JAX package's 2-D ones."""
    from gpras_tpu.gp import exact
    from gpras_tpu.parallel.pexact import make_dist_nlml

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(N, 3)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=N))
    params = exact.init_params("Matern52", x, noise_variance=0.1)
    nlml_2d = make_dist_nlml(make_mesh((4, 2), ("i", "j")), "Matern52", b=8, col_batch=16,
                             layout="2d")
    v2, g2 = jax.value_and_grad(nlml_2d)(params, x, y)
    for r in ranks.case("nlml"):
        np.testing.assert_allclose(r["v2"], r["v1"], rtol=1e-10)
        np.testing.assert_allclose(r["v2"], float(v2), rtol=1e-10)
        for k in g2:
            np.testing.assert_allclose(r["g2"][k], r["g1"][k], rtol=1e-8, atol=1e-10, err_msg=k)
            np.testing.assert_allclose(r["g2"][k], np.asarray(g2[k]), rtol=1e-8, atol=1e-10,
                                       err_msg=k)


def test_dist_nlml_2d_rejects_incompatible_col_batch(ranks):
    """col_batch smaller than the mesh 'j' axis cannot tile the backward: a
    clear error, in the port as in the reference."""
    from gpras_tpu.gp import exact
    from gpras_tpu.parallel.pexact import make_dist_nlml

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(N, 3)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]))
    params = exact.init_params("RBF", x, noise_variance=0.2)
    nlml = make_dist_nlml(make_mesh((1, 8), ("i", "j")), "RBF", b=8, col_batch=3, layout="2d")
    with pytest.raises(ValueError, match="column batch"):
        jax.grad(nlml)(params, x, y)
    for r in ranks.case("col_batch"):
        assert r["error"] is not None and "column batch" in r["error"]
