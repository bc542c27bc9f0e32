"""Matrix-free posterior engine of the port (gpras_tpu_torch.gp.exact_cg)
against the JAX reference (gpras_tpu.gp.exact_cg), in float64. On the CPU the
JAX functions take their XLA panel path and the port its plain panel path,
so both run the same algorithm on the same numbers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.gp import exact_cg as J
from gpras_tpu_torch.gp import exact_cg as T
from gpras_tpu_torch.ops.block_cholesky import fit_block
from torch_parity import t64

# Same float64 operations in another order (BLAS blocking, reductions):
# ~1e-16 per operation. Where the two sides run the same arithmetic op for
# op, 1e-9 relative is far below any algorithmic difference (a wrong freeze,
# a different pivot) and far above that rounding.
RTOL = 1e-9
# Once a CG run has exhausted its well-separated eigenvalues, the rounding
# difference of the two sides grows by orders of magnitude per iteration
# (loss of orthogonality): both still converge, but each only to the CG
# tolerance (relative residual 1e-6). Past that point the two are held to
# 1e-5 relative to the solution's scale, the accuracy CG itself promises.
RTOL_CG = 1e-5
# Matern12 is linear in r = sqrt(r2) at r = 0, and r2 at a coincident pair
# rounds to ~1e-16 |a|^2 in either BLAS call, so a kernel column at its own
# pivot moves by ~1e-8: entries are held to 1e-7 absolute.
ATOL_COINCIDENT = 1e-7


def _problem(n=96, d=3, seed=0, noise=0.3, kernel="Matern52"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    params = {"log_variance": np.float64(0.2),
              "log_lengthscales": np.log(rng.uniform(0.7, 1.5, d)),
              "log_noise_variance": np.float64(np.log(noise))}
    return kernel, x, y, params


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.as_tensor(v) for k, v in params.items()})


def test_kmv_matches_jax():
    kernel, x, _, params = _problem()
    pj, pt = _both(params)
    v = np.random.default_rng(1).normal(size=(96, 5))
    want = J.kmv(kernel, pj, jnp.asarray(x), jnp.asarray(v), jnp.float64(0.3), row_panel=32)
    got = T.kmv(kernel, pt, t64(x), t64(v), torch.tensor(0.3, dtype=torch.float64),
                row_panel=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel", ["RBF", "Matern12", "Matern52"])
def test_pivoted_cholesky_and_woodbury_match_jax(kernel):
    _, x, _, params = _problem(n=80, seed=2, kernel=kernel)
    pj, pt = _both(params)
    lj = J.pivoted_cholesky(kernel, pj, jnp.asarray(x), 12)
    lt = T.pivoted_cholesky(kernel, pt, t64(x), 12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL_COINCIDENT)

    noise = 0.05
    pinv_j, logdet_j = J.make_woodbury_pinv(lj, jnp.float64(noise))
    pinv_t, logdet_t = T.make_woodbury_pinv(lt, torch.tensor(noise, dtype=torch.float64))
    v = np.random.default_rng(3).normal(size=(80, 4))
    np.testing.assert_allclose(pinv_t(t64(v)).numpy(), np.asarray(pinv_j(jnp.asarray(v))),
                               rtol=RTOL, atol=ATOL_COINCIDENT / noise)
    np.testing.assert_allclose(float(logdet_t), float(logdet_j), rtol=1e-9)


@pytest.mark.parametrize("precond", [0, 16])
def test_mbcg_matches_jax(precond):
    kernel, x, _, params = _problem(seed=4, noise=0.3)
    pj, pt = _both(params)
    b = np.random.default_rng(5).normal(size=(96, 4))
    noise_j, noise_t = jnp.float64(0.3), torch.tensor(0.3, dtype=torch.float64)
    pinv_j = pinv_t = None
    if precond:
        pinv_j, _ = J.make_woodbury_pinv(J.pivoted_cholesky(kernel, pj, jnp.asarray(x), precond),
                                         noise_j)
        pinv_t, _ = T.make_woodbury_pinv(T.pivoted_cholesky(kernel, pt, t64(x), precond),
                                         noise_t)
    xj = jnp.asarray(x)

    def run(iters):
        out_j = J.mbcg(lambda v: J.kmv(kernel, pj, xj, v, noise_j, row_panel=32),
                       jnp.asarray(b), max_iters=iters, pinv=pinv_j)
        out_t = T.mbcg(lambda v: T.kmv(kernel, pt, t64(x), v, noise_t, row_panel=32),
                       t64(b), max_iters=iters, pinv=pinv_t)
        return out_t, out_j

    # the first iterations run op for op alike: every recorded coefficient
    for name, got, want in zip(("x", "alphas", "betas", "rz0"), *run(6)):
        scale = np.max(np.abs(np.asarray(want)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL * scale, err_msg=name)
    # the full budget: both solve the system to the CG tolerance
    (x_t, *_), (x_j, *_) = run(40)
    scale = np.max(np.abs(np.asarray(x_j)))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL_CG,
                               atol=RTOL_CG * scale)


def test_cg_posterior_alpha_and_predict_match_jax():
    kernel, x, y, params = _problem(n=120, seed=6, noise=0.1)
    pj, pt = _both(params)
    xq = np.random.default_rng(7).normal(size=(24, 3))
    a_j = J.cg_posterior_alpha(kernel, pj, jnp.asarray(x), jnp.asarray(y), max_iters=48,
                               row_panel=40, precond_rank=16)
    a_t = T.cg_posterior_alpha(kernel, pt, t64(x), t64(y), max_iters=48, row_panel=40,
                               precond_rank=16)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=RTOL_CG,
                               atol=RTOL_CG * np.max(np.abs(np.asarray(a_j))))
    m_j, v_j = J.cg_predict(kernel, pj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq),
                            max_iters=48, row_panel=40, var_chunk=8, precond_rank=16)
    m_t, v_t = T.cg_predict(kernel, pt, t64(x), t64(y), t64(xq), max_iters=48,
                            row_panel=40, var_chunk=8, precond_rank=16)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL_CG, atol=1e-10)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=RTOL_CG, atol=1e-10)


def test_cg_predict_preconditioned_small_noise_matches_jax_and_dense():
    """The small-noise preconditioned case of test_exact_cg.py: the port and
    the reference agree with each other, and both with the dense posterior."""
    rng = np.random.default_rng(15)
    x = rng.normal(size=(96, 2))
    y = np.sin(x[:, 0])
    xq = rng.normal(size=(32, 2))
    params = {"log_variance": np.float64(0.0), "log_lengthscales": np.array([0.8, 0.8]),
              "log_noise_variance": np.float64(np.log(1e-3))}
    pj, pt = _both(params)
    m_j, v_j = J.cg_predict("RBF", pj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq),
                            max_iters=48, row_panel=32, var_chunk=32, precond_rank=24)
    m_t, v_t = T.cg_predict("RBF", pt, t64(x), t64(y), t64(xq), max_iters=48, row_panel=32,
                            var_chunk=32, precond_rank=24)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=RTOL, atol=1e-12)

    from gpras_tpu_torch.gp.exact import predict

    # build_train_gram adds the same float64 jitter as the CG engine's noise
    m_d, v_d = predict("RBF", pt, t64(x), t64(y), t64(xq))
    # the bounds test_exact_cg.py sets for this case (CG tolerance 1e-6)
    np.testing.assert_allclose(m_t.numpy(), m_d.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), v_d.numpy(), rtol=1e-3, atol=1e-6)


def test_fit_block_matches_reference():
    from gpras_tpu.ops.block_cholesky import fit_block as ref

    for n in (1, 7, 64, 200, 256, 257, 1000):
        for target in (256, 512):
            assert fit_block(n, target) == ref(n, target)
