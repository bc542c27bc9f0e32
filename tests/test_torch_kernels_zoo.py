"""Kernel zoo of the PyTorch port (gpras_tpu_torch.ops.kernels) against the JAX
reference (gpras_tpu.ops.kernels), all eight covariances, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.ops import kernels as JK
from gpras_tpu_torch.ops import kernels as TK
from torch_parity import np_params, t64

# Both sides run the same float64 formulas; what differs is the order of the
# D-wide sums inside the BLAS calls (~1e-16 relative). rtol 1e-12 leaves four
# orders of magnitude for that, and atol 1e-14 covers entries that are ~0.
RTOL, ATOL = 1e-12, 1e-14


def _params(kernel, d, rng):
    p = JK.init_params(kernel, d, variance=1.7,
                       lengthscales=jnp.asarray(rng.uniform(0.5, 2.0, d)),
                       period=1.3, offset=0.4, degree=3.0, dtype=jnp.float64)
    if "log_period" in p:
        p["log_period"] = jnp.asarray(np.log(rng.uniform(0.8, 1.6, d)))
    return p


@pytest.mark.parametrize("kernel", JK.KERNEL_NAMES)
def test_gram_and_kdiag_match_jax(kernel):
    rng = np.random.default_rng(3)
    d = 3
    x1 = rng.normal(size=(23, d))
    # x2 repeats five rows of x1: coincident points exercise the r2 floor
    x2 = np.concatenate([rng.normal(size=(11, d)), x1[:5]], axis=0)
    pj = _params(kernel, d, rng)
    pt = {k: torch.as_tensor(v) for k, v in np_params(pj).items()}

    for a, b in ((x1, x2), (x1, None)):
        want = np.asarray(JK.gram(kernel, pj, jnp.asarray(a),
                                  None if b is None else jnp.asarray(b)))
        got = TK.gram(kernel, pt, t64(a), None if b is None else t64(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=kernel)
    want_d = np.asarray(JK.kdiag(kernel, pj, jnp.asarray(x1)))
    got_d = TK.kdiag(kernel, pt, t64(x1)).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL, err_msg=kernel)
    assert TK.trainable_param_names(kernel) == JK.trainable_param_names(kernel)


@pytest.mark.parametrize("kernel", JK.KERNEL_NAMES)
def test_init_constrain_round_trip(kernel):
    pt = TK.init_params(kernel, 4, variance=2.0, lengthscales=0.5, dtype=torch.float64)
    pj = JK.init_params(kernel, 4, variance=2.0, lengthscales=0.5, dtype=jnp.float64)
    assert sorted(pt) == sorted(pj)
    for k in pt:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-15)
    back = TK.unconstrain(TK.constrain(pt))
    for k in pt:
        np.testing.assert_allclose(back[k].numpy(), pt[k].numpy(), rtol=1e-14, atol=1e-15)
