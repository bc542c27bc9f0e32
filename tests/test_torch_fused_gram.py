"""Plain versions of the port's fused matvec kernels (gpras_tpu_torch.ops.
fused_gram) against the JAX Pallas kernel they replace, run as
tests/test_kernels.py runs it: ``pallas_kmv(..., interpret=True)`` on the CPU.

On CPU tensors the wrappers ``kmv_dense`` (B2) and ``kmv_sym`` (B3) take
their plain version; the CUDA kernels themselves are checked against that
plain version on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.ops import kernels as JK
from gpras_tpu.ops.pallas_gram import pallas_kmv
from gpras_tpu_torch.ops import fused_gram
from torch_parity import t32

# float32 on both sides. The Pallas body contracts with a bf16x3 hi/lo split
# (~2^-16 relative per product) and the plain version in fp32; these are the
# bounds tests/test_kernels.py holds pallas_kmv to.
RTOL, ATOL_REL = 2e-4, 2e-5


def _case(kernel, n1, n2, d, r, seed):
    rng = np.random.default_rng(seed)
    params = {"log_variance": np.float32(0.3),
              "log_lengthscales": np.log(rng.uniform(0.5, 2.0, d)).astype(np.float32)}
    x1 = rng.normal(size=(n1, d)).astype(np.float32)
    x2 = rng.normal(size=(n2, d)).astype(np.float32)
    v = rng.normal(size=(n1 if n2 == 0 else n2, r)).astype(np.float32)
    return params, x1, x2, v


def _check(got, want, msg):
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale, err_msg=msg)


@pytest.mark.parametrize("r", [1, 3, 130])
@pytest.mark.parametrize("case", ["dense_square", "dense_cross", "sym_ragged"])
def test_plain_kmv_matches_pallas_interpret(case, r):
    kernel = {"dense_square": "Matern52", "dense_cross": "RBF",
              "sym_ragged": "Matern32"}[case]
    n1, n2 = {"dense_square": (300, 0), "dense_cross": (300, 140),
              "sym_ragged": (333, 0)}[case]
    params, x1, x2, v = _case(kernel, n1, n2, 4, r, seed=7 + r)
    pj = {k: jnp.asarray(a) for k, a in params.items()}
    pt = {k: torch.as_tensor(a) for k, a in params.items()}
    launches = (fused_gram.kmv_dense.launches, fused_gram.kmv_sym.launches)
    if case == "dense_cross":
        want = pallas_kmv(kernel, pj, jnp.asarray(x1), jnp.asarray(v), x2=jnp.asarray(x2),
                          interpret=True, tile_m=128, tile_n=128)
        got = fused_gram.kmv_dense(kernel, pt, t32(x1), t32(v), x2=t32(x2))
    elif case == "dense_square":
        want = pallas_kmv(kernel, pj, jnp.asarray(x1), jnp.asarray(v), noise=jnp.float32(0.25),
                          interpret=True, tile_m=128, tile_n=128, sym=False)
        got = fused_gram.kmv_dense(kernel, pt, t32(x1), t32(v), noise=0.25)
    else:
        want = pallas_kmv(kernel, pj, jnp.asarray(x1), jnp.asarray(v), noise=jnp.float32(0.3),
                          interpret=True, tile_m=128, tile_n=128, sym=True)
        got = fused_gram.kmv_sym(kernel, pt, t32(x1), t32(v), noise=torch.tensor(0.3))
    _check(got.numpy(), np.asarray(want), f"{case} r={r}")
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (fused_gram.kmv_dense.launches, fused_gram.kmv_sym.launches) == launches


@pytest.mark.parametrize("kernel", JK.STATIONARY_KERNELS)
def test_plain_kmv_panels_match_dense_f64(kernel):
    """The panel loop (ragged last panel) equals one dense K @ v + noise v."""
    params, x1, _, v = _case(kernel, 150, 0, 3, 2, seed=1)
    pt = {k: torch.as_tensor(a, dtype=torch.float64) for k, a in params.items()}
    x = torch.as_tensor(x1, dtype=torch.float64)
    vv = torch.as_tensor(v, dtype=torch.float64)
    got = fused_gram.kmv_plain(kernel, pt, x, vv, noise=0.5, row_panel=64)
    pj = {k: jnp.asarray(a, jnp.float64) for k, a in params.items()}
    kd = np.asarray(JK.gram(kernel, pj, jnp.asarray(x1, jnp.float64))) + 0.5 * np.eye(150)
    # rtol 1e-12 for the float64 sums in another order. atol 1e-6: on the
    # diagonal r2 = a2 + b2 - 2ab rounds to ~1e-16 |a|^2 in either BLAS call,
    # and Matern12 / Exponential are linear in r = sqrt(r2) there, so K_ii
    # moves by ~1e-8 and a row of K @ v by up to ~1e-7
    np.testing.assert_allclose(got.numpy(), kd @ v.astype(np.float64), rtol=1e-12, atol=1e-6)


def test_wrappers_refuse_mixed_or_unknown_devices():
    params = {"log_variance": torch.tensor(0.0), "log_lengthscales": torch.zeros(2)}
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="devices"):
        fused_gram.kmv_sym("RBF", params, x, torch.zeros((4, 1), device="meta"))
    with pytest.raises(ValueError, match="meta"):
        fused_gram.kmv_dense("RBF", params, x.to("meta"), torch.zeros((4, 1), device="meta"))
