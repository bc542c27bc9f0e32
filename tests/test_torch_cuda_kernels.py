"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the CPU suite).
The machine with the card has no JAX, so run them there without the suite's
conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

# The kernels contract in plain fp32 FMA; the reference is the plain version
# in float64 on the same fp32 inputs. fp32 rounding of the tile entries and
# of sums over a few thousand terms stays near 1e-6 of the result's scale;
# 1e-4 * max|want| leaves ample margin and still catches a wrong tile,
# mask or mirror (errors of order one entry, ~1e-2 of the scale).
TOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n1, n2, d, r, seed):
    g = np.random.default_rng(seed)
    params = {"log_variance": torch.tensor(0.3, device=device),
              "log_lengthscales": torch.tensor(np.log(g.uniform(0.5, 2.0, d)),
                                               dtype=torch.float32, device=device)}
    x1 = torch.tensor(g.normal(size=(n1, d)), dtype=torch.float32, device=device)
    x2 = torch.tensor(g.normal(size=(n2, d)), dtype=torch.float32, device=device)
    v = torch.tensor(g.normal(size=(n2, r)), dtype=torch.float32, device=device)
    return params, x1, x2, v


def _f64(params):
    return {k: v.double() for k, v in params.items()}


# R picks the build: 1 column per thread up to R = 16, 4 up to 64, 16 above;
# each build is held against plain at a ragged and (where it has one) a full R
@pytest.mark.parametrize("r", [1, 7, 33, 64, 70, 300])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kmv_dense_matches_plain(device, kernel, r):
    params, x1, x2, v = _inputs(device, 1999, 1001, 5, r, seed=r)
    got = fused_gram.kmv_dense(kernel, params, x1, v, x2=x2)
    want = fused_gram.kmv_plain(kernel, _f64(params), x1.double(), v.double(), x2=x2.double())
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


@pytest.mark.parametrize("r", [1, 7, 33, 64, 70, 300])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kmv_sym_matches_plain(device, kernel, r):
    params, x, _, v = _inputs(device, 2003, 2003, 5, r, seed=10 + r)
    got = fused_gram.kmv_sym(kernel, params, x, v, noise=torch.tensor(0.3, device=device))
    want = fused_gram.kmv_plain(kernel, _f64(params), x.double(), v.double(), noise=0.3)
    dense = fused_gram.kmv_dense(kernel, params, x, v, noise=0.3)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= TOL * scale
    assert (dense.double() - want).abs().max().item() <= TOL * scale


def test_kmv_sym_is_deterministic(device):
    params, x, _, v = _inputs(device, 3001, 3001, 8, 33, seed=3)
    a = fused_gram.kmv_sym("Matern52", params, x, v, noise=0.1)
    b = fused_gram.kmv_sym("Matern52", params, x, v, noise=0.1)
    assert torch.equal(a, b)


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    params, x, _, v = _inputs(device, 300, 300, 3, 4, seed=4)
    with pytest.raises(TypeError):
        fused_gram.kmv_sym("RBF", params, x.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_gram.kmv_sym("RBF", params, x, v.t().contiguous().t())
    with pytest.raises(ValueError, match="support"):
        fused_gram.kmv_dense("Linear", params, x, v)
    with pytest.raises(ValueError, match="devices"):
        fused_gram.kmv_dense("RBF", params, x, v.cpu())
