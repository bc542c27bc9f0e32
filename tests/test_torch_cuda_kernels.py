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
from torch_parity import TF32X3_TOL, tf32_round

pytestmark = pytest.mark.cuda

# The kernels contract in fp32 FMA (B3 above 16 right-hand sides in 3xTF32,
# ~2^-22 per product); the reference is the plain version in float64 on the
# same fp32 inputs. Rounding of the tile entries and of sums over a few
# thousand terms stays near 1e-6 of the result's scale; 1e-4 * max|want|
# leaves ample margin and still catches a wrong tile, mask or mirror (errors
# of order one entry, ~1e-2 of the scale).
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


# R picks the build: up to R = 16 the rows design (these 32 row tiles are
# fewer than two per SM), above it the tiled one with 4 columns per thread up
# to 64 and 16 above; each is held against plain at a ragged and (where it has
# one) a full R
@pytest.mark.parametrize("r", [1, 7, 33, 64, 70, 300])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kmv_dense_matches_plain(device, kernel, r):
    params, x1, x2, v = _inputs(device, 1999, 1001, 5, r, seed=r)
    got = fused_gram.kmv_dense(kernel, params, x1, v, x2=x2)
    want = fused_gram.kmv_plain(kernel, _f64(params), x1.double(), v.double(), x2=x2.double())
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


# B2's rows design (a thread per query row, R <= 16): its four widths of V
# (1, 4, 8, 16 columns in registers, ragged at 3 and 7), query counts from one
# row to several ragged blocks of 64, cross and square (noise on the global
# diagonal, whichever chunk holds it), all five covariances; 2,003 training
# points are 32 stages of 64, the last ragged
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("r", [1, 3, 7, 16])
@pytest.mark.parametrize("n1", [1, 17, 64, 300])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kmv_dense_rows_matches_plain(device, kernel, n1, r, square):
    n2 = n1 if square else 2003
    params, x1, x2, v = _inputs(device, n1, n2, 8, r, seed=100 + n1 + r)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert fused_gram.kmv_dense_plan(n1, n2, r, sms).rows
    if square:
        got = fused_gram.kmv_dense(kernel, params, x1, v, noise=torch.tensor(0.3, device=device))
        want = fused_gram.kmv_plain(kernel, _f64(params), x1.double(), v.double(), noise=0.3)
    else:
        got = fused_gram.kmv_dense(kernel, params, x1, v, x2=x2)
        want = fused_gram.kmv_plain(kernel, _f64(params), x1.double(), v.double(),
                                    x2=x2.double())
    torch.cuda.synchronize()
    assert (got.double() - want).abs().max().item() <= TOL * want.abs().max().item()


# the rows design past 8 input dimensions (a row's further coordinates live in
# shared memory) and at one dimension; one shared lengthscale for all
@pytest.mark.parametrize("d", [1, 9, 16, 128])
@pytest.mark.parametrize("r", [1, 7])
def test_kmv_dense_rows_matches_plain_other_dimensions(device, r, d):
    params, x1, x2, v = _inputs(device, 300, 2003, d, r, seed=200 + d + r)
    x1, x2 = (x1 * (4.0 / d) ** 0.5).contiguous(), (x2 * (4.0 / d) ** 0.5).contiguous()
    if d == 16:
        params["log_lengthscales"] = torch.tensor(0.2, device=device)
    got = fused_gram.kmv_dense("Matern52", params, x1, v, x2=x2)
    want = fused_gram.kmv_plain("Matern52", _f64(params), x1.double(), v.double(), x2=x2.double())
    torch.cuda.synchronize()
    assert (got.double() - want).abs().max().item() <= TOL * want.abs().max().item()


# coincident points: a query that is a training point has r2 == 0 exactly
# (the norms and the dot share one FMA chain), so Matern12 and Exponential,
# linear in r there, agree with float64 as closely as anywhere else
@pytest.mark.parametrize("kernel", ["Matern12", "Exponential", "Matern52"])
def test_kmv_dense_rows_coincident_points(device, kernel):
    params, _, x2, v = _inputs(device, 64, 2003, 8, 1, seed=9)
    x1 = x2[:200].clone()
    v = torch.zeros_like(v)
    v[:200] = 1.0  # only the coincident (and nearby) columns count
    got = fused_gram.kmv_dense(kernel, params, x1, v, x2=x2)
    want = fused_gram.kmv_plain(kernel, _f64(params), x1.double(), v.double(), x2=x2.double())
    torch.cuda.synchronize()
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("n1, r", [(256, 1), (300, 7), (64, 16)])
def test_kmv_dense_is_deterministic(device, n1, r):
    params, x1, x2, v = _inputs(device, n1, 5003, 8, r, seed=8)
    a = fused_gram.kmv_dense("Matern52", params, x1, v, x2=x2)
    b = fused_gram.kmv_dense("Matern52", params, x1, v, x2=x2)
    assert torch.equal(a, b)


# the two designs of B2 compute one function: the tiled design, forced at a
# shape the rows design serves, agrees with it to fp32 rounding
@pytest.mark.parametrize("r", [1, 16])
def test_kmv_dense_designs_agree(device, r):
    params, x1, x2, v = _inputs(device, 256, 5003, 8, r, seed=12)
    rows = fused_gram.kmv_dense("Matern52", params, x1, v, x2=x2)
    launch, tiled = fused_gram._kmv_dense_cuda(
        "Matern52", params, x1, v, x2, None, plan=fused_gram.KmvPlan(False, 33, 33 * 256 * r, 2,
                                                    fused_gram.kmv_dense_smem(False, 8, r)))
    assert launch() == 0
    torch.cuda.synchronize()
    assert (rows - tiled).abs().max().item() <= 1e-5 * rows.abs().max().item()


# B3's builds and their edges: the symmetric build up to R = 16 (1 or 4
# columns a pass, ragged passes at 7), the tensor-core build above (64
# columns a block up to R = 64, 256 above; ragged at 17, 65 and 300, two
# blocks along R at 300); N ragged (2003) and smaller than one tile (50)
@pytest.mark.parametrize("n", [2003, 50])
@pytest.mark.parametrize("r", [1, 7, 16, 17, 64, 65, 256, 300])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kmv_sym_matches_plain(device, kernel, r, n):
    params, x, _, v = _inputs(device, n, n, 5, r, seed=10 + r)
    got = fused_gram.kmv_sym(kernel, params, x, v, noise=torch.tensor(0.3, device=device))
    want = fused_gram.kmv_plain(kernel, _f64(params), x.double(), v.double(), noise=0.3)
    dense = fused_gram.kmv_dense(kernel, params, x, v, noise=0.3)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= TOL * scale
    assert (dense.double() - want).abs().max().item() <= TOL * scale


# D above 8: both builds then read the coordinates in runs of 8 past the
# first (the tensor-core build's rows from device memory, the symmetric
# build's from shared memory). 128 is the most the wrappers take (every build
# then fits its shared memory, 169 KB at most); the coordinates are scaled by
# sqrt(4 / D) so that r2 stays O(1) and the off-diagonal entries count.
@pytest.mark.parametrize("d", [9, 16, 128])
@pytest.mark.parametrize("r", [1, 7, 64, 300])
def test_kmv_sym_matches_plain_wide_inputs(device, r, d):
    params, x, _, v = _inputs(device, 2003, 2003, d, r, seed=60 + d + r)
    x = (x * (4.0 / d) ** 0.5).contiguous()
    got = fused_gram.kmv_sym("Matern52", params, x, v, noise=torch.tensor(0.3, device=device))
    want = fused_gram.kmv_plain("Matern52", _f64(params), x.double(), v.double(), noise=0.3)
    torch.cuda.synchronize()
    offdiag = (want - (torch.exp(params["log_variance"]).double() + 0.3) * v.double())
    assert offdiag.abs().max().item() > 0.1 * want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= TOL * want.abs().max().item()


def _close(got, want):
    return (got.double() - want).abs().max().item() <= TOL * want.abs().max().item()


# Past 128 input dimensions the kernels used to refuse; now each takes its
# wide path (fused_gram.STAGED_DIM): B1, B3 and B4/B5 stage the first 128
# coordinates and read the rest from their packed copy, B2's tiled build
# stages 128 at a time (its rows design is not planned there). B1-B5 against
# their plain versions at D = 129, 200 and 300: B1 square and cross, B2 at a
# serving-bucket shape (R = 1) and a tiled one (R = 64), B3 through both
# builds (R = 1, 7, 64, 300), B4 and B5 with m = 16 probes. The coordinates
# are scaled by sqrt(4 / D), so the covariances stay far from 0 and 1.
@pytest.mark.parametrize("d", [129, 200, 300])
def test_kmv_sym_raises_past_128_dimensions(device, d):
    params, x1, x2, v = _inputs(device, 1999, 1001, d, 300, seed=d)
    x1 = (x1 * (4.0 / d) ** 0.5).contiguous()
    x2 = (x2 * (4.0 / d) ** 0.5).contiguous()
    p64 = _f64(params)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert fused_gram.gram_plan(1999, 1999, d, True, sms).staged == fused_gram.STAGED_DIM
    for b in (None, x2):
        got = fused_gram.gram("Matern52", params, x1, b, noise=0.2)
        want = fused_gram.gram_plain("Matern52", p64, x1.double(),
                                     None if b is None else b.double(), noise=0.2)
        assert _close(got, want)
        assert got.abs().min().item() < 0.5 * got.abs().max().item()
    for n1, r in ((256, 1), (256, 64)):
        q = x1[:n1].contiguous()
        vv = torch.tensor(np.random.default_rng(d + r).normal(size=(8192, r)),
                          dtype=torch.float32, device=device)
        xb = torch.cat([x2] * 9)[:8192].contiguous()
        assert not fused_gram.kmv_dense_plan(n1, 8192, r, sms, d).rows
        got = fused_gram.kmv_dense("Matern52", params, q, vv, x2=xb)
        want = fused_gram.kmv_plain("Matern52", p64, q.double(), vv.double(), x2=xb.double())
        assert _close(got, want)
    for r in (1, 7, 64, 300):
        vr = v[:, :r].contiguous()
        got = fused_gram.kmv_sym("Matern52", params, x2, vr, noise=0.3)
        want = fused_gram.kmv_plain("Matern52", p64, x2.double(), vr.double(), noise=0.3)
        assert _close(got, want)
    pk, xk, w, z, alpha = _kgrad_inputs(device, 1999, d, 16, seed=d + 1)
    xk = (xk * (4.0 / d) ** 0.5).contiguous()
    want = fused_gram.kgrad_plain("Matern52", _f64(pk), xk.double(), w.double(), z.double(),
                                  alpha.double(), 1.7, 1.0 / 16)
    want_v = torch.cat([want["log_variance"].reshape(1), want["log_lengthscales"]])
    for sym in (False, True):
        got = fused_gram.kgrad("Matern52", pk, xk, w, z, alpha, 1.7, 1.0 / 16, sym=sym)
        assert _close(torch.cat([got["log_variance"].reshape(1), got["log_lengthscales"]]),
                      want_v)
    torch.cuda.synchronize()


# the first designs, kept as timing yardsticks, keep their cap and refuse
# past it by name
def test_first_designs_refuse_past_their_cap(device):
    params, x, _, v = _inputs(device, 300, 300, 129, 4, seed=5)
    with pytest.raises(ValueError, match="first design"):
        fused_gram._gram_cuda("RBF", params, x, None, 0.1, tiles=True)
    with pytest.raises(ValueError, match="first port"):
        fused_gram._kgrad_cuda(True, "RBF", params, x, v, v, v[:, 0].contiguous(), 1.0, 0.25,
                               tiles=True)


# the grids a call launches, as the kernel's entry point counts them, are the
# plan's: prep, the build, and a fixed-order sum where the plan has one
@pytest.mark.parametrize("n", [50, 2003])
@pytest.mark.parametrize("r", [1, 16, 17, 64, 256])
def test_kmv_sym_launches_the_planned_grids(device, r, n):
    params, x, _, v = _inputs(device, n, n, 8, r, seed=70 + r)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    before = (fused_gram.kmv_sym.launches, fused_gram.kmv_sym.grids)
    fused_gram.kmv_sym("Matern52", params, x, v, noise=0.1)
    assert (fused_gram.kmv_sym.launches - before[0], fused_gram.kmv_sym.grids - before[1]) == \
        (1, fused_gram.kmv_sym_plan(n, 8, r, sms).grids)


@pytest.mark.parametrize("r", [1, 64, 256])
def test_kmv_sym_is_deterministic(device, r):
    params, x, _, v = _inputs(device, 3001, 3001, 8, r, seed=3)
    a = fused_gram.kmv_sym("Matern52", params, x, v, noise=0.1)
    b = fused_gram.kmv_sym("Matern52", params, x, v, noise=0.1)
    assert torch.equal(a, b)


# 3xTF32, proven: the kernel's error against float64 stays under a bound that
# one TF32 pass (K and V rounded to TF32, products summed in float64) misses
# on the same inputs
@pytest.mark.parametrize("r", [64, 256])
def test_kmv_sym_contracts_in_3xtf32(device, r):
    params, x, _, v = _inputs(device, 2003, 2003, 8, r, seed=40 + r)
    got = fused_gram.kmv_sym("Matern52", params, x, v, noise=0.3)
    want = fused_gram.kmv_plain("Matern52", _f64(params), x.double(), v.double(), noise=0.3)
    kmat = fused_gram.gram_plain("Matern52", params, x, noise=0.3)
    one_pass = tf32_round(kmat).double() @ tf32_round(v).double()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    err_one = (one_pass - want).abs().max().item()
    assert err <= TF32X3_TOL * scale < err_one, (err / scale, err_one / scale)


def test_sqrt_rn_is_sqrtf_bit_for_bit(device):
    """The covariance tails' branch-free square root (csrc/stationary.cuh)
    against torch.sqrt (IEEE, correctly rounded) over every float32 in
    [1e-36, 2^60], the range it promises."""
    from gpras_tpu_torch.ops._build import library

    lo = int(torch.tensor([1e-36]).view(torch.int32))
    hi = int(torch.tensor([2.0 ** 60]).view(torch.int32))
    stream = torch.cuda.current_stream(device).cuda_stream
    mismatches = 0
    for b0 in range(lo, hi + 1, 1 << 27):
        x = torch.arange(b0, min(hi + 1, b0 + (1 << 27)), dtype=torch.int64,
                         device=device).to(torch.int32).view(torch.float32)
        out = torch.empty_like(x)
        assert library().gpras_sqrt_rn(x.data_ptr(), out.data_ptr(), x.numel(), stream) == 0
        mismatches += int((out.view(torch.int32) != torch.sqrt(x).view(torch.int32)).sum())
    assert mismatches == 0


# B1: ragged shapes (masked edges) and whole tiles (64 x 128), cross and square
@pytest.mark.parametrize("n1, n2", [(1999, 1001), (2048, 1024), (2003, None), (2048, None)])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_gram_matches_plain(device, kernel, n1, n2):
    params, x1, x2, _ = _inputs(device, n1, n2 or n1, 5, 1, seed=n1 + 7)
    x2 = None if n2 is None else x2
    noise = None if n2 else torch.tensor(0.3, device=device)
    got = fused_gram.gram(kernel, params, x1, x2, noise=noise)
    want = fused_gram.gram_plain(kernel, _f64(params), x1.double(),
                                 None if x2 is None else x2.double(),
                                 noise=None if noise is None else 0.3)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= TOL * want.abs().max().item()
    if n2 is None:  # a point against itself: r2 == 0 exactly, so K_ii == var + noise
        diag = torch.exp(params["log_variance"]) + noise
        assert torch.equal(got.diagonal(), diag.expand(n1))


# B1's symmetric design against the first (a block per 64 x 128 tile of the
# whole output), bit for bit: square with noise (one tile, ragged tiles,
# whole tiles, and N % 4 != 0, where rows leave by 4-byte streaming stores
# instead of 16-byte ones) and cross (N2 % 4 != 0 and == 0)
@pytest.mark.parametrize("n1, n2", [(1, None), (65, None), (2003, None), (2048, None),
                                    (2049, None), (2050, None), (2051, None), (1999, 1001),
                                    (1999, 1024)])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_gram_equals_the_first_design(device, kernel, n1, n2):
    params, x1, x2, _ = _inputs(device, n1, n2 or n1, 8, 1, seed=n1 + 3)
    x2 = None if n2 is None else x2
    noise = None if n2 else torch.tensor(0.3, device=device)
    got = fused_gram.gram(kernel, params, x1, x2, noise=noise)
    launch, first = fused_gram._gram_cuda(kernel, params, x1, x2, noise, tiles=True)
    assert launch() == 0
    torch.cuda.synchronize()
    assert torch.equal(got, first)


# one block walking every tile (each output buffer reused many times), and
# one SM's worth of blocks, give the same bits as the planned grid
@pytest.mark.parametrize("n", [2048, 2051])
def test_gram_any_block_count_gives_the_same_bits(device, n):
    params, x, _, _ = _inputs(device, n, n, 8, 1, seed=n)
    want = fused_gram.gram("Matern52", params, x, noise=0.1)
    for sms, per_sm in ((1, 1), (1, 2), (7, 2)):
        plan = fused_gram.gram_plan(n, n, 8, True, sms, per_sm=per_sm)
        launch, got = fused_gram._gram_cuda("Matern52", params, x, None, 0.1, plan=plan)
        assert launch() == 0
        torch.cuda.synchronize()
        assert torch.equal(got, want), (sms, per_sm)


# both ways out of shared memory (16-byte streaming stores when N2 % 4 == 0,
# else 4-byte ones) write the first design's bits, square and cross, with
# the planned blocks and with one block an SM (each block reusing its
# staged tile many times)
@pytest.mark.parametrize("n1, n2", [(2052, None), (2051, None), (1999, 1024), (1999, 1001)])
def test_gram_store_paths_give_the_same_bits(device, n1, n2):
    params, x1, x2, _ = _inputs(device, n1, n2 or n1, 8, 1, seed=n1 + 5)
    x2 = None if n2 is None else x2
    launch, want = fused_gram._gram_cuda("Matern32", params, x1, x2, 0.2, tiles=True)
    assert launch() == 0
    for per_sm in (None, 1):
        plan = fused_gram.gram_plan(n1, n2 or n1, 8, n2 is None, per_sm=per_sm)
        assert plan.store == (fused_gram.GRAM_STORE_VECTOR if (n2 or n1) % 4 == 0
                              else fused_gram.GRAM_STORE_SCALAR)
        launch, got = fused_gram._gram_cuda("Matern32", params, x1, x2, 0.2, plan=plan)
        assert launch() == 0
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# the mirror tiles carry the same bits as the tiles they mirror
@pytest.mark.parametrize("n", [130, 2048, 2051])
@pytest.mark.parametrize("kernel", ["Matern52", "RBF", "Matern12"])
def test_gram_square_is_symmetric(device, kernel, n):
    params, x, _, _ = _inputs(device, n, n, 8, 1, seed=2 * n)
    k = fused_gram.gram(kernel, params, x, noise=0.25)
    off = k - torch.diag(k.diagonal())
    assert torch.equal(off, off.T)
    assert torch.equal(k.diagonal(), (torch.exp(params["log_variance"]) + 0.25).expand(n))


def _kgrad_inputs(device, n, d, m, seed):
    params, x, _, _ = _inputs(device, n, n, d, 1, seed=seed)
    g = np.random.default_rng(seed + 1)
    w = torch.tensor(g.normal(size=(n, m)), dtype=torch.float32, device=device)
    z = torch.tensor(g.choice([-1.0, 1.0], size=(n, m)), dtype=torch.float32, device=device)
    alpha = torch.tensor(g.normal(size=n), dtype=torch.float32, device=device)
    return params, x, w, z, alpha


# B4 and B5: ragged N and whole tiles, m = 16 probes as on the training path.
# The sums run over n^2 fp32 terms taken in float64 per tile; 1e-4 of the
# largest gradient entry leaves room for fp32 rounding of each term and
# catches a wrong mask, mirror or diagonal tile (errors of whole tiles).
@pytest.mark.parametrize("n", [1999, 2048])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kgrad_matches_plain(device, kernel, sym, n):
    params, x, w, z, alpha = _kgrad_inputs(device, n, 5, 16, seed=n)
    got = fused_gram.kgrad(kernel, params, x, w, z, alpha, 1.7, 1.0 / 16, sym=sym)
    want = fused_gram.kgrad_plain(kernel, _f64(params), x.double(), w.double(), z.double(),
                                  alpha.double(), 1.7, 1.0 / 16)
    torch.cuda.synchronize()
    got_v = torch.cat([got["log_variance"].reshape(1), got["log_lengthscales"]]).double()
    want_v = torch.cat([want["log_variance"].reshape(1), want["log_lengthscales"]])
    assert (got_v - want_v).abs().max().item() <= TOL * want_v.abs().max().item(), (got_v, want_v)


# B5's strips: ragged N just past where ``kgrad`` picks it (3,585), probe
# counts 1, 7, 16, one input dimension, eight, and more than eight (a second
# pass over the sweep for dimensions 8..), all five covariances at the
# training shape's D and m; against the plain version and against B4, which
# computes the same sum over every tile
@pytest.mark.parametrize("n, d, m", [(3585, 8, 16), (5003, 8, 7), (2003, 8, 1), (2003, 1, 16),
                                     (2003, 11, 5), (1999, 20, 16), (50, 3, 2)])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kgrad_sym_strips_match_plain(device, kernel, n, d, m):
    params, x, w, z, alpha = _kgrad_inputs(device, n, d, m, seed=n + d + m)
    x = (x * (4.0 / d) ** 0.5).contiguous()
    got = fused_gram.kgrad_sym(kernel, params, x, w, z, alpha, 1.7, 1.0 / m)
    dense = fused_gram.kgrad_dense(kernel, params, x, w, z, alpha, 1.7, 1.0 / m)
    want = fused_gram.kgrad_plain(kernel, _f64(params), x.double(), w.double(), z.double(),
                                  alpha.double(), 1.7, 1.0 / m)
    torch.cuda.synchronize()
    want_v = torch.cat([want["log_variance"].reshape(1), want["log_lengthscales"]])
    for res in (got, dense):
        res_v = torch.cat([res["log_variance"].reshape(1), res["log_lengthscales"]]).double()
        assert (res_v - want_v).abs().max().item() <= TOL * want_v.abs().max().item()


# coincident points: every point twice. Matern12's and Exponential's f' ~ 1/r
# is zeroed below r2 = 1e-12; without that guard (or with an r2 that is not
# exactly 0 for a point against itself) the lengthscale gradient is garbage
@pytest.mark.parametrize("kernel", ["Matern12", "Exponential", "Matern32"])
@pytest.mark.parametrize("cotangent_on_device", [False, True])
def test_kgrad_sym_coincident_points(device, kernel, cotangent_on_device):
    params, x, w, z, alpha = _kgrad_inputs(device, 2000, 8, 16, seed=21)
    x = torch.cat([x[:1000], x[:1000]]).contiguous()
    g = torch.tensor(0.9, device=device) if cotangent_on_device else 0.9
    got = fused_gram.kgrad_sym(kernel, params, x, w, z, alpha, g, 1.0 / 16)
    want = fused_gram.kgrad_plain(kernel, _f64(params), x.double(), w.double(), z.double(),
                                  alpha.double(), 0.9, 1.0 / 16)
    torch.cuda.synchronize()
    got_v = torch.cat([got["log_variance"].reshape(1), got["log_lengthscales"]]).double()
    want_v = torch.cat([want["log_variance"].reshape(1), want["log_lengthscales"]])
    assert torch.isfinite(got_v).all()
    assert (got_v - want_v).abs().max().item() <= TOL * want_v.abs().max().item()


# any segment length gives the same sum (to float64 rounding of the partials'
# order): one tile a block, the plan's, and one block per strip pair; and the
# first port (a block per tile) agrees too
def test_kgrad_sym_segment_lengths_agree(device):
    params, x, w, z, alpha = _kgrad_inputs(device, 5003, 8, 16, seed=31)
    common = ("Matern52", params, x, w, z, alpha, 1.1, 1.0 / 16)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    outs = []
    for per in (1, None, 1000):
        plan = fused_gram.kgrad_sym_plan(5003, 8, 16, sms, per=per)
        launch, out = fused_gram._kgrad_cuda(True, *common, plan=plan)
        assert launch() == 0
        outs.append(out)
    launch, first = fused_gram._kgrad_cuda(True, *common, tiles=True)
    assert launch() == 0
    torch.cuda.synchronize()
    scale = outs[1].abs().max().item()
    for out in (outs[0], outs[2], first):
        assert (out - outs[1]).abs().max().item() <= 1e-6 * scale


# B4: the strips, as planned and with three blocks in all (each share
# crossing strip pairs), against the plain version in float64 and against
# the first port (a block per tile), at ragged and whole N up to where
# ``kgrad`` hands over to B5, with coincident points (every fifth point
# repeats its neighbour); the planned call gives the same bits run to run
@pytest.mark.parametrize("n", [1999, 2048, 3001, 3072, 3584])
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_kgrad_dense_walks_match_plain(device, kernel, n):
    params, x, w, z, alpha = _kgrad_inputs(device, n, 8, 16, seed=n + 1)
    x[1::5] = x[0::5][:x[1::5].shape[0]]
    common = (kernel, params, x, w, z, alpha, 1.7, 1.0 / 16)
    want = fused_gram.kgrad_plain(kernel, _f64(params), x.double(), w.double(), z.double(),
                                  alpha.double(), 1.7, 1.0 / 16)
    want_v = torch.cat([want["log_variance"].reshape(1), want["log_lengthscales"]])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    outs = []
    for cards in (sms, 1):
        launch, out = fused_gram._kgrad_cuda(
            False, *common, plan=fused_gram.kgrad_dense_plan(n, 8, 16, cards))
        assert launch() == 0
        outs.append(out)
    launch, first = fused_gram._kgrad_cuda(False, *common, tiles=True)
    assert launch() == 0
    a = fused_gram.kgrad_dense(*common)
    b = fused_gram.kgrad_dense(*common)
    torch.cuda.synchronize()
    for k in a:
        assert torch.equal(a[k], b[k])
    planned = torch.cat([a["log_variance"].reshape(1), a["log_lengthscales"]])
    for res in (*outs, first, planned):
        assert torch.isfinite(res).all()
        assert (res.double() - want_v).abs().max().item() <= TOL * want_v.abs().max().item()


def test_kgrad_sym_is_deterministic(device):
    params, x, w, z, alpha = _kgrad_inputs(device, 5003, 8, 16, seed=5)
    a = fused_gram.kgrad_sym("Matern52", params, x, w, z, alpha, 0.9, 1.0 / 16)
    b = fused_gram.kgrad_sym("Matern52", params, x, w, z, alpha, 0.9, 1.0 / 16)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_kgrad_picks_the_references_body(device):
    params, x, w, z, alpha = _kgrad_inputs(device, 3585, 3, 4, seed=6)
    before = (fused_gram.kgrad_dense.launches, fused_gram.kgrad_sym.launches)
    fused_gram.kgrad("RBF", params, x[:3584], w[:3584], z[:3584], alpha[:3584], 1.0, 0.25)
    fused_gram.kgrad("RBF", params, x, w, z, alpha, 1.0, 0.25)
    assert (fused_gram.kgrad_dense.launches - before[0],
            fused_gram.kgrad_sym.launches - before[1]) == (1, 1)


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
    with pytest.raises(TypeError):
        fused_gram.gram("RBF", params, x.double())
    with pytest.raises(ValueError, match="support"):
        fused_gram.gram("Periodic", params, x)
    with pytest.raises(TypeError):
        fused_gram.kgrad("RBF", params, x, v.double(), v.double(), v[:, 0].double(), 1.0, 0.25)
    with pytest.raises(ValueError, match="devices"):
        fused_gram.kgrad_sym("RBF", params, x, v, v.cpu(), v[:, 0], 1.0, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gram.kgrad_sym("RBF", params, x, v, v, torch.zeros(600, device=device)[::2],
                             1.0, 0.25)
    with pytest.raises(ValueError, match="kgrad takes"):
        fused_gram.kgrad_sym("RBF", params, x, v, v[:, :2].contiguous(), v[:, 0].contiguous(),
                             1.0, 0.25)
    with pytest.raises(ValueError, match="dimensions"):
        fused_gram.kmv_dense("RBF", params, x, v, x2=x[:, :2].contiguous())
    with pytest.raises(ValueError, match="log_lengthscales"):
        fused_gram.kmv_dense("RBF", {**params, "log_lengthscales": params["log_lengthscales"][:2]},
                             x, v)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gram.kmv_dense("RBF", params, x, v, x2=x.t().contiguous().t())


# the hyperparameters go to the kernels in log space and are exponentiated
# there; a lengthscale tensor that is a strided view, one shared lengthscale,
# and noise as a device tensor, a CPU tensor or a number give the same bits
def test_wrappers_take_hyperparameters_in_any_layout(device):
    params, x, _, v = _inputs(device, 700, 700, 4, 3, seed=14)
    base = fused_gram.kmv_dense("Matern52", params, x, v, noise=0.3)
    wide = torch.zeros(8, device=device)
    wide[::2] = params["log_lengthscales"]
    strided = {**params, "log_lengthscales": wide[::2]}
    for p, noise in ((strided, 0.3), (params, torch.tensor(0.3)),
                     (params, torch.tensor(0.3, device=device))):
        assert torch.equal(fused_gram.kmv_dense("Matern52", p, x, v, noise=noise), base)
    one = {**params, "log_lengthscales": torch.tensor(0.1, device=device)}
    four = {**params, "log_lengthscales": torch.full((4,), 0.1, device=device)}
    for fn in (fused_gram.kmv_dense, fused_gram.kmv_sym):
        assert torch.equal(fn("RBF", one, x, v, noise=0.2), fn("RBF", four, x, v, noise=0.2))
    assert torch.equal(fused_gram.gram("RBF", one, x), fused_gram.gram("RBF", four, x))


# the kernels scale the coordinates as PyTorch would: B1 on raw inputs equals
# B1 on inputs divided by the lengthscales beforehand with unit lengthscales,
# bit for bit (IEEE division, and expf is torch.exp's function)
@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
def test_gram_scales_as_pytorch_does(device, kernel):
    params, x1, x2, _ = _inputs(device, 1000, 900, 5, 1, seed=17)
    ls = torch.exp(params["log_lengthscales"])
    unit = {**params, "log_lengthscales": torch.zeros(5, device=device)}
    got = fused_gram.gram(kernel, params, x1, x2)
    assert torch.equal(got, fused_gram.gram(kernel, unit, x1 / ls, x2 / ls))


# C1, strided training inputs: the Hutchinson engine at N = 4,096 with a
# 2,048-point warm-start rung (every second point; its backward takes B4, the
# full-N one B5), once with a contiguous x and once with a strided one (every
# other column of a wider array). Before the repair the rung's x reached B4
# as a (2,048, 3) view with strides (6, 1) and was refused.
def test_fit_takes_strided_inputs_on_the_card(device):
    from gpras_tpu_torch.gp.model import GPRAS

    g = np.random.default_rng(3)
    wide = torch.tensor(g.normal(size=(4096, 6)), dtype=torch.float32, device=device)
    x = wide[:, ::2]
    y = torch.sin(x[:, 0]) + 0.1 * torch.tensor(g.normal(size=4096), dtype=torch.float32,
                                                device=device)
    assert not x.is_contiguous()
    for xx in (x.contiguous(), x):
        before = (fused_gram.kgrad_dense.launches, fused_gram.kgrad_sym.launches)
        model = GPRAS("Matern52", model_type="exact", exact_engine="hutchinson", device=device)
        model.fit(xx, y, optimization_method="adam", max_iter=2, warm_start_subsample=2048)
        assert torch.isfinite(model.fit_info["losses"]).all()
        assert fused_gram.kgrad_dense.launches > before[0]
        assert fused_gram.kgrad_sym.launches > before[1]
