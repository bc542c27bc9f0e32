"""B3 (``fused_gram.kmv_sym``) on the CPU: its 3xTF32 contraction emulated in
plain PyTorch, its plan, and its plain version against the JAX Pallas body.

The CUDA kernel (csrc/kmv_sym.cu) runs only on the card
(tests/test_torch_cuda_kernels.py). What the CPU can show:

- the numerics it relies on: on ``kmv_plain``'s covariance panels, a 3xTF32
  product (both operands split hi = tf32(a), lo = tf32(a - hi); K_lo V_hi +
  K_hi V_lo + K_hi V_hi) stays within the on-card tolerance of float64, and
  one TF32 pass does not;
- the plan the wrapper sizes the scratch from, and the symmetric build's
  walk (mirrored here) covering each upper-triangle tile exactly once, one
  slot each;
- ``kmv_sym`` on CPU tensors (its plain version) still equals the reference's
  ``pallas_kmv(sym=True)`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.ops.pallas_gram import pallas_kmv
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from torch_parity import TF32X3_TOL, t32, tf32_round


def _case(kernel, n, d, r, seed):
    rng = np.random.default_rng(seed)
    params = {"log_variance": np.float32(0.3),
              "log_lengthscales": np.log(rng.uniform(0.5, 2.0, d)).astype(np.float32)}
    x = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, r)).astype(np.float32)
    return params, x, v


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _panels(kernel, params, x, noise, row_panel=256):
    """The float32 covariance row panels kmv_plain builds, noise on the
    diagonal, as (row offset, panel)."""
    for r0 in range(0, x.shape[0], row_panel):
        panel = K.gram(kernel, params, x[r0:r0 + row_panel], x)
        idx = torch.arange(panel.shape[0])
        panel[idx, r0 + idx] += noise
        yield r0, panel


@pytest.mark.parametrize("r", [64, 256])
@pytest.mark.parametrize("kernel", ["Matern52", "RBF"])
def test_3xtf32_meets_the_on_card_tolerance_and_one_pass_does_not(kernel, r):
    params, x, v = _case(kernel, 1000, 8, r, seed=r)
    pt = {k: torch.as_tensor(a) for k, a in params.items()}
    xt, vt = t32(x), t32(v)
    want = fused_gram.kmv_plain(kernel, {k: t.double() for k, t in pt.items()}, xt.double(),
                                vt.double(), noise=0.3)
    v_hi, v_lo = _split(vt)
    three = torch.empty_like(want)
    one = torch.empty_like(want)
    for r0, panel in _panels(kernel, pt, xt, 0.3):
        k_hi, k_lo = _split(panel)
        rows = slice(r0, r0 + panel.shape[0])
        three[rows] = (k_lo.double() @ v_hi.double() + k_hi.double() @ v_lo.double()
                       + k_hi.double() @ v_hi.double())
        one[rows] = k_hi.double() @ v_hi.double()
    scale = want.abs().max().item()
    err3 = (three - want).abs().max().item() / scale
    err1 = (one - want).abs().max().item() / scale
    assert err3 <= TF32X3_TOL / 10, err3  # room left for the card's fp32 sums
    assert err1 > TF32X3_TOL, err1


def test_tf32_split_is_exact_to_2_pow_minus_22():
    a = t32(np.random.default_rng(1).normal(size=10_000) * 10.0 ** np.arange(-5, 5).repeat(1000))
    hi, lo = _split(a)
    # hi keeps 10 mantissa bits, lo the next 11: hi + lo misses a by ~2^-22
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    rel = ((hi.double() + lo.double() - a.double()).abs() / a.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
    assert ((hi.double() - a.double()).abs() / a.double().abs()).max().item() <= 2.0 ** -11


@pytest.mark.parametrize("n", [1, 50, 64, 65, 2003, 49_152])
@pytest.mark.parametrize("r", [1, 7, 16, 17, 64, 65, 256, 300])
def test_plan(n, r):
    plan = fused_gram.kmv_sym_plan(n, 8, r)
    assert plan.npad % fused_gram.SYM_ROWS == 0 and n <= plan.npad < n + fused_gram.SYM_ROWS
    assert plan.dp == 8 and plan.nb == -(-n // fused_gram.TILE)
    assert plan.nb * fused_gram.TILE <= plan.npad  # every staged tile lies in the padding
    cols = 8 * plan.width if plan.tc else plan.width
    assert plan.chunks == -(-r // cols) and (plan.chunks - 1) * cols < r
    if plan.tc:
        assert r > fused_gram.SYM_MAX_R and plan.width == (8 if r <= 64 else 32)
        # hi and lo of 8 columns x width n-tiles per padded point and chunk
        assert plan.vbuf == plan.chunks * plan.npad * 2 * cols
        # each split sweeps at least 8 stages; its partial sums need N x R
        assert plan.splits in (1, 2)
        assert plan.splits == 1 or plan.npad // fused_gram.SYM_STAGE >= 8 * plan.splits
        assert plan.parts == (plan.splits * n * r if plan.splits > 1 else 0)
        assert plan.grids == 2 + (plan.splits > 1)
    else:
        assert r <= fused_gram.SYM_MAX_R and plan.width == (1 if r == 1 else 4)
        assert plan.splits == 1 and plan.vbuf == plan.chunks * plan.npad * plan.width
        assert plan.parts == plan.nb * (plan.nb + 1) // 2 * fused_gram.TILE * r
        assert plan.grids == 3
    if n == 49_152 and r == 1:  # the cache build's alpha solve: 75.6 MB of slots
        assert plan.parts * 4 == 75_595_776


# at the serving shapes on an H100 (132 SMs): the 64-column build (two blocks
# an SM) splits its sweep in two, so 768 blocks fill 264 slots in 3 waves
# instead of 384 in 1.45; the 256-column build (one an SM) fills 132 slots
# in 2.9 waves unsplit; the symmetric build never splits
@pytest.mark.parametrize("r, splits, grids", [(1, 1, 3), (64, 2, 3), (256, 1, 2)])
def test_plan_at_the_serving_shapes(r, splits, grids):
    plan = fused_gram.kmv_sym_plan(49_152, 8, r, sms=132)
    assert (plan.splits, plan.grids) == (splits, grids)


# the split rule: in two below two waves of resident blocks, if each half
# keeps 8 stages of 32 points (N above 384)
@pytest.mark.parametrize("n, r, sms, splits", [
    (49_152, 64, 132, 2), (49_152, 64, 192, 2), (49_152, 64, 96, 1), (49_152, 256, 132, 1),
    (49_152, 256, 200, 2), (2003, 300, 132, 2), (384, 64, 132, 1), (512, 64, 132, 2)])
def test_plan_splits_below_two_waves(n, r, sms, splits):
    plan = fused_gram.kmv_sym_plan(n, 8, r, sms=sms)
    blocks = plan.npad // fused_gram.SYM_ROWS * plan.chunks
    assert plan.splits == splits
    assert (blocks < 2 * sms * (2 if plan.width == 8 else 1)) == (splits == 2 or n <= 384)


def test_tensor_core_plan_at_any_r():
    plan = fused_gram._tc_plan(49_152, 8, 1, 1)
    assert plan.tc and plan.width == 8 and plan.chunks == 1
    assert (plan.splits, plan.parts, plan.grids) == (1, 0, 2)
    split = fused_gram._tc_plan(49_152, 8, 64, 2)
    assert (split.parts, split.grids) == (2 * 49_152 * 64, 3)


@pytest.mark.parametrize("d, dp", [(1, 8), (8, 8), (9, 16), (128, 128)])
def test_plan_pads_the_dimensions_to_eight(d, dp):
    assert fused_gram.kmv_sym_plan(100, d, 1).dp == dp


def _symmetric_walk(nb):
    """csrc/kmv_sym.cu's symmetric build, block by block: (row tile i, column
    tile j, slot) in visiting order. Block p takes row tiles p and
    nb - 1 - p, each swept j = i .. nb - 1; slot (i, j) is j (j + 1) / 2 + i
    (sym_slot), so row tile j's slots are contiguous for the fixed-order sum."""
    order = []
    for p in range(-(-nb // 2)):
        rows = [p] if nb - 1 - p == p else [p, nb - 1 - p]
        order.append([(i, j, j * (j + 1) // 2 + i) for i in rows for j in range(i, nb)])
    return order


@pytest.mark.parametrize("nb", [1, 2, 3, 8, 9, 768])
def test_symmetric_walk_covers_each_upper_tile_once(nb):
    order = _symmetric_walk(nb)
    tiles = [(i, j) for block in order for i, j, _ in block]
    assert sorted(tiles) == [(i, j) for i in range(nb) for j in range(i, nb)]
    slots = [s for block in order for _, _, s in block]
    assert sorted(slots) == list(range(nb * (nb + 1) // 2))
    # row tile j's slots, i = 0 .. j, are contiguous and end with its row sums
    for i, j, s in (t for block in order for t in block):
        assert s == j * (j + 1) // 2 + i
    # balanced: every block takes nb + 1 tiles (the middle row of an odd nb alone)
    sizes = sorted(len(block) for block in order)
    assert len(order) == -(-nb // 2)
    assert sizes[-1] == nb + 1 or nb == 1
    assert sizes[0] >= (nb + 1) // 2
    # the plan's slots hold exactly these tiles
    plan = fused_gram.kmv_sym_plan(nb * fused_gram.TILE, 8, 1)
    assert plan.parts == len(slots) * fused_gram.TILE


@pytest.mark.parametrize("r", [1, 17, 64])
def test_plain_kmv_sym_matches_pallas_interpret(r):
    params, x, v = _case("Matern52", 200, 4, r, seed=20 + r)
    pj = {k: jnp.asarray(a) for k, a in params.items()}
    pt = {k: torch.as_tensor(a) for k, a in params.items()}
    want = pallas_kmv("Matern52", pj, jnp.asarray(x), jnp.asarray(v), noise=jnp.float32(0.3),
                      interpret=True, tile_m=128, tile_n=128, sym=True)
    before = fused_gram.kmv_sym.launches
    got = fused_gram.kmv_sym("Matern52", pt, t32(x), t32(v), noise=torch.tensor(0.3))
    want = np.asarray(want)
    # the bounds tests/test_kernels.py holds pallas_kmv to (its bf16_3x
    # contraction against fp32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5 * np.abs(want).max())
    assert fused_gram.kmv_sym.launches == before  # a CPU tensor takes the plain version
