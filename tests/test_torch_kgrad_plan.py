"""What of B2's, B4's and B5's Hopper designs lives in Python, on the CPU.

``fused_gram.kgrad_sym_plan`` cuts B5's upper triangle into the segments
csrc/kgrad_sym.cu's blocks walk, and sizes the packed operands and the
partial sums; ``fused_gram.kgrad_dense_plan`` does the same for B4 (the
same strips, csrc/kgrad_strips.cuh, an even share of the walk per block);
``fused_gram.kmv_dense_plan`` picks B2's design and its split.
The tests below walk the plan as the kernel does (the same index formulas, in
numpy), lay the operands out as its prep grid does and contract them tile by
tile from that layout, and hold the result against the plain version. The
kernels themselves run only on the card (tests/test_torch_cuda_kernels.py).

On CPU tensors ``kmv_dense`` and ``kgrad_sym`` take their plain versions,
which are held here against the JAX package's ``pallas_kmv`` / ``pallas_kgrad``
in interpret mode on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.ops.pallas_gram import pallas_kgrad, pallas_kmv
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from torch_parity import t32, t64

T = fused_gram.TILE


def _tile_at(plan, t):
    """Tile t of the walk's sequence, as csrc/kgrad_strips.cuh's tile_at
    derives it: strip pairs (p, nb - 1 - p), nb + 1 tiles a pair."""
    nb = plan.nb
    p, off = divmod(t, nb + 1)
    if off >= nb - p:
        return nb - 1 - p, nb - 1 - p + off - (nb - p)
    return p, p + off


def _walk(plan, b, s):
    """The (strip, column tile) pairs of block (b, s), in order, as
    kgrad_strips_kernel derives them: segment s of pair b (``per`` > 0),
    else block b's even share of the whole walk."""
    nb = plan.nb
    if plan.per:
        length = nb + 1 if nb - 1 - b > b else nb - b
        t0, t1 = (b * (nb + 1) + min(length, k * plan.per) for k in (s, s + 1))
    else:
        total = nb * (nb + 1) // 2
        t0, t1 = total * b // plan.groups, total * (b + 1) // plan.groups
    return [_tile_at(plan, t) for t in range(t0, t1)]


@pytest.mark.parametrize("n", [1, 64, 65, 2003, 3585, 5003, 49_152])
@pytest.mark.parametrize("per", [None, 1, 7, 10_000])
def test_kgrad_sym_plan_visits_each_upper_tile_once(n, per):
    plan = fused_gram.kgrad_sym_plan(n, 8, 16, per=per)
    assert plan.nb == -(-n // T) and plan.groups == (plan.nb + 1) // 2
    assert plan.segs * plan.per >= plan.nb + 1 > (plan.segs - 1) * plan.per
    seen = {}
    for p in range(plan.groups):
        tiles = [tile for s in range(plan.segs) for tile in _walk(plan, p, s)]
        # balanced: every pair of strips walks nb + 1 tiles, the middle strip
        # of an odd count half of that
        assert len(tiles) == (plan.nb + 1 if plan.nb - 1 - p > p else (plan.nb + 1) // 2)
        for tile in tiles:
            seen[tile] = seen.get(tile, 0) + 1
    want = {(i, j) for i in range(plan.nb) for j in range(i, plan.nb)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("n, d, m", [(49_152, 8, 16), (3585, 8, 16), (5003, 1, 1), (5003, 20, 7),
                                     (2003, 128, 16), (2003, 8, 128), (300, 128, 128)])
def test_kgrad_sym_plan_scratch_and_shared_memory(n, d, m):
    plan = fused_gram.kgrad_sym_plan(n, d, m)
    assert plan.dp % 8 == 0 and d <= plan.dp < d + 8
    assert plan.fields == plan.dp + 2 * m + 1
    assert plan.pack == plan.nb * plan.fields * T          # one packed block per strip
    assert plan.partial == (1 + plan.dp) * plan.groups * plan.segs
    assert plan.grids == 3
    # the row side and the ring fit one block's shared memory; the ring is
    # three deep only while four such blocks fit an SM
    tile_bytes = plan.fields * T * 4
    assert 1 <= plan.stages <= 3
    assert (1 + plan.stages) * tile_bytes <= fused_gram.SMEM_BYTES
    assert (plan.stages == 3) == (16 * tile_bytes <= fused_gram.SMEM_BYTES)


def test_kgrad_sym_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        fused_gram.kgrad_sym_plan(300, 128, 128 + 64)


@pytest.mark.parametrize("sms", [132, 108])
def test_kgrad_sym_plan_fills_the_card(sms):
    # the training shape: KGRAD_DEPTH blocks per SM, a few percent of tail
    plan = fused_gram.kgrad_sym_plan(49_152, 8, 16, sms=sms)
    blocks = plan.groups * plan.segs
    assert fused_gram.KGRAD_DEPTH * sms <= blocks < 1.1 * fused_gram.KGRAD_DEPTH * sms
    # the smallest N that reaches B5: still three blocks per SM, of at least
    # KGRAD_MIN_TILES tiles
    small = fused_gram.kgrad_sym_plan(3585, 8, 16, sms=sms)
    assert small.per == fused_gram.KGRAD_MIN_TILES
    assert small.groups * small.segs >= 3 * sms


@pytest.mark.parametrize("sms", [132, 108, 7, 1])
@pytest.mark.parametrize("n", [1, 64, 2003, 3001, 3072, 3584])
def test_kgrad_dense_plan_visits_each_tile_once(n, sms):
    """Each upper tile once (its mirror by the folded cotangent), whatever
    the number of blocks; every block's share is the same to within one
    tile, and a share may cross from one strip pair into the next."""
    plan = fused_gram.kgrad_dense_plan(n, 8, 16, sms)
    assert plan.nb == -(-n // T)
    assert (plan.segs, plan.per) == (1, 0)
    seen, shares = {}, []
    for b in range(plan.groups):
        tiles = _walk(plan, b, 0)
        shares.append(len(tiles))
        for tile in tiles:
            seen[tile] = seen.get(tile, 0) + 1
    want = {(i, j) for i in range(plan.nb) for j in range(i, plan.nb)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert min(shares) >= 1 and max(shares) - min(shares) <= 1


@pytest.mark.parametrize("sms", [132, 114, 108, 66])
def test_kgrad_dense_plan_fills_the_card_at_its_path_shape(sms):
    # N = 3,072 (48 strips): KGRAD_DENSE_PER_SM blocks on every SM, at least two
    plan = fused_gram.kgrad_dense_plan(3072, 8, 16, sms)
    assert plan.groups == fused_gram.KGRAD_DENSE_PER_SM * sms >= 2 * sms
    assert fused_gram.kgrad_dense_plan(64, 8, 16, sms).groups == 1


@pytest.mark.parametrize("n, d, m", [(3072, 8, 16), (3584, 8, 16), (3001, 8, 16), (1, 8, 16),
                                     (64, 8, 16), (2003, 1, 1), (2003, 20, 7), (2003, 9, 16),
                                     (1999, 33, 3), (300, 128, 16), (300, 8, 128),
                                     (300, 100, 100), (300, 128, 128), (3584, 64, 64)])
def test_kgrad_dense_plan_scratch_and_shared_memory(n, d, m):
    plan = fused_gram.kgrad_dense_plan(n, d, m)
    assert plan.dp % 8 == 0 and d <= plan.dp < d + 8
    assert plan.fields == plan.dp + 2 * m + 1
    assert plan.pack == plan.nb * plan.fields * T
    assert plan.partial == (1 + plan.dp) * plan.groups
    assert plan.grids == 3
    tile_bytes = plan.fields * T * 4
    assert 1 <= plan.stages <= 3
    assert (1 + plan.stages) * tile_bytes <= fused_gram.SMEM_BYTES
    assert (plan.stages == 3) == (16 * tile_bytes <= fused_gram.SMEM_BYTES)


def test_kgrad_dense_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="kgrad_dense.*shared memory"):
        fused_gram.kgrad_dense_plan(300, 128, 128 + 64)


def test_kgrad_sym_takes_segmented_plans_only():
    x = torch.zeros((10, 2))
    w = torch.zeros((10, 3))
    params = {"log_variance": torch.tensor(0.0), "log_lengthscales": torch.zeros(2)}
    with pytest.raises(ValueError, match="strip pairs in segments"):
        fused_gram._kgrad_cuda(True, "RBF", params, x, w, w, w[:, 0].contiguous(), 1.0, 1 / 3,
                               plan=fused_gram.kgrad_dense_plan(10, 2, 3))


def _f_fp(kernel, r2):
    """f(u) and f'(u) of csrc/stationary.cuh's f_fp, in float64."""
    if kernel == "RBF":
        f = np.exp(-0.5 * r2)
        return f, -0.5 * f
    r = np.sqrt(np.maximum(r2, 1e-36))
    inv2r = np.where(r2 > 1e-12, 0.5 / r, 0.0)
    if kernel == "Matern12":
        f = np.exp(-r)
        return f, -f * inv2r
    if kernel == "Matern32":
        e = np.exp(-np.sqrt(3.0) * r)
        return (1.0 + np.sqrt(3.0) * r) * e, -1.5 * e
    if kernel == "Matern52":
        s5r = np.sqrt(5.0) * r
        e = np.exp(-s5r)
        return (1.0 + s5r + 5.0 / 3.0 * r2) * e, -(5.0 / 6.0) * (1.0 + s5r) * e
    f = np.exp(-0.5 * r)  # Exponential
    return f, -0.5 * f * inv2r


def _pack(plan, x_scaled, w, z, alpha, d, m):
    """pack[tile][field][64] as kgrad_pack_kernel lays it out."""
    n = x_scaled.shape[0]
    pack = np.zeros((plan.nb, plan.fields, T))
    for e in range(plan.nb * T):
        if e >= n:
            break
        t, r = divmod(e, T)
        pack[t, :d, r] = x_scaled[e]
        pack[t, plan.dp:plan.dp + m, r] = w[e]
        pack[t, plan.dp + m:plan.dp + 2 * m, r] = z[e]
        pack[t, plan.dp + 2 * m, r] = alpha[e]
    return pack


def _tile_sums(kernel, plan, rows, cols, mirror, d, m, q0, inv_m):
    """One tile's nine sums from two packed blocks, as tile_sums computes
    them: the folded depth-2m dot on a mirror tile, per-entry differences."""
    dp = plan.dp
    depth = 2 * m if mirror else m
    kb = np.zeros((T, T))
    for k in range(depth):
        kb += np.outer(rows[dp + k], cols[dp + (k + m if k < m else k - m)])
    kb = inv_m * kb - (2.0 if mirror else 1.0) * np.outer(rows[dp + 2 * m], cols[dp + 2 * m])
    diff = rows[:dp, :, None] - cols[:dp, None, :]
    f, fp = _f_fp(kernel, np.sum(diff[:d] ** 2, axis=0))
    sums = np.zeros(9)
    sums[0] = np.sum(kb * f)
    for k in range(8):
        sums[1 + k] = np.sum(kb * fp * diff[q0 + k] ** 2)
    return sums


@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
@pytest.mark.parametrize("n, d, m, per, walk", [
    (333, 3, 4, None, "sym"), (200, 11, 2, 2, "sym"), (129, 8, 1, 1, "sym"),
    (333, 3, 4, 3, "dense"), (200, 11, 2, 3, "dense"), (129, 8, 1, 1, "dense")])
def test_packed_strips_emulation_matches_plain(kernel, n, d, m, per, walk):
    """The whole data flow of B5 (``sym``) and of B4 (``dense``) in numpy,
    float64: pack, walk every block of the plan, sum each block's tiles
    (folded cotangent on a tile j > i), write its partials where the kernel
    does, add the slots, scale; against
    ``kgrad_plain``. Coincident points (every tenth point repeats its
    neighbour) keep the 1e-12 guard in play."""
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d))
    x[::10] = x[1::10][:len(x[::10])]
    w = rng.normal(size=(n, m))
    z = rng.choice([-1.0, 1.0], size=(n, m))
    alpha = rng.normal(size=n)
    params = {"log_variance": np.float64(0.3), "log_lengthscales": np.log(rng.uniform(0.5, 2, d))}
    g, inv_m = 1.7, 1.0 / m
    if walk == "sym":
        plan = fused_gram.kgrad_sym_plan(n, d, m, per=per)
    else:  # here ``per`` is the number of SMs, of three blocks each
        plan = fused_gram.kgrad_dense_plan(n, d, m, sms=per)
    pack = _pack(plan, x / np.exp(params["log_lengthscales"]), w, z, alpha, d, m)
    slots = plan.groups * plan.segs
    partial = np.full((1 + plan.dp, slots), np.nan)
    for zc in range(plan.dp // 8):
        for p in range(plan.groups):
            for s in range(plan.segs):
                sums = np.zeros(9)
                for i, j in _walk(plan, p, s):
                    sums += _tile_sums(kernel, plan, pack[i], pack[j], j > i, d, m, 8 * zc,
                                       inv_m)
                slot = p * plan.segs + s
                if zc == 0:
                    partial[0, slot] = sums[0]
                for k in range(8):
                    if 8 * zc + k < d:
                        partial[1 + 8 * zc + k, slot] = sums[1 + k]
    assert np.isfinite(partial[:d + 1]).all()  # every slot the sum reads was written
    scale = 0.5 * g * np.exp(params["log_variance"])
    got = partial[:d + 1].sum(axis=1) * scale * np.array([1.0] + [-2.0] * d)
    want = fused_gram.kgrad_plain(kernel, {k: t64(v) for k, v in params.items()}, t64(x), t64(w),
                                  t64(z), t64(alpha), g, inv_m)
    want = np.concatenate([[float(want["log_variance"])], want["log_lengthscales"].numpy()])
    # float64 on both sides, sums in another order. The plain version expands
    # r2 = a2 + b2 - 2ab, which at the coincident pairs rounds to ~1e-16 where
    # the per-entry differences give 0; Matern12 and Exponential are linear
    # in r there (f changes by ~1e-8), the others quadratic
    rtol = 1e-6 if kernel in ("Matern12", "Exponential") else 1e-10
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# ------------------------------------------------------------------ B2


@pytest.mark.parametrize("n1, n2, r, rows", [
    (64, 49_152, 1, True), (256, 49_152, 1, True), (256, 49_152, 16, True),
    (1, 5003, 7, True), (300, 2003, 3, True), (4999, 3001, 1, True),
    (256, 49_152, 17, False),                  # more right-hand sides than a thread holds
    (64 * 264, 49_152, 1, False),              # two row tiles per SM fill the card alone
    (64 * 263, 49_152, 1, True), (49_152, 49_152, 64, False)])
def test_kmv_dense_plan_picks_the_design_by_shape(n1, n2, r, rows):
    plan = fused_gram.kmv_dense_plan(n1, n2, r, sms=132)
    assert plan.rows == rows
    stages = -(-n2 // T)
    assert 1 <= plan.splits <= stages
    assert plan.parts == (plan.splits * n1 * r if plan.splits > 1 else 0)
    assert plan.grids == (2 if plan.splits > 1 else 1)
    if rows:
        # whole 64-point stages per chunk, none empty (csrc/kmv.cu derives
        # `per` from the split the same way), and ROWS_DEPTH blocks per SM
        # unless the sweep is too short to cut that finely
        per = -(-stages // plan.splits)
        assert (plan.splits - 1) * per < stages <= plan.splits * per
        blocks = plan.splits * -(-n1 // T)
        assert blocks >= fused_gram.ROWS_DEPTH * 132 / 2 or per == 1


def test_kmv_dense_plan_at_the_serving_shapes():
    # a 256-query bucket: 4 row groups x 384 chunks of two stages; a 64-query
    # bucket: every stage its own chunk
    assert fused_gram.kmv_dense_plan(256, 49_152, 1, sms=132)[:2] == (True, 384)
    assert fused_gram.kmv_dense_plan(64, 49_152, 1, sms=132)[:2] == (True, 768)


def test_rows_design_sum_order_is_more_exact_than_one_accumulator():
    """The rows design sums 64 x per terms in a register, then each output's
    slots: lane l adds slots l, l + 32, ... and a butterfly joins the lanes.
    In float32 on 49,152 terms of one sign that order misses the float64 sum
    by less than a single running accumulator does."""
    rng = np.random.default_rng(5)
    terms = rng.uniform(0.0, 1.0, 49_152).astype(np.float32)
    plan = fused_gram.kmv_dense_plan(256, 49_152, 1, sms=132)
    per = -(-768 // plan.splits) * T
    slots = np.array([np.cumsum(terms[k * per:(k + 1) * per], dtype=np.float32)[-1]
                      for k in range(plan.splits)], np.float32)
    lanes = np.zeros(32, np.float32)
    for k, val in enumerate(slots):
        lanes[k % 32] = np.float32(lanes[k % 32] + val)
    off = 16
    while off:
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
        off //= 2
    assert len(set(lanes.tolist())) == 1  # every lane holds the same total
    exact = terms.astype(np.float64).sum()
    one = np.cumsum(terms, dtype=np.float32)[-1]
    assert abs(lanes[0] - exact) < 0.25 * abs(one - exact)
    assert abs(lanes[0] - exact) <= 2e-7 * exact


# ------------------------------------------- CPU tensors: the plain versions


def _case(n1, n2, d, r, seed):
    rng = np.random.default_rng(seed)
    params = {"log_variance": np.float32(0.3),
              "log_lengthscales": np.log(rng.uniform(0.5, 2.0, d)).astype(np.float32)}
    return (params, rng.normal(size=(n1, d)).astype(np.float32),
            rng.normal(size=(n2, d)).astype(np.float32),
            rng.normal(size=(n2, r)).astype(np.float32))


@pytest.mark.parametrize("n1, r", [(64, 1), (256, 1), (17, 16)])
@pytest.mark.parametrize("kernel", ["Matern52", "Matern12"])
def test_kmv_dense_on_cpu_matches_pallas_interpret(kernel, n1, r):
    """The shapes the rows design serves on the card (few queries, R <= 16),
    through the wrapper on CPU tensors, against ``pallas_kmv`` in interpret
    mode. float32 on both sides; the Pallas body contracts in bf16x3
    (~2^-16 per product): tests/test_torch_fused_gram.py's bounds."""
    params, x1, x2, v = _case(n1, 700, 4, r, seed=n1 + r)
    launches = fused_gram.kmv_dense.launches
    got = fused_gram.kmv_dense(kernel, {k: torch.as_tensor(a) for k, a in params.items()},
                               t32(x1), t32(v), x2=t32(x2))
    want = np.asarray(pallas_kmv(kernel, {k: jnp.asarray(a) for k, a in params.items()},
                                 jnp.asarray(x1), jnp.asarray(v), x2=jnp.asarray(x2),
                                 interpret=True, tile_m=128, tile_n=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5 * np.abs(want).max())
    assert fused_gram.kmv_dense.launches == launches  # a CPU tensor takes the plain version


@pytest.mark.parametrize("kernel", ["Matern52", "RBF", "Exponential"])
def test_kgrad_sym_on_cpu_matches_pallas_interpret(kernel):
    """``kgrad_sym`` on CPU tensors (float64 on the float32 inputs) against
    ``pallas_kgrad``'s symmetric body in interpret mode; the reference's own
    tolerances (tests/test_kernels.py:172-180: the Pallas body expands
    (a - b)^2 and contracts in bf16_3x)."""
    rng = np.random.default_rng(3)
    n, d, m = 640, 4, 8
    params = {"log_variance": np.float32(0.2),
              "log_lengthscales": np.log(rng.uniform(0.5, 2.0, d)).astype(np.float32)}
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(n, m)).astype(np.float32)
    z = rng.choice([-1.0, 1.0], size=(n, m)).astype(np.float32)
    alpha = rng.normal(size=n).astype(np.float32)
    launches = fused_gram.kgrad_sym.launches
    got = fused_gram.kgrad_sym(kernel, {k: t64(v) for k, v in params.items()}, t64(x), t64(w),
                               t64(z), t64(alpha), 1.7, 1.0 / m)
    want = pallas_kgrad(kernel, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                        jnp.asarray(w), jnp.asarray(z), jnp.asarray(alpha), g=1.7, inv_m=1.0 / m,
                        interpret=True, tile=128, sym=True)
    np.testing.assert_allclose(float(got["log_variance"]), float(want["log_variance"]), rtol=5e-3)
    gl = got["log_lengthscales"].numpy()
    np.testing.assert_allclose(np.asarray(want["log_lengthscales"], np.float64), gl,
                               atol=8e-3 * max(np.abs(gl).max(), 1e-3), rtol=5e-3)
    assert fused_gram.kgrad_sym.launches == launches


def test_scalar_arguments_never_read_a_device_tensor_on_the_host():
    """A number or a CPU tensor goes to the kernel by value; None is 0."""
    dev = torch.device("cpu")
    assert fused_gram._scalar_arg(None, dev) == (None, 0.0)
    assert fused_gram._scalar_arg(0.25, dev) == (None, 0.25)
    assert fused_gram._scalar_arg(torch.tensor(0.5, dtype=torch.float64), dev) == (None, 0.5)


def test_kernel_args_checks_stay():
    params = {"log_variance": torch.tensor(0.0), "log_lengthscales": torch.zeros(3)}
    x, v = torch.zeros((5, 3)), torch.zeros((5, 2))
    hyp = fused_gram._kernel_args("RBF", params, (x,), (v,))
    assert (hyp.kid, hyp.ls_stride) == (0, 1)
    wide = torch.zeros(6)
    assert fused_gram._kernel_args("RBF", {**params, "log_lengthscales": wide[::2]},
                                   (x,)).ls_stride == 2
    assert fused_gram._kernel_args("RBF", {**params, "log_lengthscales": torch.tensor(0.0)},
                                   (x,)).ls_stride == 0
    with pytest.raises(ValueError, match="log_lengthscales"):
        fused_gram._kernel_args("RBF", {**params, "log_lengthscales": torch.zeros(2)}, (x,))
    with pytest.raises(TypeError):
        fused_gram._kernel_args("RBF", params, (x.double(),))
    with pytest.raises(ValueError, match="contiguous"):
        fused_gram._kernel_args("RBF", params, (x,), (v.t().contiguous().t(),))
    with pytest.raises(ValueError, match="2-D"):
        fused_gram._kernel_args("RBF", params, (x[0],))
    with pytest.raises(ValueError, match="support"):
        fused_gram._kernel_args("Linear", params, (x,))
    with pytest.raises(ValueError, match="input dimension"):
        fused_gram._kernel_args("RBF", params, (torch.zeros((5, 0)),))
