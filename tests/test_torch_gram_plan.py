"""What of B1's symmetric Hopper design lives in Python, on the CPU.

``fused_gram.gram_plan`` sizes csrc/gram.cu's persistent grid: the tile
sequence its blocks walk (the upper triangle of 64 x 64 tiles, enumerated by
strip pairs, when the Gram is square; every tile otherwise), the packed
points' scratch and the shared memory of a block. The tests below walk the
plan with the kernel's own index formulas (in numpy), check the staged
output tile's row layout (alignment for the 16-byte stores, bank groups of
the transposed writes), and replay the kernel's data flow, through either
way out of shared memory, in float64 against the plain version. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py holds it to the first design bit for bit).

On CPU tensors ``gram`` takes its plain version, held here against the JAX
package's ``pallas_gram`` in interpret mode on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.ops.pallas_gram import pallas_gram
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.ops import kernels as K
from torch_parity import t32, t64

T = fused_gram.TILE


def _tiles(plan, square):
    """(ti, tj) of every tile of the sequence, as gram_sym_kernel's coords()
    derives them (upper_tile when square, row by row otherwise)."""
    t = np.arange(plan.tiles, dtype=np.int64)
    if not square:
        return t // plan.nb2, t % plan.nb2
    nb = plan.nb1
    p = t // (nb + 1)
    off = t - p * (nb + 1)
    len0 = nb - p
    first = off < len0
    ti = np.where(first, p, nb - 1 - p)
    tj = np.where(first, p + off, nb - 1 - p + off - len0)
    return ti, tj


STORES = (fused_gram.GRAM_STORE_SCALAR, fused_gram.GRAM_STORE_VECTOR)


def _obuf_at(r, c):
    """csrc/gram.cu's obuf_at: float offset of row r, column c of a staged
    tile, rows of 64 skewed by 4 floats every 4 rows."""
    return r * T + 4 * (r >> 2) + c


@pytest.mark.parametrize("sms", [1, 7, 108, 132])
@pytest.mark.parametrize("n1, n2", [(1, None), (63, None), (64, None), (65, None), (127, None),
                                    (128, None), (129, None), (2003, None), (5003, None),
                                    (49_152, None), (4999, 3001), (1, 5), (65, 64), (300, 2051)])
def test_gram_plan_covers_every_output_tile_once(n1, n2, sms):
    square = n2 is None
    n2 = n1 if square else n2
    plan = fused_gram.gram_plan(n1, n2, 8, square, sms)
    assert (plan.nb1, plan.nb2) == (-(-n1 // T), -(-n2 // T))
    ti, tj = _tiles(plan, square)
    written = np.zeros((plan.nb1, plan.nb2), np.int64)
    np.add.at(written, (ti, tj), 1)
    if square:
        assert (ti <= tj).all()
        off = ti != tj
        np.add.at(written, (tj[off], ti[off]), 1)  # the mirror of each off-diagonal tile
    assert (written == 1).all()
    # block b walks tiles b, b + blocks, ...: every block has work, and the
    # shares differ by at most one tile
    assert 1 <= plan.blocks <= min(plan.tiles, fused_gram.GRAM_MAX_PER_SM * sms)
    share = np.bincount(np.arange(plan.tiles) % plan.blocks, minlength=plan.blocks)
    assert share.min() >= 1 and share.max() - share.min() <= 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [1, 8, 20, 64, 128, 193])
def test_gram_plan_scratch_and_shared_memory(d, aligned):
    shapes = ((2003, 2004, False), (4999, 3000, False), (2004, 2004, True)) if aligned else \
        ((2004, 2003, False), (4999, 3001, False), (2003, 2003, True))
    for n1, n2, square in shapes:
        plan = fused_gram.gram_plan(n1, n2, d, square)
        assert plan.fields == d + 1
        assert plan.store == (fused_gram.GRAM_STORE_VECTOR if aligned
                              else fused_gram.GRAM_STORE_SCALAR)
        assert plan.pack == (plan.nb1 + (0 if square else plan.nb2)) * (d + 1) * T
        assert plan.grids == (2 if square else 3)
        # the tile and its mirror staged, and two input stages of both sides
        # (up to STAGED_DIM coordinates and the norm), fit one block; as many
        # blocks an SM as fit together, at most the launch bounds' three
        assert plan.staged == min(d, fused_gram.STAGED_DIM)
        assert plan.smem == 4 * (2 * fused_gram.GRAM_OBUF + 4 * (plan.staged + 1) * T)
        assert plan.smem <= fused_gram.SMEM_BYTES
        per_sm = plan.blocks // 132
        assert 1 <= per_sm <= fused_gram.GRAM_MAX_PER_SM
        assert per_sm * (plan.smem + 1024) <= fused_gram.SM_SMEM_BYTES
        assert per_sm == fused_gram.GRAM_MAX_PER_SM or \
            (per_sm + 1) * (plan.smem + 1024) > fused_gram.SM_SMEM_BYTES


def test_gram_plan_at_the_training_shape():
    plan = fused_gram.gram_plan(49_152, 49_152, 8, True)
    assert (plan.tiles, plan.blocks, plan.store) == (295_296, 396, fused_gram.GRAM_STORE_VECTOR)


@pytest.mark.parametrize("n2, aligned", [(49_152, True), (2048, True), (2052, True), (2049, False),
                                         (2050, False), (2051, False), (1001, False)])
def test_gram_plan_takes_16_byte_stores_only_for_aligned_rows(n2, aligned):
    store = fused_gram.gram_plan(64, n2, 8, False).store
    assert store == (fused_gram.GRAM_STORE_VECTOR if aligned else fused_gram.GRAM_STORE_SCALAR)


def test_gram_plan_refuses_a_square_of_two_sizes():
    with pytest.raises(ValueError, match="square"):
        fused_gram.gram_plan(64, 65, 8, True)


@pytest.mark.parametrize("square", [True, False])
def test_gram_plan_refuses_what_shared_memory_cannot_hold(square):
    # a whole record of D = 194 would not fit a block's 227 KB; the planned
    # design stages STAGED_DIM coordinates and reads the rest from the packed
    # points, so it takes any D, while the first design, kept as a timing
    # yardstick, stages every coordinate and refuses past 128 by name, before
    # any launch
    plan = fused_gram.gram_plan(2048, 2048, 194, square)
    assert plan.staged == fused_gram.STAGED_DIM and plan.smem <= fused_gram.SMEM_BYTES
    params = {"log_variance": torch.tensor(0.0), "log_lengthscales": torch.zeros(194)}
    x = torch.zeros((64, 194))
    with pytest.raises(ValueError, match="first design"):
        fused_gram._gram_cuda("RBF", params, x, None if square else x, 0.1, tiles=True)


def test_staged_tile_layout_keeps_rows_whole():
    """Every (row, 16-byte chunk) of a tile has its own 16-byte aligned
    place inside the buffer, a row's 64 floats in order."""
    places = {}
    for r in range(T):
        for c in range(0, T, 4):
            at = _obuf_at(r, c)
            assert at % 4 == 0 and 0 <= at < fused_gram.GRAM_OBUF
            assert at == _obuf_at(r, 0) + c
            places[at] = (r, c)
    assert len(places) == T * T // 4


@pytest.mark.parametrize("access", ["tile", "mirror", "16-byte reads"])
def test_staged_writes_hit_distinct_bank_groups(access):
    """A float4 access of a warp is served a quarter-warp (8 lanes) at a
    time; it is free of bank conflicts when the 8 lanes' 16-byte chunks fall
    in 8 distinct groups of 4 banks. Thread (ty, tx) = (tid >> 4, tid & 15)
    writes rows 4 ty + k at column 4 tx; its mirror writes go at step k to
    row 4 tx + k, column 4 ty; the 16-byte streaming stores read element
    e = tid + 256 k at row e / 16, column 4 (e % 16)."""
    for warp in range(8):
        for quarter in range(4):
            tids = np.arange(8) + 8 * quarter + 32 * warp
            ty, tx = tids >> 4, tids & 15
            for k in range(4):
                if access == "tile":
                    words = [_obuf_at(4 * a + k, 4 * b) for a, b in zip(ty, tx)]
                elif access == "mirror":
                    words = [_obuf_at(4 * b + k, 4 * a) for a, b in zip(ty, tx)]
                else:
                    words = [_obuf_at(v >> 4, 4 * (v & 15)) for v in tids + 256 * k]
                assert len({(w // 4) % 8 for w in words}) == 8


def _cov(kernel, r2, var):
    """csrc/stationary.cuh's covariance(), in float64."""
    if kernel == "RBF":
        return var * np.exp(-0.5 * r2)
    r = np.sqrt(np.maximum(r2, 1e-36))
    if kernel == "Matern12":
        return var * np.exp(-r)
    if kernel == "Matern32":
        return var * (1 + np.sqrt(3.0) * r) * np.exp(-np.sqrt(3.0) * r)
    if kernel == "Matern52":
        return var * (1 + np.sqrt(5.0) * r + 5.0 / 3.0 * r2) * np.exp(-np.sqrt(5.0) * r)
    return var * np.exp(-0.5 * r)


@pytest.mark.parametrize("kernel", K.STATIONARY_KERNELS)
@pytest.mark.parametrize("n1, n2", [(130, None), (131, None), (132, None), (200, None),
                                    (200, 131), (200, 132)])
def test_symmetric_walk_emulation_matches_plain(kernel, n1, n2):
    """B1's data flow in float64: the pack grid (coordinates divided by the
    lengthscales, then the squared norm, zeros past N), each tile of the
    plan's walk from two packed blocks, its entries staged in the skewed
    buffer with (square, off the diagonal) their transpose, written out as
    the plan's stores write them (16-byte chunks, 16 lanes a row, when
    N2 % 4 == 0; else one float a lane, a warp a row or a mirror row) and
    clipped at the ragged edges; noise on the global diagonal."""
    rng = np.random.default_rng(n1 + (n2 or 0))
    square = n2 is None
    n2v = n1 if square else n2
    d = 3
    x1 = rng.normal(size=(n1, d))
    x2 = x1 if square else rng.normal(size=(n2v, d))
    params = {"log_variance": np.float64(0.4), "log_lengthscales": np.log(rng.uniform(0.5, 2, d))}
    var, ls, noise = np.exp(params["log_variance"]), np.exp(params["log_lengthscales"]), 0.3
    plan = fused_gram.gram_plan(n1, n2v, d, square, sms=3)
    assert plan.store == STORES[n2v % 4 == 0]

    def pack(x, nb):
        out = np.zeros((nb, d + 1, T))
        for g in range(x.shape[0]):
            s = x[g] / ls
            out[g // T, :d, g % T] = s
            out[g // T, d, g % T] = np.sum(s * s)
        return out

    pa = pack(x1, plan.nb1)
    pb = pa if square else pack(x2, plan.nb2)
    got = np.full((n1, n2v), np.nan)
    for ti, tj in zip(*_tiles(plan, square)):
        rows, cols = pa[ti], pb[tj]
        r2 = np.maximum(rows[d][:, None] + cols[d][None, :] - 2 * rows[:d].T @ cols[:d], 0.0)
        tile = _cov(kernel, r2, var)
        row0, col0 = ti * T, tj * T
        if square:
            gr, gc = np.meshgrid(row0 + np.arange(T), col0 + np.arange(T), indexing="ij")
            tile = tile + noise * (gr == gc)
        mirror = square and ti != tj
        staged = np.zeros(fused_gram.GRAM_OBUF)
        staged_t = np.zeros(fused_gram.GRAM_OBUF)
        for r in range(T):
            for c in range(0, T, 4):
                staged[_obuf_at(r, c):_obuf_at(r, c) + 4] = tile[r, c:c + 4]
                staged_t[_obuf_at(r, c):_obuf_at(r, c) + 4] = tile[c:c + 4, r]
        nr, nc = min(T, n1 - row0), min(T, n2v - col0)
        if plan.store == fused_gram.GRAM_STORE_VECTOR:
            for e in range(T * T // 4):
                r, c = e >> 4, 4 * (e & 15)
                if r < nr and c < nc:
                    got[row0 + r, col0 + c:col0 + c + 4] = staged[_obuf_at(r, c):][:4]
                if mirror and r < nc and c < nr:
                    got[col0 + r, row0 + c:row0 + c + 4] = staged_t[_obuf_at(r, c):][:4]
        else:
            for r in range(nr):
                for c in range(nc):
                    got[row0 + r, col0 + c] = staged[_obuf_at(r, c)]
            if mirror:
                for c in range(nc):
                    for r in range(nr):
                        got[col0 + c, row0 + r] = staged_t[_obuf_at(c, r)]
    want = fused_gram.gram_plain(kernel, {k: t64(v) for k, v in params.items()}, t64(x1),
                                 None if square else t64(x2), noise if square else None).numpy()
    assert np.isfinite(got).all()  # every entry written
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kernel", ["Matern52", "RBF", "Matern32"])
@pytest.mark.parametrize("n2", [None, 300])
def test_gram_on_cpu_matches_pallas_interpret(kernel, n2):
    """``gram`` on CPU tensors (float32) against ``pallas_gram`` in
    interpret mode on the same inputs; square with noise and cross. The
    Pallas body forms r2 = a2 + b2 - 2ab with its dot in bf16x3 (~2^-16 per
    product): tests/test_torch_fused_gram.py's bounds."""
    rng = np.random.default_rng(11)
    d = 4
    params = {"log_variance": np.float32(0.3),
              "log_lengthscales": np.log(rng.uniform(0.5, 2.0, d)).astype(np.float32)}
    x1 = rng.normal(size=(200, d)).astype(np.float32)
    x2 = None if n2 is None else rng.normal(size=(n2, d)).astype(np.float32)
    noise = 0.1 if n2 is None else None
    launches = fused_gram.gram.launches
    got = fused_gram.gram(kernel, {k: torch.as_tensor(v) for k, v in params.items()}, t32(x1),
                          None if x2 is None else t32(x2), noise=noise)
    want = np.asarray(pallas_gram(kernel, {k: jnp.asarray(v) for k, v in params.items()},
                                  jnp.asarray(x1), None if x2 is None else jnp.asarray(x2),
                                  noise=None if noise is None else jnp.float32(noise),
                                  interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5 * np.abs(want).max())
    assert fused_gram.gram.launches == launches  # a CPU tensor takes the plain version
