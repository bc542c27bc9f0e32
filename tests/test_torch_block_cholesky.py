"""The port's blocked and in-place factorizations (gpras_tpu_torch/ops/
block_cholesky.py, ops/linalg.tri_inverse) and the Hutchinson engine's
factorization knobs against the JAX package's, on the same seeded numpy
inputs, in float64 unless a case says float32.

Every case of tests/test_block_cholesky.py, each held against numpy as the
reference test holds it and against the JAX function (1e-10 relative in
float64); ``super_cholesky`` also runs in place (the result shares the
input's storage) and reads nothing above the diagonal, with ``zero_upper``
either way; ``default_chol_config`` returns the reference's dict. Strips
wider than ``SPLIT`` are cut to whole panels: held to numpy (and once to the
JAX function) at shapes where that happens, and the ``addmm_`` products the
walk issues are recorded on meta tensors at the cells' layouts, where
nothing is computed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpras_tpu.gp import exact_stochastic as JS
from gpras_tpu.ops import block_cholesky as JB
from gpras_tpu.ops import linalg as JL
from gpras_tpu_torch.gp import exact_stochastic as TS
from gpras_tpu_torch.ops import block_cholesky as TB
from gpras_tpu_torch.ops import linalg as TL
from torch_parity import t32, t64

#: float64, the same factorization in another order of operations
RTOL = 1e-10


def make_spd(n=96, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("b", [8, 16, 32, 96])
def test_blocked_cholesky_matches_dense(b):
    k = make_spd()
    got = TB.blocked_cholesky(t64(k), b)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)
    _close(got, JB.blocked_cholesky(jnp.asarray(k), b))


def test_blocked_cholesky_reads_only_the_lower_triangle():
    k = make_spd(seed=5)
    stale = k + np.triu(np.random.default_rng(6).normal(size=k.shape) * 100.0, 1)
    kt = t64(stale)
    got = TB.blocked_cholesky(kt, 16)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(kt.numpy(), stale)  # a copy: the input is left as it is


def test_blocked_solves_match_dense():
    k = make_spd(seed=1)
    rng = np.random.default_rng(2)
    rhs = rng.normal(size=(96, 5))
    l = TB.blocked_cholesky(t64(k), 16)
    jl = JB.blocked_cholesky(jnp.asarray(k), 16)
    ln = l.numpy()
    y = TB.blocked_solve_lower(l, t64(rhs), 16)
    np.testing.assert_allclose(y.numpy(), np.linalg.solve(ln, rhs), rtol=1e-8, atol=1e-8)
    _close(y, JB.blocked_solve_lower(jl, jnp.asarray(rhs), 16))
    x = TB.blocked_solve_upper(l, y, 16)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(ln.T, y.numpy()), rtol=1e-8,
                               atol=1e-8)
    _close(x, JB.blocked_solve_upper(jl, jnp.asarray(y.numpy()), 16))
    want = np.linalg.solve(k, rhs)
    got = TB.blocked_cho_solve(l, t64(rhs), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)
    _close(got, JB.blocked_cho_solve(jl, jnp.asarray(rhs), 16))
    # the 1-D right-hand side, and a target block that does not divide N
    got1 = TB.blocked_cho_solve(l, t64(rhs[:, 0]), 16)
    np.testing.assert_allclose(got1.numpy(), want[:, 0], rtol=1e-7, atol=1e-7)
    _close(TB.blocked_cho_solve(l, t64(rhs), 40), JB.blocked_cho_solve(jl, jnp.asarray(rhs), 40))


def test_blocked_solves_read_only_the_lower_triangle():
    k = make_spd(seed=7)
    l = np.linalg.cholesky(k)
    stale = t64(l + np.triu(np.full(l.shape, 1e6), 1))
    rhs = np.random.default_rng(8).normal(size=(96, 3))
    np.testing.assert_allclose(TB.blocked_cho_solve(stale, t64(rhs), 32).numpy(),
                               np.linalg.solve(k, rhs), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("call", [
    lambda k: TB.blocked_cholesky(k, 7), lambda k: TB.super_cholesky(k, 7),
    lambda k: TB.blocked_solve_lower(k, k[:, :2], 7),
    lambda k: TB.blocked_solve_upper(k, k[:, :2], 7)])
def test_bad_block_size_raises(call):
    with pytest.raises(ValueError, match="divisible"):
        call(t64(make_spd()))


@pytest.mark.parametrize("inv_panel", [True, False])
@pytest.mark.parametrize("n,w,strip", [(96, 32, 48), (128, 32, 128), (64, 64, 64),
                                       (96, 48, 40)])
def test_super_cholesky_matches_xla(n, w, strip, inv_panel):
    """The shrinking-panel factorization: ragged strips (not aligned to the
    panel width), one panel, both panel solves; against numpy and the JAX
    one, which always takes the inverse route."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(n, 16))
    k = a @ a.T + n * np.eye(n)
    got = TB.super_cholesky(torch.tensor(k), w, strip, inv_panel)  # a copy: it factors in place
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)
    _close(got, JB.super_cholesky(jnp.asarray(k), w, strip, "highest", inv_panel=inv_panel))


@pytest.mark.parametrize("zero_upper", [True, False])
def test_super_cholesky_in_place_ignores_stale_upper_triangle(zero_upper):
    """The strip updates maintain only the lower triangle, so the
    factorization must never read above the diagonal: garbage there leaves
    the factor as it is. The result is the input's storage; with
    ``zero_upper=False`` the values above the diagonal are stale, as the
    reference leaves them, and the solves still read the factor right."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(96, 16))
    k = a @ a.T + 96 * np.eye(96)
    garbage = np.triu(rng.normal(size=(96, 96)) * 100.0, k=1)
    kt = torch.tensor(k + garbage)
    ptr = kt.data_ptr()
    got = TB.super_cholesky(kt, 32, 48, zero_upper=zero_upper)
    assert got.data_ptr() == ptr and got is kt
    want = JB.super_cholesky(jnp.asarray(k + garbage), 32, 48, "highest",
                             zero_upper=zero_upper)
    ref = np.linalg.cholesky(k)
    np.testing.assert_allclose(np.tril(got.numpy()), ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.tril(got.numpy()), np.tril(np.asarray(want)), rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())
    upper = np.triu(got.numpy(), 1)
    if zero_upper:
        assert not upper.any()
    else:
        assert upper.any()
        rhs = rng.normal(size=96)
        np.testing.assert_allclose(TB.blocked_cho_solve(got, t64(rhs), 512).numpy(),
                                   np.linalg.solve(k, rhs), rtol=1e-9, atol=1e-9)


def _low_rank_spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 16))
    return a @ a.T + n * np.eye(n)


#: shapes at which the strip asked for is wider than SPLIT and is cut: the
#: 17,920 layout scaled down (the strip asked for covers every trailing
#: matrix), a strip of twice SPLIT, and a panel width that does not divide
#: SPLIT (strips of 1,920)
SPLIT_SHAPES = [(3072, 256, 16384), (4608, 256, 4096), (3072, 384, 16384)]


@pytest.mark.parametrize("inv_panel", [True, False])
@pytest.mark.parametrize("n,w,strip", SPLIT_SHAPES)
def test_super_cholesky_split_square_matches_numpy(n, w, strip, inv_panel):
    assert strip > TB.SPLIT and n - w > TB.SPLIT
    k = _low_rank_spd(n, 9)
    got = TB.super_cholesky(torch.tensor(k), w, strip, inv_panel)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(k), rtol=1e-9, atol=1e-9)


def test_super_cholesky_split_square_matches_xla():
    n, w, strip = SPLIT_SHAPES[0]
    k = _low_rank_spd(n, 10)
    got = TB.super_cholesky(torch.tensor(k), w, strip)
    _close(got, JB.super_cholesky(jnp.asarray(k), w, strip, "highest"))


@pytest.mark.parametrize("zero_upper", [True, False])
def test_split_square_ignores_stale_upper_triangle(zero_upper):
    """The cut strips leave most of each diagonal square's upper triangle
    stale; what is there, garbage included, must not reach the factor."""
    n, w, strip = SPLIT_SHAPES[2]
    k = _low_rank_spd(n, 11)
    rng = np.random.default_rng(12)
    kt = torch.tensor(k + np.triu(rng.normal(size=(n, n)) * 100.0, k=1))
    got = TB.super_cholesky(kt, w, strip, zero_upper=zero_upper)
    assert got is kt
    np.testing.assert_allclose(np.tril(got.numpy()), np.linalg.cholesky(k), rtol=1e-9,
                               atol=1e-9)
    assert np.triu(got.numpy(), 1).any() != zero_upper
    rhs = rng.normal(size=n)
    np.testing.assert_allclose(TB.blocked_cho_solve(got, t64(rhs), 512).numpy(),
                               np.linalg.solve(k, rhs), rtol=1e-9, atol=1e-9)


class _AddmmShapes(TorchDispatchMode):
    """Records each ``addmm_``'s (rows, inner, columns)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.addmm_.default:
            (m, kk), (_, c) = args[1].shape, args[2].shape
            self.calls.append((m, kk, c))
        return func(*args, **(kwargs or {}))


def _walk_products(n, w, strip):
    """The trailing-update products ``_factor_`` issues on an (n, n) meta
    tensor (no arithmetic runs), the diagonal blocks left as they are."""
    with _AddmmShapes() as rec:
        TB._factor_(torch.empty(n, n, device="meta"), w, strip, True, lambda a: a)
    return rec.calls


def _flop(calls):
    return sum(2 * m * kk * c for m, kk, c in calls)


def _whole_strips(n, w, strip):
    """The products of a walk that updates every strip whole, at and below
    its first row."""
    return [(n - cs, w, min(cs + strip, n) - cs)
            for c0 in range(w, n, w) for cs in range(c0, n, strip)]


@pytest.mark.parametrize("n,w,strip,calls,flop,whole", [
    (17920, 1792, 16384, 45, 1_899_013_079_040, 3_280_113_500_160),  # pipe17k-fit's
    (32768, 512, 16384, 528, 12_515_534_700_544, 18_648_747_999_232),  # the accuracy fit's
])
def test_split_walk_does_about_a_third_of_n_cubed(n, w, strip, calls, flop, whole):
    """Where the strip is cut, the products do N^3 / 3 to within a few
    percent (1.71 N^3 / 3 at 17,920 and 1.59 at 32,768 with strips updated whole)."""
    got = _walk_products(n, w, strip)
    assert len(got) == calls and _flop(got) == flop and all(kk == w for _, kk, _ in got)
    assert abs(flop / (n ** 3 / 3) - 1) < 0.07
    assert _flop(_whole_strips(n, w, strip)) == whole


@pytest.mark.parametrize("n,w,strip", [(49152, 512, 2048), (4096, 512, 512),
                                       (96, 48, 40), (3072, 1024, 2048)])
def test_walk_at_most_split_wide_is_unchanged(n, w, strip):
    """A strip of at most SPLIT columns is one product at and below its first
    row, in the order the walk always issued them (exact49k-fit: w = 512,
    strip 2,048)."""
    want = _whole_strips(n, w, strip)
    got = _walk_products(n, w, strip)
    assert got == want and _flop(got) == _flop(want)


def test_tri_inverse_matches_inv():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(48, 48))
    l = np.linalg.cholesky(a @ a.T + 48 * np.eye(48))
    got = TL.tri_inverse(t64(l))
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(l), rtol=1e-9, atol=1e-9)
    _close(got, JL.tri_inverse(jnp.asarray(l), precision="highest"))
    assert not np.triu(got.numpy(), 1).any()
    # stale upper-triangle values must not leak into the result
    got2 = TL.tri_inverse(t64(l + np.triu(np.full((48, 48), 1e6), 1)))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), rtol=1e-12)


@pytest.mark.parametrize("engine", ["blocked", "super"])
def test_blocked_engines_survive_high_condition_f32(engine):
    """cond(K) ~ 3e5 in float32: the library's Cholesky survives it, and so
    must the blocked engines (the reference test's matrix and limit: the
    reconstruction error, 1e-5 of max |K|)."""
    rng = np.random.default_rng(0)
    n = 512
    x = rng.normal(size=(n, 3))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * d2 / 4.0) + 2e-4 * np.eye(n)
    got = TB.blocked_cholesky(t32(k), 64) if engine == "blocked" \
        else TB.super_cholesky(t32(k), 128, 256)  # t32 copies: the float64 k stays
    got = np.tril(got.numpy().astype(np.float64))
    assert np.all(np.isfinite(got))
    recon = np.abs(got @ got.T - k).max()
    assert recon < 1e-5 * np.abs(k).max(), recon


@pytest.mark.parametrize("n", [1_000, 16_384, 16_385, 32_767, 32_768, 49_152, 65_536])
def test_default_chol_config_is_the_references(n):
    assert TS.default_chol_config(n) == JS.default_chol_config(n)
