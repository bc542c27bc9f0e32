"""The frozen work counts against values worked by hand at two shapes."""

from __future__ import annotations

import pytest

from perfbench import work


@pytest.mark.parametrize("n1,n2,d,ops,nbytes", [
    (4, 6, 2, 4 * 6 * 16, 4.0 * (24 + 10 * 2)),
    (49152, 49152, 8, 49152 ** 2 * 28, 4.0 * (49152 ** 2 + 2 * 49152 * 8)),
])
def test_gram_work(n1, n2, d, ops, nbytes):
    assert work.gram_work(n1, n2, d) == (ops, nbytes)


@pytest.mark.parametrize("n,r,d,sym,ops,nbytes", [
    (4, 3, 2, True, 8 * 16 + 2 * 16 * 3, 4.0 * (8 * 2 + 12 + 12)),
    (49152, 256, 8, True, 49152 ** 2 / 2 * 28 + 2.0 * 49152 ** 2 * 256,
     4.0 * (2 * 49152 * 8 + 2 * 49152 * 256)),
    (4, 1, 2, False, 16 * 16 + 2 * 16, 4.0 * (8 * 2 + 4 + 4)),
])
def test_kmv_work(n, r, d, sym, ops, nbytes):
    assert work.kmv_work(n, n, r, sym, d) == (ops, nbytes)


@pytest.mark.parametrize("n,d,m,ops,nbytes", [
    (3, 2, 1, 6 * (12 + 4 + 19), 4.0 * 3 * (2 + 2 + 1)),
    (49152, 8, 16, 49152 * 49153 / 2 * 131, 4.0 * 49152 * 41),
])
def test_kgrad_work(n, d, m, ops, nbytes):
    assert work.kgrad_work(n, d, m) == (ops, nbytes)


def test_one_rate_and_what_binds():
    assert work.COMPUTE_RATE == pytest.approx(164.9e12)
    # B5 at N = 49,152: 1.58e11 operations, bound by operations at ~0.96 ms
    t, binds = work.bound_s(*work.kgrad_work(49152, 8, 16))
    assert binds == "operations" and t == pytest.approx(9.6e-4, rel=0.01)
    t, binds = work.bound_s(1.0, 3.35e12)
    assert binds == "bytes" and t == pytest.approx(1.0)


def test_hutchinson_step_ops():
    n, d = 49152, 8
    fwd = n * (n + 1) / 2 * 28 + n ** 3 / 3 + 2.0 * n * n
    assert work.hutchinson_step_ops(n, d, grad=False) == pytest.approx(fwd)
    assert work.hutchinson_step_ops(n, d) == pytest.approx(
        fwd + 2.0 * n * n * 16 + n * (n + 1) / 2 * 131)
