"""The float64 reference against the program at a tiny size on the CPU."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.reference import eof as ref_eof
from perfbench.reference import exact as ref_exact
from perfbench.reference import sgpr as ref_sgpr
from perfbench.reference.precision import Precision, round_tf32
from perfbench.tests import tiny

F64 = Precision("f64")
CFG = {**json.loads((tiny.REPO / "perfbench/configs/exact-mat52-n49k.json").read_text()),
       **tiny.TINY}


def _problem(seed=3):
    x, y, w = data.training_set(CFG, seed, "cpu")
    p = {k: v[0] for k, v in data.hyperparameters(CFG, w).items()}
    return x.double(), y.double(), p


def test_hutchinson_value_and_gradient_match_the_program():
    from gpras_tpu_torch.gp import exact_stochastic

    x, y, p = _problem()
    n = x.shape[0]
    z = ref_exact.probes(n, 16)
    z_prog = exact_stochastic.rademacher_probes(n, 16, dtype=torch.float64)
    assert torch.equal(z, z_prog)
    loss_fn = exact_stochastic.make_hutchinson_training_loss("Matern52")
    leaves = {k: v.double().clone().requires_grad_(True) for k, v in p.items()}
    want = loss_fn(leaves, x, y[:, 0], z_prog)
    grads = torch.autograd.grad(want, list(leaves.values()))
    got, got_grad = ref_exact.value_and_grad(F64, p, x, y[:, 0], z, 1e-9)
    assert got == pytest.approx(float(want.detach()), rel=1e-12)
    for k, g in zip(leaves, grads):
        torch.testing.assert_close(got_grad[k], g, rtol=1e-9, atol=1e-9)


def test_posteriors_match_the_program():
    from gpras_tpu_torch.gp import exact_cg, sgpr
    from gpras_tpu_torch.gp.model import _exact_posterior_cache, _exact_predict_from_cache

    x, y, p = _problem()
    p64 = {k: v.double() for k, v in p.items()}
    xq = x[:7] + 0.3
    cache = _exact_posterior_cache("Matern52", p64, x, y[:, 0])
    want = _exact_predict_from_cache("Matern52", p64, cache, x, xq)
    # the program's float64 jitter is 1e-9 (x variance), added on the diagonal
    got = ref_exact.posterior(F64, p64, x, y[:, 0], xq, 1e-9)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-7, atol=1e-9)
    del exact_cg
    ps = {**p64, "z": x[::19][:20].clone()}
    want = sgpr.predict("Matern52", ps, x, y[:, 0], xq)
    got = ref_sgpr.posterior(F64, ps, x, y[:, 0], xq, 1e-9)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-10)


def test_eof_matches_the_preprocessor():
    from gpras_tpu_torch import PreProcessor

    lf, hf, elev = data.fields(CFG, 4, "preprocessor", 30, "cpu")
    pre = PreProcessor(hydraulic_parameter="wse", device="cpu")
    pre.fit(hf.numpy(), elev.numpy(), spatial_mode_count=4)
    ref = ref_eof.Eof(hf, elev, 4, 0.03)
    assert np.array_equal(ref.wet.numpy(), ~pre.dry_indices)
    np.testing.assert_allclose(ref.comps.numpy(), pre.eofs, atol=1e-10)
    q = data.fields(CFG, 5, "requests", 6, "cpu", hf=True)[1]
    np.testing.assert_allclose(ref.transform(q).numpy(), pre.transform(q.numpy()), atol=1e-9)
    m = torch.randn(6, 4, dtype=torch.float64)
    v = torch.rand(6, 4, dtype=torch.float64)
    f, fv = ref.decode(m, v)
    wf, wv = pre.reverse_transform(m.numpy(), v.numpy())
    np.testing.assert_allclose(f.numpy(), wf, atol=1e-9)
    np.testing.assert_allclose(fv.numpy(), wv, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, -math.pi])
    r = round_tf32(a)
    assert r[0] == a[0] and r[1] == 1.0 and r[2] == 1.0 + 2.0 ** -10
    assert abs(float(r[3]) + math.pi) <= 2.0 ** -11 * math.pi
