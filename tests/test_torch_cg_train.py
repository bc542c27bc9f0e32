"""The matrix-free CG training loss on the port (gpras_tpu_torch.gp.exact_cg)
against the JAX package (gpras_tpu.gp.exact_cg): the SLQ log-determinant,
``make_cg_nlml`` and ``make_cg_training_loss`` with and without the
pivoted-Cholesky preconditioner, the residual gate, the Russian-roulette
estimator, and ``GPRAS.fit(exact_engine="cg")`` step for step, on the same
seeded numpy inputs and the reference's own probe draws, in float64 unless a
case says otherwise. On the CPU both packages take their plain loops (the
reference's ``_cotangent_grads`` panel loop, the port's ``kgrad_plain``).

Limits: 1e-8 relative on losses and 1e-7 x max|grad| on gradients (float64:
the same algorithm, operations in another order); Matern12's r-singular
diagonal is held to 1e-7 on both, as tests/test_torch_exact_train.py states.

CG without reorthogonalization is chaotic while a column is still
iterating: a 1e-15 relative perturbation of K (the size of the two
packages' Gram difference) moved the quad term by 1e-6 to 1e-4 after 24
iterations at condition numbers 80-960 (measured on the port alone, N =
300), far above these limits. So the parity cases are well conditioned
(variance 0.3, noise 1.0: condition ~25) and run until every column has
converged and frozen; there the two packages agree to ~1e-14.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.gp import exact_cg as JC
from gpras_tpu.gp.model import GPRAS as JGPRAS
from gpras_tpu_torch.fit import optimizers as TO
from gpras_tpu_torch.gp import exact_cg as TC
from gpras_tpu_torch.gp.model import GPRAS as TGPRAS
from gpras_tpu_torch.ops import fused_gram
from gpras_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from torch_parity import np_params, t32, t64

RTOL = 1e-8
GTOL = 1e-7


def _tol(kernel):
    return 1e-7 if kernel in ("Matern12", "Exponential") else RTOL


def _data(n, d=3, p=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    cols = [np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.1 * rng.normal(size=n)]
    for j in range(1, p):
        cols.append(np.cos(x[:, j % d]) + 0.1 * rng.normal(size=n))
    return x, np.stack(cols, axis=1)


def _params(d, seed=1, noise=1.0, variance=0.3):
    rng = np.random.default_rng(seed)
    return {"log_variance": np.float64(math.log(variance)),
            "log_noise_variance": np.float64(math.log(noise)),
            "log_lengthscales": np.log(rng.uniform(0.6, 1.6, d))}


def _draws(key, n, probes, rank, dtype=jnp.float64):
    """The reference's probes for ``key`` (make_cg_nlml's draws), as numpy:
    (u1, u2) with a preconditioner, Rademacher z without."""
    if rank > 0:
        k1, k2 = jax.random.split(key)
        return (np.asarray(jax.random.normal(k1, (rank, probes), dtype)),
                np.asarray(jax.random.normal(k2, (n, probes), dtype)))
    return np.asarray(jax.random.rademacher(key, (n, probes), dtype=dtype))


def _torch_draws(draws, conv=t64):
    return tuple(conv(a) for a in draws) if isinstance(draws, tuple) else conv(draws)


def _assert_grads(got, want, gtol=GTOL):
    """Every gradient entry within gtol x the largest entry of the gradient."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), rtol=0,
                                   atol=gtol * scale, err_msg=k)


def _slq_without_mask(alphas, betas, b2):
    """_slq_logdet_from_coeffs with an off-diagonal wherever the upper node is
    active (the both-active mask dropped): what a faulty port would compute."""
    vals = []
    for a, bt, nrm2 in zip(alphas.T, betas.T, b2):
        active = a > 0
        safe = np.where(active, a, 1.0)
        diag = 1.0 / safe
        diag[1:] += np.where(active[:-1], bt[:-1] / safe[:-1], 0.0)
        off = np.where(active[:-1], np.sqrt(np.maximum(bt[:-1], 0.0)) / safe[:-1], 0.0)
        diag = np.where(active, diag, 1.0)
        ev, vec = np.linalg.eigh(np.diag(diag) + np.diag(off, 1) + np.diag(off, -1))
        vals.append(nrm2 * np.sum(vec[0] ** 2 * np.log(np.maximum(ev, 1e-30))))
    return np.mean(vals)


# ------------------------------------------------------------------- SLQ


def test_slq_logdet_from_coeffs_matches_jax():
    """Random CG coefficients for 6 probe columns over 12 steps: columns 0-2
    run every step, column 3 converges (frozen, alpha = 0 from step 7),
    column 4 breaks down (an O(1) beta recorded just before it freezes at
    step 5), column 5 is frozen from step 1."""
    rng = np.random.default_rng(3)
    k, m = 12, 6
    alphas = rng.uniform(0.2, 1.5, (k, m))
    betas = rng.uniform(0.01, 0.6, (k, m))
    alphas[7:, 3] = betas[6:, 3] = 0.0
    betas[4, 4] = 1.3
    alphas[5:, 4] = betas[5:, 4] = 0.0
    alphas[1:, 5] = betas[1:, 5] = 0.0
    b2 = rng.uniform(50.0, 150.0, m)
    want = float(JC._slq_logdet_from_coeffs(jnp.asarray(alphas), jnp.asarray(betas),
                                            jnp.asarray(b2)))
    got = TC._slq_logdet_from_coeffs(t64(alphas), t64(betas), t64(b2))
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    # per probe too, and the breakdown column is where a dropped mask shows:
    # it moves that term by ~1e-4 of itself, 1e8 times the limit above
    terms = TC._slq_terms(t64(alphas), t64(betas), t64(b2)).numpy()
    np.testing.assert_allclose(terms.mean(), want, rtol=1e-12)
    broken = (alphas[:, 4:5], betas[:, 4:5], b2[4:5])
    assert abs(_slq_without_mask(*broken) - terms[4]) > 1e-5 * abs(terms[4])
    one = TC._slq_terms(t64(alphas[:1]), t64(betas[:1]), t64(b2))  # one Lanczos step
    np.testing.assert_allclose(one.numpy()[:5], b2[:5] * np.log(1.0 / alphas[0, :5]), rtol=1e-12)


# -------------------------------------------------------------- the NLML


@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("kernel", ["Matern52", "RBF", "Matern12"])
def test_cg_nlml_value_and_gradient_match_jax(kernel, rank):
    n, m, iters = 300, 8, 32
    x, y = _data(n, seed=4)
    params = _params(3)
    key = jax.random.PRNGKey(0)
    jloss = JC.make_cg_training_loss(kernel, probes=m, max_iters=iters, col_panel=64,
                                     precond_rank=rank)
    (wv, (wg, wy)) = jax.value_and_grad(
        lambda p, yy: jloss(p, jnp.asarray(x), yy, key), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(y[:, 0]))
    tloss = TC.make_cg_training_loss(kernel, probes=m, max_iters=iters, precond_rank=rank)
    draws = _torch_draws(_draws(key, n, m, rank))
    yt = t64(y[:, 0]).requires_grad_(True)
    tp = {k: t64(v).requires_grad_(True) for k, v in params.items()}
    tv = tloss(tp, t64(x), yt, draws)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(wv), rtol=_tol(kernel))
    _assert_grads({k: v.grad for k, v in tp.items()}, wg)
    # d/dy = g alpha, the y column's CG solution, which each package stops at
    # its own 1e-6 relative residual: held to that tolerance (measured
    # 1.05e-7 of max|alpha|, Matern52 without a preconditioner)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(wy), rtol=0,
                               atol=1e-6 * np.abs(wy).max())


def test_cg_nlml_residual_gate_gives_inf():
    """The reference's test of the gate (tests/test_exact_cg.py,
    test_monolithic_nlml_residual_gate) on the port: 2 iterations cannot
    reach a 1e-6 relative residual, so the value is +inf, as the
    reference's; a loose gate leaves the value as it is ungated."""
    n, d = 256, 3
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    params = {"log_variance": np.float32(0.0), "log_noise_variance": np.float32(math.log(0.2)),
              "log_lengthscales": np.zeros(d, np.float32)}
    key = jax.random.PRNGKey(11)
    z = t32(_draws(key, n, 8, 0, jnp.float32))
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ungated = TC.make_cg_training_loss("Matern52", probes=8, max_iters=12)
    v_ref = float(ungated(tp, t32(x), t32(y), z))
    assert np.isfinite(v_ref)
    tight = TC.make_cg_training_loss("Matern52", probes=8, max_iters=2, residual_gate=1e-6)
    assert np.isposinf(float(tight(tp, t32(x), t32(y), z)))
    jtight = JC.make_cg_training_loss("Matern52", probes=8, max_iters=2, col_panel=64,
                                      residual_gate=1e-6)
    assert np.isposinf(float(jtight(jp, jnp.asarray(x), jnp.asarray(y), key)))
    loose = TC.make_cg_training_loss("Matern52", probes=8, max_iters=12, residual_gate=1e3)
    assert float(loose(tp, t32(x), t32(y), z)) == v_ref
    # the gated value's gradient is still the estimator's (the custom backward)
    value, grads = TO.value_and_grad(lambda p: tight(p, t32(x), t32(y), z), tp)
    assert np.isposinf(float(value)) and all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("rank", [0, 8])
def test_slq_logdet_rr_matches_jax_at_the_sampled_depth(rank):
    """The reference samples the truncation depth on the host from its key;
    the port takes the depth (``rr_depth`` of the uniform draw) and the
    probes as inputs, here drawn from the reference's split of the same
    key."""
    n, probes = 200, 6
    x, _ = _data(n, seed=6)
    params = _params(3, seed=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for seed in range(40):  # a key whose sampled depth telescopes at least twice
        key = jax.random.PRNGKey(seed)
        k_depth, k_probe = jax.random.split(key)
        u = float(jax.random.uniform(k_depth, ()))
        if TC.rr_depth(u) >= 2:
            break
    want = float(JC.slq_logdet_rr("Matern52", jp, jnp.asarray(x), key, probes=probes,
                                  base_iters=8, seg_iters=4, precond_rank=rank))
    draws = _torch_draws(_draws(k_probe, n, probes, rank))
    tp = {k: t64(v) for k, v in params.items()}
    got = TC.slq_logdet_rr("Matern52", tp, t64(x), draws, TC.rr_depth(u), base_iters=8,
                           seg_iters=4, precond_rank=rank)
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_precond_probes_are_fixed_normal_draws():
    u1, u2 = TC.precond_probes(5000, 64, 16, dtype=torch.float64)
    assert u1.shape == (64, 16) and u2.shape == (5000, 16)
    again = TC.precond_probes(5000, 64, 16, dtype=torch.float32)
    assert torch.equal(again[1], u2.float())
    assert abs(float(u2.mean())) < 0.02 and abs(float(u2.std()) - 1.0) < 0.02


# ---------------------------------------------------------------- GPRAS


def _reference_draws(monkeypatch):
    """The port's fit takes the reference's probes: u1, u2 from the split of
    PRNGKey(0), as gpras_tpu's GPRAS._loss_fn draws them."""
    def draws(n, rank, probes=16, dtype=torch.float32, device=None):
        u1, u2 = _draws(jax.random.PRNGKey(0), n, probes, rank)
        return (torch.as_tensor(u1, dtype=dtype, device=device),
                torch.as_tensor(u2, dtype=dtype, device=device))
    monkeypatch.setattr(TC, "precond_probes", draws)


def test_fit_cg_engine_matches_jax(tmp_path, monkeypatch):
    """GPRAS.fit(exact_engine="cg") at N = 1,024, two modes, Adam step for
    step; the fitted checkpoint loads in gpras_tpu and predicts the same, and
    the JAX package's checkpoint loads in the port with its engine."""
    _reference_draws(monkeypatch)
    x, y = _data(1024, p=2, seed=15)
    kw = dict(optimization_method="adam", max_iter=4, learning_rate=0.05)
    jm = JGPRAS("Matern52", model_type="exact", dtype=jnp.float64, exact_engine="cg")
    tm = TGPRAS("Matern52", model_type="exact", dtype=torch.float64, exact_engine="cg",
                device="cpu")
    jm.fit(x, y, **kw)
    tm.fit(x, y, **kw)
    np.testing.assert_allclose(tm.fit_info["losses"].numpy(), np.asarray(jm.fit_info["losses"]),
                               rtol=RTOL)
    np.testing.assert_array_equal(tm.fit_info["iterations"].numpy(),
                                  np.asarray(jm.fit_info["iterations"]))
    for k, v in np_params(jm.params).items():
        np.testing.assert_allclose(tm.params[k].numpy(), v, rtol=1e-7, atol=1e-7, err_msg=k)
    # the port's checkpoint in the JAX package, and the JAX package's in the port
    tm.to_file(tmp_path / "port_cg.npz")
    back = JGPRAS.from_file(tmp_path / "port_cg.npz")
    assert back.exact_engine == "cg"
    for k, v in np_params(back.params).items():
        np.testing.assert_array_equal(v, tm.params[k].numpy())
    jm.to_file(tmp_path / "jax_cg.npz")
    mine = TGPRAS.from_file(tmp_path / "jax_cg.npz", device="cpu")
    assert mine.exact_engine == "cg" and mine._matrix_free
    for k, v in np_params(jm.params).items():
        np.testing.assert_array_equal(mine.params[k].numpy(), v)
    # the in-memory form carries the same arrays both ways
    there = params_to_numpy(params_from_numpy(np_params(jm.params), dtype=torch.float64))
    for k, v in np_params(jm.params).items():
        np.testing.assert_array_equal(there[k], v)
    xq = np.random.default_rng(42).normal(size=(9, 3))
    (bm, bv), (pm, pv) = back.predict(xq), tm.predict(xq)
    np.testing.assert_allclose(pm, bm, rtol=1e-6, atol=1e-6 * np.abs(bm).max())
    np.testing.assert_allclose(pv, bv, rtol=1e-6)


def test_fit_resets_the_cg_closure_and_probes():
    x, y = _data(300, seed=16)
    tm = TGPRAS("RBF", model_type="exact", dtype=torch.float64, exact_engine="cg", device="cpu")
    tm.fit(x, y, optimization_method="adam", max_iter=1)
    first = tm._cg_draws[1].shape
    tm.fit(x[:200], y[:200], optimization_method="adam", max_iter=1)
    assert first == (300, 16) and tm._cg_draws[1].shape == (200, 16)


def _fake_cuda(monkeypatch, calls):
    """The kernel route on CPU tensors: the wrappers' CUDA branches with the
    launch replaced by the plain version, after the wrappers' own checks
    (float32, contiguous, shapes), and every call recorded."""
    monkeypatch.setattr(fused_gram, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fused_gram, "_sms", lambda dev: 132)

    def kmv_sym_run(plan, kernel, params, x, v, noise):
        fused_gram._kernel_args(kernel, params, (x,), (v,))
        calls.append(("kmv_sym", v.shape[1]))
        return fused_gram.kmv_plain(kernel, params, x, v, noise=noise)

    def kgrad_cuda(sym, kernel, params, x, w, z, alpha, g, inv_m, plan=None, tiles=False):
        fused_gram._kernel_args(kernel, params, (x,), (w, z, alpha))
        calls.append(("kgrad_sym" if sym else "kgrad_dense", w.shape[1]))
        grads = fused_gram.kgrad_plain(kernel, params, x, w, z, alpha, g, inv_m)
        out = torch.cat([grads["log_variance"].reshape(1), grads["log_lengthscales"]])
        return (lambda: 0), out

    monkeypatch.setattr(fused_gram, "_kmv_sym_run", kmv_sym_run)
    monkeypatch.setattr(fused_gram, "_kgrad_cuda", kgrad_cuda)


def test_cg_loss_float32_takes_the_b5_rule(monkeypatch):
    """N = 4,096 in float32 with the route forced to the kernels: every mbcg
    iteration goes through kmv_sym (17 columns: y and 16 probes), and the
    backward through kgrad's B5 rule (ceil(N / 512) >= 8) with contiguous
    alpha and W, whose mbcg columns are strided views. On the CPU the
    wrappers run their plain versions. Against the JAX package in float32:
    the value to 1e-5 relative and the gradient to 1e-4 x its largest entry
    (two float32 runs of the same solves; measured 0 and 1.3e-7)."""
    n, iters = 4096, 12
    x, y = _data(n, seed=17)
    params = _params(3)
    key = jax.random.PRNGKey(0)
    draws = _torch_draws(_draws(key, n, 16, 64, jnp.float32), t32)
    loss = TC.make_cg_training_loss("Matern52", max_iters=iters, precond_rank=64)
    calls = []
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(TC, "_fused", lambda kernel, xx: True)
    tp = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()}
    value, grads = TO.value_and_grad(lambda p: loss(p, t32(x), t32(y[:, 0]), draws), tp)
    assert calls.count(("kmv_sym", 17)) == iters and calls[-1] == ("kgrad_sym", 16)
    jloss = JC.make_cg_training_loss("Matern52", max_iters=iters, precond_rank=64)
    wv, wg = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x, jnp.float32),
                                                 jnp.asarray(y[:, 0], jnp.float32), key))(
        {k: jnp.asarray(v, jnp.float32) for k, v in params.items()})
    np.testing.assert_allclose(float(value), float(wv), rtol=1e-5)
    _assert_grads(grads, wg, 1e-4)
