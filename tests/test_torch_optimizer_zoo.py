"""The optimizer zoo on the port (gpras_tpu_torch.fit.optimizers) against the
JAX package (gpras_tpu.fit.optimizers), on the same inputs, in float64:
the host L-BFGS core, its two wrappers, Adadelta, the staged schedules, the
multi-start fit, differential evolution, the dispatcher, and
``utils/profiling.log_fit_losses``.

Limits, each for a reason:
- ``lbfgs_fit_hostls`` on the same numpy value-and-gradient function:
  1e-12 on every evaluated point and on the result (the same float64 numpy
  arithmetic; identical in practice), equal ``stopped_by``, ``evals`` and
  iteration counts.
- Adadelta and Adam against optax: 1e-8 relative step for step (the
  SGPR loss's float64 rounding differences, ~1e-14, compound over steps).
- ``lbfgs_fit``, ``lbfgs_fit_chunked`` and the schedules that end in them:
  final loss within the stop band of the reference's, tol * |loss| with
  the reference's tol 1e-5 (ROADMAP.md "Optimizers": optax's zoom
  linesearch and the port's Nocedal-Wright one do not share a trajectory).
- Differential evolution: the generation's arithmetic exactly against a
  numpy transcription of the reference's (gpras_tpu/fit/optimizers.py
  :828-846); the final energy within 1e-3 relative of the reference's (the
  populations are drawn from different generators, so only the optimum
  they reach is comparable; both run until their spread is 1e-6 of it).
"""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.fit import optimizers as JO
from gpras_tpu.gp import sgpr as JS
from gpras_tpu.utils.profiling import log_fit_losses as j_log_fit_losses
from gpras_tpu_torch.fit import optimizers as TO
from gpras_tpu_torch.gp import sgpr as TS
from gpras_tpu_torch.utils.profiling import log_fit_losses as t_log_fit_losses
from torch_parity import np_params, t64

BAND = 1e-5  # the reference's tol: the L-BFGS wrappers' final-loss band


def _problem(seed=0, n=24, d=2, m=6):
    """The reference's optimizer test problem (tests/test_optimizers.py):
    SGPR on 24 points, 6 inducing points, in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.05 * rng.normal(size=n)
    p = np_params(JS.init_params("RBF", jnp.asarray(x), jnp.asarray(x[:m]), noise_variance=0.5))

    def jloss(q):
        return JS.training_loss("RBF", q, jnp.asarray(x), jnp.asarray(y))

    def tloss(q):
        return TS.training_loss("RBF", q, t64(x), t64(y))

    return p, jloss, tloss, x


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: t64(v) for k, v in p.items()}


def _in_band(got, want, band=BAND):
    got, want = float(got), float(want)
    assert got <= want + band * abs(want), (got, want)


# ------------------------------------------------------------ log_fit_losses


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("every", [1, 3, 50])
def test_log_fit_losses_matches_jax(batched, every, caplog):
    losses = np.full((2, 12), np.nan)
    losses[0, :9] = np.linspace(5.0, 1.0, 9)
    losses[1, :7] = np.linspace(4.0, 2.0, 7)
    losses = losses if batched else losses[0]
    want = j_log_fit_losses({"losses": jnp.asarray(losses)}, "fit", every)
    with caplog.at_level(logging.INFO, logger="gpras_tpu_torch"):
        for arr in (losses, torch.as_tensor(losses)):
            assert t_log_fit_losses({"losses": arr}, "fit", every) == want
    assert sum("fit step" in r.message for r in caplog.records) == 2 * len(range(0, len(want),
                                                                                 every))
    assert t_log_fit_losses({"losses": arr}) == want  # name "fit", every 50


def test_log_fit_losses_without_losses():
    assert t_log_fit_losses({"losses": None}) == j_log_fit_losses({"losses": None}) == []
    assert t_log_fit_losses({}) == []


# -------------------------------------------------------- lbfgs_fit_hostls


def _quadratic(p):
    a, b = p["a"], p["b"]
    w = np.array([1.0, 7.0])
    f = float(np.sum(w * (a - np.array([1.0, -2.0])) ** 2) + 3.0 * (b - 0.5) ** 2)
    return f, {"a": 2.0 * w * (a - np.array([1.0, -2.0])), "b": np.asarray(6.0 * (b - 0.5))}


def _rosenbrock(p):
    x0, x1 = p["x"]
    f = (1.0 - x0) ** 2 + 100.0 * (x1 - x0 ** 2) ** 2
    g = np.array([-2.0 * (1.0 - x0) - 400.0 * x0 * (x1 - x0 ** 2), 200.0 * (x1 - x0 ** 2)])
    return float(f), {"x": g}


def _floored(p):
    """A quadratic whose minimum (-1) lies below the noise floor (0.25)."""
    v, a = p["log_noise_variance"], p["a"]
    f = (v + 1.0) ** 2 + np.sum((a - 0.3) ** 2) + 0.5 * v * a[0]
    return float(f), {"log_noise_variance": np.asarray(2.0 * (v + 1.0) + 0.5 * a[0]),
                      "a": 2.0 * (a - 0.3) + np.array([0.5 * v, 0.0])}


PROBLEMS = {
    "quadratic": (_quadratic, {"a": np.zeros(2), "b": np.asarray(0.0)}, {}),
    "rosenbrock": (_rosenbrock, {"x": np.array([-1.2, 1.0])}, {"max_iter": 60}),
    "floored": (_floored, {"log_noise_variance": np.asarray(2.0), "a": np.zeros(2)},
                {"floors": {"log_noise_variance": 0.25}}),
    "band": (_rosenbrock, {"x": np.array([-1.2, 1.0])}, {"max_iter": 60, "stop_loss": 0.5}),
    "min_decrease": (_rosenbrock, {"x": np.array([-1.2, 1.0])},
                     {"max_iter": 60, "min_decrease": 1e-3}),
    "plateau": (_rosenbrock, {"x": np.array([-1.2, 1.0])},
                {"max_iter": 60, "patience": 1, "tol": 5e-2}),
}


def _recording(fn, to_grad):
    """fn on numpy; ``to_grad`` wraps the gradient for the package; every
    evaluated point is recorded, flattened in sorted-key order."""
    points = []

    def vag(p):
        q = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float64)
             for k, v in p.items()}
        points.append(np.concatenate([np.ravel(q[k]) for k in sorted(q)]))
        f, g = fn(q)
        return f, {k: to_grad(v) for k, v in g.items()}

    return vag, points


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lbfgs_hostls_matches_jax(name):
    fn, p0, kw = PROBLEMS[name]
    jvag, jpts = _recording(fn, jnp.asarray)
    tvag, tpts = _recording(fn, torch.as_tensor)
    jp, jinfo = JO.lbfgs_fit_hostls(jvag, _jax(p0), **kw)
    tp, tinfo = TO.lbfgs_fit_hostls(tvag, _torch(p0), **kw)
    assert len(tpts) == len(jpts) == tinfo["evals"] == jinfo["evals"]
    np.testing.assert_allclose(np.stack(tpts), np.stack(jpts), rtol=1e-12, atol=1e-12)
    assert tinfo["stopped_by"] == jinfo["stopped_by"]
    assert int(tinfo["iterations"]) == int(jinfo["iterations"])
    np.testing.assert_array_equal(tinfo["losses"].numpy(), np.asarray(jinfo["losses"]))
    assert float(tinfo["loss"]) == float(jinfo["loss"])
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-12, atol=1e-12)
    expected = {"band": "stop_loss_band", "min_decrease": "noise_plateau",
                "plateau": "plateau_rule"}
    if name in expected:
        assert tinfo["stopped_by"] == expected[name]
    if name == "floored":
        assert float(tp["log_noise_variance"]) >= 0.25


def test_lbfgs_hostls_non_finite_start_and_gtol():
    p0 = {"x": torch.tensor([0.5, 0.5], dtype=torch.float64)}
    p, info = TO.lbfgs_fit_hostls(lambda p: (float("nan"), {"x": p["x"]}), p0)
    assert info["stopped_by"] == "non_finite_init" and info["evals"] == 1 and p is p0
    vag, _ = _recording(_quadratic, torch.as_tensor)
    _, info = TO.lbfgs_fit_hostls(vag, _torch(PROBLEMS["quadratic"][1]), max_iter=50,
                                  gtol=1e-6)
    assert info["stopped_by"] == "gtol" and int(info["iterations"]) < 50


# ------------------------------------------------------- L-BFGS wrappers


def test_lbfgs_fit_final_loss_in_the_references_band():
    p, jloss, tloss, _ = _problem()
    _, jinfo = JO.lbfgs_fit(jloss, _jax(p), max_iter=40)
    tp, tinfo = TO.lbfgs_fit(tloss, _torch(p), max_iter=40)
    assert sorted(tinfo) == sorted(jinfo)
    _in_band(tinfo["loss"], jinfo["loss"])
    assert tinfo["losses"].shape == (40,)


def test_lbfgs_fit_mask_keeps_frozen_leaves():
    p, jloss, tloss, _ = _problem()
    mask = TO.mask_except(_torch(p), ("z",))
    tp, tinfo = TO.lbfgs_fit(tloss, _torch(p), max_iter=20, mask=mask)
    np.testing.assert_array_equal(tp["z"].numpy(), p["z"])
    assert not np.allclose(tp["log_noise_variance"].numpy(), p["log_noise_variance"])
    _, jinfo = JO.lbfgs_fit(jloss, _jax(p), max_iter=20,
                            mask=JO.mask_except(_jax(p), ("z",)))
    _in_band(tinfo["loss"], jinfo["loss"])


def test_lbfgs_fit_chunked_band_mask_floors_and_progress():
    p, jloss, tloss, _ = _problem()
    _, jfull = JO.lbfgs_fit_chunked(jloss, _jax(p), max_iter=30, chunk=30)
    seen = []
    tp, tfull = TO.lbfgs_fit_chunked(tloss, _torch(p), max_iter=30, chunk=4,
                                     progress=lambda i, b: seen.append((i, b)))
    assert {"iterations", "losses", "loss", "stopped_by"} <= set(tfull)
    _in_band(tfull["loss"], jfull["loss"])
    done = int(tfull["iterations"])
    assert [i for i, _ in seen] == list(range(4, done + 1, 4)) + ([done] if done % 4 else [])
    assert seen[-1][1] == pytest.approx(float(np.nanmin(tfull["losses"].numpy())), rel=1e-6)
    # band entry, as the reference's stop_loss semantics
    target = float(tfull["losses"][3])
    _, banded = TO.lbfgs_fit_chunked(tloss, _torch(p), max_iter=30, stop_loss=target)
    assert banded["stopped_by"] == "stop_loss_band" and int(banded["iterations"]) <= 4
    floor = {"log_noise_variance": 0.25}
    fp, _ = TO.lbfgs_fit_chunked(tloss, _torch(p), max_iter=8, floors=floor)
    assert float(fp["log_noise_variance"]) >= 0.25
    mp, _ = TO.lbfgs_fit_chunked(tloss, _torch(p), max_iter=8,
                                 mask=TO.mask_only(_torch(p), ("z",)))
    np.testing.assert_array_equal(mp["log_variance"].numpy(), p["log_variance"])


# ------------------------------------------------------ Adadelta, schedules


def test_adadelta_matches_optax_step_for_step():
    p, jloss, tloss, _ = _problem()
    jp, jinfo = JO.adadelta_fit(jloss, _jax(p), max_iter=30, learning_rate=1.0)
    tp, tinfo = TO.adadelta_fit(tloss, _torch(p), max_iter=30, learning_rate=1.0)
    np.testing.assert_allclose(tinfo["losses"].numpy(), np.asarray(jinfo["losses"]), rtol=1e-8)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-8, atol=1e-12,
                                   err_msg=k)
    assert not np.allclose(tp["z"].numpy(), p["z"])
    mp, _ = TO.adadelta_fit(tloss, _torch(p), max_iter=5, learning_rate=1.0,
                            mask=TO.mask_only(_torch(p), ("z",)))
    np.testing.assert_array_equal(mp["log_variance"].numpy(), p["log_variance"])


def test_two_stage_matches_jax_step_for_step():
    p, jloss, tloss, _ = _problem()
    jp, jinfo = JO.two_stage_fit(jloss, _jax(p), max_iter=30, learning_rate=0.05)
    tp, tinfo = TO.two_stage_fit(tloss, _torch(p), max_iter=30, learning_rate=0.05)
    np.testing.assert_allclose(tinfo["losses"].numpy(), np.asarray(jinfo["losses"]), rtol=1e-8)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-8, atol=1e-12,
                                   err_msg=k)


def test_three_stage_final_loss_in_the_references_band():
    p, jloss, tloss, _ = _problem()
    _, jinfo = JO.three_stage_fit(jloss, _jax(p), max_iter=30)
    _, tinfo = TO.three_stage_fit(tloss, _torch(p), max_iter=30)
    _in_band(tinfo["loss"], jinfo["loss"])


# ----------------------------------------------------------- multi-start


def test_multi_start_from_the_same_starts_matches_jax():
    p, jloss, tloss, x = _problem()
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    starts = jax.vmap(lambda k: JO._sample_restart(k, _jax(p), jnp.asarray(x)))(keys)
    _, jinfo = JO.multi_start_fit(jloss, _jax(p), x=jnp.asarray(x), n_starts=6, iter_initial=15,
                                  iter_final=100)
    tp, tinfo = TO.multi_start_fit(tloss, _torch(p), starts=_torch(np_params(starts)),
                                   iter_initial=15, iter_final=100)
    want = np.asarray(jinfo["restart_losses"])
    np.testing.assert_allclose(tinfo["restart_losses"].numpy(), want, rtol=1e-8)
    assert int(np.nanargmin(tinfo["restart_losses"].numpy())) == int(np.nanargmin(want))
    _in_band(tinfo["loss"], jinfo["loss"])


def test_sample_restart_boxes_and_seeding():
    p, _, tloss, x = _problem()
    draws = [TO._sample_restart(torch.Generator().manual_seed(s), _torch(p), t64(x))
             for s in range(200)]
    lv = np.array([float(d["log_variance"]) for d in draws]) / math.log(10.0)
    ln = np.array([float(d["log_noise_variance"]) for d in draws]) / math.log(10.0)
    ls = np.array([d["log_lengthscales"].numpy() for d in draws]) / math.log(10.0)
    assert lv.min() >= -1 and lv.max() <= 1 and ln.min() >= -3 and ln.max() <= 0
    assert np.all(ls == ls[:, :1]) and ls.min() >= -1 and ls.max() <= 1  # one scalar
    z = np.stack([d["z"].numpy() for d in draws])
    assert (z >= x.min(0)).all() and (z <= x.max(0)).all()
    a, _ = TO.multi_start_fit(tloss, _torch(p), x=t64(x), n_starts=3, iter_initial=3,
                              iter_final=3)
    b, _ = TO.multi_start_fit(tloss, _torch(p), x=t64(x), n_starts=3, iter_initial=3,
                              iter_final=3)
    for k in a:
        assert torch.equal(a[k], b[k])


# ---------------------------------------------------- differential evolution


def _numpy_generation(pop, f, fmut, idx, cross_u, jdim, lo, hi, recombination, energy):
    """The reference's generation (gpras_tpu/fit/optimizers.py:828-846) in numpy."""
    n_pop, dim = pop.shape
    best_u = pop[np.argmin(f)]
    mutant = best_u[None, :] + fmut * (pop[idx[:, 0]] - pop[idx[:, 1]])
    mutant = np.clip(mutant, lo, hi)
    cross = cross_u < recombination
    force = np.eye(dim, dtype=bool)[jdim]
    cross = np.logical_or(cross, force)
    trial = np.where(cross, mutant, pop)
    f_trial = energy(trial)
    accept = f_trial < f
    return np.where(accept[:, None], trial, pop), np.where(accept, f_trial, f)


def test_de_generation_matches_a_numpy_transcription():
    lo, hi = np.array(TO.DE_LOWER), np.array(TO.DE_UPPER)
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    pop = lo + rng.uniform(size=(15, 3)) * (hi - lo)

    def energy_np(u):
        return np.sum((u - np.array([0.3, -0.2, -1.0])) ** 2, axis=1)

    def energy_t(u):
        return torch.as_tensor(energy_np(u.numpy()))

    f = energy_np(pop)
    tpop, tf = torch.as_tensor(pop), torch.as_tensor(f)
    for _ in range(5):
        draws = TO._de_draws(gen, 15, 3)
        tpop, tf = TO._de_generation(tpop, tf, draws, energy_t, torch.as_tensor(lo),
                                     torch.as_tensor(hi), 0.7)
        pop, f = _numpy_generation(pop, f, *(d.numpy() for d in draws), lo, hi, 0.7,
                                   energy_np)
        np.testing.assert_array_equal(tpop.numpy(), pop)
        np.testing.assert_array_equal(tf.numpy(), f)
        fmut = float(draws[0])
        assert 0.5 <= fmut <= 1.0 and (pop >= lo).all() and (pop <= hi).all()


def test_de_fit_bounds_and_final_energy_match_jax():
    p, jloss, tloss, _ = _problem()
    kw = dict(popsize=5, max_iter=150, tol=1e-6, adam_iter=20)
    jp, jinfo = JO.de_fit(jloss, _jax(p), seed=0, **kw)
    tp, tinfo = TO.de_fit(tloss, _torch(p), seed=0, **kw)
    u = np.array([float(tp["log_variance"]), float(tp["log_lengthscales"][0]),
                  float(tp["log_noise_variance"])]) / math.log(10.0)
    assert (u >= np.array(TO.DE_LOWER) - 1e-12).all() and (u <= np.array(TO.DE_UPPER) + 1e-12).all()
    assert np.all(tp["log_lengthscales"].numpy() == tp["log_lengthscales"].numpy()[0])
    np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]), rtol=1e-3)
    assert tinfo["losses"].shape == (15,) and float(tinfo["loss"]) == float(tinfo["losses"].min())
    # the Adam stage on Z ran: Z moved, and identically to the reference's
    np.testing.assert_allclose(tp["z"].numpy(), np.asarray(jp["z"]), rtol=1e-8)


# ---------------------------------------------------------------- FITTERS


def test_fitters_have_the_references_keys():
    assert sorted(TO.FITTERS) == sorted(JO.FITTERS)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        TO.fit(lambda p: p["a"], {"a": torch.zeros(())}, method="sgd")


@pytest.mark.parametrize("method", sorted(JO.FITTERS))
def test_every_fitter_runs(method):
    p, _, tloss, x = _problem()
    kw = {"two-stage": dict(max_iter=5), "three-stage": dict(max_iter=5),
          "adam": dict(max_iter=5), "adadelta": dict(max_iter=5),
          "L-BFGS-B": dict(max_iter=5),
          "stochastic": dict(x=t64(x), n_starts=2, iter_initial=3, iter_final=3),
          "diffential_evolution": dict(popsize=2, max_iter=3, adam_iter=3),
          "differential_evolution": dict(popsize=2, max_iter=3, adam_iter=3)}[method]
    fitted, info = TO.fit(tloss, _torch(p), method=method, **kw)
    assert sorted(fitted) == sorted(p)
    assert all(bool(torch.isfinite(v).all()) for v in fitted.values())
    assert math.isfinite(float(info["loss"]))
