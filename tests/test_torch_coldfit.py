"""The cold exact fit on the port (gpras_tpu_torch.gp.coldfit.fit_exact) and
its parts, the segmented CG step (exact_cg.make_cg_step_chunked) and the
gate-abort rule (exact_cg.gate_abort_decision), against the JAX package
(gpras_tpu), on the same seeded inputs and the reference's own probe draws,
in float64.

Limits, each for a reason:
- ``gate_abort_decision``: equal, on hypothesis-drawn histories (pure host
  arithmetic, copied).
- The segmented step: loss within 1e-8 relative, gradients within
  1e-6 x max|want|, the same number of segments. CG without
  reorthogonalization amplifies the two packages' ~1e-15 Gram difference
  while a column still iterates (tests/test_torch_cg_train.py), so the cases
  are well conditioned (variance 0.3, noise 1.0, rank-16 preconditioner)
  and every column converges to the tolerance inside the budget; measured
  there: 0 to 2e-9 on the loss and 2e-16 to 1.2e-8 on the gradients.
- The early exit: bit for bit equal to running every segment.
- ``fit_exact``: on the segmented CG path both packages run the same host
  L-BFGS over the same step, so the trajectories agree to 1e-6 relative (the
  losses are stored in float32); on the Hutchinson and one-piece CG paths the
  reference's optax linesearch and the port's do not share a trajectory
  (ROADMAP.md "Optimizers"), so the final loss is held within the stop
  band, tol * |loss| with tol 1e-5, of the reference's.
"""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gpras_tpu.gp import coldfit as JCF
from gpras_tpu.gp import exact_cg as JC
from gpras_tpu_torch.gp import coldfit as TCF
from gpras_tpu_torch.gp import exact_cg as TC
from gpras_tpu_torch.gp import exact_stochastic as TS
from torch_parity import t64

BAND = 1e-5


def _data(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _params(d=3, noise=1.0, variance=0.3, seed=1):
    rng = np.random.default_rng(seed)
    return {"log_variance": np.float64(math.log(variance)),
            "log_noise_variance": np.float64(math.log(noise)),
            "log_lengthscales": np.log(rng.uniform(0.6, 1.6, d))}


def _draws(key, n, probes, rank):
    """The reference's draws for ``key``, as make_cg_step_chunked's setup
    makes them: (u1, u2) with a preconditioner, Rademacher z without."""
    if rank > 0:
        k1, k2 = jax.random.split(key)
        return (t64(jax.random.normal(k1, (rank, probes), jnp.float64)),
                t64(jax.random.normal(k2, (n, probes), jnp.float64)))
    return t64(jax.random.rademacher(key, (n, probes), dtype=jnp.float64))


def _both_steps(n, rank=16, probes=15, max_iters=32, seg_iters=4, tol=1e-6, gate=0.1, **kw):
    x, y = _data(n)
    p = _params()
    key = jax.random.PRNGKey(0)
    opts = dict(probes=probes, max_iters=max_iters, seg_iters=seg_iters, tol=tol,
                precond_rank=rank, residual_gate=gate, **kw)
    jstep = JC.make_cg_step_chunked("Matern52", **opts)
    jl, jg = jstep({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(y), key)
    tstep = TC.make_cg_step_chunked("Matern52", **opts)
    args = ({k: t64(v) for k, v in p.items()}, t64(x), t64(y), _draws(key, n, probes, rank))
    tl, tg = tstep(*args)
    return (jl, jg, jstep), (tl, tg, tstep), args


# ---------------------------------------------------------------- gate abort


@settings(max_examples=300, deadline=None, database=None)
@given(hist=st.lists(st.floats(1e-6, 100.0), max_size=12),
       rel=st.floats(1e-6, 100.0), segs_ran=st.integers(0, 20), extra=st.integers(0, 20),
       gate=st.floats(1e-4, 1.0))
def test_gate_abort_decision_matches_jax(hist, rel, segs_ran, extra, gate):
    n_segs = segs_ran + extra
    assert TC.gate_abort_decision(hist, rel, segs_ran, n_segs, gate) == \
        JC.gate_abort_decision(hist, rel, segs_ran, n_segs, gate)


def test_gate_abort_decision_cases():
    stalled = [1.0, 0.95, 0.92, 0.9]
    assert TC.gate_abort_decision(stalled, 0.9, 4, 8, 0.1)  # 0.9 * ~0.97^4 > 0.4
    assert not TC.gate_abort_decision(stalled, 0.9, 3, 8, 0.1)  # too little history
    assert not TC.gate_abort_decision([1.0, 0.5, 0.45, 0.44], 0.44, 4, 8, 0.1)  # decayed once
    assert not TC.gate_abort_decision(stalled, 0.9, 4, 64, 0.1)  # the rest could get there


# ----------------------------------------------------------- segmented step


@pytest.mark.parametrize("n, rank", [(512, 16), (1024, 16), (2048, 16), (512, 0)])
def test_segmented_step_matches_jax(n, rank):
    (jl, jg, jstep), (tl, tg, tstep), _ = _both_steps(n, rank=rank)
    assert math.isfinite(float(jl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-8)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(v), rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
    assert tstep.last_segments == jstep.last_segments


def test_early_exit_is_bit_identical_to_the_full_budget():
    (_, _, jstep), (tl, tg, tstep), args = _both_steps(1024)
    assert tstep.last_segments < 32 // 4  # the exit happened
    full = TC.make_cg_step_chunked("Matern52", probes=15, max_iters=32, seg_iters=4, tol=1e-6,
                                   precond_rank=16, residual_gate=0.1, early_exit=False,
                                   gate_abort=False)
    fl, fg = full(*args)
    assert full.last_segments == 8
    assert torch.equal(fl, tl)
    for k in fg:
        assert torch.equal(fg[k], tg[k]), k


def test_a_frozen_carry_is_a_fixed_point():
    """Once every column is frozen, more mbcg iterations leave every output
    ``finish`` reads as it is: the solution, the residual, rz and the
    coefficient rows (only the search direction moves)."""
    x, y = _data(512)
    p = {k: t64(v) for k, v in _params().items()}
    noise = TC._noise(p, torch.float64)
    z = TS.rademacher_probes(512, 7, dtype=torch.float64)
    b = torch.cat([t64(y)[:, None], z], dim=1)
    carry, _, stop2 = TC._mbcg_init(b, 64, 1e-6, TC._identity)

    def mv(v):
        return TC.kmv("Matern52", p, t64(x), v, noise)

    i = 0
    while not bool(carry[6].all()):
        carry = TC._mbcg_run(mv, carry, i, i + 4, stop2, TC._identity)
        i += 4
    assert i < 64
    frozen = tuple(t.clone() for t in carry)
    carry = TC._mbcg_run(mv, carry, i, 64, stop2, TC._identity)
    for j in (0, 2, 3, 4, 5, 6):  # x, residual, rz, alphas, betas, done
        assert torch.equal(carry[j], frozen[j]), j


def test_gate_abort_stops_where_the_reference_stops(monkeypatch, caplog):
    """Both packages' step with the decision forced (abort once 5 segments
    ran): the decision sees the same histories, the same segments run (the
    host's one-segment lag), and the gate turns the loss to +inf."""
    calls = {"jax": [], "torch": []}

    def forced(tag):
        def decide(hist, rel, segs_ran, n_segs, gate):
            calls[tag].append((list(hist), rel, segs_ran, n_segs))
            return segs_ran >= 5
        return decide

    monkeypatch.setattr(JC, "gate_abort_decision", forced("jax"))
    monkeypatch.setattr(TC, "gate_abort_decision", forced("torch"))
    with caplog.at_level(logging.INFO, logger=TC.__name__):
        (jl, _, jstep), (tl, _, tstep), _ = _both_steps(1024, rank=0, max_iters=64, seg_iters=2,
                                                        tol=1e-12, gate=1e-9)
    assert float(jl) == float(tl) == math.inf
    assert tstep.last_segments == jstep.last_segments == 6
    assert [c[2:] for c in calls["torch"]] == [c[2:] for c in calls["jax"]]
    for (th, tr, *_), (jh, jr, *_) in zip(calls["torch"], calls["jax"]):
        np.testing.assert_allclose(th + [tr], jh + [jr], rtol=1e-8)
    assert any("cg gate_abort at segment 5/32" in r.message for r in caplog.records)


def test_segmented_step_checks_its_segments():
    with pytest.raises(ValueError, match="must divide"):
        TC.make_cg_step_chunked("Matern52", max_iters=30, seg_iters=4)


# ---------------------------------------------------------------- fit_exact


def test_cg_threshold_is_the_references():
    assert TCF.CG_THRESHOLD == JCF.CG_THRESHOLD == 65536


def test_fit_exact_hutchinson_matches_jax_within_the_band():
    x, y = _data(384)
    key = jax.random.PRNGKey(0)
    _, jinfo = JCF.fit_exact("Matern52", jnp.asarray(x), jnp.asarray(y), max_iter=30, key=key)
    z = t64(jax.random.rademacher(key, (384, 16), dtype=jnp.float64))
    p, info = TCF.fit_exact("Matern52", t64(x), t64(y), max_iter=30, key=z)
    assert info["engine"] == jinfo["engine"] == "hutchinson"  # auto below the threshold
    assert info["stopped_by"] in ("max_iter", "plateau_rule", "linesearch_failure")
    assert info["evals"] >= int(info["iterations"]) + 1
    assert float(p["log_noise_variance"]) >= math.log(1e-4)  # the floor binds from below
    assert float(info["loss"]) < float(info["losses"][0])
    assert float(info["loss"]) <= float(jinfo["loss"]) + BAND * abs(float(jinfo["loss"]))


def test_fit_exact_segmented_cg_follows_the_references_trajectory():
    x, y = _data(256)
    kw = dict(engine="cg", max_iter=8, probes=16, cg_iters=32, seg_iters=4, precond_rank=16)
    key = jax.random.PRNGKey(0)
    jp, jinfo = JCF.fit_exact("Matern52", jnp.asarray(x), jnp.asarray(y), key=key, **kw)
    p, info = TCF.fit_exact("Matern52", t64(x), t64(y), key=_draws(key, 256, 16, 16), **kw)
    assert info["engine"] == jinfo["engine"] == "cg_hostls"
    assert (info["stopped_by"], info["evals"], int(info["iterations"])) == \
        (jinfo["stopped_by"], jinfo["evals"], int(jinfo["iterations"]))
    np.testing.assert_allclose(info["losses"].numpy(), np.asarray(jinfo["losses"]), rtol=1e-6)
    for k in jp:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8)
    assert float(p["log_noise_variance"]) >= math.log(1e-3)


def test_fit_exact_one_piece_cg_within_the_band():
    x, y = _data(256)
    kw = dict(engine="cg", max_iter=12, probes=16, cg_iters=32, precond_rank=16,
              host_linesearch=False)
    key = jax.random.PRNGKey(0)
    _, jinfo = JCF.fit_exact("Matern52", jnp.asarray(x), jnp.asarray(y), key=key, **kw)
    _, info = TCF.fit_exact("Matern52", t64(x), t64(y), key=_draws(key, 256, 16, 16), **kw)
    assert info["engine"] == jinfo["engine"] == "cg"
    assert float(info["loss"]) <= float(jinfo["loss"]) + BAND * abs(float(jinfo["loss"]))


def test_fit_exact_stop_decrease_truncates_identically():
    """The noise-plateau stop ends the segmented CG fit earlier on the same
    trajectory (the rule only truncates)."""
    x, y = t64(_data(256)[0]), t64(_data(256)[1])
    kw = dict(engine="cg", max_iter=10, probes=16, cg_iters=32, seg_iters=4, precond_rank=16)
    _, full = TCF.fit_exact("Matern52", x, y, **kw)
    losses = full["losses"].numpy()
    fin = losses[np.isfinite(losses)]
    earns = fin[:-1] - fin[1:]
    thresh = float(earns[earns.size // 2]) + 1e-9
    expect = int(np.argmax(np.concatenate([[np.inf], earns]) < thresh)) + 1
    _, stopped = TCF.fit_exact("Matern52", x, y, stop_decrease=thresh, **kw)
    assert stopped["stopped_by"] == "noise_plateau"
    assert int(stopped["iterations"]) == expect
    np.testing.assert_array_equal(stopped["losses"].numpy()[:expect], losses[:expect])


def test_fit_exact_key_is_the_draws_or_their_generator():
    x, y = t64(_data(128)[0]), t64(_data(128)[1])
    runs = [TCF.fit_exact("Matern52", x, y, max_iter=4, key=key)[1]["losses"]
            for key in (None, torch.Generator().manual_seed(0),
                        TS.rademacher_probes(128, 16, dtype=torch.float64))]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    other = TCF.fit_exact("Matern52", x, y, max_iter=4, key=torch.Generator().manual_seed(5))
    assert not torch.equal(other[1]["losses"], runs[0])


def test_fit_exact_refuses_what_the_reference_refuses():
    x, y = t64(_data(64)[0]), t64(_data(64)[1])
    with pytest.raises(ValueError, match="unknown engine"):
        TCF.fit_exact("Matern52", x, y, engine="dense")
    with pytest.raises(ValueError, match="host_linesearch"):
        TCF.fit_exact("Matern52", x, y, engine="hutchinson", host_linesearch=True)
    with pytest.raises(ValueError, match="host-linesearch"):
        TCF.fit_exact("Matern52", x, y, engine="hutchinson", stop_decrease=1.0)


def test_cold_fit_example_runs_on_the_cpu():
    """examples/torch_cold_fit.py (the card's timing script) at a CPU size."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_cold_fit.py"
    spec = importlib.util.spec_from_file_location("torch_cold_fit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(512, 2, device="cpu", verbose=False)
    assert out["engine"] == "hutchinson" and out["iterations"] == 2
    assert out["evals"] >= 3 and out["losses"][1] < out["losses"][0]
