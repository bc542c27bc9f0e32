"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program, with the run driven as the
benchmark drives it (the look for a chip skipped; tiny sizes on the CPU).
One chip, so no cell has an exchange between chips to leave out."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())

FIT_CELLS = ("exact49k-fit",)
SERVE_CELLS = ("exact49k-serve", "sgpr49k-serve")


def _state_unchanged(monkeypatch):
    """Every optimizer step returns the parameters it was given."""
    from gpras_tpu_torch.fit import optimizers

    inner = optimizers._adam_update

    def update(grads, state, *args):
        updates, state = inner(grads, state, *args)
        return {k: torch.zeros_like(v) for k, v in updates.items()}, state

    monkeypatch.setattr(optimizers, "_adam_update", update)


def _half_rows(monkeypatch):
    """The losses see the first half of the rows, scaled up to stand for all."""
    from gpras_tpu_torch.gp import exact_stochastic

    make = exact_stochastic.make_hutchinson_training_loss

    def make_half(*args, **kwargs):
        loss = make(*args, **kwargs)
        return lambda p, x, y, z: 2.0 * loss(p, x[:x.shape[0] // 2], y[:y.shape[0] // 2],
                                             z[:z.shape[0] // 2])

    monkeypatch.setattr(exact_stochastic, "make_hutchinson_training_loss", make_half)


def _half_fields(monkeypatch):
    """A request's second half of fields gets the first half's answers."""
    from gpras_tpu_torch import PosteriorPredictor

    inner = PosteriorPredictor.predict_field

    def predict(self, lf, **kw):
        k = lf.shape[0]
        f, v = inner(self, lf[:(k + 1) // 2], **kw)
        idx = np.arange(k) % f.shape[0]
        return f[idx], v[idx]

    monkeypatch.setattr(PosteriorPredictor, "predict_field", predict)


def _answer_altered(monkeypatch):
    """One posterior mean altered where the model produces it."""
    from gpras_tpu_torch import GPRAS

    inner = GPRAS.predict

    def predict(self, x):
        mean, var = inner(self, x)
        mean = mean.copy()
        mean[0, 0] += 0.05 * (1.0 + abs(mean[0, 0]))
        return mean, var

    monkeypatch.setattr(GPRAS, "predict", predict)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_rows], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_fault_is_not_correct(cell, fault, tmp_path, monkeypatch, capsys):
    tiny.patch_program(monkeypatch)
    fault(monkeypatch)
    rc, result, err = tiny.run(tiny.make_root(tmp_path), monkeypatch, capsys, cell)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", [_half_fields, _answer_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serve_fault_is_not_correct(cell, fault, tmp_path, monkeypatch, capsys):
    tiny.patch_program(monkeypatch)
    fault(monkeypatch)
    rc, result, err = tiny.run(tiny.make_root(tmp_path), monkeypatch, capsys, cell, seconds=0.2)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", FIT_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(cell, tmp_path, monkeypatch, capsys):
    tiny.patch_program(monkeypatch)
    rc, result, err = tiny.run(tiny.make_root(tmp_path), monkeypatch, capsys, cell, seconds=0.2)
    assert rc == 0, err[-2000:]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert err.rstrip().splitlines()[-1].startswith("perfbench check ")
    from perfbench.run import cell_metrics

    # every end-to-end metric of the cell, under its own name, alias or not
    want = {m["name"] for m in cell_metrics(BENCH, cell, "end_to_end")}
    want.discard("request_p95_ms")  # reported only where a window holds 20 requests or more
    assert want <= set(result["metrics"]) <= want | {"request_p95_ms"}
