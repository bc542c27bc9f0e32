"""The accuracy north stars on the port (gpras_tpu_torch.accuracy) against
the JAX package's (gpras_tpu.accuracy), on the CPU.

Limits, each for a reason:
- ``make_problem`` and ``make_exact_problem``: bit-identical (the same numpy
  code from the same seed); ``summarize`` and ``summarize_exact``: equal on
  the same inputs (the same numpy code).
- ``run_path("f64")``: the predicted depth field within 1e-6 of the
  reference's, relative to its scale, at a small problem with
  ``max_iter=20`` (float64 EOFs from two eigensolvers, ~1e-13 apart, then 20
  Adam steps per mode; a loose limit, far above what float64 leaves).
- ``run_exact_path("f64")``: the port reads the ``exact_f32.npz`` the
  reference's float32 path wrote and its dense float64 posterior equals the
  reference's within 1e-10 (the same float64 algorithm).
"""

import numpy as np
import pytest
import torch

from gpras_tpu import accuracy as JA
from gpras_tpu_torch import accuracy as TA
import torch_parity  # noqa: F401  (one torch thread)

SMALL = {"n_events": 8, "n_train_events": 6, "t_steps": 12, "n_cells_hf": 256,
         "n_cells_lf": 64, "n_inducing": 16, "max_iter": 20}
SMALL_EXACT = {"n_train": 384, "n_test": 64, "max_iter": 6, "warm_start_subsample": 0}


def test_problems_are_bit_identical():
    for cfg in (None, SMALL):
        got, want = TA.make_problem(cfg), JA.make_problem(cfg)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for cfg in (None, SMALL_EXACT):
        got, want = TA.make_exact_problem(cfg), JA.make_exact_problem(cfg)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert TA.DEFAULT_CONFIG == JA.DEFAULT_CONFIG and TA.EXACT_CONFIG == JA.EXACT_CONFIG


def test_summaries_are_equal_on_the_same_inputs():
    rng = np.random.default_rng(0)
    truth = np.abs(rng.normal(size=(10, 30)))
    paths = [{"field": truth + s * rng.normal(size=truth.shape),
              "field_var": rng.uniform(0.01, 0.1, size=truth.shape), "truth": truth}
             for s in (0.1, 0.05)]
    assert TA.summarize(*paths) == JA.summarize(*paths)
    n = SMALL_EXACT["n_test"]
    exact = [{"mean": rng.normal(size=n), "var": rng.uniform(0.01, 0.5, size=n)}
             for _ in range(2)]
    assert TA.summarize_exact(*exact, SMALL_EXACT) == JA.summarize_exact(*exact, SMALL_EXACT)


def test_run_path_f64_matches_jax():
    got = TA.run_path("f64", SMALL, device="cpu")
    want = JA.run_path("f64", SMALL)
    assert int(got["n_modes"][0]) == int(want["n_modes"][0])
    np.testing.assert_array_equal(got["truth"], want["truth"])
    for k in ("field", "field_var"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6 * np.abs(want[k]).max())
    with pytest.raises(ValueError, match="unknown accuracy path"):
        TA.run_path("f16", SMALL, device="cpu")


def test_run_exact_path_f64_reads_the_references_f32_output(tmp_path):
    JA.run_exact_path("f32", str(tmp_path), SMALL_EXACT)
    want = JA.run_exact_path("f64", str(tmp_path), SMALL_EXACT)
    got = TA.run_exact_path("f64", str(tmp_path), SMALL_EXACT, device="cpu")
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                   atol=1e-10 * np.abs(want[k]).max())
    on_disk = np.load(tmp_path / "exact_f64.npz")  # the port's, written over the reference's
    np.testing.assert_array_equal(on_disk["mean"], got["mean"])


def test_run_exact_path_f32_writes_what_the_references_f64_path_reads(tmp_path):
    """The port's float32 production fit (dense engine at this size), its
    npz read by the reference's gold path."""
    out = TA.run_exact_path("f32", str(tmp_path), SMALL_EXACT, device="cpu")
    assert out["mean"].shape == out["var"].shape == (SMALL_EXACT["n_test"],)
    assert out["param_log_lengthscales"].shape == (1, 8)
    want = JA.run_exact_path("f64", str(tmp_path), SMALL_EXACT)
    got = TA.run_exact_path("f64", str(tmp_path), SMALL_EXACT, device="cpu")
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-10,
                               atol=1e-10 * np.abs(want["mean"]).max())
    s = TA.summarize_exact(out, got, SMALL_EXACT)
    assert s["exact_rmse_vs_f64"] < 0.25 * s["exact_rmse_f64_gold"]
    with pytest.raises(ValueError, match="unknown exact accuracy path"):
        TA.run_exact_path("f16", str(tmp_path), SMALL_EXACT, device="cpu")
    assert torch.get_num_threads() == 1
