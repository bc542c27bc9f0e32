"""The port's storm-event selection against the JAX package's, on the same catalogs.

``gpras_tpu_torch/pipeline/event_selection.py`` is the reference's code with
one change: the diversity fill's two PCAs run on ``device`` through the port's
``eof/pca.pca_fit`` (float64, the frame's dtype), where the reference runs
the JAX ``pca_fit`` (float64 under these tests' x64). Everything else is the
same numpy and pandas, so the return periods, the selected storms and the
STAC item are held equal, and the PCA scores to 1e-10.

The catalogs: tests/test_tooling.py's ``make_sst_parquet`` (60 events, one
hydrograph shape scaled per event) and ``chip_smoke.sst_catalog`` (the
card's phase 18 catalog: lognormal scales and shapes) at 60 and 2,000 events
x 72 hours. On ``make_sst_parquet``'s catalog each hydrograph pivot has rank
one: its components past the first are directions of the null space, whose
scores are rounding noise that the standardization scales up to unit
variance, so the diversity fill there picks by each LAPACK's rounding, in
the reference as in the port. That catalog is held equal where the selection
is defined (return periods, the Max and AEP picks, the first component's
scores) and to the JAX test's invariants; the varied catalogs are held equal
pick for pick.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch_parity  # noqa: F401  (one torch thread)

import gpras_tpu.eof.pca as jpca
from gpras_tpu.pipeline import event_selection as jes
from gpras_tpu_torch.eof.pca import pca_fit_reference
from gpras_tpu_torch.pipeline import event_selection as tes
from test_tooling import make_sst_parquet

REPO = Path(__file__).resolve().parents[1]
RPS = [2, 5, 10, 25, 50, 100, 200, 500, 1000, 2000]
SCORE_RTOL = 1e-10  # standardized PCA scores, x max|want|


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sst")
    make_sst_parquet(root / "uniform60.pq")
    smoke = _smoke()
    for n in (60, 2000):
        smoke.sst_catalog(root / f"varied{n}.pq", n_events=n, steps=72)
    return root


#: catalog -> (EventSelection keywords, run_selection arguments)
CASES = {"uniform60": ({"arrival_rate": 5, "test_rp_range": [1.2, 50]}, (20, 6, [2, 5, 10, 25])),
         "varied60": ({"arrival_rate": 5, "test_rp_range": [1.2, 50]}, (20, 6, [2, 5, 10, 25])),
         "varied2000": ({}, (35, 14, RPS))}
COLS = ["event_id", "Set", "Type", "RP_precip-cum", "RP_inflow"]


def _standardized(captured) -> np.ndarray:
    """The diversity fill's standardized score matrix from its two PCAs."""
    combined = np.concatenate([x @ c.T for x, c, _ in captured], axis=1)
    std = combined.std(axis=0)
    std[std == 0] = 1.0
    return (combined - combined.mean(axis=0)) / std


def _select(pq: str, case: str, monkeypatch):
    """Both packages' run_selection on ``pq``, each PCA's input and output
    recorded."""
    kw, args = CASES[case]
    captured = {"jax": [], "torch": []}
    jfit, tfit = jpca.pca_fit, tes.pca_fit

    def jrec(x, k):
        c, e = jfit(x, k)
        captured["jax"].append((np.asarray(x), np.asarray(c), np.asarray(e)))
        return c, e

    def trec(x, k):
        c, e = tfit(x, k)
        captured["torch"].append((x.numpy(), c.numpy(), e.numpy()))
        return c, e

    monkeypatch.setattr(jpca, "pca_fit", jrec)
    monkeypatch.setattr(tes, "pca_fit", trec)
    j, jmax = jes.EventSelection(pq, **kw).run_selection(*args)
    t, tmax = tes.EventSelection(pq, device="cpu", **kw).run_selection(*args)
    return j, jmax, t, tmax, captured


@pytest.mark.parametrize("seed,n,rate", [(0, 200, 10), (1, 57, 5), (2, 10, 10), (3, 1000, 7)])
def test_block_maxima_return_periods_match(seed, n, rate):
    rng = np.random.default_rng(seed)
    v = rng.exponential(size=n)
    v[::9] = v[0]  # ties among the block maxima
    got = tes.block_maxima_return_periods(v, rate)
    np.testing.assert_array_equal(got, jes.block_maxima_return_periods(v, rate))
    assert got.min() >= 0.01


@pytest.mark.parametrize("case", ["varied60", "varied2000"])
def test_run_selection_matches(case, catalogs, monkeypatch):
    """The same storms, Sets, Types and return periods, the same event
    maxima, and standardized PCA scores (the diversity fill's distances)
    equal to 1e-10 of their scale."""
    j, jmax, t, tmax, captured = _select(str(catalogs / f"{case}.pq"), case, monkeypatch)
    assert t[COLS].values.tolist() == j[COLS].values.tolist()
    pd.testing.assert_frame_equal(tmax, jmax)
    assert len(captured["torch"]) == len(captured["jax"]) == 2
    for (xj, cj, ej), (xt, ct, et) in zip(captured["jax"], captured["torch"]):
        np.testing.assert_array_equal(xt, xj)  # the same centered pivot
        assert np.abs(ct - cj).max() <= SCORE_RTOL * np.abs(cj).max()
        assert np.abs(et - ej).max() <= SCORE_RTOL * np.abs(ej).max()
    want = _standardized(captured["jax"])
    assert np.abs(_standardized(captured["torch"]) - want).max() <= SCORE_RTOL * np.abs(want).max()
    n_train = CASES[case][1][0]
    assert (t["Type"] == "Train").sum() == n_train
    assert {"Max", "AEP", "Diverse"} <= set(t["Set"])
    assert not set(t[t.Type == "Train"].event_id) & set(t[t.Type == "Test"].event_id)


def test_run_selection_on_a_rank_one_catalog(catalogs, monkeypatch):
    """make_sst_parquet's catalog (one hydrograph shape): equal return
    periods, Max and AEP picks and first-component scores; the rest of each
    package's selection meets tests/test_tooling.py's invariants."""
    j, jmax, t, tmax, captured = _select(str(catalogs / "uniform60.pq"), "uniform60",
                                         monkeypatch)
    pd.testing.assert_frame_equal(tmax, jmax)
    aep = t["Set"].isin(["Max", "AEP"])
    assert t[aep][COLS].values.tolist() == j[j["Set"].isin(["Max", "AEP"])][COLS].values.tolist()
    for (xj, cj, ej), (xt, ct, et) in zip(captured["jax"], captured["torch"]):
        # rank one: the variance past the first component is rounding
        assert max(ej[1:].max(), et[1:].max()) <= 1e-12 * ej[0]
        want = xj @ cj[0]
        assert np.abs(xt @ ct[0] - want).max() <= SCORE_RTOL * np.abs(want).max()
    for sel in (j, t):
        assert (sel["Type"] == "Train").sum() == 20
        assert {"Max", "AEP", "Diverse"} <= set(sel["Set"])
        assert not set(sel[sel.Type == "Train"].event_id) & set(sel[sel.Type == "Test"].event_id)


def test_diversity_pca_runs_on_the_device_in_float64(catalogs, monkeypatch):
    """The port hands pca_fit float64 tensors on its device and gets the
    numpy reference's components back (pca_fit_reference, the card's check)."""
    seen = []
    fit = tes.pca_fit

    def rec(x, k):
        seen.append((x.device.type, x.dtype))
        c, e = fit(x, k)
        want_c, want_e = pca_fit_reference(x.numpy(), k)
        assert np.abs(c.numpy() - want_c).max() <= SCORE_RTOL * np.abs(want_c).max()
        assert np.abs(e.numpy() - want_e).max() <= SCORE_RTOL * np.abs(want_e).max()
        return c, e

    monkeypatch.setattr(tes, "pca_fit", rec)
    sel = tes.EventSelection(str(catalogs / "varied2000.pq"), device="cpu")
    assert sel.device == "cpu"
    sel.run_selection(35, 14, RPS)
    assert seen == [("cpu", torch.float64)] * 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_selection_without_a_card_raises(catalogs, tmp_path):
    """EventSelection and select-events default to the card; without one
    they raise (torch's own error), and nothing falls back to the CPU."""
    from gpras_tpu_torch.__main__ import main as tmain

    sel = tes.EventSelection(str(catalogs / "varied60.pq"), arrival_rate=5)
    with pytest.raises((AssertionError, RuntimeError)):
        sel.run_selection(20, 6, [2, 5, 10, 25])
    with pytest.raises((AssertionError, RuntimeError)):
        tmain(["select-events", str(catalogs / "varied2000.pq"), str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_write_events_stac_matches(catalogs, tmp_path, monkeypatch):
    j, _, t, _, _ = _select(str(catalogs / "varied2000.pq"), "varied2000", monkeypatch)
    jes.write_events_stac(j, "s3://bucket/events", str(tmp_path / "j.json"))
    item = tes.write_events_stac(t, "s3://bucket/events", str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert item["properties"] == {"datetime": None, "train_event_count": 35,
                                  "test_event_count": 14}
    # non-numeric ids stay strings, a missing Set reads Unknown
    odd = t.head(3).copy()
    odd["event_id"] = ["a-1", "7", "storm x"]
    odd = odd.drop(columns="Set")
    jes.write_events_stac(odd, "/local/events", str(tmp_path / "j2.json"))
    tes.write_events_stac(odd, "/local/events", str(tmp_path / "t2.json"))
    assert (tmp_path / "t2.json").read_bytes() == (tmp_path / "j2.json").read_bytes()
    assets = json.loads((tmp_path / "t2.json").read_text())["assets"]
    assert [a["event_id"] for a in assets.values()] == ["a-1", 7, "storm x"]
    assert {a["properties"]["Set"] for a in assets.values()} == {"Unknown"}


@pytest.mark.parametrize("argv", [[], ["--n-train", "30", "--n-test", "10",
                                       "--target-rps", "2,10,100", "--test-rp-range", "2,150",
                                       "--s3-prefix", "/data/sst"]],
                         ids=["defaults", "options"])
def test_select_events_cli_matches(argv, catalogs, tmp_path, capsys):
    """``select-events`` through both packages' main (the port's with
    ``--device cpu``) writes the same STAC item."""
    from gpras_tpu.__main__ import main as jmain
    from gpras_tpu_torch.__main__ import main as tmain

    pq = str(catalogs / "varied2000.pq")
    assert jmain(["select-events", pq, str(tmp_path / "j.json"), *argv]) == 0
    assert tmain(["select-events", pq, str(tmp_path / "t.json"), *argv,
                  "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [f"wrote {tmp_path / 'j.json'}",
                                                    f"wrote {tmp_path / 't.json'}"]
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
