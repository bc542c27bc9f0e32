"""HmsPreProcessor and the metric suite on the port
(gpras_tpu_torch.eof.preprocessor.HmsPreProcessor, gpras_tpu_torch.metrics)
against the JAX package (gpras_tpu), on the same seeded numpy inputs, in
float64.

Limits, each for a reason:
- HmsPreProcessor: 1e-10 relative on the fit's state and the transformed
  features (numpy and PyTorch eigensolvers on the same covariance: the
  components agree to ~1e-13 where the eigenvalues are apart, and the sign
  convention fixes the rest); the antecedent precipitation index is the
  reference's numpy code, 1e-12.
- Metrics: 1e-12 relative on every function and on ``compute_event_metrics``
  (means and sums over the same entries in another order), exact on the
  integer-valued ones (peak indices, counts, NaN where the reference has
  NaN); ``export_metric_summary``'s three tables equal the reference's to
  rtol 1e-12 (``pandas.testing.assert_frame_equal``).
"""

import sqlite3

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gpras_tpu.eof.preprocessor import HmsPreProcessor as JHms
from gpras_tpu.metrics import metrics as JM
from gpras_tpu_torch.eof.preprocessor import HmsPreProcessor as THms
from gpras_tpu_torch.eof.preprocessor import PreProcessor as TPre
from gpras_tpu_torch.metrics import metrics as TM
from torch_parity import t64

RTOL_HMS = 1e-10
RTOL_METRICS = 1e-12


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.nanmax(np.abs(want), initial=0.0), 1e-300))


# ----------------------------------------------------------------- HmsPreProcessor


def _forcing(n_events=6, steps=20, n_bc=3, n_precip=48, seed=0):
    """A seeded forcing frame: inflow hydrographs and a precip grid of a few
    smooth storm patterns, dry at the start of each event."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, steps)
    grid = np.linspace(0.0, 1.0, n_precip)
    patterns = np.stack([np.sin((k + 1) * np.pi * grid) ** 2 for k in range(4)])
    rows, ev = [], []
    for e in range(n_events):
        amp = rng.uniform(0.2, 2.0, size=4)
        pulse = np.exp(-((t - rng.uniform(0.3, 0.7)) ** 2) / 0.02)
        precip = np.maximum(pulse[:, None] * (amp @ patterns)[None, :]
                            + 0.05 * rng.normal(size=(steps, n_precip)), 0.0)
        precip[:2] = 0.0
        bc = 100.0 * pulse[:, None] * rng.uniform(0.5, 1.5, size=n_bc) + 10.0
        rows.append(np.concatenate([bc, precip], axis=1))
        ev += [f"e{e}"] * steps
    bc_mask = np.array([True] * n_bc + [False] * n_precip)
    return np.concatenate(rows), bc_mask, ~bc_mask, np.asarray(ev)


@pytest.mark.parametrize("event_reset", [False, True])
@pytest.mark.parametrize("modes", [None, 3])
def test_hms_fit_and_transform_match_jax(event_reset, modes):
    x, bc_mask, precip_mask, ev = _forcing()
    jp, tp = JHms(event_reset=event_reset), THms(event_reset=event_reset, device="cpu")
    jp.fit(x, bc_mask, precip_mask, precip_spatial_mode_count=modes, event_ids=ev)
    tp.fit(x, bc_mask, precip_mask, precip_spatial_mode_count=modes, event_ids=ev)
    assert tp.precip_spatial_mode_count == jp.precip_spatial_mode_count > 0
    for k, want in jp.to_dict().items():
        got = tp.to_dict()[k]
        if isinstance(want, np.ndarray) and want.dtype.kind == "f":
            _close(got, want, RTOL_HMS)
        else:
            np.testing.assert_array_equal(got, want)
    x_new, _, _, ev_new = _forcing(n_events=3, seed=1)
    _close(tp.transform(x_new, event_ids=ev_new), jp.transform(x_new, event_ids=ev_new),
           RTOL_HMS)


def test_hms_keeps_the_nan_std_of_a_feature_with_no_nonzero_entry():
    x, bc_mask, precip_mask, _ = _forcing()
    x[:, 0] = 7.0  # a constant inflow column centres to all zeros
    jp, tp = JHms(), THms(device="cpu")
    jp.fit(x, bc_mask, precip_mask, precip_spatial_mode_count=2)
    tp.fit(x, bc_mask, precip_mask, precip_spatial_mode_count=2)
    assert np.isnan(tp.x_std[0]) and np.isnan(jp.x_std[0])
    _close(tp.x_std[1:], jp.x_std[1:], RTOL_HMS)


@pytest.mark.parametrize("k, window", [(0.85, None), (1.0, None), (0.5, 3), (0.85, 5)])
def test_api_matches_jax_with_windows_and_event_ids(k, window):
    rng = np.random.default_rng(3)
    x = rng.uniform(size=23)
    ev = np.array(["a"] * 10 + ["b"] * 6 + ["c"] * 7)
    for ids in (None, ev):
        _close(THms.calc_antecedent_precipitation_index(x, k=k, window=window, event_ids=ids),
               JHms.calc_antecedent_precipitation_index(x, k=k, window=window, event_ids=ids),
               RTOL_METRICS)
    with pytest.raises(ValueError, match="event_ids length"):
        THms.calc_antecedent_precipitation_index(x, event_ids=ev[:5])


def test_hms_artifacts_load_across_packages(tmp_path):
    x, bc_mask, precip_mask, ev = _forcing()
    jp, tp = JHms(event_reset=True), THms(event_reset=True, device="cpu")
    jp.fit(x, bc_mask, precip_mask, event_ids=ev)
    tp.fit(x, bc_mask, precip_mask, event_ids=ev)
    jp.to_file(tmp_path / "j.npz")
    tp.to_file(tmp_path / "t.npz")
    from_j = THms.from_file(tmp_path / "j.npz", device="cpu")
    from_t = JHms.from_file(tmp_path / "t.npz")
    assert from_j.event_reset and from_t.event_reset
    want = jp.transform(x, event_ids=ev)
    _close(from_j.transform(x, event_ids=ev), want, RTOL_HMS)
    _close(from_t.transform(x, event_ids=ev), want, RTOL_HMS)


def test_preprocessor_from_file_loads_each_class_its_own_artifact(tmp_path):
    """The spatial PreProcessor no longer refuses other classes' artifacts;
    each class reads its own, as in the reference."""
    rng = np.random.default_rng(2)
    field = 5.0 + rng.normal(size=(30, 20))
    pre = TPre(hydraulic_parameter="wse", device="cpu")
    pre.fit(field, np.zeros(20), spatial_mode_count=2)
    pre.to_file(tmp_path / "pre.npz")
    x, bc_mask, precip_mask, _ = _forcing()
    hms = THms(device="cpu")
    hms.fit(x, bc_mask, precip_mask, precip_spatial_mode_count=2)
    hms.to_file(tmp_path / "hms.npz")
    np.testing.assert_array_equal(TPre.from_file(tmp_path / "pre.npz", device="cpu")
                                  .transform(field), pre.transform(field))
    np.testing.assert_array_equal(THms.from_file(tmp_path / "hms.npz", device="cpu")
                                  .transform(x), hms.transform(x))


# ----------------------------------------------------------------------- metrics


def _event(t=24, c=40, seed=0, tie=True):
    """Observed and predicted depth fields with dry cells, and sigma; with
    ``tie``, cell 0 peaks twice at the same value in both fields."""
    rng = np.random.default_rng(seed)
    tt = np.linspace(0.0, 1.0, t)[:, None]
    x = np.maximum(np.exp(-((tt - rng.uniform(0.3, 0.7, c)) ** 2) / 0.03)
                   * rng.uniform(0.0, 2.0, c) - 0.1, 0.0)
    y = np.maximum(x + 0.1 * rng.normal(size=(t, c)), 0.0)
    if tie:
        x[:, 0], y[:, 0] = 0.0, 0.0
        x[[4, 9], 0] = 1.25
        y[[3, 11], 0] = 0.75
    conf = rng.uniform(0.05, 0.2, size=(t, c))
    return x, y, conf


def _peaks(x, y):
    return (np.argmax(x, axis=0), np.argmax(y, axis=0))


TWO = ["rmse_aoi_toi", "mae_aoi_toi", "rmse_aoi_ts", "rmse_cell_toi", "err_aoi_toi",
       "err_aoi_ts", "err_cell_toi"]
PEAKS = ["rmse_aoi_mts", "err_cell_mts", "nse_aoi_mts", "err_aoi_mts"]
CONF = ["conf_aoi_toi", "conf_aoi_ts", "conf_cell_toi"]
COUNTS = ["pod_mts", "rfa_mts", "csi_mts", "f2_mts", "f3_mts"]


@pytest.mark.parametrize("name", TWO + PEAKS + CONF + COUNTS + ["fi_aoi_toi"])
@pytest.mark.parametrize("threshold", [0.5, 5.0])  # 5.0: every peak dry, empty denominators
def test_each_metric_matches_jax(name, threshold):
    x, y, conf = _event()
    x_mts, y_mts = _peaks(x, y)
    tf, jf = getattr(TM, name), getattr(JM, name)
    tx, ty = t64(x), t64(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if name in TWO:
        got, want = tf(tx, ty), jf(jx, jy)
    elif name in PEAKS:
        got = tf(tx, ty, torch.as_tensor(x_mts), torch.as_tensor(y_mts))
        want = jf(jx, jy, jnp.asarray(x_mts), jnp.asarray(y_mts))
    elif name in CONF:
        got, want = tf(t64(conf)), jf(jnp.asarray(conf))
    elif name in COUNTS:
        got = tf(tx, ty, threshold, torch.as_tensor(x_mts), torch.as_tensor(y_mts))
        want = jf(jx, jy, threshold, jnp.asarray(x_mts), jnp.asarray(y_mts))
    else:
        got, want = tf(tx, ty, 3, 0.1), jf(jx, jy, 3, 0.1)
    assert got.dtype == torch.float64
    if np.isnan(np.asarray(want)).any():
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    else:
        _close(got, want, RTOL_METRICS)
    if threshold == 5.0 and name in ("f2_mts", "f3_mts"):
        assert float(got) == 1.0
    if threshold == 5.0 and name in ("pod_mts", "rfa_mts", "csi_mts"):
        assert np.isnan(float(got))  # 0 / 0, as in the reference


@pytest.mark.parametrize("t_tol, v_tol", [(0, 0.0), (0, 0.1), (1, 0.1), (3, 0.1), (5, 0.02),
                                          (30, 0.1)])
def test_fidelity_index_shifts_or_into_updated_rows(t_tol, v_tol):
    x, y, _ = _event(seed=4)
    _close(TM.fi_aoi_toi(t64(x), t64(y), t_tol, v_tol),
           JM.fi_aoi_toi(jnp.asarray(x), jnp.asarray(y), t_tol, v_tol), RTOL_METRICS)


@pytest.mark.parametrize("kwargs", [dict(), dict(depth_threshold=0.3, t_tol=3, v_tol=0.1),
                                    dict(contingency=False), dict(depth_threshold=9.0)])
def test_compute_event_metrics_matches_jax(kwargs):
    x, y, conf = _event(seed=5)
    got = TM.compute_event_metrics(t64(x), t64(y), t64(conf), **kwargs)
    want = JM.compute_event_metrics(jnp.asarray(x), jnp.asarray(y), jnp.asarray(conf), **kwargs)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if np.isnan(w).any():
            np.testing.assert_array_equal(np.isnan(got[k].numpy()), np.isnan(w))
        else:
            _close(got[k], w, RTOL_METRICS)


def test_a_tied_peak_takes_the_first_index():
    x, y, conf = _event()
    assert int(torch.argmax(t64(x), dim=0)[0]) == 4 and int(torch.argmax(t64(y), dim=0)[0]) == 3
    got = TM.compute_event_metrics(t64(x), t64(y), t64(conf))
    _close(got["err_cell_mts"][0], 0.5, RTOL_METRICS)


def test_metric_columns_are_the_references():
    assert TM.SCALAR_COLUMNS == JM.SCALAR_COLUMNS
    assert TM.TS_COLUMNS == JM.TS_COLUMNS
    assert TM.CELL_COLUMNS == JM.CELL_COLUMNS


def _frames(n_events=3, seed=6):
    """(event, timestep)-indexed frames with ragged event lengths."""
    xs, ys, cs, idx = [], [], [], []
    for e in range(n_events):
        x, y, conf = _event(t=18 + 3 * e, c=12, seed=seed + e, tie=e == 0)
        xs.append(x)
        ys.append(y)
        cs.append(conf)
        idx += [(f"ev{e}", 100 + s) for s in range(x.shape[0])]
    index = pd.MultiIndex.from_tuples(idx, names=["event", "timestep"])
    cols = [f"cell{i}" for i in range(12)]
    return tuple(pd.DataFrame(np.concatenate(a), index=index, columns=cols)
                 for a in (xs, ys, cs))


@pytest.mark.parametrize("kwargs", [dict(depth_threshold=0.4),
                                    dict(t_tol=2, v_tol=0.1, hydraulic_parameter="velocity")])
def test_export_metric_summary_tables_equal_jax(tmp_path, kwargs):
    x_all, y_all, conf_all = _frames()
    JM.export_metric_summary(x_all, y_all, conf_all, tmp_path / "j.db", **kwargs)
    TM.export_metric_summary(x_all, y_all, conf_all, tmp_path / "t.db", device="cpu", **kwargs)
    for table in ("scalar_metrics", "timeseries_metrics", "cell_metrics"):
        frames = []
        for db in ("j.db", "t.db"):
            with sqlite3.connect(tmp_path / db) as con:
                frames.append(pd.read_sql(f"select * from {table}", con))
        pd.testing.assert_frame_equal(frames[1], frames[0], rtol=1e-12)
