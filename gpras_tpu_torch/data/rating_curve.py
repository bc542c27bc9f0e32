"""Stage-discharge rating curve: least-squares cubic B-spline, from scratch.

A copy of ``gpras_tpu/data/rating_curve.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax).

Capability parity with the reference's ``RatingCurve`` (gpras/preprocess.py:454-513),
which wraps scipy's FITPACK ``LSQUnivariateSpline``: finite/positive/range
filtering and sort (gpras/preprocess.py:473-490), 7 interior knots placed at
discharge quantiles (gpras/preprocess.py:492-496), cubic fit, rmse/mae fit stats,
``predict`` mapping discharge -> WSE.

Implementation: Cox-de Boor basis evaluation (vectorized numpy) on a clamped
cubic knot vector + one dense least-squares solve. No Fortran dependency; the
design matrix is tiny (n_points x (n_knots + 4)).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def bspline_design_matrix(x: np.ndarray, knots: np.ndarray, degree: int = 3) -> np.ndarray:
    """Cox-de Boor recursion, vectorized over evaluation points.

    ``knots`` is the full (clamped) knot vector; returns (len(x), n_basis) with
    n_basis = len(knots) - degree - 1.
    """
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(knots, dtype=np.float64)
    n_basis = len(t) - degree - 1
    # degree-0: indicator of [t_i, t_{i+1}); close the last interval
    b = np.zeros((len(x), len(t) - 1))
    for i in range(len(t) - 1):
        if t[i + 1] > t[i]:
            b[:, i] = (x >= t[i]) & (x < t[i + 1])
    # clamp right end: points at the final knot belong to the last nonempty interval
    last = np.max(np.nonzero(t < t[-1])[0]) if np.any(t < t[-1]) else 0
    b[x >= t[-1], last] = 1.0
    for k in range(1, degree + 1):
        b_new = np.zeros((len(x), len(t) - k - 1))
        for i in range(len(t) - k - 1):
            left_den = t[i + k] - t[i]
            right_den = t[i + k + 1] - t[i + 1]
            term = 0.0
            if left_den > 0:
                term = (x - t[i]) / left_den * b[:, i]
            if right_den > 0:
                term = term + (t[i + k + 1] - x) / right_den * b[:, i + 1]
            b_new[:, i] = term
        b = b_new
    return b[:, :n_basis]


class RatingCurve:
    """Discharge -> WSE spline (reference gpras/preprocess.py:454)."""

    def __init__(
        self,
        q: np.ndarray,
        wse: np.ndarray,
        drop_nonpos: bool = True,
        qmin: float = 10,
        qmax: float = 10e10,
        n_knots: int = 7,
    ) -> None:
        self._preprocess_data(np.asarray(q, float), np.asarray(wse, float),
                              drop_nonpos, qmin, qmax)
        if len(self.q) < max(8, n_knots + 5):
            raise ValueError(
                f"Not enough points ({len(self.q)}) for knots={n_knots}. "
                "Reduce knots or add data."
            )
        self.n_knots = n_knots
        self._fit()

    def _preprocess_data(self, q, wse, drop_nonpos, qmin, qmax) -> None:
        """Finite/positive/range mask then sort by discharge
        (gpras/preprocess.py:473-490)."""
        mask = np.isfinite(q) & np.isfinite(wse)
        if drop_nonpos:
            mask &= q > 0
        if qmin is not None:
            mask &= q > float(qmin)
        if qmax is not None:
            mask &= q < float(qmax)
        q, wse = q[mask], wse[mask]
        order = np.argsort(q)
        self.q = q[order]
        self.wse = wse[order]

    def _fit(self) -> None:
        """Interior knots at discharge quantiles; clamped cubic LSQ solve
        (knot placement parity with gpras/preprocess.py:492-496)."""
        qs_ = np.linspace(0.0, 1.0, self.n_knots + 2)[1:-1]
        interior = np.quantile(self.q, qs_)
        k = 3
        self.knots = np.concatenate([
            np.repeat(self.q[0], k + 1), interior, np.repeat(self.q[-1], k + 1)
        ])
        design = bspline_design_matrix(self.q, self.knots, k)
        self.coef, *_ = np.linalg.lstsq(design, self.wse, rcond=None)

    @property
    def fit_stats(self) -> dict[str, Any]:
        """rmse/mae of the fit (gpras/preprocess.py:498-503)."""
        resid = self.predict(self.q) - self.wse
        return {"rmse": np.sqrt(np.mean(resid**2)), "mae": np.mean(np.abs(resid))}

    def predict(self, q: np.ndarray) -> np.ndarray:
        """WSE at given discharges; extrapolation is clamped to the fitted range
        (FITPACK extrapolates the end polynomial; clamping is safer for rating
        curves, which must stay monotone-ish outside the data)."""
        q = np.clip(np.asarray(q, dtype=np.float64), self.q[0], self.q[-1])
        return bspline_design_matrix(q, self.knots, 3) @ self.coef

    def plot(self, out_path: str | Path, title: str | None = None) -> None:
        """Fitted curve + source scatter (gpras/preprocess.py:505-509)."""
        from gpras_tpu_torch.plotting import plot_rating_curve

        q_rng = np.linspace(self.q.min(), self.q.max(), 1000)
        plot_rating_curve(self.q, self.wse, q_rng, self.predict(q_rng), out_path, title)
