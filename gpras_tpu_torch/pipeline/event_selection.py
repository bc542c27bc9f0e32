"""Storm-event selection from an SST catalog + STAC events writer.

A copy of ``gpras_tpu/pipeline/event_selection.py`` (the port may not import
the JAX package, whose ``__init__`` imports jax), with one change:
``EventSelection`` takes a ``device`` (``"cuda"`` by default). The diversity
fill's two centered hydrograph pivots go there as float64 tensors, the frame's
dtype, through the port's ``pca_fit``, and only their scores come back to the
host. The greedy max-min loop, the return periods and the test bins stay
numpy.

Capability parity with the reference's experimental-design tooling
(production/pre_processing/event_selection.py:13-324):

- empirical return periods from block maxima + rank interpolation with linear
  extrapolation (reference :34-67),
- AEP-targeted training storms: three "Max" preselects (max precip RP, max
  inflow RP, max joint normalized magnitude) then, per target RP, the candidate
  with the smallest joint log10 distance in (RP_precip, RP_inflow) space that is
  not within a relative tolerance of an already-selected storm (:73-146),
- diversity fill: PCA of per-event precip + inflow hydrographs (device PCA from
  gpras_tpu_torch.eof.pca), standardized, then greedy max-min-distance selection
  (:148-185),
- test storms: one sample per log-spaced RP bin (seeded RNG) on both RP axes,
  with random filler if bins under-fill (:187-237),
- ``write_events_stac``: STAC item with per-event S3 hrefs and RP properties
  (:260-302).

Input parquet schema: columns event_id, datetime, precip-cum, precip-excess,
inflow (one row per event-hour).
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import pandas as pd
import torch

from gpras_tpu_torch.eof.pca import pca_fit


def block_maxima_return_periods(values: np.ndarray, arrival_rate: int) -> np.ndarray:
    """Empirical RP of each value: block maxima -> descending ranks ->
    RP = (n_blocks + 1) / rank, interpolated (and linearly extrapolated) back
    onto the values."""
    v = np.asarray(values, dtype=np.float64)
    blocks = np.array([v[i:i + arrival_rate].max()
                       for i in range(0, len(v), arrival_rate)])
    sorted_desc = np.sort(blocks)[::-1]
    ranks = np.arange(1, len(sorted_desc) + 1)
    rp_desc = (len(sorted_desc) + 1) / ranks
    xb, idx = np.unique(sorted_desc, return_index=True)
    yb = rp_desc[idx]

    def interp_extrap(x):
        out = np.interp(x, xb, yb)
        if len(xb) >= 2:
            lo = x < xb[0]
            hi = x > xb[-1]
            slope_lo = (yb[1] - yb[0]) / (xb[1] - xb[0])
            slope_hi = (yb[-1] - yb[-2]) / (xb[-1] - xb[-2])
            out = np.where(lo, yb[0] + slope_lo * (x - xb[0]), out)
            out = np.where(hi, yb[-1] + slope_hi * (x - xb[-1]), out)
        # linear extrapolation below the smallest block maximum can go
        # negative (the reference lets it — negative recurrence intervals
        # then break its relative-tolerance dedup and leak into the STAC);
        # clamp to a small positive floor, preserving order via the clip
        return np.maximum(out, 0.01)

    return interp_extrap(v)


class EventSelection:
    """Select train/test storms from SST results (reference event_selection.py:13)."""

    def __init__(self, pq_file: str, arrival_rate: int = 10,
                 window_ratio: float = 0.2,
                 test_rp_range: list[int] | None = None, tol: float = 0.15,
                 device: str | torch.device = "cuda"):
        self.pq_file = pq_file
        self.device = device
        self.arrival_rate = arrival_rate
        self.window_ratio = window_ratio
        self.tol = tol
        self.test_rp_range = test_rp_range or [5, 2000]
        self.df = pd.read_parquet(pq_file)
        self.event_max = self._calculate_return_periods()

    def _calculate_return_periods(self) -> pd.DataFrame:
        em = (self.df.groupby("event_id")[["precip-cum", "inflow"]].max()
              .reset_index().sort_values("event_id").reset_index(drop=True))
        em["RP_precip-cum"] = block_maxima_return_periods(
            em["precip-cum"].values, self.arrival_rate)
        em["RP_inflow"] = block_maxima_return_periods(
            em["inflow"].values, self.arrival_rate)
        return em

    def _is_close(self, rp1: float, rp2: float) -> bool:
        return abs(rp1 - rp2) / max(rp1, rp2) < self.tol

    # ------------------------------------------------------------- AEP training

    def _select_aep_storms(self, target_rps: list[int]) -> pd.DataFrame:
        em = self.event_max
        selected: list[pd.Series] = []
        sets: list[str] = []
        chosen: set = set()

        def norm(col):
            c = em[col]
            return (c - c.min()) / (c.max() - c.min())

        joint = norm("precip-cum") + norm("inflow")
        for row in (em.loc[em["RP_precip-cum"].idxmax()],
                    em.loc[em["RP_inflow"].idxmax()],
                    em.loc[joint.idxmax()]):
            if row["event_id"] not in chosen:
                selected.append(row)
                chosen.add(row["event_id"])
                sets.append("Max")

        def conflicts(candidate) -> bool:
            return any(self._is_close(candidate["RP_precip-cum"], s["RP_precip-cum"])
                       and self._is_close(candidate["RP_inflow"], s["RP_inflow"])
                       for s in selected)

        for rp in target_rps:
            rmin, rmax = rp * (1 - self.window_ratio), rp * (1 + self.window_ratio)
            for rp_field in ("RP_precip-cum", "RP_inflow"):
                window = em[em[rp_field].between(rmin, rmax)].copy()
                if window.empty:
                    continue
                window["log_dist"] = np.sqrt(
                    np.log10(window["RP_precip-cum"] / rp) ** 2
                    + np.log10(window["RP_inflow"] / rp) ** 2)
                for _, cand in window.sort_values("log_dist").iterrows():
                    if cand["event_id"] not in chosen and not conflicts(cand):
                        selected.append(cand.drop(labels=["log_dist"],
                                                  errors="ignore"))
                        chosen.add(cand["event_id"])
                        sets.append("AEP")
                        break

        out = pd.DataFrame(selected).copy()
        out["Set"] = sets
        out["Type"] = "Train"
        return out

    # ----------------------------------------------------------- diversity fill

    def _select_diverse_storms(self, selected_event_ids: list, num_to_select: int,
                               n_components: int = 5) -> pd.DataFrame:
        df = self.df.copy()
        df["datetime"] = pd.to_datetime(df["datetime"])
        df = df.sort_values(["event_id", "datetime"])
        df["hour"] = df.groupby("event_id").cumcount()
        p1 = df.pivot(index="event_id", columns="hour",
                      values="precip-excess").fillna(0)
        p2 = df.pivot(index="event_id", columns="hour", values="inflow").fillna(0)

        def pcs(frame: pd.DataFrame) -> np.ndarray:
            x = torch.as_tensor(frame.values - frame.values.mean(axis=0),
                                device=self.device)
            comps, _ = pca_fit(x, n_components)
            return (x @ comps.T).cpu().numpy()

        combined = np.concatenate([pcs(p1), pcs(p2)], axis=1)
        std = combined.std(axis=0)
        std[std == 0] = 1.0
        scaled = pd.DataFrame((combined - combined.mean(axis=0)) / std,
                              index=p1.index)

        selected_list = list(selected_event_ids)
        candidates = [i for i in scaled.index if i not in set(selected_list)]
        if len(candidates) < num_to_select:
            raise ValueError(
                f"diversity fill needs {num_to_select} more events but only "
                f"{len(candidates)} remain in the catalog")
        added = []
        for _ in range(num_to_select):
            sel_vecs = scaled.loc[selected_list].values
            cand_vecs = scaled.loc[candidates].values
            dists = np.linalg.norm(cand_vecs[:, None, :] - sel_vecs[None, :, :],
                                   axis=2)
            best = candidates[int(dists.min(axis=1).argmax())]
            added.append(best)
            selected_list.append(best)
            candidates.remove(best)

        out = self.event_max[self.event_max.event_id.isin(added)].copy()
        out["Set"] = "Diverse"
        out["Type"] = "Train"
        return out

    # ----------------------------------------------------------------- test set

    def _select_test_storms(self, test_rp_range: list[int], n_test_storms: int,
                            excluded_ids: list | None = None) -> pd.DataFrame:
        rp_min, rp_max = test_rp_range
        n_bins = n_test_storms // 2
        rng = np.random.default_rng(seed=42)
        eligible = self.event_max[
            self.event_max["RP_precip-cum"].between(rp_min, rp_max)
            & self.event_max["RP_inflow"].between(rp_min, rp_max)].copy()
        if excluded_ids:
            eligible = eligible[~eligible["event_id"].isin(excluded_ids)]
        if eligible.empty:
            raise ValueError("No eligible storms found in the specified test RP range.")

        def sample_bins(rp_col: str) -> set:
            bins = np.logspace(np.log10(rp_min), np.log10(rp_max), n_bins + 1)
            out = set()
            for i in range(n_bins):
                sub = eligible[(eligible[rp_col] >= bins[i])
                               & (eligible[rp_col] <= bins[i + 1])]
                if not sub.empty:
                    pick = sub.sample(1, random_state=int(rng.integers(0, 10000)))
                    out.add(pick.iloc[0]["event_id"])
            return out

        test_ids = sample_bins("RP_precip-cum") | sample_bins("RP_inflow")
        if len(test_ids) < n_test_storms:
            remaining = eligible[~eligible["event_id"].isin(test_ids)]
            filler = remaining.sample(n=min(n_test_storms - len(test_ids),
                                            len(remaining)),
                                      random_state=42)["event_id"].tolist()
            test_ids.update(filler)
        out = self.event_max[self.event_max.event_id.isin(test_ids)].copy()
        out["Set"] = "Test"
        out["Type"] = "Test"
        return out

    def run_selection(self, n_train_storms: int, n_test_storms: int,
                      target_rps: list[int]) -> tuple[pd.DataFrame, pd.DataFrame]:
        """AEP picks -> diversity fill to n_train -> binned test set
        (reference event_selection.py:239-257)."""
        aep = self._select_aep_storms(target_rps)
        diverse = self._select_diverse_storms(
            aep.event_id.tolist(), n_train_storms - len(aep))
        train = pd.concat([aep, diverse], ignore_index=True)
        train["Type"] = "Train"
        test = self._select_test_storms(self.test_rp_range, n_test_storms,
                                        excluded_ids=train.event_id.tolist())
        return pd.concat([train, test], ignore_index=True), self.event_max


def write_events_stac(selected_df: pd.DataFrame, s3_prefix: str,
                      out_path: str) -> dict[str, Any]:
    """STAC item with per-event DSS hrefs + RP properties
    (reference event_selection.py:260-302)."""
    assets = {}
    for _, row in selected_df.iterrows():
        # SST catalogs use integer ids (the reference int()s them,
        # event_selection.py:266); keep non-numeric ids as-is
        raw_id = row["event_id"]
        try:
            event_id: Any = int(raw_id)
        except (TypeError, ValueError):
            event_id = str(raw_id)
        assets[str(event_id)] = {
            "href": f"{s3_prefix}/{event_id}/hydrology/SST.dss",
            "type": "application/x.hec-dss",
            "roles": [str(row["Type"])],
            "event_id": event_id,
            "properties": {
                "Set": str(row.get("Set", "Unknown")),
                "avg_precip_in": round(float(row["precip-cum"]), 2),
                "peak_inflow_cfs": round(float(row["inflow"]), 2),
                "recurrence_interval_precip": round(float(row["RP_precip-cum"]), 2),
                "recurrence_interval_inflow": round(float(row["RP_inflow"]), 2),
            },
        }
    item: dict[str, Any] = {
        "type": "Feature",
        "stac_version": "1.1.0",
        "id": "GPR_SST_Events",
        "geometry": None,
        "bbox": None,
        "properties": {
            "datetime": None,
            "train_event_count": int((selected_df["Type"] == "Train").sum()),
            "test_event_count": int((selected_df["Type"] == "Test").sum()),
        },
        "links": [],
        "assets": assets,
    }
    with open(out_path, "w") as f:
        json.dump(item, f, indent=2)
    return item
