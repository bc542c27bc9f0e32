"""Parquet-backed dataset replay: skip HDF extraction on re-runs.

A copy of ``gpras_tpu/data/reader.py``: either package reads the other's
DB. It imports neither h5py nor matplotlib, so the pipeline replays a DB
where those are not installed.

Parity with the reference's 4-table parquet DB and ``RasReader``
(gpras/preprocess.py:36-41, 185-193, 809-863). A "DB" is a directory with:

- ``hf_model.parquet``   — HF field, (run, t)-MultiIndexed rows x cell columns
- ``lf_model.parquet``   — LF features, same index
- ``cell_info.parquet``  — hf_cell_id, elevation, area, centroid x/y
  [+ lf_cell_id]  (the reference stores geoparquet polygons; we store centroids —
  geometry stays in the RAS HDF and can be re-read when plotting needs it)
- ``ref_lines.parquet``  — reference-line WSE/flow timeseries

``is_valid`` keys replay on file existence exactly like the reference
(gpras/preprocess.py:856-863), which is the pipeline's artifact-cache seam.
"""

from __future__ import annotations

import os
from functools import cached_property
from pathlib import Path

import numpy as np
import pandas as pd

DB_PATHS = {
    "hf": "hf_model.parquet",
    "lf": "lf_model.parquet",
    "cell_info": "cell_info.parquet",
    "ref_lines": "ref_lines.parquet",
}


def export_db(
    out_path: str | Path,
    hf_df: pd.DataFrame,
    lf_df: pd.DataFrame,
    cell_info: pd.DataFrame,
    ref_lines: pd.DataFrame | None = None,
) -> None:
    """Write the 4-table DB (reference export_db, gpras/preprocess.py:185-193)."""
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    hf_df.to_parquet(out / DB_PATHS["hf"])
    lf_df.to_parquet(out / DB_PATHS["lf"])
    cell_info.to_parquet(out / DB_PATHS["cell_info"], index=False)
    if ref_lines is None:
        ref_lines = pd.DataFrame()
    ref_lines.to_parquet(out / DB_PATHS["ref_lines"])


class RasReader:
    """Replay a built DB instead of re-extracting from RAS models
    (reference gpras/preprocess.py:809-863)."""

    def __init__(self, db_path: str | Path):
        self.db_path = Path(db_path)

    @property
    def aligned_datasets(self) -> tuple[pd.DataFrame, pd.DataFrame]:
        hf_df = pd.read_parquet(self.db_path / DB_PATHS["hf"])
        lf_df = pd.read_parquet(self.db_path / DB_PATHS["lf"])
        return hf_df, lf_df

    @property
    def hf_resampler(self) -> np.ndarray:
        return self._cell_info["hf_cell_id"].values

    @property
    def lf_resampler(self) -> np.ndarray:
        return self._cell_info["lf_cell_id"].values

    @property
    def cell_elevations(self) -> np.ndarray:
        return self._cell_info["elevation"].values

    @property
    def cell_areas(self) -> np.ndarray:
        return self._cell_info["area"].values

    @cached_property
    def _cell_info(self) -> pd.DataFrame:
        return pd.read_parquet(self.db_path / DB_PATHS["cell_info"])

    @cached_property
    def hf_geometry_aoi(self) -> pd.DataFrame:
        """Cell table with a ``cell_id`` alias column (plotting convenience,
        mirrors gpras/preprocess.py:849-854)."""
        df = self._cell_info.copy()
        df["cell_id"] = df["hf_cell_id"]
        return df

    @cached_property
    def ref_lines(self) -> pd.DataFrame:
        return pd.read_parquet(self.db_path / DB_PATHS["ref_lines"])

    @staticmethod
    def is_valid(db_path: str | Path) -> bool:
        if not os.path.isdir(db_path):
            return False  # missing OR a stray regular file: rebuild the DB
        files = os.listdir(db_path)
        return all(i in files for i in DB_PATHS.values())
