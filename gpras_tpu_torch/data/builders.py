"""DataBuilders: extract + align HF/LF training data from HEC-RAS/HMS outputs.

Capability parity with the reference's builder hierarchy
(gpras/preprocess.py:44-806):

- ``DataBuilder``       — base: per-plan HF extraction, temporal clipping by flow
  convergence, AOI masking, parquet export (gpras/preprocess.py:44-324).
- ``RasUpskillDataBuilder``  — LF-RAS -> HF-RAS pairing with max-overlap cell
  resampling and below-ground clamping (gpras/preprocess.py:327-427).
- ``RasInterpolaterBuilder`` — Delaunay LF->HF interpolation
  (gpras/preprocess.py:430-451). The reference rebuilds a
  ``LinearNDInterpolator`` **per timestep** in a Python loop
  (gpras/preprocess.py:444-447); here the triangulation and barycentric weights
  are computed once and each timestep is a vectorized gather+weighted-sum, so the
  whole timeseries interpolates in one numpy einsum.
- ``HmsUpskillDataBuilder``  — LF features straight from HMS DSS forcing
  (gpras/preprocess.py:700-806).
- ``PseudoSurfaceDataBuilder`` — rating-curve + centerline pseudo surface with a
  nested HMS-upskill GPR estimate (gpras/preprocess.py:516-697).

Geometry predicates use ``gpras_tpu_torch.data.geometry`` (no GEOS): the LF->HF
max-overlap pairing is realized as "LF cell containing the HF centroid"
(nearest-LF-centroid fallback), which selects the dominant-overlap cell for the
convex cells of RAS meshes.

A copy of ``gpras_tpu/data/builders.py`` (host numpy code), with one change:
``PseudoSurfaceDataBuilder`` takes a ``device`` for the port's fluvial
``GPRAS`` and preprocessors it loads, so its nested estimate runs there. The
pipeline constructs a builder only when the parquet DB is missing, so a
replay never imports this module; it imports without h5py, which
``ras_model`` imports where it first reads an HDF file.
"""

from __future__ import annotations

import re
from datetime import datetime
from functools import cached_property
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import pandas as pd

from gpras_tpu_torch.data import reader as db
from gpras_tpu_torch.data.geometry import LineString, Polygon, rasterize_polygon
from gpras_tpu_torch.data.ras_model import RasModel
from gpras_tpu_torch.data.rating_curve import RatingCurve

if TYPE_CHECKING:
    import torch

HydraulicParameterType = str  # "wse" | "depth" | "velocity"


def _convex_ring_mask(verts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """True per ring iff the polygon is convex (all turn cross-products share a
    sign; collinear vertices tolerated). verts (n, maxv, 2) padded, counts (n,)."""
    out = np.empty(len(counts), dtype=bool)
    for i, c in enumerate(np.asarray(counts, dtype=int)):
        if c < 4:
            out[i] = True
            continue
        p = verts[i, :c]
        q = np.concatenate([p, p[:2]], axis=0)
        e = np.diff(q, axis=0)  # c+1 edges incl. wrap
        cross = e[:-1, 0] * e[1:, 1] - e[:-1, 1] * e[1:, 0]
        tol = 1e-9 * max(float(np.max(np.abs(cross))), 1.0)
        out[i] = bool(np.all(cross >= -tol) or np.all(cross <= tol))
    return out


class DataBuilder:
    """Base extractor: HF data, temporal clipping, AOI masking
    (reference gpras/preprocess.py:44)."""

    def __init__(
        self,
        hf_ras: RasModel,
        mesh_id: str,
        plans: list[str],
        area_of_interest: Polygon,
        cell_id_field: str = "cell_id",
        flow_convergence_threshold: float = 0.95,
        cutoffs: dict[str, tuple[int, int]] | None = None,
        hf_resampler: np.ndarray | None = None,
        hydraulic_parameter: HydraulicParameterType = "wse",
    ):
        self.hf_ras = hf_ras
        self.mesh_id = mesh_id
        self.plans = plans
        self.area_of_interest = area_of_interest
        self.cell_id_field = cell_id_field
        self.flow_convergence_threshold = flow_convergence_threshold
        self.hf_resampler = hf_resampler
        self.hydraulic_parameter = hydraulic_parameter
        self.set_spatial_resamplers()
        self.cutoffs: dict[str, tuple[int, int]] = cutoffs or {}
        self._hf_aligned: pd.DataFrame | None = None
        self._lf_aligned: pd.DataFrame | None = None

    # -------------------------------------------------------------- extraction

    def align_datasets(self, plot_dir: str | None = None) -> None:
        """Per-plan incremental load -> temporal clip -> (run, t)-indexed concat
        (reference gpras/preprocess.py:89-116; incremental to bound RAM)."""
        hf_store, lf_store = [], []
        for p in self.plans:
            lf_data = self.get_lf_plan_data(p)
            hf_data = self.get_hf_plan_data(p)
            combo = np.concatenate([hf_data.values, lf_data.values], axis=1)
            if p not in self.cutoffs:
                self.cutoffs[p] = self.get_cutoff(combo)
                if plot_dir is not None:
                    self._plot_cutoff_diagnostic(combo, self.cutoffs[p],
                                                 str(Path(plot_dir) / f"{p}.png"))
            start, stop = self.cutoffs[p]
            dur = stop - start
            index = pd.MultiIndex.from_arrays(
                [[p] * dur, np.arange(dur)], names=["run", "t"])
            hf_store.append(pd.DataFrame(hf_data.values[start:stop],
                                         columns=hf_data.columns, index=index))
            lf_store.append(pd.DataFrame(lf_data.values[start:stop],
                                         columns=lf_data.columns, index=index))
        self._hf_aligned = pd.concat(hf_store)
        self._lf_aligned = pd.concat(lf_store)

    @cached_property
    def aligned_datasets(self) -> tuple[pd.DataFrame, pd.DataFrame]:
        if self._hf_aligned is None or self._lf_aligned is None:
            self.align_datasets()
        return self._hf_aligned, self._lf_aligned

    @cached_property
    def aligned_ref_line_df(self) -> pd.DataFrame:
        """Reference-line WSE/flow, clipped to each plan's cutoff window
        (reference gpras/preprocess.py:125-133)."""
        store = []
        for p in self.plans:
            ref = self.get_ref_line_df(p)
            start, stop = self.cutoffs[p]
            store.append(ref.iloc[start:stop].copy())
        return pd.concat(store)

    def get_cutoff(self, combo: np.ndarray) -> tuple[int, int]:
        """Warmup/convergence clipping: keep the window where the cumulative
        normalized |dWSE/dt| is in (1e-3, flow_convergence_threshold)
        (reference gpras/preprocess.py:135-147, incl. NaN tail trimming)."""
        if np.isnan(combo).any():
            nan_cols = np.isnan(combo).any(axis=0)
            end_trim = np.min(np.argmax(np.isnan(combo), axis=0)[nan_cols])
            combo = combo[:end_trim, :]
        dx_dt = self._delta_cols_norm(combo)
        rate = np.sum(dx_dt, axis=1) / np.sum(dx_dt)
        cum = np.cumsum(rate)
        stop = int(np.argmax(cum > self.flow_convergence_threshold))
        start = int(np.argmax(cum > 10e-4))
        return (start, stop)

    @staticmethod
    def _delta_cols_norm(arr: np.ndarray) -> np.ndarray:
        """Per-column-normalized |diff| over time (gpras/preprocess.py:149-155)."""
        dx_dt = np.abs(np.diff(arr, axis=0))
        normalizer = np.sum(dx_dt, axis=0)
        normalizer[normalizer == 0] = 1
        return dx_dt / normalizer

    def _plot_cutoff_diagnostic(self, arr, cutoffs, out_path: str) -> None:
        from gpras_tpu_torch.plotting import ts_clipping

        Path(out_path).parent.mkdir(exist_ok=True, parents=True)
        ts_clipping(self._delta_cols_norm(arr), cutoffs, out_path)

    def get_hf_plan_data(self, plan: str) -> pd.DataFrame:
        """HF WSE (or velocity magnitude) within the AOI
        (reference gpras/preprocess.py:163-174)."""
        ph = self.hf_ras.plan_hdfs[plan]
        dt_index = ph.timestamps()
        if self.hydraulic_parameter == "velocity":
            vx = ph.mesh_timeseries_output(self.mesh_id, "Cell Velocity - Velocity X")
            vy = ph.mesh_timeseries_output(self.mesh_id, "Cell Velocity - Velocity Y")
            vals = np.sqrt(vx**2 + vy**2)
        else:
            vals = ph.mesh_timeseries_output(self.mesh_id, "Water Surface")
        vals = vals[:, self.hf_resampler]
        return pd.DataFrame(vals, index=dt_index, columns=self.hf_resampler)

    def get_lf_plan_data(self, plan: str) -> pd.DataFrame:
        raise RuntimeError("Use a DataBuilder subclass for LF data extraction.")

    def set_spatial_resamplers(self) -> None:
        if self.hf_resampler is None:
            self.hf_resampler = self.hf_cell_ids_aoi

    # ----------------------------------------------------------------- geometry

    @cached_property
    def _hf_mesh(self):
        return self.hf_ras.get_plan_geometry(self.plans, self.mesh_id)

    @cached_property
    def _hf_mask(self) -> np.ndarray:
        return self._hf_mesh.intersects(self.area_of_interest)

    @cached_property
    def hf_cell_ids_aoi(self) -> np.ndarray:
        return self._hf_mesh.cell_ids[self._hf_mask]

    @cached_property
    def hf_centroids_aoi(self) -> np.ndarray:
        return self._hf_mesh.centroids[self._hf_mask]

    @cached_property
    def hf_geometry_aoi(self) -> pd.DataFrame:
        """AOI cell table (id + centroid + polygon ring), the plotting/geometry
        surface the reference exposes as a GeoDataFrame
        (gpras/preprocess.py:214-217). The ``geometry`` column holds each
        cell's (k, 2) exterior-ring vertex array — the same column name the
        reference's GeoDataFrame uses — so the spatial plots can render true
        polygon choropleths (PolyCollection, no GEOS needed)."""
        c = self.hf_centroids_aoi
        df = pd.DataFrame({
            self.cell_id_field: self.hf_cell_ids_aoi,
            "x": c[:, 0],
            "y": c[:, 1],
        })
        verts, counts = self._hf_mesh.padded_vertices()
        rows = np.nonzero(self._hf_mask)[0]
        df["geometry"] = [verts[i, : counts[i]] for i in rows]
        return df

    @cached_property
    def cell_areas(self) -> np.ndarray:
        return self.hf_ras.get_cell_areas(self.plans[0], self.mesh_id)[self.hf_resampler]

    @cached_property
    def cell_elevations(self) -> np.ndarray:
        return self.hf_ras.get_cell_minimum_elevation(self.plans[0], self.mesh_id)[self.hf_resampler]

    @cached_property
    def cell_info_df(self) -> pd.DataFrame:
        """Cell table persisted to the DB (reference gpras/preprocess.py:195-205;
        centroids instead of polygons — see data/reader.py)."""
        c = self.hf_centroids_aoi
        return pd.DataFrame({
            "hf_cell_id": self.hf_resampler,
            "elevation": self.cell_elevations,
            "area": self.cell_areas,
            "x": c[:, 0],
            "y": c[:, 1],
        })

    def export_db(self, out_path: str) -> None:
        hf_df, lf_df = self.aligned_datasets
        db.export_db(out_path, hf_df, lf_df, self.cell_info_df, self.aligned_ref_line_df)

    # ----------------------------------------------------- aux timeseries reads

    def get_precip_ts(self, plan: str) -> pd.DataFrame:
        """Excess precip for raster cells touching the AOI
        (reference gpras/preprocess.py:291-300)."""
        ph = self.hf_ras.plan_hdfs[plan]
        stamps = ph.get("Event Conditions/Meteorology/Precipitation/Timestamp")[:].astype(str)
        dt_index = pd.to_datetime(stamps, format="%d%b%Y %H:%M:%S.%f")
        data = ph.get("Event Conditions/Meteorology/Precipitation/Values")
        mask = self._rasterized_aoi
        vals = np.reshape(data, (data.shape[0], mask.shape[0], mask.shape[1]))[:, mask]
        return pd.DataFrame(vals, index=dt_index,
                            columns=[f"precip_{i}" for i in range(vals.shape[1])])

    @cached_property
    def _rasterized_aoi(self) -> np.ndarray:
        """AOI mask on the plan's precip raster (reference gpras/preprocess.py:236-251).

        The AOI (in the HF model's CRS, like every other geometry input) is
        reprojected onto the raster's CRS (meta['Projection']) before
        rasterizing — FFRD precip grids ship in the SHG Albers CRS while
        models are in state-plane/UTM. No-op when either CRS is unrecorded
        or they match (utils/crs.py gateway: pyproj when importable, owned
        Snyder projections otherwise)."""
        meta = self.hf_ras.get_precip_attributes(self.plans[0])
        cellsize = float(meta["Raster Cellsize"])
        left = float(meta["Raster Left"])
        top = float(meta["Raster Top"])
        rows, cols = int(meta["Raster Rows"]), int(meta["Raster Cols"])
        aoi = self._aoi_in(meta.get("Projection"))
        return rasterize_polygon(aoi, (left, top), cellsize,
                                 (rows, cols), all_touched=True)

    def export_rasterized_aoi(self, out_base: str) -> list[str]:
        """QC dump of the rasterized AOI mask on the plan's precip grid —
        the reference's debug GeoTIFF escape hatch
        (gpras/preprocess.py:253-270) as npz + PNG (geometry.export_grid_qc).
        Returns the written paths."""
        from gpras_tpu_torch.data.geometry import export_grid_qc

        meta = self.hf_ras.get_precip_attributes(self.plans[0])
        return export_grid_qc(
            self._rasterized_aoi.astype(np.int32),
            (float(meta["Raster Left"]), float(meta["Raster Top"])),
            float(meta["Raster Cellsize"]), out_base,
            crs_wkt=meta.get("Projection"), title="rasterized AOI")

    def export_precip_qc(self, data: np.ndarray, out_base: str) -> list[str]:
        """QC dump of one precip raster timestep on the plan's grid
        (reference _export_precip_gtiff, gpras/preprocess.py:272-289)."""
        from gpras_tpu_torch.data.geometry import export_grid_qc

        meta = self.hf_ras.get_precip_attributes(self.plans[0])
        return export_grid_qc(
            np.asarray(data, np.float32),
            (float(meta["Raster Left"]), float(meta["Raster Top"])),
            float(meta["Raster Cellsize"]), out_base,
            crs_wkt=meta.get("Projection"), title="precip")

    def _aoi_in(self, dst_wkt: str | None) -> Polygon:
        """The AOI reprojected from the HF model CRS to ``dst_wkt`` (identity
        when either CRS is unknown or they match)."""
        from gpras_tpu_torch.utils import crs as crs_mod

        t = crs_mod.make_transformer(self.hf_ras.projection, dst_wkt)
        return self.area_of_interest if t is None else self.area_of_interest.transformed(t)

    def get_ref_line_df(self, plan: str) -> pd.DataFrame:
        """Reference-line flow+WSE frame (reference gpras/preprocess.py:302-311)."""
        from gpras_tpu_torch.data.ras_model import REFERENCE_LINES_PATH

        ph = self.hf_ras.plan_hdfs[plan]
        dt_index = ph.timestamps()
        names = [n.decode() if isinstance(n, bytes) else str(n)
                 for n in ph.get(f"{REFERENCE_LINES_PATH}/Name")[:]]
        flows = ph.get(f"{REFERENCE_LINES_PATH}/Flow")[:]
        wse = ph.get(f"{REFERENCE_LINES_PATH}/Water Surface")[:]
        flows_df = pd.DataFrame(flows, index=dt_index, columns=[n + "_flows" for n in names])
        wse_df = pd.DataFrame(wse, index=dt_index, columns=[n + "_wse" for n in names])
        return pd.concat([flows_df, wse_df], axis=1)

    def get_bc_ts(self, plan: str, bc_id: str) -> pd.DataFrame:
        """Boundary-condition discharge column (reference gpras/preprocess.py:313-318)."""
        from gpras_tpu_torch.data.ras_model import BC_PATH

        ph = self.hf_ras.plan_hdfs[plan]
        vals = ph.get(f"{BC_PATH}/{bc_id}")[:, 1]
        return pd.DataFrame(vals, index=ph.timestamps(), columns=[bc_id])


class RasUpskillDataBuilder(DataBuilder):
    """LF-RAS -> HF-RAS pairing (reference gpras/preprocess.py:327-427)."""

    def __init__(self, hf_ras: RasModel, lf_ras: RasModel, mesh_id: str,
                 plans: list[str], area_of_interest: Polygon,
                 cell_id_field: str = "cell_id",
                 flow_convergence_threshold: float = 0.95,
                 cutoffs: dict[str, tuple[int, int]] | None = None,
                 hf_resampler: np.ndarray | None = None,
                 lf_resampler: np.ndarray | None = None,
                 hydraulic_parameter: HydraulicParameterType = "wse"):
        self.lf_ras = lf_ras
        self.lf_resampler = lf_resampler
        super().__init__(hf_ras=hf_ras, mesh_id=mesh_id, plans=plans,
                         area_of_interest=area_of_interest,
                         cell_id_field=cell_id_field,
                         flow_convergence_threshold=flow_convergence_threshold,
                         cutoffs=cutoffs, hf_resampler=hf_resampler,
                         hydraulic_parameter=hydraulic_parameter)
        # honor caller-supplied pairings independently (replay consistency:
        # a saved lf_cell_id pairing must not be silently recomputed)
        if hf_resampler is not None:
            self.hf_resampler = hf_resampler
        if lf_resampler is not None:
            self.lf_resampler = lf_resampler

    def get_lf_plan_data(self, plan: str) -> pd.DataFrame:
        """LF field resampled onto HF cells; WSE clamped at the HF cell ground
        elevation (reference gpras/preprocess.py:363-377)."""
        ph = self.lf_ras.plan_hdfs[plan]
        dt_index = ph.timestamps()
        if self.hydraulic_parameter == "velocity":
            vx = ph.mesh_timeseries_output(self.mesh_id, "Cell Velocity - Velocity X")
            vy = ph.mesh_timeseries_output(self.mesh_id, "Cell Velocity - Velocity Y")
            vals = np.sqrt(vx**2 + vy**2)
        else:
            vals = ph.mesh_timeseries_output(self.mesh_id, "Water Surface")
        vals = vals[:, self.lf_resampler]
        if self.hydraulic_parameter != "velocity":
            vals = np.maximum(vals, self.cell_elevations[None, :])
        return pd.DataFrame(vals, index=dt_index, columns=self.hf_resampler)

    def set_spatial_resamplers(self) -> None:
        """Pair each HF cell with the dominant-overlap LF cell (the reference's
        largest-intersection-area rule, gpras/preprocess.py:385-401).

        With the native geometry engine present this is **exact**: each HF cell
        is clipped against its bbox-candidate LF cells (Sutherland-Hodgman) and
        the largest intersection wins. Fallback: nearest-LF-centroid, which
        picks the same cell for convex, well-resolved meshes."""
        if getattr(self, "lf_resampler", None) is not None and self.hf_resampler is not None:
            return
        super().set_spatial_resamplers()
        lf_idx_in_aoi = self._lf_mesh_aoi_indices
        lf_ids = self._lf_mesh.cell_ids[lf_idx_in_aoi]
        exact = self._exact_max_overlap()
        if exact is not None:
            self.lf_resampler = exact
            return
        nearest = self._lf_submesh_containing(self.hf_centroids_aoi)
        self.lf_resampler = lf_ids[nearest]

    def _exact_max_overlap(self) -> np.ndarray | None:
        """Exact largest-overlap LF cell per AOI HF cell via the native clipping
        engine; None when the engine is unavailable."""
        from gpras_tpu_torch import native

        if not native.available():
            return None
        from scipy.spatial import cKDTree

        lf_idx = self._lf_mesh_aoi_indices
        lf_verts_all, lf_counts_all = self._lf_mesh.padded_vertices()
        lf_verts = lf_verts_all[lf_idx]
        lf_counts = lf_counts_all[lf_idx]
        hf_verts_all, hf_counts_all = self._hf_mesh.padded_vertices()
        hf_rows = np.nonzero(self._hf_mask)[0]
        hf_verts = hf_verts_all[hf_rows]
        hf_counts = hf_counts_all[hf_rows]
        # bbox candidates: k nearest LF centroids covers every overlapper for
        # meshes where LF cells are convex and comparable in size
        lf_cents = self._lf_mesh.centroids[lf_idx]
        k = min(9, len(lf_idx))
        _, cand = cKDTree(lf_cents).query(self.hf_centroids_aoi, k=k)
        cand = cand.astype(np.int32)
        if cand.ndim == 1:
            # k=1: query returns (S,); np.atleast_2d would give (1, S) and
            # feed a malformed candidate matrix to the native clipper
            cand = cand[:, None]
        best, area = native.best_overlap_batch(hf_verts, hf_counts,
                                               lf_verts, lf_counts, cand)
        lf_ids = self._lf_mesh.cell_ids[lf_idx]
        # Sutherland-Hodgman clipping is exact only for convex clip polygons;
        # concave HF cells (breaklines / refinement boundaries) would get wrong
        # intersection areas, so route them to the nearest-centroid rule.
        convex = _convex_ring_mask(hf_verts, hf_counts)
        # cells with zero overlap (shouldn't happen inside the AOI): nearest
        fallback = self._lf_submesh_containing(self.hf_centroids_aoi)
        chosen = np.where(convex & (best >= 0), best, fallback)
        return lf_ids[chosen]

    @cached_property
    def _lf_mesh(self):
        return self.lf_ras.get_plan_geometry(self.plans, self.mesh_id)

    @cached_property
    def _lf_mesh_aoi_indices(self) -> np.ndarray:
        return np.nonzero(self._lf_mesh.intersects(self.area_of_interest))[0]

    def _lf_submesh_containing(self, pts: np.ndarray) -> np.ndarray:
        from scipy.spatial import cKDTree

        cents = self._lf_mesh.centroids[self._lf_mesh_aoi_indices]
        _, idx = cKDTree(cents).query(pts)
        return idx

    @cached_property
    def lf_geometry_aoi(self) -> pd.DataFrame:
        idx = self._lf_mesh_aoi_indices
        c = self._lf_mesh.centroids[idx]
        return pd.DataFrame({self.cell_id_field: self._lf_mesh.cell_ids[idx],
                             "x": c[:, 0], "y": c[:, 1]})

    @cached_property
    def cell_info_df(self) -> pd.DataFrame:
        """Adds the paired LF cell id (reference gpras/preprocess.py:422-427)."""
        base = super().cell_info_df
        base["lf_cell_id"] = self.lf_resampler
        return base


class RasInterpolaterBuilder(RasUpskillDataBuilder):  # noqa: D101
    """Delaunay LF->HF interpolation (reference gpras/preprocess.py:430-451),
    with the per-timestep interpolator loop replaced by precomputed barycentric
    weights applied as one vectorized gather + weighted sum."""

    @cached_property
    def _barycentric(self) -> tuple[np.ndarray, np.ndarray]:
        """(vertex_indices (S, 3), weights (S, 3)) of each HF centroid in the
        Delaunay triangulation of LF AOI centroids; points outside the hull get
        weight NaN (clamped to ground later, matching gpras/preprocess.py:449-450)."""
        from scipy.spatial import Delaunay

        lf_pts = self._lf_mesh.centroids[self._lf_mesh_aoi_indices]
        tri = Delaunay(lf_pts)
        q = self.hf_centroids_aoi
        simplex = tri.find_simplex(q)
        t = tri.transform[np.clip(simplex, 0, None)]
        bary2 = np.einsum("sij,sj->si", t[:, :2, :], q - t[:, 2, :])
        weights = np.column_stack([bary2, 1.0 - bary2.sum(axis=1)])
        verts = tri.simplices[np.clip(simplex, 0, None)]
        weights[simplex < 0] = np.nan
        return verts, weights

    def get_lf_plan_data(self, plan: str) -> pd.DataFrame:
        if self.hydraulic_parameter == "velocity":
            # the reference interpolater is WSE-only (preprocess.py:437-450);
            # silently pairing interpolated WSE with HF velocities would
            # train a nonsense mapping — refuse loudly instead
            raise ValueError("RasInterpolaterBuilder supports "
                             "hydraulic_parameter='wse'/'depth' only; use "
                             "lf_model_type='ras_upskill' for velocity")
        ph = self.lf_ras.plan_hdfs[plan]
        dt_index = ph.timestamps()
        z = ph.mesh_timeseries_output(self.mesh_id, "Water Surface")
        z = z[:, self._lf_mesh_aoi_indices]
        verts, weights = self._barycentric
        vals = np.einsum("tsv,sv->ts", z[:, verts], weights)
        mask = (vals < self.cell_elevations) | np.isnan(vals)
        vals = np.where(mask, self.cell_elevations[None, :], vals)
        return pd.DataFrame(vals, index=dt_index, columns=self.hf_resampler)


class HmsUpskillDataBuilder(DataBuilder):
    """LF features from HMS DSS forcing (reference gpras/preprocess.py:700-806)."""

    def __init__(self, hf_ras: RasModel, inflow_dss_dir: str,
                 inflow_hms_elements: list[list[str]], precip_dss_dir: str,
                 precip_spatial_mode_count: int, mesh_id: str, plans: list[str],
                 area_of_interest: Polygon, cell_id_field: str = "cell_id",
                 flow_convergence_threshold: float = 0.95,
                 cutoffs: dict[str, tuple[int, int]] | None = None,
                 hf_resampler: np.ndarray | None = None,
                 hydraulic_parameter: HydraulicParameterType = "wse"):
        super().__init__(hf_ras, mesh_id, plans, area_of_interest, cell_id_field,
                         flow_convergence_threshold, cutoffs, hf_resampler,
                         hydraulic_parameter)
        self.inflow_dss_dir = inflow_dss_dir
        self.inflow_hms_elements = inflow_hms_elements
        self.precip_dss_dir = precip_dss_dir
        self.precip_spatial_mode_count = precip_spatial_mode_count

    def get_lf_plan_data(self, plan: str) -> pd.DataFrame:
        """Element inflows ++ masked precip grid, NaN -> 0
        (reference gpras/preprocess.py:737-743)."""
        cols = [self.get_hms_inflow_ts(plan, bc) for bc in self.inflow_hms_elements]
        cols.append(self.get_hms_precip_ts(plan))
        return pd.concat(cols, axis=1).fillna(0)

    def get_hms_inflow_ts(self, plan: str, bc_id: list[str]) -> pd.DataFrame:
        """One HMS element timeseries matched by (B, C) catalog parts
        (reference gpras/preprocess.py:745-750)."""
        from gpras_tpu_torch.data.dss import open_dss

        dss = open_dss(str(Path(self.inflow_dss_dir) / f"{plan}.dss"))
        path = [str(i) for i in dss.get_catalog()
                if bc_id[0] == i.B and bc_id[1] == i.C][0]
        data = dss.get(path)
        return pd.DataFrame(data.values, index=data.times,
                            columns=[f"{bc_id[0]}_{bc_id[1]}"])

    def get_hms_precip_ts(self, plan: str) -> pd.DataFrame:
        """Per-record datetime regex parse; grid flipped north-up and masked to
        the AOI (reference gpras/preprocess.py:752-769)."""
        from gpras_tpu_torch.data.dss import open_dss

        dss = open_dss(str(Path(self.precip_dss_dir) / f"{plan}.dss"))
        ts, dt_index = [], []
        for i in dss.get_catalog():
            t = re.search(r"\d{2}[A-Za-z]{3}\d{4}:\d{4}", str(i))
            if not t:
                raise ValueError(f"Could not parse datetime from DSS catalog entry: {i}")
            dt_index.append(datetime.strptime(t.group(), "%d%b%Y:%H%M"))
            record = dss.get(str(i))
            data = np.flipud(record.data)
            ts.append(data[self._aoi_precip_mask])
        vals = np.array(ts)
        return pd.DataFrame(vals, index=dt_index,
                            columns=[f"precip_{i}" for i in range(vals.shape[1])])

    @cached_property
    def _aoi_precip_mask(self) -> np.ndarray:
        """AOI mask on the HMS grid built from DSS grid metadata
        (reference gpras/preprocess.py:771-806). The AOI is reprojected from
        the HF model CRS to the grid's ``srsDefinition`` (the SHG Albers WKT
        every HMS grid record carries) when both are known — the reference's
        pyproj.Transformer step (preprocess.py:790-794)."""
        from gpras_tpu_torch.data.dss import open_dss

        dss = open_dss(str(Path(self.precip_dss_dir) / f"{self.plans[0]}.dss"))
        template = dss.get(str(next(iter(dss.get_catalog()))))
        pixel = template.cellSize
        height = template.numberOfCellsY
        upper_left_x = template.lowerLeftCellX * pixel
        upper_left_y = (template.lowerLeftCellY + height) * pixel
        aoi = self._aoi_in(getattr(template, "srsDefinition", None))
        return rasterize_polygon(
            aoi, (upper_left_x, upper_left_y), pixel,
            (template.numberOfCellsY, template.numberOfCellsX), all_touched=True)

    def export_rasterized_aoi(self, out_base: str) -> list[str]:
        """QC dump of the AOI mask on the HMS DSS grid (reference
        gpras/preprocess.py:253-270 equivalent for the HMS path)."""
        from gpras_tpu_torch.data.dss import open_dss
        from gpras_tpu_torch.data.geometry import export_grid_qc

        dss = open_dss(str(Path(self.precip_dss_dir) / f"{self.plans[0]}.dss"))
        template = dss.get(str(next(iter(dss.get_catalog()))))
        pixel = template.cellSize
        top = (template.lowerLeftCellY + template.numberOfCellsY) * pixel
        return export_grid_qc(
            self._aoi_precip_mask.astype(np.int32),
            (template.lowerLeftCellX * pixel, top), pixel, out_base,
            crs_wkt=getattr(template, "srsDefinition", None),
            title="rasterized AOI (HMS grid)")


class PseudoSurfaceDataBuilder(DataBuilder):
    """Pseudo LF surface from rating curves + centerline interpolation + an HMS
    upskill GPR floor (reference gpras/preprocess.py:516-697)."""

    def __init__(self, hf_ras: RasModel, inflow_dss_dir: str,
                 inflow_hms_elements: list[Any], precip_dss_dir: str,
                 precip_spatial_mode_count: int,
                 fluvial_lf_preprocessor_path: str,
                 fluvial_hf_preprocessor_path: str, fluvial_gpr_path: str,
                 us_bc_id_ras: str, ds_bc_id_ras: str,
                 us_bc_id_hms: str, ds_bc_id_hms: str,
                 centerline_path: str, mesh_id: str, plans: list[str],
                 area_of_interest: Polygon, cell_id_field: str = "cell_id",
                 flow_convergence_threshold: float = 0.95,
                 cutoffs: dict[str, tuple[int, int]] | None = None,
                 hf_resampler: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(hf_ras, mesh_id, plans, area_of_interest, cell_id_field,
                         flow_convergence_threshold, cutoffs, hf_resampler)
        from gpras_tpu_torch.eof.preprocessor import HmsPreProcessor, PreProcessor
        from gpras_tpu_torch.gp.model import GPRAS

        self.inflow_dss_dir = inflow_dss_dir
        self.inflow_hms_elements = inflow_hms_elements
        self.us_bc_id_ras = us_bc_id_ras
        self.ds_bc_id_ras = ds_bc_id_ras
        self.us_bc_id_hms = us_bc_id_hms
        self.ds_bc_id_hms = ds_bc_id_hms
        self.centerline_path = centerline_path
        self.centerline = LineString.from_geojson_file(centerline_path)
        self._set_centerline_cells()
        self._set_centerline_interpolater()
        self._set_cell_interpolater()

        self.fluvia_data_builder = HmsUpskillDataBuilder(
            hf_ras, inflow_dss_dir, inflow_hms_elements, precip_dss_dir,
            precip_spatial_mode_count, mesh_id, plans, area_of_interest,
            cell_id_field, flow_convergence_threshold, cutoffs, hf_resampler)
        self.fluvial_lf_preprocessor = HmsPreProcessor.from_file(fluvial_lf_preprocessor_path,
                                                                 device=device)
        self.fluvial_hf_preprocessor = PreProcessor.from_file(fluvial_hf_preprocessor_path,
                                                              device=device)
        self.fluvial_gpr = GPRAS.from_file(fluvial_gpr_path, device=device)

    # ----------------------------------------------------------- lf extraction

    def get_lf_plan_data(self, plan: str) -> pd.DataFrame:
        """Inflow -> rating curves -> centerline WSE -> thiessen spread ->
        elementwise max with the HMS-upskill GPR estimate
        (reference gpras/preprocess.py:581-599)."""
        us_ts = self.get_hms_inflow_ts(plan, self.us_bc_id_hms)
        ds_ts = self.get_hms_inflow_ts(plan, self.ds_bc_id_hms)
        us_wse = self.us_rating_curve.predict(us_ts.values[:, 0])
        ds_wse = self.ds_rating_curve.predict(ds_ts.values[:, 0])
        centerline_wse = self.interpolate_centerline(us_wse, ds_wse)
        full = self.interpolate_surface(centerline_wse)
        full = np.maximum(full, self.cell_elevations[None, :])
        full = np.maximum(full, self.get_lf_fluvial_est(plan))
        return pd.DataFrame(full, columns=self.hf_cell_ids_aoi, index=us_ts.index)

    def get_lf_fluvial_est(self, plan: str) -> np.ndarray:
        """Nested GPR inference inside data building
        (reference gpras/preprocess.py:601-606)."""
        df = self.fluvia_data_builder.get_lf_plan_data(plan)
        reduced = self.fluvial_lf_preprocessor.transform(df.values)
        predicted, _ = self.fluvial_gpr.predict(reduced)
        return self.fluvial_hf_preprocessor.reverse_transform(predicted)

    def get_hms_inflow_ts(self, plan: str, bc_id: str) -> pd.DataFrame:
        """FLOW series for a named HMS element (reference gpras/preprocess.py:608-613)."""
        from gpras_tpu_torch.data.dss import open_dss

        dss = open_dss(str(Path(self.inflow_dss_dir) / f"{plan}.dss"))
        path = [str(i) for i in dss.get_catalog()
                if bc_id == i.B and i.C == "FLOW"][0]
        data = dss.get(path)
        return pd.DataFrame(data.values, index=data.times, columns=[f"{bc_id}_FLOW"])

    # ------------------------------------------------------------ rating curves

    @cached_property
    def bc_ts(self) -> pd.DataFrame:
        return pd.concat([self.get_ref_line_df(p) for p in self.plans], axis=0)

    @cached_property
    def us_rating_curve(self) -> RatingCurve:
        return RatingCurve(self.bc_ts[self.us_bc_id_ras + "_flows"].values,
                           self.bc_ts[self.us_bc_id_ras + "_wse"].values)

    @cached_property
    def ds_rating_curve(self) -> RatingCurve:
        return RatingCurve(self.bc_ts[self.ds_bc_id_ras + "_flows"].values,
                           self.bc_ts[self.ds_bc_id_ras + "_wse"].values)

    # ------------------------------------------------------------- interpolation

    def _set_centerline_cells(self) -> None:
        """Cells touched by the centerline: sample the line at half the median
        cell spacing and collect containing cells (replaces the shapely
        intersects of gpras/preprocess.py:555-558)."""
        cents = self.hf_centroids_aoi
        if len(cents) > 1:
            from scipy.spatial import cKDTree

            d, _ = cKDTree(cents).query(cents, k=2)
            spacing = float(np.median(d[:, 1]))
        else:
            spacing = max(self.centerline.length / 100.0, 1e-6)
        samples = self.centerline.sample(spacing / 2.0)
        from scipy.spatial import cKDTree

        _, nearest = cKDTree(cents).query(samples)
        order = []
        for i in nearest:
            if i not in order:
                order.append(i)
        self._centerline_cell_rows = np.asarray(order, dtype=int)
        self.centerline_cell_ids = self.hf_cell_ids_aoi[self._centerline_cell_rows]

    def _set_centerline_interpolater(self) -> None:
        """Median fractional WSE drop per centerline cell over all plans/times
        with positive BC flow (reference gpras/preprocess.py:643-667)."""
        us_wse_col = f"{self.us_bc_id_ras}_wse"
        ds_wse_col = f"{self.ds_bc_id_ras}_wse"
        us_q_col = f"{self.us_bc_id_ras}_flows"
        ds_q_col = f"{self.ds_bc_id_ras}_flows"
        frames = []
        for p in self.plans:
            bc = self.get_ref_line_df(p)[[us_wse_col, ds_wse_col, us_q_col, ds_q_col]]
            cells = self.get_hf_plan_data(p).values[:, self._centerline_cell_rows]
            mask = (bc[[us_q_col, ds_q_col]] > 0).any(axis=1).values
            frames.append((bc.values[mask], cells[mask]))
        bc_all = np.concatenate([f[0] for f in frames])
        wses = np.concatenate([f[1] for f in frames])
        us = bc_all[:, 0]
        ds = bc_all[:, 1]
        rng = us - ds
        # flat pools (us == ds within float precision) carry no gradient
        # information and would contribute inf/NaN fractional drops
        flat = np.abs(rng) < 1e-9 * np.maximum(np.abs(us), 1.0)
        if np.all(flat):
            raise ValueError("centerline interpolater: every timestep with "
                             "positive BC flow has a flat pool (us == ds)")
        ratios = (us[~flat, None] - wses[~flat]) / rng[~flat, None]
        self.cl_interpolater = np.median(ratios, axis=0)

    def interpolate_centerline(self, us_wse: np.ndarray, ds_wse: np.ndarray) -> np.ndarray:
        """(T, centerline_cells) WSE by fractional-drop interpolation
        (reference gpras/preprocess.py:634-637)."""
        rng = us_wse - ds_wse
        return us_wse[:, None] - np.outer(rng, self.cl_interpolater)

    def _set_cell_interpolater(self) -> None:
        """Nearest centerline cell per AOI cell (thiessen spread,
        reference gpras/preprocess.py:669-674)."""
        from scipy.spatial import cKDTree

        cl_cents = self.hf_centroids_aoi[self._centerline_cell_rows]
        _, idx = cKDTree(cl_cents).query(self.hf_centroids_aoi)
        self.cell_interpolater = idx

    def interpolate_surface(self, cl_wse: np.ndarray) -> np.ndarray:
        return cl_wse[:, self.cell_interpolater]

    @cached_property
    def cell_stations(self) -> np.ndarray:
        """Arc-length station of each centerline cell
        (reference gpras/preprocess.py:676-693, via projection of centroids
        instead of boundary-intersection points)."""
        cents = self.hf_centroids_aoi[self._centerline_cell_rows]
        return np.asarray([self.centerline.project(c) for c in cents])

    def plot_centerline_interpolater(self, out_path: str) -> None:
        from gpras_tpu_torch.plotting import plot_centerline_interpolater

        plot_centerline_interpolater(self.cell_stations, self.cl_interpolater, out_path)
