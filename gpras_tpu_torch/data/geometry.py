"""Minimal host-side geometry toolkit (numpy + matplotlib.path; no GEOS/GDAL).

The reference leans on geopandas/shapely/rasterio for: AOI cell masking
(``geom.intersects(aoi)``, gpras/preprocess.py:223-224), largest-overlap LF->HF
cell pairing (``gpd.overlay`` intersection, gpras/preprocess.py:390-398), AOI
rasterization onto precip grids (gpras/preprocess.py:236-251, 771-806), and
centerline station projection (gpras/preprocess.py:676-693). None of those
libraries ship in this image, so this module provides the needed subset:

- ``Polygon``: ring-based polygon with vectorized point-in-polygon
  (matplotlib.path's C implementation), shoelace area, centroid, GeoJSON I/O.
- ``CellMesh``: a 2-D mesh as padded face-point indices + coordinates (exactly
  the HEC-RAS HDF encoding), with vectorized centroids/areas and AOI
  intersection masks.
- ``LineString``: arc-length stations and nearest-point projection.
- ``rasterize_polygon``: boolean mask of a polygon on a north-up grid
  (``all_touched`` approximated by sampling pixel centers + corners).

Intersection tests are vertex/centroid-sampling approximations of exact
polygon-polygon predicates — exact for the convex, well-resolved cells HEC-RAS
meshes are made of in all but degenerate slivers.

A copy of ``gpras_tpu/data/geometry.py``, except that ``matplotlib.path`` is
imported at the first point-in-polygon test, not with the module: the port
runs where matplotlib is not installed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path

import numpy as np


class Polygon:
    """Simple polygon (exterior ring only)."""

    def __init__(self, ring: np.ndarray):
        ring = np.asarray(ring, dtype=np.float64)
        if not np.allclose(ring[0], ring[-1]):
            ring = np.vstack([ring, ring[:1]])
        self.ring = ring

    @cached_property
    def _path(self):
        from matplotlib.path import Path as MplPath

        return MplPath(self.ring)

    @classmethod
    def from_geojson_file(cls, path: str | Path) -> "Polygon":
        """First polygon from a GeoJSON file (Feature/FeatureCollection/geometry)."""
        with open(path) as f:
            gj = json.load(f)
        geom = gj
        if gj.get("type") == "FeatureCollection":
            geom = gj["features"][0]["geometry"]
        elif gj.get("type") == "Feature":
            geom = gj["geometry"]
        if geom["type"] == "Polygon":
            ring = geom["coordinates"][0]
        elif geom["type"] == "MultiPolygon":
            ring = geom["coordinates"][0][0]
        else:
            raise ValueError(f"Unsupported geometry type {geom['type']}")
        # GeoJSON positions may carry a z coordinate; keep (x, y) only
        return cls(np.asarray(ring, dtype=float)[:, :2])

    def to_geojson(self) -> dict:
        return {"type": "Polygon", "coordinates": [self.ring.tolist()]}

    def contains_points(self, pts: np.ndarray) -> np.ndarray:
        """Vectorized point-in-polygon, (N, 2) -> (N,) bool."""
        return self._path.contains_points(np.asarray(pts, dtype=np.float64))

    def transformed(self, fn) -> "Polygon":
        """New polygon with ``fn`` ((N, 2) -> (N, 2)) applied to the ring —
        the shapely.ops.transform surface the reference uses for CRS
        reprojection (gpras/preprocess.py:791-794)."""
        return Polygon(np.asarray(fn(self.ring), dtype=np.float64))

    @property
    def area(self) -> float:
        x, y = self.ring[:-1, 0], self.ring[:-1, 1]
        x2, y2 = self.ring[1:, 0], self.ring[1:, 1]
        return float(abs(np.sum(x * y2 - x2 * y)) / 2.0)

    @property
    def centroid(self) -> np.ndarray:
        return self.ring[:-1].mean(axis=0)

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        return (self.ring[:, 0].min(), self.ring[:, 1].min(),
                self.ring[:, 0].max(), self.ring[:, 1].max())


@dataclass
class CellMesh:
    """2-D mesh cells in the HEC-RAS HDF encoding: ``face_point_indexes`` is
    (n_cells, max_verts) int, -1-padded; ``face_points`` is (n_pts, 2)."""

    cell_ids: np.ndarray
    face_point_indexes: np.ndarray
    face_points: np.ndarray

    @property
    def n_cells(self) -> int:
        return len(self.cell_ids)

    def cell_vertices(self, i: int) -> np.ndarray:
        idx = self.face_point_indexes[i]
        return self.face_points[idx[idx >= 0]]

    @property
    def centroids(self) -> np.ndarray:
        """Vectorized vertex-mean centroids (padded entries masked)."""
        idx = self.face_point_indexes
        valid = idx >= 0
        pts = self.face_points[np.clip(idx, 0, None)]  # (C, V, 2)
        w = valid[..., None].astype(np.float64)
        return (pts * w).sum(axis=1) / np.maximum(w.sum(axis=1), 1.0)

    @property
    def areas(self) -> np.ndarray:
        """Vectorized shoelace areas over the padded vertex arrays."""
        idx = self.face_point_indexes
        valid = idx >= 0
        counts = valid.sum(axis=1)
        pts = self.face_points[np.clip(idx, 0, None)].astype(np.float64)
        # replace padding with the wrap-around first vertex so extra edges are zero-length
        first = pts[:, :1, :]
        pts = np.where(valid[..., None], pts, first)
        nxt = np.roll(pts, -1, axis=1)
        # the roll pulls the first vertex after the last valid one -> correct closure
        cross = pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
        area = np.abs(cross.sum(axis=1)) / 2.0
        return np.where(counts >= 3, area, 0.0)

    def intersects(self, poly: Polygon) -> np.ndarray:
        """Boolean mask: cell touches the polygon (any vertex or centroid inside,
        or any polygon vertex inside the cell bbox). Approximates shapely's
        ``intersects`` (reference gpras/preprocess.py:223-224)."""
        idx = self.face_point_indexes
        valid = idx >= 0
        pts = self.face_points[np.clip(idx, 0, None)]
        flat = pts.reshape(-1, 2)
        inside = poly.contains_points(flat).reshape(pts.shape[:2])
        vertex_hit = np.any(inside & valid, axis=1)
        centroid_hit = poly.contains_points(self.centroids)
        # polygon vertex inside cell bbox
        first = pts[:, :1, :]
        pts_masked = np.where(valid[..., None], pts, first)
        cell_min = pts_masked.min(axis=1)
        cell_max = pts_masked.max(axis=1)
        ring = poly.ring[:-1]
        in_bbox = np.zeros(self.n_cells, dtype=bool)
        for v in ring:
            in_bbox |= np.all((cell_min <= v) & (v <= cell_max), axis=1)
        return vertex_hit | centroid_hit | in_bbox

    def padded_vertices(self) -> tuple[np.ndarray, np.ndarray]:
        """(verts (C, V, 2) with padding repeating the first vertex,
        counts (C,)) — the encoding the native clipping engine consumes."""
        idx = self.face_point_indexes
        valid = idx >= 0
        counts = valid.sum(axis=1).astype(np.int32)
        pts = self.face_points[np.clip(idx, 0, None)].astype(np.float64)
        first = pts[:, :1, :]
        return np.where(valid[..., None], pts, first), counts

    def containing_cell(self, pts: np.ndarray) -> np.ndarray:
        """For each query point, the index (into this mesh) of the cell whose
        centroid is nearest — the point-sampling primitive used for max-overlap
        resampling and centerline-cell lookup."""
        from scipy.spatial import cKDTree

        tree = cKDTree(self.centroids)
        _, idx = tree.query(np.asarray(pts, dtype=np.float64))
        return idx


class LineString:
    """Polyline with arc-length stations (centerline support,
    reference gpras/preprocess.py:676-693)."""

    def __init__(self, coords: np.ndarray):
        # GeoJSON positions may carry a z coordinate; keep (x, y) only
        self.coords = np.asarray(coords, dtype=np.float64)[:, :2]
        seg = np.diff(self.coords, axis=0)
        self._seg_len = np.hypot(seg[:, 0], seg[:, 1])
        self.stations = np.concatenate([[0.0], np.cumsum(self._seg_len)])

    @classmethod
    def from_geojson_file(cls, path: str | Path) -> "LineString":
        with open(path) as f:
            gj = json.load(f)
        geom = gj
        if gj.get("type") == "FeatureCollection":
            geom = gj["features"][0]["geometry"]
        elif gj.get("type") == "Feature":
            geom = gj["geometry"]
        if geom["type"] != "LineString":
            raise ValueError(f"Expected LineString, got {geom['type']}")
        return cls(np.asarray(geom["coordinates"]))

    @property
    def length(self) -> float:
        return float(self.stations[-1])

    def project(self, pt: np.ndarray) -> float:
        """Arc-length station of the closest point on the line (shapely
        ``line.project`` equivalent)."""
        p = np.asarray(pt, dtype=np.float64)
        a = self.coords[:-1]
        b = self.coords[1:]
        ab = b - a
        denom = np.maximum(np.sum(ab * ab, axis=1), 1e-30)
        t = np.clip(np.sum((p - a) * ab, axis=1) / denom, 0.0, 1.0)
        proj = a + t[:, None] * ab
        d2 = np.sum((proj - p) ** 2, axis=1)
        i = int(np.argmin(d2))
        return float(self.stations[i] + t[i] * self._seg_len[i])

    def sample(self, spacing: float) -> np.ndarray:
        """Points every ``spacing`` along the line (used for cell-touch tests)."""
        n = max(int(np.ceil(self.length / spacing)) + 1, 2)
        s = np.linspace(0.0, self.length, n)
        return self.interpolate(s)

    def interpolate(self, s: np.ndarray) -> np.ndarray:
        s = np.clip(np.asarray(s, dtype=np.float64), 0, self.length)
        seg = np.clip(np.searchsorted(self.stations, s, side="right") - 1, 0,
                      len(self._seg_len) - 1)
        frac = (s - self.stations[seg]) / np.maximum(self._seg_len[seg], 1e-30)
        return self.coords[seg] + frac[:, None] * (self.coords[seg + 1] - self.coords[seg])


def rasterize_polygon(
    poly: Polygon,
    upper_left: tuple[float, float],
    pixel_size: float,
    shape: tuple[int, int],
    all_touched: bool = True,
) -> np.ndarray:
    """Boolean mask of ``poly`` on a north-up grid (row 0 at the top).

    ``all_touched=True`` marks a pixel if its center or any corner falls inside
    (a sampling approximation of rasterio's all_touched, reference
    gpras/preprocess.py:243-250)."""
    rows, cols = shape
    x0, y0 = upper_left
    xs = x0 + (np.arange(cols) + 0.5) * pixel_size
    ys = y0 - (np.arange(rows) + 0.5) * pixel_size
    gx, gy = np.meshgrid(xs, ys)
    centers = np.column_stack([gx.ravel(), gy.ravel()])
    mask = poly.contains_points(centers).reshape(shape)
    if all_touched:
        for dx in (-0.5, 0.5):
            for dy in (-0.5, 0.5):
                pts = centers + np.array([dx, dy]) * pixel_size
                mask |= poly.contains_points(pts).reshape(shape)
    return mask


def export_grid_qc(data: np.ndarray, upper_left: tuple[float, float],
                   pixel_size: float, out_base: str,
                   crs_wkt: str | None = None, title: str = "") -> list[str]:
    """Write a georeferenced QC dump of a raster-grid array — the capability
    of the reference's debug GeoTIFF exports (_export_rasterized_aoi /
    _export_precip_gtiff, gpras/preprocess.py:253-289) without rasterio:

    - ``<out_base>.npz``: the array plus the north-up grid georeferencing
      (upper-left corner, pixel size, CRS WKT) — everything a GIS reimport
      needs;
    - ``<out_base>.png``: a rendered image with coordinate axes for eyeball
      QC (skipped, with the npz still written, if matplotlib is missing).

    Returns the list of paths written.
    """
    data = np.asarray(data)
    x0, y0 = float(upper_left[0]), float(upper_left[1])
    paths = [f"{out_base}.npz"]
    np.savez(paths[0], data=data, upper_left=np.array([x0, y0]),
             pixel_size=np.float64(pixel_size),
             crs_wkt=np.str_(crs_wkt or ""))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return paths
    rows, cols = data.shape[-2], data.shape[-1]
    fig, ax = plt.subplots(figsize=(8, 8 * rows / max(cols, 1)))
    im = ax.imshow(np.asarray(data, np.float64),
                   extent=(x0, x0 + cols * pixel_size,
                           y0 - rows * pixel_size, y0),
                   origin="upper", interpolation="nearest")
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(title or out_base)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig(f"{out_base}.png", dpi=120, bbox_inches="tight")
    plt.close(fig)
    paths.append(f"{out_base}.png")
    return paths
