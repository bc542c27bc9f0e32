"""HEC-RAS model handle: read plan/geometry HDF5s, mutate the project.

A copy of ``gpras_tpu/data/ras_model.py`` (the port may not import the JAX
package, whose ``__init__`` imports jax), with one change: h5py is imported
where an HDF file is first read or written, not with the module, so the
project's text files (the .prj, flow and plan files) and every module that
imports ``RasModel`` work where h5py is not installed.

Capability parity with the reference ``RasModel`` (gpras/ras/model.py:28-207),
which subclasses hecstac's STAC item and reads HDF through rashdf. Neither
hecstac nor rashdf ships here, so this is a direct h5py implementation over the
real HEC-RAS HDF layout:

- results:  /Results/Unsteady/Output/Output Blocks/Base Output/Unsteady Time
  Series/2D Flow Areas/{mesh}/{Water Surface | Cell Velocity - Velocity X/Y}
- time:     .../Unsteady Time Series/Time Date Stamp
- geometry: Geometry/2D Flow Areas/{mesh}/{Cells Minimum Elevation | Cells
  Surface Area | Cells FacePoint Indexes | FacePoints Coordinate}
- precip:   /Event Conditions/Meteorology/Precipitation (attrs + Values/Timestamp)

Model mutation (append plans/flows, .prj registration, suffix increments,
encoding/newline-preserving text patching) mirrors gpras/ras/model.py:31-94 and
183-207.
"""

from __future__ import annotations

import json
import shutil
from functools import cached_property
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import pandas as pd

from gpras_tpu_torch.data.geometry import CellMesh
from gpras_tpu_torch.utils.file_utils import detect_file_properties, get_filename

if TYPE_CHECKING:
    import h5py

RESULTS_TS_ROOT = "Results/Unsteady/Output/Output Blocks/Base Output/Unsteady Time Series"
TIME_STAMP_PATH = f"{RESULTS_TS_ROOT}/Time Date Stamp"
PLAN_INFO_PATH = "Plan Data/Plan Information"
PRECIP_PATH = "Event Conditions/Meteorology/Precipitation"
REFERENCE_LINES_PATH = f"{RESULTS_TS_ROOT}/Reference Lines"
BC_PATH = f"{RESULTS_TS_ROOT}/Boundary Conditions"


def _decode(v: Any) -> Any:
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return v


class PlanHdf:
    """One plan's HDF5 results file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)

    @cached_property
    def _h5(self) -> h5py.File:
        import h5py

        return h5py.File(self.path, "r")

    def get(self, key: str) -> h5py.Dataset:
        return self._h5[key.lstrip("/")]

    def attrs(self, group: str) -> dict[str, Any]:
        return {k: _decode(v) for k, v in self._h5[group.lstrip("/")].attrs.items()}

    @cached_property
    def plan_name(self) -> str:
        info = self.attrs(PLAN_INFO_PATH)
        return str(info.get("Plan Name", self.path.stem))

    @cached_property
    def projection(self) -> str | None:
        """Root 'Projection' WKT attribute (the CRS rashdf exposes on every
        GeoDataFrame the reference builds, gpras/ras/model.py:168-174 via
        mesh_cell_polygons); None when the file records no CRS."""
        v = self._h5.attrs.get("Projection")
        return _decode(v) if v is not None else None

    @cached_property
    def geometry_title(self) -> str:
        info = self.attrs(PLAN_INFO_PATH)
        return str(info.get("Geometry Title", ""))

    def mesh_timeseries_output(self, mesh_id: str, variable: str) -> np.ndarray:
        """(timesteps, cells) array for a mesh output variable — the surface the
        reference reaches via rashdf (gpras/preprocess.py:168-172)."""
        return self.get(f"{RESULTS_TS_ROOT}/2D Flow Areas/{mesh_id}/{variable}")[:]

    def timestamps(self) -> pd.DatetimeIndex:
        stamps = self.get(TIME_STAMP_PATH)[:].astype(str)
        # HEC-RAS writes end-of-day stamps as '24:00:00' (rolls to the next
        # day); pandas' strict parser rejects them
        fixed, bump = [], []
        for t in stamps:
            if " 24:" in t:
                fixed.append(t.replace(" 24:", " 00:"))
                bump.append(True)
            else:
                fixed.append(t)
                bump.append(False)
        out = pd.to_datetime(fixed, format="%d%b%Y %H:%M:%S")
        if any(bump):
            out = out + pd.to_timedelta(np.where(bump, 1, 0), unit="D")
        return pd.DatetimeIndex(out)


class RasModel:
    """A HEC-RAS project: plan/geometry HDF files + text files + .prj."""

    def __init__(self, prj_path: str | Path, assets: dict[str, str] | None = None):
        """``assets`` maps filename -> path; discovered from the project dir if
        not given (every sibling file sharing the project stem)."""
        self.prj_path = Path(prj_path)
        self.model_root_dir = self.prj_path.parent
        self.id = self.prj_path.stem
        if assets is None:
            assets = {
                p.name: str(p)
                for p in sorted(self.model_root_dir.glob(f"{self.id}.*"))
            }
        self.assets = dict(assets)

    # ------------------------------------------------------------- constructors

    @classmethod
    def from_stac(cls, stac_path: str | Path) -> "RasModel":
        """Build from a STAC item json (assets' hrefs), the reference's loading
        path (data_models.py:299-313). Relative hrefs resolve against the STAC
        file's directory."""
        stac_path = Path(stac_path)
        with open(stac_path) as f:
            item = json.load(f)
        assets = {}
        prj = None
        for name, asset in item.get("assets", {}).items():
            href = asset["href"]
            p = Path(href)
            if not p.is_absolute():
                p = (stac_path.parent / p).resolve()
            # key by the href FILENAME — suffix-based discovery
            # (plan_hdfs/geometry_hdfs/plan_files) filters on it; arbitrary
            # STAC asset keys like 'plan-01' would silently match nothing
            assets[p.name] = str(p)
            if str(p).endswith(".prj"):
                prj = p
        if prj is None:
            # fall back: project file next to the stac json
            hits = list(stac_path.parent.glob("*.prj"))
            if not hits:
                raise FileNotFoundError(f"No .prj asset found in {stac_path}")
            prj = hits[0]
        return cls(prj, assets)

    def _spatial_extent(self) -> tuple[list[float] | None, dict | None]:
        """(bbox, GeoJSON bbox polygon) from any mesh's facepoint coordinates
        (model CRS), or (None, None) when no geometry HDF is readable."""
        for handles in (self.geometry_hdfs, self.plan_hdfs):
            for h in handles.values():
                try:
                    areas = h._h5["Geometry/2D Flow Areas"]
                    import h5py

                    lo = np.array([np.inf, np.inf])
                    hi = np.array([-np.inf, -np.inf])
                    found = False
                    for name, grp in areas.items():
                        if isinstance(grp, h5py.Group) \
                                and "FacePoints Coordinate" in grp:
                            pts = np.asarray(grp["FacePoints Coordinate"])
                            lo = np.minimum(lo, pts.min(axis=0))
                            hi = np.maximum(hi, pts.max(axis=0))
                            found = True
                    if not found:
                        continue
                    bbox = [float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1])]
                    ring = [[bbox[0], bbox[1]], [bbox[2], bbox[1]],
                            [bbox[2], bbox[3]], [bbox[0], bbox[3]],
                            [bbox[0], bbox[1]]]
                    return bbox, {"type": "Polygon", "coordinates": [ring]}
                except Exception:
                    continue
        return None, None

    @staticmethod
    def _asset_entry(name: str, path: str) -> dict[str, Any]:
        """hecstac-style asset metadata: media type + roles from the HEC-RAS
        filename grammar (.prj / .pNN / .gNN / .uNN / *.hdf)."""
        suffix = Path(name).suffix.lower()
        entry: dict[str, Any] = {"href": str(path), "title": name}
        if suffix == ".hdf":
            entry["type"] = "application/x-hdf"
            stem_suffix = Path(Path(name).stem).suffix
            if stem_suffix.startswith(".p"):
                entry["roles"] = ["ras-plan", "results"]
            elif stem_suffix.startswith(".g"):
                entry["roles"] = ["ras-geometry"]
            else:
                entry["roles"] = ["data"]
        elif suffix == ".prj":
            entry["type"] = "text/plain"
            entry["roles"] = ["project-file"]
        elif len(suffix) == 4 and suffix[1] in "pgu" and suffix[2:].isdigit():
            entry["type"] = "text/plain"
            entry["roles"] = {"p": ["plan-file"], "g": ["geometry-file"],
                              "u": ["unsteady-flow-file"]}[suffix[1]]
        else:
            entry["roles"] = ["data"]
        return entry

    def to_stac(self, out_path: str | Path) -> None:
        """Write a STAC 1.0 item json for this model — the capability of
        production/pre_processing/make_ras_stac.py:6-13 (hecstac
        ``RASModelItem.from_prj(...).to_file(...)``), without hecstac:
        bbox/geometry from the mesh facepoint extent, the model projection as
        ``proj:wkt2``, per-asset media types and hec-ras roles, and the
        project file's mtime as the item datetime.

        Per STAC 1.0 / GeoJSON RFC 7946, the item ``geometry``/``bbox`` are
        WGS84 lon/lat (reprojected from the model CRS via the owned Snyder
        inverses in utils/crs.py, ring edges densified); the native-CRS
        extent moves to ``proj:bbox``/``proj:geometry``. When no projection
        is available (or it fails to parse) the item carries null geometry
        and only the proj fields."""
        bbox, geom = self._spatial_extent()
        native_bbox, native_geom = bbox, geom
        lonlat = None
        if bbox is not None and self.projection:
            try:
                from gpras_tpu_torch.utils.crs import CRS as _CRS

                crs = _CRS.from_wkt(self.projection)
                # densify each bbox edge so the lon/lat envelope tracks the
                # projected edges' curvature, not just the 4 corners
                t = np.linspace(0.0, 1.0, 9)
                xs = np.concatenate([
                    bbox[0] + (bbox[2] - bbox[0]) * t,            # south
                    np.full_like(t, bbox[2]),                     # east
                    bbox[2] + (bbox[0] - bbox[2]) * t,            # north
                    np.full_like(t, bbox[0]),                     # west
                ])
                ys = np.concatenate([
                    np.full_like(t, bbox[1]),
                    bbox[1] + (bbox[3] - bbox[1]) * t,
                    np.full_like(t, bbox[3]),
                    bbox[3] + (bbox[1] - bbox[3]) * t,
                ])
                lon, lat = crs.to_lonlat(xs, ys)
                ring = [[float(a), float(b)] for a, b in zip(lon, lat)]
                ring.append(ring[0])
                lonlat = (
                    [float(lon.min()), float(lat.min()),
                     float(lon.max()), float(lat.max())],
                    {"type": "Polygon", "coordinates": [ring]},
                )
            except Exception:
                lonlat = None
        bbox, geom = lonlat if lonlat is not None else (None, None)
        try:
            import datetime as _dt

            mtime = self.prj_path.stat().st_mtime
            dt = _dt.datetime.fromtimestamp(
                mtime, _dt.timezone.utc).isoformat().replace("+00:00", "Z")
        except OSError:
            dt = None
        props: dict[str, Any] = {"datetime": dt}
        extensions = []
        if self.projection:
            props["proj:wkt2"] = self.projection
            extensions.append(
                "https://stac-extensions.github.io/projection/v1.1.0/schema.json")
        if native_bbox is not None and self.projection:
            # native-CRS extent (meters) belongs in the proj extension, not
            # in the RFC 7946 lon/lat geometry/bbox slots
            props["proj:bbox"] = native_bbox
            props["proj:geometry"] = native_geom
        item = {
            "type": "Feature",
            "stac_version": "1.0.0",
            "stac_extensions": extensions,
            "id": self.id,
            "geometry": geom,
            **({"bbox": bbox} if bbox is not None else {}),
            "properties": props,
            "links": [],
            "assets": {
                name: self._asset_entry(name, path)
                for name, path in self.assets.items()
            },
        }
        with open(out_path, "w") as f:
            json.dump(item, f, indent=2)

    # ------------------------------------------------------------------ readers

    @cached_property
    def plan_hdfs(self) -> dict[str, PlanHdf]:
        """plan name -> PlanHdf (reference gpras/ras/model.py:106-113)."""
        out = {}
        for name, path in self.assets.items():
            if ".p" in name and name.endswith(".hdf"):
                ph = PlanHdf(path)
                try:
                    out[ph.plan_name] = ph
                except Exception:
                    continue
        return out

    @cached_property
    def geometry_hdfs(self) -> dict[str, PlanHdf]:
        """geometry title -> handle (reference gpras/ras/model.py:115-122)."""
        out = {}
        for name, path in self.assets.items():
            if ".g" in name and name.endswith(".hdf"):
                gh = PlanHdf(path)
                try:
                    title = gh.attrs("Geometry").get("Title", Path(path).stem)
                except Exception:  # unreadable/corrupt file: plan HDF fallback
                    title = Path(path).stem
                out[title] = gh
        return out

    def get_cell_minimum_elevation(self, plan: str, mesh_id: str) -> np.ndarray:
        """Per-cell min elevation, NaN ghost cells dropped
        (reference gpras/ras/model.py:124-130)."""
        ds = self.plan_hdfs[plan].get(f"Geometry/2D Flow Areas/{mesh_id}/Cells Minimum Elevation")[:]
        return ds[~np.isnan(ds)]

    def get_cell_areas(self, plan: str, mesh_id: str) -> np.ndarray:
        """Per-cell surface area, NaN/zero ghost cells dropped
        (reference gpras/ras/model.py:153-166)."""
        ds = self.plan_hdfs[plan].get(f"Geometry/2D Flow Areas/{mesh_id}/Cells Surface Area")[:]
        return ds[(~np.isnan(ds)) & (~np.isclose(ds, 0, atol=1e-3))]

    def get_plan_wsels(self, plans: list[str], mesh_id: str) -> pd.DataFrame:
        """(run, t)-indexed WSE frame (reference gpras/ras/model.py:132-144).

        Output columns are trimmed to the REAL cell count (ghost cells index
        after real cells and carry NaN minimum elevations) — the reference
        gets this for free from rashdf's mesh_timeseries_output."""
        n_real = len(self.get_cell_minimum_elevation(plans[0], mesh_id))
        store = []
        for p in plans:
            wse = self.plan_hdfs[p].mesh_timeseries_output(mesh_id, "Water Surface")
            df = pd.DataFrame(wse[:, :n_real])
            df["run"] = p
            df["t"] = df.index.to_list()
            store.append(df)
        return pd.concat(store).set_index(["run", "t"])

    def get_plan_depths(self, plans: list[str], mesh_id: str) -> pd.DataFrame:
        """WSE minus per-cell minimum elevation (reference gpras/ras/model.py:146-151)."""
        elevations = self.get_cell_minimum_elevation(plans[0], mesh_id)
        return self.get_plan_wsels(plans, mesh_id) - elevations

    @cached_property
    def projection(self) -> str | None:
        """The model's CRS as WKT: first geometry HDF's root Projection attr,
        plan HDFs as fallback (reference: rashdf attaches this CRS to every
        geometry frame, so AOI/centerline inputs arrive in it)."""
        for handle in list(self.geometry_hdfs.values()) + list(self.plan_hdfs.values()):
            if handle.projection:
                return handle.projection
        return None

    def get_plan_geometry(self, plans: list[str], mesh_id: str) -> CellMesh:
        """Mesh cell polygons for the (single) geometry behind ``plans``
        (reference gpras/ras/model.py:168-174, including the single-geometry
        assertion). Reads from the geometry HDF when present, else the plan HDF."""
        titles = [self.plan_hdfs[p].geometry_title for p in plans if p in self.plan_hdfs]
        assert all(t == titles[0] for t in titles), "Multiple geometries found in the model runs."
        handle = self.geometry_hdfs.get(titles[0]) or self.plan_hdfs[plans[0]]
        root = f"Geometry/2D Flow Areas/{mesh_id}"
        fpi = handle.get(f"{root}/Cells FacePoint Indexes")[:]
        pts = handle.get(f"{root}/FacePoints Coordinate")[:]
        return CellMesh(cell_ids=np.arange(fpi.shape[0]), face_point_indexes=fpi,
                        face_points=pts)

    def get_precip_attributes(self, plan: str) -> dict[str, Any]:
        """Precip raster attrs (reference gpras/ras/model.py:176-180)."""
        return self.plan_hdfs[plan].attrs(PRECIP_PATH)

    # ----------------------------------------------------------------- mutation

    @property
    def plan_files(self) -> list[str]:
        return [p for n, p in self.assets.items()
                if n.split(".")[-1].startswith("p") and not n.endswith(".hdf")
                and n.split(".")[-1][1:].isdigit()]

    @property
    def unsteady_flow_files(self) -> list[str]:
        return [p for n, p in self.assets.items()
                if n.split(".")[-1].startswith("u") and n.split(".")[-1][1:].isdigit()]

    def increment_suffix(self, paths: list[str], suffix_letter: str) -> str:
        """Next free pXX/uXX filename (reference gpras/ras/model.py:83-94)."""
        used = set()
        for p in paths:
            suffix = get_filename(p).split(".")[-1]
            assert suffix[0] == suffix_letter, f"Mismatched file types in {paths}"
            used.add(int(suffix[1:]))
        ind = 1
        while ind in used:
            ind += 1
        return str(self.model_root_dir / f"{self.id}.{suffix_letter}{str(ind).zfill(2)}")

    def add_text_file(self, file) -> str:
        """Write a flow/plan text file under the next suffix and register it in
        the .prj (reference gpras/ras/model.py:63-81)."""
        from gpras_tpu_torch.data.flow_file import UnsteadyFlowFile
        from gpras_tpu_torch.data.plan_file import PlanFile

        if isinstance(file, UnsteadyFlowFile):
            line_base = "Unsteady File={}"
            existing = self.unsteady_flow_files
            letter = "u"
        elif isinstance(file, PlanFile):
            line_base = "Plan File={}"
            existing = self.plan_files
            letter = "p"
        else:
            raise TypeError(f"Cannot register {type(file)} in a RAS project")
        new_path = self.increment_suffix(existing, letter)
        file.to_file(new_path)
        add_file_to_prj_file(str(self.prj_path), line_base.format(new_path.split(".")[-1]))
        self.assets[Path(new_path).name] = new_path
        return new_path

    def make_new_plan(self, template_run: str, plan_attrs: dict[str, Any],
                      boundary_conditions: list) -> tuple[str, str]:
        """Clone a template plan (hdf + txt), patch attrs, write BC datasets,
        register in the project (reference gpras/ras/model.py:31-61)."""
        from gpras_tpu_torch.data.plan_file import update_hdf_attributes, update_hdf_data

        src_path = self.assets[template_run]
        new_run = self.increment_suffix(self.plan_files, "p")
        dst_path = new_run + ".hdf"
        src_txt = src_path[: -len(".hdf")] if src_path.endswith(".hdf") else src_path
        shutil.copy(src_path, dst_path)
        shutil.copy(src_txt, new_run)
        update_hdf_attributes(dst_path, PLAN_INFO_PATH, plan_attrs["hdf"])
        update_text_attributes(new_run, plan_attrs["txt"])
        add_file_to_prj_file(str(self.prj_path), f"Plan File={new_run.split('.')[-1]}")
        for bc in boundary_conditions:
            update_hdf_data(dst_path, bc.path, bc.data)
        self.assets[Path(dst_path).name] = dst_path
        self.assets[Path(new_run).name] = new_run
        return dst_path, new_run


def add_file_to_prj_file(prj_path: str, file_row: str) -> None:
    """Insert a 'Plan File=pXX'-style row after the last row with the same key,
    preserving encoding and newline convention (reference gpras/ras/model.py:183-192)."""
    encoding, newline = detect_file_properties(prj_path)
    with open(prj_path, encoding=encoding) as f:
        lines = f.readlines()
    key = file_row.split("=")[0]
    last = max((i for i, line in enumerate(lines) if line.startswith(key)),
               default=len(lines) - 1)
    lines.insert(last + 1, file_row + "\n")
    with open(prj_path, "w", encoding=encoding, newline=newline) as f:
        f.writelines(lines)


def update_text_attributes(txt_path: str, attrs: dict[str, str]) -> None:
    """Patch key=value rows in a RAS text file in place, preserving encoding and
    newlines (reference gpras/ras/model.py:195-207)."""
    encoding, newline = detect_file_properties(txt_path)
    with open(txt_path, encoding=encoding) as f:
        lines = f.readlines()
    for ind, line in enumerate(lines):
        # key = text before the FIRST '=' (values may contain '=')
        key = line.rstrip("\n").split("=", 1)[0]
        if "=" in line and key in attrs:
            lines[ind] = f"{key}={attrs[key]}\n"
    with open(txt_path, "w", encoding=encoding, newline=newline) as f:
        f.writelines(lines)
