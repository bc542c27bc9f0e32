"""The port's data layer against the JAX package's, on the same inputs.

``gpras_tpu_torch`` keeps its own copy of the host code it needs
(``utils/crs``, ``utils/file_utils``, ``data/geometry``, ``data/rating_curve``,
``data/dss``, ``data/ras_model``'s read side and ``native``), since it may not
import ``gpras_tpu``. Each test runs both copies on the same numpy inputs and
holds the port to the reference exactly (``np.array_equal``): the code is the
same, so are the bits. The native geometry engine is the port's own build
(under ``build/gpras_tpu_torch/``) against the reference's library.
"""

import json
import math

import numpy as np
import pytest
import torch_parity  # noqa: F401  (one torch thread)

import fixtures as fx
from gpras_tpu import native as jnative
from gpras_tpu.data import dss as jdss
from gpras_tpu.data import geometry as jgeo
from gpras_tpu.data import rating_curve as jrc
from gpras_tpu.data.ras_model import RasModel as JRasModel
from gpras_tpu.utils import crs as jcrs
from gpras_tpu.utils import file_utils as jfu
from gpras_tpu_torch import native as tnative
from gpras_tpu_torch.data import dss as tdss
from gpras_tpu_torch.data import geometry as tgeo
from gpras_tpu_torch.data import rating_curve as trc
from gpras_tpu_torch.data.ras_model import RasModel as TRasModel
from gpras_tpu_torch.utils import crs as tcrs
from gpras_tpu_torch.utils import file_utils as tfu

SHG_WKT = (
    'PROJCS["USA_Contiguous_Albers_Equal_Area_Conic_USGS_version",'
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Albers"],'
    'PARAMETER["False_Easting",0.0],PARAMETER["False_Northing",0.0],'
    'PARAMETER["Central_Meridian",-96.0],'
    'PARAMETER["Standard_Parallel_1",29.5],'
    'PARAMETER["Standard_Parallel_2",45.5],'
    'PARAMETER["Latitude_Of_Origin",23.0],UNIT["Meter",1.0]]'
)
NAD83_WKT = (
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]]'
)
TX_NC_WKT = (
    'PROJCS["NAD_1983_StatePlane_Texas_North_Central_FIPS_4202_Feet",'
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Lambert_Conformal_Conic"],'
    'PARAMETER["False_Easting",1968500.0],'
    'PARAMETER["False_Northing",6561666.666666666],'
    'PARAMETER["Central_Meridian",-98.5],'
    'PARAMETER["Standard_Parallel_1",32.13333333333333],'
    'PARAMETER["Standard_Parallel_2",33.96666666666667],'
    'PARAMETER["Latitude_Of_Origin",31.66666666666667],'
    'UNIT["Foot_US",0.3048006096012192]]'
)
UTM14_WKT = (
    'PROJCS["NAD_1983_UTM_Zone_14N",'
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Transverse_Mercator"],'
    'PARAMETER["False_Easting",500000.0],PARAMETER["False_Northing",0.0],'
    'PARAMETER["Central_Meridian",-99.0],PARAMETER["Scale_Factor",0.9996],'
    'PARAMETER["Latitude_Of_Origin",0.0],UNIT["Meter",1.0]]'
)
WKTS = {"shg": SHG_WKT, "nad83": NAD83_WKT, "tx_nc_feet": TX_NC_WKT, "utm14": UTM14_WKT}


def _same(a, b):
    """Equal arrays, NaN where NaN."""
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------------- crs

@pytest.mark.parametrize("kind, params, lonlat", [
    # Snyder's worked examples (tests/test_crs.py), Clarke 1866
    ("aea", dict(sp1=29.5, sp2=45.5, lat0=23.0, lon0=-96.0), (-75.0, 35.0)),
    ("lcc", dict(sp1=33.0, sp2=45.0, lat0=23.0, lon0=-96.0), (-75.0, 35.0)),
    ("tmerc", dict(lat0=0.0, lon0=-75.0, k0=0.9996), (-73.5, 40.5)),
])
def test_crs_snyder_projections_match(kind, params, lonlat):
    out = []
    for mod in (jcrs, tcrs):
        rad = {k: math.radians(v) for k, v in params.items() if k in ("sp1", "sp2", "lat0", "lon0")}
        other = {k: v for k, v in params.items() if k not in rad}
        c = mod.CRS(kind=kind, a=6378206.4, inv_f=294.9786982,
                    params={"fe": 0.0, "fn": 0.0, "k0": 1.0, **other, **rad})
        x, y = c.from_lonlat(np.array([lonlat[0]]), np.array([lonlat[1]]))
        out.append((x, y, *c.to_lonlat(x, y)))
    for a, b in zip(*out):
        _same(a, b)


@pytest.mark.parametrize("name", sorted(WKTS))
def test_crs_wkt_parse_and_round_trip_match(name):
    wkt = WKTS[name]
    lon, lat = np.meshgrid(np.linspace(-99.5, -94.0, 6), np.linspace(29.0, 35.0, 6))
    got = []
    for mod in (jcrs, tcrs):
        c = mod.CRS.from_wkt(wkt)
        x, y = c.from_lonlat(lon.ravel(), lat.ravel())
        got.append((c.kind, c.a, c.inv_f, c.unit, sorted(c.params.items()), x, y,
                    *c.to_lonlat(x, y)))
    assert got[0][:5] == got[1][:5]
    for a, b in zip(got[0][5:], got[1][5:]):
        _same(a, b)


@pytest.mark.parametrize("src, dst", [("nad83", "tx_nc_feet"), ("nad83", "shg"),
                                      ("tx_nc_feet", "shg"), ("shg", "nad83"),
                                      ("utm14", "shg")])
def test_crs_transform_points_match(src, dst):
    pts = np.array([[-97.2, 32.8], [-97.0, 33.1], [-96.8, 32.9]])
    if src != "nad83":
        pts = jcrs.transform_points(NAD83_WKT, WKTS[src], pts)
    _same(jcrs.transform_points(WKTS[src], WKTS[dst], pts),
          tcrs.transform_points(WKTS[src], WKTS[dst], pts))


def test_crs_identity_transformers_and_tokenizer_match():
    other = SHG_WKT.replace("USGS_version", "SHG")
    for a, b in ((None, SHG_WKT), (SHG_WKT, None), (SHG_WKT, SHG_WKT), (SHG_WKT, other)):
        assert jcrs.make_transformer(a, b) is None
        assert tcrs.make_transformer(a, b) is None
    wkt = SHG_WKT[:-1] + ',AXIS["Easting",EAST],AXIS["Northing",NORTH],AUTHORITY["EPSG","5070"]]'
    assert jcrs._tokenize_wkt(wkt) == tcrs._tokenize_wkt(wkt)
    t_j = jcrs.make_transformer(NAD83_WKT, SHG_WKT)
    t_t = tcrs.make_transformer(NAD83_WKT, SHG_WKT)
    pts = np.array([[-97.0, 33.0], [-96.5, 32.5]])
    _same(t_j(pts), t_t(pts))


# -------------------------------------------------------------------- geometry

RINGS = {
    "square": np.array([[0, 0], [2, 0], [2, 2], [0, 2]], dtype=float),
    "concave": np.array([[0, 0], [4, 0], [4, 3], [2, 1.5], [0, 3]], dtype=float),
    "closed_triangle": np.array([[1, 1], [3, 1], [1, 3], [1, 1]], dtype=float),
}


@pytest.mark.parametrize("name", sorted(RINGS))
def test_polygon_matches(name):
    pts = np.random.default_rng(0).uniform(-1, 5, size=(300, 2))
    ring = RINGS[name]
    j, t = jgeo.Polygon(ring), tgeo.Polygon(ring)
    _same(j.ring, t.ring)
    assert (j.area, j.bounds, j.to_geojson()) == (t.area, t.bounds, t.to_geojson())
    _same(j.centroid, t.centroid)
    _same(j.contains_points(pts), t.contains_points(pts))
    _same(j.transformed(lambda p: 2.0 * p + 1.0).ring, t.transformed(lambda p: 2.0 * p + 1.0).ring)


def test_geojson_readers_match(tmp_path):
    poly = tmp_path / "aoi.geojson"
    fx.write_aoi(poly, 0.2, 0.3, 5.8, 4.1)
    line = tmp_path / "line.geojson"
    line.write_text(json.dumps({"type": "FeatureCollection", "features": [{
        "type": "Feature", "geometry": {"type": "LineString",
                                        "coordinates": [[0.1, 3.0, 7.0], [5.9, 3.5, 7.0]]}}]}))
    _same(jgeo.Polygon.from_geojson_file(poly).ring, tgeo.Polygon.from_geojson_file(poly).ring)
    _same(jgeo.LineString.from_geojson_file(line).coords,
          tgeo.LineString.from_geojson_file(line).coords)


@pytest.mark.parametrize("nx, ny, cell", [(4, 3, 1.0), (7, 5, 2.5)])
def test_cell_mesh_matches(nx, ny, cell):
    pts, fpi = fx.grid_mesh(nx, ny, cell)
    aoi = np.array([[0.6, 0.6], [2.4 * cell, 0.6], [2.4 * cell, 1.4 * cell], [0.6, 1.4 * cell]])
    q = np.random.default_rng(1).uniform(0, nx * cell, size=(50, 2))
    j = jgeo.CellMesh(np.arange(nx * ny), fpi, pts)
    t = tgeo.CellMesh(np.arange(nx * ny), fpi, pts)
    assert j.n_cells == t.n_cells
    for name in ("centroids", "areas"):
        _same(getattr(j, name), getattr(t, name))
    _same(j.intersects(jgeo.Polygon(aoi)), t.intersects(tgeo.Polygon(aoi)))
    for a, b in zip(j.padded_vertices(), t.padded_vertices()):
        _same(a, b)
    _same(j.cell_vertices(3), t.cell_vertices(3))
    _same(j.containing_cell(q), t.containing_cell(q))


def test_linestring_and_rasterize_match():
    coords = np.array([[0, 0], [10, 0], [10, 5], [4, 8]], dtype=float)
    j, t = jgeo.LineString(coords), tgeo.LineString(coords)
    assert j.length == t.length
    for p in ([3.0, 5.0], [11.0, 2.0], [5.0, 7.0]):
        assert j.project(np.array(p)) == t.project(np.array(p))
    for spacing in (0.7, 2.5):
        _same(j.sample(spacing), t.sample(spacing))
    _same(j.interpolate(np.array([0.0, 3.3, 12.0])), t.interpolate(np.array([0.0, 3.3, 12.0])))
    ring = RINGS["concave"]
    for touched in (False, True):
        _same(jgeo.rasterize_polygon(jgeo.Polygon(ring), (-0.5, 4.0), 0.5, (10, 11), touched),
              tgeo.rasterize_polygon(tgeo.Polygon(ring), (-0.5, 4.0), 0.5, (10, 11), touched))


def test_export_grid_qc_matches(tmp_path):
    data = np.arange(30, dtype=np.float32).reshape(5, 6)
    paths = [mod.export_grid_qc(data, (1.0, 9.0), 0.5, str(tmp_path / name), crs_wkt=SHG_WKT,
                                title="qc")
             for mod, name in ((jgeo, "jax"), (tgeo, "torch"))]
    assert [p.replace("jax", "torch") for p in paths[0]] == paths[1]
    with np.load(paths[0][0]) as a, np.load(paths[1][0]) as b:
        assert a.files == b.files
        for k in a.files:
            _same(a[k], b[k])


# ---------------------------------------------------------------- rating curve

@pytest.mark.parametrize("case", ["smooth", "filtered", "bounded"])
def test_rating_curve_matches(case):
    rng = np.random.default_rng(0)
    kwargs = {}
    if case == "smooth":
        q = np.exp(rng.uniform(np.log(20), np.log(5000), 300))
        wse = 100 + 3 * np.log(q) + 0.05 * rng.normal(size=q.shape)
    else:
        q = np.array([np.nan, -5, 5, 100, 200, 50, 400, 300, 800, 600, 1000, 900,
                      1500, 1200, 2000])
        wse = 10 + np.sqrt(np.abs(q))
        kwargs = {"n_knots": 3} if case == "filtered" else {"n_knots": 2, "qmax": 1600.0}
    j, t = jrc.RatingCurve(q, wse, **kwargs), trc.RatingCurve(q, wse, **kwargs)
    _same(j.q, t.q)
    _same(j.wse, t.wse)
    assert j.fit_stats == t.fit_stats
    grid = np.linspace(-10, 6000, 57)
    _same(j.predict(grid), t.predict(grid))
    knots = np.concatenate([[0] * 4, [2.5, 5, 7.5], [10] * 4])
    x = np.linspace(0, 10, 200)
    _same(jrc.bspline_design_matrix(x, knots, 3), trc.bspline_design_matrix(x, knots, 3))


def test_rating_curve_too_few_points_raises_in_both():
    for mod in (jrc, trc):
        with pytest.raises(ValueError):
            mod.RatingCurve(np.arange(5) + 20.0, np.arange(5.0))


# ------------------------------------------------------------------------- dss

def test_fake_dss_and_grid_copy_match(tmp_path):
    """FakeDss through each package's gateway, and hdf_grid_to_dss's grid
    copy (flipped north-up) into a fake DSS: the same records in both."""
    import h5py

    grid = np.arange(2 * 12, dtype=np.float32).reshape(2, 12)
    with h5py.File(tmp_path / "g.hdf", "w") as f:
        f.create_dataset("precip", data=grid)
    for mod, fu, tag in ((jdss, jfu, "jax"), (tdss, tfu, "torch")):
        template = str(tmp_path / f"{tag}_template.dss")
        out = str(tmp_path / f"{tag}_out.dss")
        (tmp_path / f"{tag}_template.dss").write_bytes(b"")
        for path in (template, out):  # the fake holds no file: the copy's records too
            mod.FakeDss.register(path, {"/SHG/P/PRECIP/01JAN2020:0000/X/GPR/": mod.FakeRecord(
                data=np.zeros((3, 4), np.float32), cellSize=2.0, numberOfCellsX=4,
                numberOfCellsY=3, srsDefinition="LOCAL")})
        mod.set_dss_factory(mod.FakeDss)
        try:
            fu.hdf_grid_to_dss(tmp_path / "g.hdf", "precip", template, out,
                               "/SHG/P/PRECIP/{stamp}/X/GPR/", ["01JAN2020:0100", "01JAN2020:0200"])
            d = mod.open_dss(out)
            cat = [str(c) for c in d.get_catalog()]
            recs = {c: d.get(c).data for c in cat}
        finally:
            mod.set_dss_factory(None)
        if tag == "jax":
            want_cat, want = cat, recs
    assert cat == want_cat and len(cat) == 3
    for c in cat:
        _same(recs[c], want[c])
    _same(recs["/SHG/P/PRECIP/01JAN2020:0100/X/GPR/"], np.flipud(grid[0].reshape(3, 4)))
    assert jdss.HAS_HECDSS == tdss.HAS_HECDSS
    if not tdss.HAS_HECDSS:  # without the package or a fake: a clear error in both
        for mod in (jdss, tdss):
            with pytest.raises(ImportError, match="hecdss"):
                mod.open_dss(str(tmp_path / "missing.dss"))


# ------------------------------------------------------------------ file_utils

@pytest.mark.parametrize("raw", [b"Plan Title=a\r\nProgram=6.5\r\n", b"\xef\xbb\xbfa=1\nb=2\n",
                                 b"a=\xe9\rb=2\r", b"plain"])
def test_file_utils_match(tmp_path, raw):
    path = tmp_path / "f.txt"
    path.write_bytes(raw)
    assert jfu.detect_file_properties(path) == tfu.detect_file_properties(path)
    for name in ("s3://bucket/a/b.p01", "s3://bucket/dir/", "/x/y/model.prj", "rel/z.u02"):
        assert jfu.get_filename(name) == tfu.get_filename(name)


# ------------------------------------------------------------------- RasModel

@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("ras")
    rows, cols = 6, 5
    meta = {"Raster Cellsize": 1.0, "Raster Left": 0.0, "Raster Top": 6.0,
            "Raster Rows": rows, "Raster Cols": cols, "Projection": SHG_WKT}
    precip = np.abs(np.random.default_rng(0).normal(size=(40, rows * cols))).astype(np.float32)
    proj = fx.make_project(root / "hf", "hfm", nx=6, ny=6, cell=1.0, plans=["e1", "e2", "e3"],
                           projection=TX_NC_WKT, precip=precip, precip_meta=meta)
    (root / "hf" / "hfm.p01").write_text("Plan Title=e1\n")
    (root / "hf" / "hfm.u01").write_text("Flow Title=u\n")
    return proj


def _models(project):
    return JRasModel.from_stac(project["stac"]), TRasModel.from_stac(project["stac"])


def test_ras_model_reads_match(project):
    j, t = _models(project)
    assert sorted(j.plan_hdfs) == sorted(t.plan_hdfs) == ["e1", "e2", "e3"]
    assert j.projection == t.projection == TX_NC_WKT
    assert j.assets == t.assets and j.id == t.id
    for plan in ("e1", "e3"):
        pj, pt = j.plan_hdfs[plan], t.plan_hdfs[plan]
        assert (pj.plan_name, pj.geometry_title, pj.projection) == \
            (pt.plan_name, pt.geometry_title, pt.projection)
        assert list(pj.timestamps()) == list(pt.timestamps())
        for var in ("Water Surface", "Cell Velocity - Velocity X"):
            _same(pj.mesh_timeseries_output(fx.MESH_ID, var),
                  pt.mesh_timeseries_output(fx.MESH_ID, var))
        _same(j.get_cell_minimum_elevation(plan, fx.MESH_ID),
              t.get_cell_minimum_elevation(plan, fx.MESH_ID))
        _same(j.get_cell_areas(plan, fx.MESH_ID), t.get_cell_areas(plan, fx.MESH_ID))
        assert j.get_precip_attributes(plan) == t.get_precip_attributes(plan)
    for name in ("get_plan_wsels", "get_plan_depths"):
        a = getattr(j, name)(["e1", "e2"], fx.MESH_ID)
        b = getattr(t, name)(["e1", "e2"], fx.MESH_ID)
        import pandas as pd

        pd.testing.assert_frame_equal(a, b)
    mj, mt = j.get_plan_geometry(["e1", "e2"], fx.MESH_ID), t.get_plan_geometry(["e1"], fx.MESH_ID)
    _same(mj.centroids, mt.centroids)
    _same(mj.face_point_indexes, mt.face_point_indexes)
    # a project opened from its .prj finds its files by name
    j, t = (cls(project["root"] / "hfm.prj") for cls in (JRasModel, TRasModel))
    assert j.assets == t.assets
    assert (j.plan_files, j.unsteady_flow_files) == (t.plan_files, t.unsteady_flow_files)
    assert len(t.plan_files) == len(t.unsteady_flow_files) == 1


def test_ras_model_stac_round_trip_matches(project, tmp_path):
    j, t = _models(project)
    j.to_stac(tmp_path / "j.stac.json")
    t.to_stac(tmp_path / "t.stac.json")
    a, b = (json.loads((tmp_path / f"{k}.stac.json").read_text()) for k in "jt")
    assert a == b
    assert b["bbox"] and b["properties"]["proj:wkt2"] == TX_NC_WKT
    # each package reads the item the other wrote
    assert TRasModel.from_stac(tmp_path / "j.stac.json").assets == \
        JRasModel.from_stac(tmp_path / "t.stac.json").assets


def test_port_has_the_read_side_only():
    """The port had only RasModel's read side until the run-generation
    tooling; now both packages have the run-creation methods, with the same
    signatures (tests/test_torch_run_tooling.py holds them to each other)."""
    import inspect

    from gpras_tpu.data import ras_model as jrm
    from gpras_tpu_torch.data import ras_model as trm

    for name in ("increment_suffix", "add_text_file", "make_new_plan"):
        assert hasattr(JRasModel, name) and hasattr(TRasModel, name)
        assert inspect.signature(getattr(TRasModel, name)) == \
            inspect.signature(getattr(JRasModel, name))
    for name in ("add_file_to_prj_file", "update_text_attributes"):
        assert inspect.signature(getattr(trm, name)) == inspect.signature(getattr(jrm, name))


# ---------------------------------------------------------------------- native

needs_native = pytest.mark.skipif(not (jnative.available() and tnative.available()),
                                  reason="no C++ toolchain for the native engine")


def test_native_library_is_built_beside_the_package_not_in_it():
    from pathlib import Path

    root = Path(tnative.__file__).resolve().parents[2]
    assert tnative._SO.parent == root / "build" / "gpras_tpu_torch"
    assert not list(Path(tnative.__file__).parent.glob("*.so"))
    assert tnative.available() == jnative.available()


@needs_native
def test_native_point_in_polygon_and_clip_match():
    rng = np.random.default_rng(0)
    ring = np.array([[0, 0], [4, 0], [4, 3], [2, 5], [0, 3]], dtype=float)
    pts = rng.uniform(-1, 6, size=(500, 2))
    _same(jnative.pip_batch(ring, pts), tnative.pip_batch(ring, pts))
    sq = RINGS["square"]
    tri = np.array([[1, 1], [3, 1], [1, 3]], dtype=float)
    for a, b in ((sq, sq), (sq, sq + [1.0, 0.0]), (sq, sq + [5.0, 0.0]),
                 (sq[::-1], (sq + [1.0, 0.0])[::-1]), (tri, sq)):
        assert jnative.clip_area_convex(a, b) == tnative.clip_area_convex(a, b)
    crossing = np.array([[-1, 1], [3, 1]], dtype=float)
    outside = np.array([[-1, -1], [-1, 5]], dtype=float)
    for line in (crossing, outside, np.array([[1, 1], [1.5, 1.5]])):
        assert jnative.polyline_touches_poly(line, sq) == tnative.polyline_touches_poly(line, sq)


@needs_native
def test_native_best_overlap_matches():
    pts, fpi = fx.grid_mesh(4, 4, 1.0)
    mesh = jgeo.CellMesh(np.arange(16), fpi, pts)
    c_verts, c_counts = mesh.padded_vertices()
    hf = jgeo.CellMesh(np.arange(64), *fx.grid_mesh(8, 8, 0.5)[::-1])
    hv, hc = hf.padded_vertices()
    cand = np.tile(np.arange(9, dtype=np.int32), (64, 1))
    got = [mod.best_overlap_batch(hv, hc, c_verts, c_counts, cand) for mod in (jnative, tnative)]
    for a, b in zip(*got):
        _same(a, b)
    from gpras_tpu.data.builders import _convex_ring_mask as jmask
    from gpras_tpu_torch.data.builders import _convex_ring_mask as tmask

    _same(jmask(hv, hc), tmask(hv, hc))


# -------------------------------------------------------------------- profiling

def test_phase_timers_match_and_profiler_trace_writes_a_trace(tmp_path):
    import time

    import torch

    from gpras_tpu.utils.profiling import PhaseTimers as JTimers
    from gpras_tpu_torch.utils.profiling import PhaseTimers as TTimers
    from gpras_tpu_torch.utils.profiling import profiler_trace

    files = []
    for cls, tag in ((JTimers, "jax"), (TTimers, "torch")):
        t = cls()
        with t.phase("load_data"):
            time.sleep(0.005)
        with t.phase("load_data"):  # a phase entered twice adds up
            time.sleep(0.005)
        t.start("fit_model")
        t.stop("fit_model")
        assert t.elapsed["load_data"] >= 0.01
        t.to_file(tmp_path / tag / "timers.json")
        files.append(json.loads((tmp_path / tag / "timers.json").read_text()))
    assert list(files[0]) == list(files[1]) == ["load_data", "fit_model"]
    with profiler_trace(None):  # no directory: nothing is traced or written
        pass
    with profiler_trace(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
