"""Coordinate reference systems: WKT parsing + point transforms.

A copy of ``gpras_tpu/utils/crs.py`` (the port may not import the JAX
package, whose ``__init__`` imports jax).

The reference reprojects the AOI onto each precipitation grid's CRS via
pyproj/rasterio (gpras/preprocess.py:236-251 for the RAS precip raster,
gpras/preprocess.py:771-806 for the HMS DSS grid, utils/spatial_utils.py:9-15
for the affine transform). This module is the optional-dependency gateway
(same pattern as ``data/dss.py``): ``pyproj`` is used when importable;
otherwise an owned ellipsoidal projection engine covers the projections that
actually occur in FFRD HEC-RAS/HMS data:

- geographic (NAD83/WGS84 lon-lat degrees),
- Albers Equal-Area Conic (the fixed SHG/standard-hydrologic-grid CRS every
  FFRD precip grid ships in, and EPSG:5070-family state CRSs),
- Lambert Conformal Conic (1SP/2SP; state-plane zones, e.g. Texas North
  Central for the Trinity pilot),
- Transverse Mercator (UTM zones).

Formulas are Snyder, *Map Projections: A Working Manual* (USGS PP 1395),
ellipsoidal forms: Albers eq. 14-1..14-12, LCC eq. 15-1..15-11, TM
eq. 8-9..8-25. Accuracy: exact for Albers/LCC; the TM series is sub-mm within
the +-4 degrees of a UTM zone. Datum shifts are NOT applied (NAD83 and WGS84
differ by ~1 m — far below the 2000 m SHG cell size these masks are built on).
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger("gpras_tpu_torch.crs")

__all__ = ["CRS", "make_transformer", "transform_points"]


# --------------------------------------------------------------------- parsing

def _tokenize_wkt(wkt: str):
    """WKT1 -> nested node: (keyword, [children]); children are str, float, or
    nodes. Handles ESRI and OGC WKT1 (PROJCS/GEOGCS/...)."""
    pos = 0
    s = wkt.strip()

    def parse_node():
        nonlocal pos
        m = re.match(r"\s*([A-Za-z_0-9]+)\s*\[", s[pos:])
        if not m:
            raise ValueError(f"WKT parse error at {pos}: {s[pos:pos+40]!r}")
        keyword = m.group(1).upper()
        pos += m.end()
        children = []
        while True:
            m = re.match(r'\s*"((?:[^"])*)"\s*', s[pos:])
            if m:
                children.append(m.group(1))
                pos += m.end()
            else:
                # a proper float token — NOT the loose [-+0-9.eE]+, which
                # would eat the "E" of bare enum tokens like EAST and crash
                # float() (AXIS["Easting",EAST] is standard GDAL output)
                m = re.match(r"\s*([-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)"
                             r"(?=\s*[,\]])", s[pos:])
                if m:
                    children.append(float(m.group(1)))
                    pos += m.end()
                elif re.match(r"\s*[A-Za-z_0-9]+\s*\[", s[pos:]):
                    children.append(parse_node())
                else:
                    m = re.match(r"\s*([A-Za-z_0-9]+)\s*", s[pos:])
                    if m:  # bare enum token (e.g. AXIS[...,NORTH])
                        children.append(m.group(1))
                        pos += m.end()
            m = re.match(r"\s*([,\]])\s*", s[pos:])
            if not m:
                raise ValueError(f"WKT parse error at {pos}: {s[pos:pos+40]!r}")
            pos += m.end()
            if m.group(1) == "]":
                return (keyword, children)

    node = parse_node()
    return node


def _find(node, keyword):
    for c in node[1]:
        if isinstance(c, tuple) and c[0] == keyword:
            return c
    return None


def _find_all(node, keyword):
    return [c for c in node[1] if isinstance(c, tuple) and c[0] == keyword]


_PARAM_ALIASES = {
    "central_meridian": "lon0", "longitude_of_center": "lon0",
    "longitude_of_origin": "lon0",
    "latitude_of_origin": "lat0", "latitude_of_center": "lat0",
    "standard_parallel_1": "sp1", "standard_parallel_2": "sp2",
    "false_easting": "fe", "false_northing": "fn",
    "scale_factor": "k0",
}

_PROJ_KINDS = (
    ("albers", "aea"),
    ("lambert_conformal_conic", "lcc"),
    ("transverse_mercator", "tmerc"),
)


@dataclass(frozen=True)
class CRS:
    """A parsed CRS: projection kind + ellipsoid + normalized parameters.

    ``kind`` is one of 'geographic', 'aea', 'lcc', 'tmerc'. Angular params are
    radians; linear params are meters; ``unit`` is the projected linear unit's
    meters-per-unit factor (1.0 for meters, 0.3048006... for US survey feet).
    """
    kind: str
    a: float = 6378137.0
    inv_f: float = 298.257222101  # GRS80
    params: dict = field(default_factory=dict)
    unit: float = 1.0
    name: str = ""

    @classmethod
    def from_wkt(cls, wkt: str) -> "CRS":
        node = _tokenize_wkt(wkt)
        if node[0] in ("GEOGCS", "GEOGCRS", "GEODCRS"):
            a, inv_f = _spheroid(node)
            return cls(kind="geographic", a=a, inv_f=inv_f,
                       name=str(node[1][0]) if node[1] else "")
        if node[0] not in ("PROJCS",):
            raise ValueError(
                f"Unsupported WKT root {node[0]!r} (WKT1 PROJCS/GEOGCS only; "
                "install pyproj for full CRS support)")
        geog = _find(node, "GEOGCS")
        if geog is None:
            raise ValueError("PROJCS without GEOGCS")
        a, inv_f = _spheroid(geog)
        projection = _find(node, "PROJECTION")
        if projection is None:
            raise ValueError("PROJCS without PROJECTION")
        pname = str(projection[1][0]).lower()
        kind = None
        for token, k in _PROJ_KINDS:
            if token in pname:
                kind = k
                break
        if kind is None:
            raise ValueError(
                f"Unsupported projection {projection[1][0]!r} (supported: "
                "Albers, Lambert_Conformal_Conic, Transverse_Mercator; "
                "install pyproj for others)")
        # the projected linear unit: last top-level UNIT in the PROJCS
        units = _find_all(node, "UNIT")
        unit = float(units[-1][1][1]) if units else 1.0
        params: dict[str, float] = {}
        for p in _find_all(node, "PARAMETER"):
            key = _PARAM_ALIASES.get(str(p[1][0]).lower())
            if key is None:
                continue
            val = float(p[1][1])
            if key in ("fe", "fn"):
                params[key] = val * unit  # linear params -> meters
            elif key == "k0":
                params[key] = val
            else:
                params[key] = math.radians(val)
        params.setdefault("fe", 0.0)
        params.setdefault("fn", 0.0)
        params.setdefault("lat0", 0.0)
        params.setdefault("lon0", 0.0)
        params.setdefault("k0", 1.0)
        if kind in ("aea", "lcc"):
            if "sp1" not in params:
                params["sp1"] = params["lat0"]
            if "sp2" not in params:
                params["sp2"] = params["sp1"]
        return cls(kind=kind, a=a, inv_f=inv_f, params=params, unit=unit,
                   name=str(node[1][0]) if node[1] else "")

    # -- ellipsoid helpers ---------------------------------------------------
    @property
    def e2(self) -> float:
        f = 1.0 / self.inv_f if self.inv_f else 0.0
        return f * (2.0 - f)

    def same_as(self, other: "CRS", tol: float = 1e-9) -> bool:
        if self.kind != other.kind:
            return False
        if abs(self.a - other.a) > 1e-3 or abs(self.e2 - other.e2) > 1e-12:
            return False
        if abs(self.unit - other.unit) > 1e-12:
            return False
        keys = set(self.params) | set(other.params)
        return all(abs(self.params.get(k, 0.0) - other.params.get(k, 0.0)) <= tol
                   for k in keys)

    # -- forward / inverse ----------------------------------------------------
    def from_lonlat(self, lon: np.ndarray, lat: np.ndarray):
        """(lon, lat) degrees -> projected (x, y) in this CRS's unit."""
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        if self.kind == "geographic":
            return np.degrees(lon), np.degrees(lat)
        fwd = {"aea": _aea_fwd, "lcc": _lcc_fwd, "tmerc": _tmerc_fwd}[self.kind]
        x, y = fwd(self, lon, lat)
        return ((x + self.params["fe"]) / self.unit,
                (y + self.params["fn"]) / self.unit)

    def to_lonlat(self, x: np.ndarray, y: np.ndarray):
        """Projected (x, y) in this CRS's unit -> (lon, lat) degrees."""
        if self.kind == "geographic":
            return np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
        xm = np.asarray(x, dtype=np.float64) * self.unit - self.params["fe"]
        ym = np.asarray(y, dtype=np.float64) * self.unit - self.params["fn"]
        inv = {"aea": _aea_inv, "lcc": _lcc_inv, "tmerc": _tmerc_inv}[self.kind]
        lon, lat = inv(self, xm, ym)
        return np.degrees(lon), np.degrees(lat)


def _spheroid(geog_node) -> tuple[float, float]:
    datum = _find(geog_node, "DATUM")
    sph = _find(datum, "SPHEROID") if datum else None
    if sph is None:
        sph = _find(geog_node, "SPHEROID")
    if sph is None:
        return 6378137.0, 298.257222101
    return float(sph[1][1]), float(sph[1][2])


# ------------------------------------------------ Albers Equal-Area (Snyder 14)

def _q(e: float, sinphi: np.ndarray) -> np.ndarray:
    if e < 1e-12:
        return 2.0 * sinphi
    esin = e * sinphi
    return (1.0 - e * e) * (sinphi / (1.0 - esin * esin)
                            - (0.5 / e) * np.log((1.0 - esin) / (1.0 + esin)))


def _m(e: float, phi: np.ndarray) -> np.ndarray:
    s = np.sin(phi)
    return np.cos(phi) / np.sqrt(1.0 - e * e * s * s)


def _aea_consts(c: CRS):
    e = math.sqrt(c.e2)
    p1, p2, p0 = c.params["sp1"], c.params["sp2"], c.params["lat0"]
    m1 = _m(e, np.float64(p1))
    q1 = _q(e, np.sin(np.float64(p1)))
    if abs(p1 - p2) < 1e-12:
        n = math.sin(p1)
    else:
        m2 = _m(e, np.float64(p2))
        q2 = _q(e, np.sin(np.float64(p2)))
        n = float((m1 * m1 - m2 * m2) / (q2 - q1))
    cc = float(m1 * m1 + n * q1)
    rho0 = c.a * math.sqrt(cc - n * float(_q(e, math.sin(p0)))) / n
    return e, n, cc, rho0


def _aea_fwd(c: CRS, lon, lat):
    e, n, cc, rho0 = _aea_consts(c)
    rho = c.a * np.sqrt(cc - n * _q(e, np.sin(lat))) / n
    theta = n * _wrap(lon - c.params["lon0"])
    return rho * np.sin(theta), rho0 - rho * np.cos(theta)


def _aea_inv(c: CRS, x, y):
    e, n, cc, rho0 = _aea_consts(c)
    rho = np.hypot(x, rho0 - y)
    theta = np.arctan2(np.sign(n) * x, np.sign(n) * (rho0 - y))
    q = (cc - (rho * n / c.a) ** 2) / n
    lon = c.params["lon0"] + theta / n
    # iterate Snyder 3-16 for phi
    phi = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
    if e > 1e-12:
        for _ in range(6):
            s = np.sin(phi)
            es2 = 1.0 - c.e2 * s * s
            phi = phi + (es2 * es2 / (2.0 * np.cos(phi))) * (
                q / (1.0 - c.e2) - s / es2
                + (0.5 / e) * np.log((1.0 - e * s) / (1.0 + e * s)))
    return lon, phi


# --------------------------------------- Lambert Conformal Conic (Snyder 15)

def _t(e: float, phi: np.ndarray) -> np.ndarray:
    esin = e * np.sin(phi)
    return np.tan(math.pi / 4.0 - phi / 2.0) / np.power(
        (1.0 - esin) / (1.0 + esin), e / 2.0)


def _lcc_consts(c: CRS):
    e = math.sqrt(c.e2)
    p1, p2, p0 = c.params["sp1"], c.params["sp2"], c.params["lat0"]
    k0 = c.params.get("k0", 1.0)
    t1 = float(_t(e, np.float64(p1)))
    m1 = float(_m(e, np.float64(p1)))
    if abs(p1 - p2) < 1e-12:
        n = math.sin(p1)
    else:
        t2 = float(_t(e, np.float64(p2)))
        m2 = float(_m(e, np.float64(p2)))
        n = (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2))
    ff = k0 * m1 / (n * t1 ** n)
    rho0 = c.a * ff * float(_t(e, np.float64(p0))) ** n
    return e, n, ff, rho0


def _lcc_fwd(c: CRS, lon, lat):
    e, n, ff, rho0 = _lcc_consts(c)
    rho = c.a * ff * np.power(_t(e, lat), n)
    theta = n * _wrap(lon - c.params["lon0"])
    return rho * np.sin(theta), rho0 - rho * np.cos(theta)


def _lcc_inv(c: CRS, x, y):
    e, n, ff, rho0 = _lcc_consts(c)
    rho = np.sign(n) * np.hypot(x, rho0 - y)
    theta = np.arctan2(np.sign(n) * x, np.sign(n) * (rho0 - y))
    lon = c.params["lon0"] + theta / n
    t = np.power(rho / (c.a * ff), 1.0 / n)
    phi = math.pi / 2.0 - 2.0 * np.arctan(t)
    for _ in range(6):
        esin = e * np.sin(phi)
        phi = math.pi / 2.0 - 2.0 * np.arctan(
            t * np.power((1.0 - esin) / (1.0 + esin), e / 2.0))
    return lon, phi


# --------------------------------------- Transverse Mercator (Snyder 8, series)

def _merid_arc(c: CRS, phi):
    e2 = c.e2
    e4, e6 = e2 * e2, e2 * e2 * e2
    return c.a * ((1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
                  - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * phi)
                  + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * phi)
                  - (35 * e6 / 3072) * np.sin(6 * phi))


def _tmerc_fwd(c: CRS, lon, lat):
    e2 = c.e2
    ep2 = e2 / (1.0 - e2)
    k0 = c.params.get("k0", 1.0)
    s, co = np.sin(lat), np.cos(lat)
    nn = c.a / np.sqrt(1.0 - e2 * s * s)
    tt = np.tan(lat) ** 2
    cc = ep2 * co * co
    aa = _wrap(lon - c.params["lon0"]) * co
    m = _merid_arc(c, lat)
    m0 = _merid_arc(c, np.float64(c.params["lat0"]))
    x = k0 * nn * (aa + (1 - tt + cc) * aa ** 3 / 6
                   + (5 - 18 * tt + tt * tt + 72 * cc - 58 * ep2) * aa ** 5 / 120)
    y = k0 * (m - m0 + nn * np.tan(lat) * (
        aa ** 2 / 2 + (5 - tt + 9 * cc + 4 * cc * cc) * aa ** 4 / 24
        + (61 - 58 * tt + tt * tt + 600 * cc - 330 * ep2) * aa ** 6 / 720))
    return x, y


def _tmerc_inv(c: CRS, x, y):
    e2 = c.e2
    ep2 = e2 / (1.0 - e2)
    k0 = c.params.get("k0", 1.0)
    m0 = _merid_arc(c, np.float64(c.params["lat0"]))
    m = m0 + y / k0
    e1 = (1.0 - math.sqrt(1.0 - e2)) / (1.0 + math.sqrt(1.0 - e2))
    mu = m / (c.a * (1 - e2 / 4 - 3 * e2 * e2 / 64 - 5 * e2 ** 3 / 256))
    phi1 = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu)
            + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu)
            + (151 * e1 ** 3 / 96) * np.sin(6 * mu)
            + (1097 * e1 ** 4 / 512) * np.sin(8 * mu))
    s1, c1 = np.sin(phi1), np.cos(phi1)
    cc1 = ep2 * c1 * c1
    tt1 = np.tan(phi1) ** 2
    n1 = c.a / np.sqrt(1.0 - e2 * s1 * s1)
    r1 = c.a * (1.0 - e2) / np.power(1.0 - e2 * s1 * s1, 1.5)
    d = x / (n1 * k0)
    phi = phi1 - (n1 * np.tan(phi1) / r1) * (
        d ** 2 / 2 - (5 + 3 * tt1 + 10 * cc1 - 4 * cc1 * cc1 - 9 * ep2) * d ** 4 / 24
        + (61 + 90 * tt1 + 298 * cc1 + 45 * tt1 * tt1 - 252 * ep2
           - 3 * cc1 * cc1) * d ** 6 / 720)
    lon = c.params["lon0"] + (
        d - (1 + 2 * tt1 + cc1) * d ** 3 / 6
        + (5 - 2 * cc1 + 28 * tt1 - 3 * cc1 * cc1 + 8 * ep2
           + 24 * tt1 * tt1) * d ** 5 / 120) / c1
    return lon, phi


def _wrap(lon):
    """Wrap longitudes to (-pi, pi]."""
    return (np.asarray(lon) + math.pi) % (2.0 * math.pi) - math.pi


# ------------------------------------------------------------------- gateway

def make_transformer(src_wkt: str | None, dst_wkt: str | None):
    """(N, 2) point transform src -> dst, or None when it is the identity
    (same CRS, or either side unknown — matching the reference's behavior of
    trusting the data when no CRS is recorded)."""
    if not src_wkt or not dst_wkt:
        return None
    if src_wkt.strip() == dst_wkt.strip():
        return None
    try:
        import pyproj  # optional accelerator/generalizer

        t = pyproj.Transformer.from_crs(pyproj.CRS(src_wkt), pyproj.CRS(dst_wkt),
                                        always_xy=True)
        if t.source_crs == t.target_crs:
            return None

        def _pyproj_transform(pts: np.ndarray) -> np.ndarray:
            pts = np.asarray(pts, dtype=np.float64)
            x, y = t.transform(pts[..., 0], pts[..., 1])
            return np.stack([x, y], axis=-1)

        return _pyproj_transform
    except ImportError:
        pass
    src = CRS.from_wkt(src_wkt)
    dst = CRS.from_wkt(dst_wkt)
    if src.same_as(dst):
        return None

    def _owned_transform(pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, dtype=np.float64)
        lon, lat = src.to_lonlat(pts[..., 0], pts[..., 1])
        x, y = dst.from_lonlat(lon, lat)
        return np.stack([x, y], axis=-1)

    return _owned_transform


def transform_points(src_wkt: str | None, dst_wkt: str | None,
                     pts: np.ndarray) -> np.ndarray:
    """Transform (N, 2) points; identity when CRSs match or are unknown."""
    t = make_transformer(src_wkt, dst_wkt)
    return np.asarray(pts, dtype=np.float64) if t is None else t(pts)
