"""Geospatial types + operations.

Counterpart of ``pinot_tpu/utils/geo.py`` (a copy: the port imports
nothing of the JAX package), with the grid cells of the geo index
(``cell_of``, ``cells_of``, ``cell_disk``; JAX :197-250) that
``segment/geoindex.py`` builds and reads.

Re-design of the reference's geospatial layer (``pinot-core/.../geospatial/``
— JTS geometry/geography types, ST_* transform functions, H3-cell indexing):
a compact WKT-backed geometry model (POINT / POLYGON / MULTIPOINT) with
vectorized numpy predicates, so point-set operations (distance prefilters,
point-in-polygon over a whole column) run as array ops — the same masked
vector shape the TPU scan kernels consume.

Geometry (planar, euclidean) vs geography (spherical, haversine meters)
follows the reference's split: the serialized form carries a geography bit
(ref: GeometryUtils.GEOGRAPHY_SRID).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

EARTH_RADIUS_M = 6371008.8  # mean earth radius


@dataclass(frozen=True)
class Geometry:
    """POINT / MULTIPOINT / POLYGON; coords are (x=lng, y=lat) pairs."""

    kind: str                       # POINT | MULTIPOINT | POLYGON
    coords: Tuple[Tuple[float, float], ...]
    geography: bool = False         # spherical semantics when True

    # -- WKT ----------------------------------------------------------------
    def wkt(self) -> str:
        if self.kind == "POINT":
            x, y = self.coords[0]
            return f"POINT ({_fmt(x)} {_fmt(y)})"
        if self.kind == "MULTIPOINT":
            inner = ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in self.coords)
            return f"MULTIPOINT ({inner})"
        inner = ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in self.coords)
        return f"POLYGON (({inner}))"

    @property
    def x(self) -> float:
        return self.coords[0][0]

    @property
    def y(self) -> float:
        return self.coords[0][1]


def _fmt(v: float) -> str:
    return f"{v:.10g}"


_WKT_POINT = re.compile(
    r"^\s*POINT\s*\(\s*([-\d.eE+]+)\s+([-\d.eE+]+)\s*\)\s*$", re.I)
_WKT_POLY = re.compile(
    r"^\s*POLYGON\s*\(\s*\((.*?)\)\s*\)\s*$", re.I | re.S)
_WKT_MULTIPOINT = re.compile(
    r"^\s*MULTIPOINT\s*\((.*?)\)\s*$", re.I | re.S)


def from_wkt(text: str, geography: bool = False) -> Geometry:
    """Parse POINT/POLYGON/MULTIPOINT WKT (ref: ST_GeomFromText /
    ST_GeogFromText)."""
    m = _WKT_POINT.match(text)
    if m:
        return Geometry("POINT", ((float(m.group(1)), float(m.group(2))),),
                        geography)
    m = _WKT_POLY.match(text)
    if m:
        pts = _parse_coord_list(m.group(1))
        return Geometry("POLYGON", tuple(pts), geography)
    m = _WKT_MULTIPOINT.match(text)
    if m:
        body = m.group(1).replace("(", "").replace(")", "")
        pts = _parse_coord_list(body)
        return Geometry("MULTIPOINT", tuple(pts), geography)
    raise ValueError(f"unsupported WKT: {text[:80]!r}")


def _parse_coord_list(body: str) -> List[Tuple[float, float]]:
    pts = []
    for part in body.split(","):
        xy = part.split()
        if len(xy) != 2:
            raise ValueError(f"bad coordinate {part!r}")
        pts.append((float(xy[0]), float(xy[1])))
    return pts


def point(x: float, y: float, geography: bool = False) -> Geometry:
    return Geometry("POINT", ((float(x), float(y)),), geography)


GEOG_PREFIX = "SRID=4326;"  # EWKT geography tag (ref: GEOGRAPHY_SRID)


def parse_ewkt(text) -> Geometry:
    """WKT or EWKT string -> Geometry; the ``SRID=4326;`` prefix selects
    geography (spherical) semantics. THE single entry every consumer of
    stored/literal geo strings goes through."""
    s = str(text)
    if s.startswith(GEOG_PREFIX):
        return from_wkt(s[len(GEOG_PREFIX):], geography=True)
    return from_wkt(s)


# --------------------------------------------------------------------------
# distance
# --------------------------------------------------------------------------

def haversine_m(lng1, lat1, lng2, lat2):
    """Spherical distance in meters; accepts scalars or numpy arrays."""
    lng1, lat1 = np.radians(lng1), np.radians(lat1)
    lng2, lat2 = np.radians(lng2), np.radians(lat2)
    dlat = lat2 - lat1
    dlng = lng2 - lng1
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlng / 2) ** 2)
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(a))


def distance(a: Geometry, b: Geometry) -> float:
    """ST_DISTANCE: euclidean for geometry, meters for geography
    (ref: StDistanceFunction)."""
    if a.kind != "POINT" or b.kind != "POINT":
        raise ValueError("ST_DISTANCE supports POINT arguments")
    if a.geography or b.geography:
        return float(haversine_m(a.x, a.y, b.x, b.y))
    return math.hypot(a.x - b.x, a.y - b.y)


# --------------------------------------------------------------------------
# containment (ray casting; vectorized over candidate points)
# --------------------------------------------------------------------------

def points_in_polygon(xs: np.ndarray, ys: np.ndarray,
                      poly: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Boolean mask: which (xs[i], ys[i]) fall inside the polygon ring
    (boundary counts as inside for axis-crossing edges, matching typical
    even-odd ray casting)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    inside = np.zeros(xs.shape, dtype=bool)
    pts = list(poly)
    if pts[0] != pts[-1]:
        pts = pts + [pts[0]]
    for (x1, y1), (x2, y2) in zip(pts[:-1], pts[1:]):
        crosses = ((y1 > ys) != (y2 > ys))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (x2 - x1) * (ys - y1) / (y2 - y1) + x1
        inside ^= crosses & (xs < xint)
    return inside


def contains(outer: Geometry, inner: Geometry) -> bool:
    """ST_CONTAINS(polygon, point) (ref: StContainsFunction)."""
    if outer.kind != "POLYGON" or inner.kind != "POINT":
        raise ValueError("ST_CONTAINS supports (POLYGON, POINT)")
    return bool(points_in_polygon(
        np.array([inner.x]), np.array([inner.y]), outer.coords)[0])


def area(g: Geometry) -> float:
    """ST_AREA via the shoelace formula (planar)."""
    if g.kind != "POLYGON":
        return 0.0
    pts = list(g.coords)
    if pts[0] != pts[-1]:
        pts = pts + [pts[0]]
    s = 0.0
    for (x1, y1), (x2, y2) in zip(pts[:-1], pts[1:]):
        s += x1 * y2 - x2 * y1
    return abs(s) / 2.0


def union(geoms: Sequence[Geometry]) -> Geometry:
    """ST_UNION over point sets -> MULTIPOINT (the reference unions
    arbitrary JTS geometries; this build covers point data)."""
    pts = []
    geography = False
    for g in geoms:
        geography = geography or g.geography
        if g.kind in ("POINT", "MULTIPOINT"):
            pts.extend(g.coords)
        else:
            raise ValueError("ST_UNION here supports point geometries")
    uniq = sorted(set(pts))
    return Geometry("MULTIPOINT", tuple(uniq), geography)


# --------------------------------------------------------------------------
# grid cells (the H3-equivalent): lat/lng -> cell id at a resolution
# --------------------------------------------------------------------------
#
# The reference's H3 index buckets points into hexagonal cells so distance
# predicates prefilter by cell disk before exact tests. This build uses a
# square lat/lng grid, as the JAX package does: a cell id packs
# (resolution, ix, iy); kRing becomes a (2r+1)^2 block. Resolution r has
# 2^r cells per 360 degrees.

def cell_of(lng: float, lat: float, res: int) -> int:
    n = 1 << res
    ix = int((lng + 180.0) / 360.0 * n) % n
    iy = min(int((lat + 90.0) / 180.0 * n), n - 1)
    return (res << 52) | (ix << 26) | iy


def cells_of(lngs: np.ndarray, lats: np.ndarray, res: int) -> np.ndarray:
    n = 1 << res
    ix = (((np.asarray(lngs) + 180.0) / 360.0 * n).astype(np.int64)) % n
    iy = np.minimum(((np.asarray(lats) + 90.0) / 180.0 * n).astype(np.int64),
                    n - 1)
    return (np.int64(res) << 52) | (ix << 26) | iy


def cell_disk(lng: float, lat: float, radius_m: float, res: int) -> List[int]:
    """Cells whose contents can be within ``radius_m`` of the point: the
    kRing analogue the geo index prefilters by.

    The longitude reach of a spherical cap is widest at its most poleward
    latitude, so the ring width uses cos() at the cap's poleward edge; a
    cap that touches a pole spans every longitude."""
    n = 1 << res
    cell_h_m = 180.0 / n * 111_320.0   # meridian meters per cell
    ry = int(radius_m / cell_h_m) + 2
    reach_deg = math.degrees(radius_m / EARTH_RADIUS_M)
    edge_lat = min(abs(lat) + reach_deg, 90.0)
    lat_cos = math.cos(math.radians(edge_lat))
    if lat_cos <= 1e-3:
        rx = n // 2
    else:
        cell_w_m = 360.0 / n * 111_320.0 * lat_cos
        rx = min(int(radius_m / cell_w_m) + 2, n // 2)
    ix0 = int((lng + 180.0) / 360.0 * n) % n
    iy0 = min(int((lat + 90.0) / 180.0 * n), n - 1)
    out = []
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            ix = (ix0 + dx) % n
            iy = iy0 + dy
            if 0 <= iy < n:
                out.append((res << 52) | (ix << 26) | iy)
    return sorted(set(out))
