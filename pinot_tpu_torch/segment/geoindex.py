"""Geo index: grid-cell prefiltering for distance predicates.

Counterpart of ``pinot_tpu/segment/geoindex.py`` (the reference's H3
index, ``ImmutableH3IndexReader`` + ``H3IndexFilterOperator``): each
DICTIONARY id of a column of WKT points maps to its cell of a square
lat/lng grid (``utils/geo.py`` ``cells_of``), and the filter path is

    cell disk -> candidate dictIds -> exact haversine on candidates -> LUT

so the doc mask has the dictId-LUT shape of every other index. The files
(``geocells``, ``geolng``, ``geolat``, ``geometa``) are the JAX package's,
byte for byte.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pinot_tpu_torch.utils import geo

DEFAULT_RESOLUTION = 9


def build_geo_index(values, resolution: int) -> Optional[Dict[str, np.ndarray]]:
    """Suffix -> array of the index over a dictionary's values at
    ``resolution``; None where a value is not a point (JAX declines the
    build rather than write an index that lies)."""
    lngs, lats = [], []
    for v in values:
        try:
            g = geo.parse_ewkt(v)
        except ValueError:
            return None
        if g.kind != "POINT":
            return None
        lngs.append(g.x)
        lats.append(g.y)
    lng_arr = np.asarray(lngs, dtype=np.float64)
    lat_arr = np.asarray(lats, dtype=np.float64)
    cells = geo.cells_of(lng_arr, lat_arr, resolution)
    return {"geocells": cells.astype(np.int64), "geolng": lng_arr,
            "geolat": lat_arr,
            "geometa": np.asarray([resolution], dtype=np.int64)}


class GeoIndexReader:
    """Query-side candidate narrowing."""

    def __init__(self, cells: np.ndarray, resolution: int, dictionary,
                 lngs: Optional[np.ndarray] = None,
                 lats: Optional[np.ndarray] = None):
        self.cells = np.asarray(cells)
        self.resolution = int(resolution)
        self.dictionary = dictionary
        self.lngs = None if lngs is None else np.asarray(lngs)
        self.lats = None if lats is None else np.asarray(lats)

    @classmethod
    def from_files(cls, files: Dict[str, np.ndarray], dictionary
                   ) -> "GeoIndexReader":
        return cls(files["geocells"], int(files["geometa"][0]), dictionary,
                   lngs=files.get("geolng"), lats=files.get("geolat"))

    def files(self) -> Dict[str, np.ndarray]:
        """The index's files, suffix -> array (as ``build_geo_index``)."""
        out = {"geocells": np.asarray(self.cells, dtype=np.int64),
               "geometa": np.asarray([self.resolution], dtype=np.int64)}
        if self.lngs is not None:
            out["geolng"] = self.lngs
            out["geolat"] = self.lats
        return out

    def candidate_dict_ids(self, lng: float, lat: float,
                           radius_m: float) -> np.ndarray:
        disk = np.asarray(geo.cell_disk(lng, lat, radius_m, self.resolution),
                          dtype=np.int64)
        return np.nonzero(np.isin(self.cells, disk))[0]

    def ids_within(self, lng: float, lat: float, radius_m: float,
                   inclusive: bool = True) -> np.ndarray:
        """dictIds whose point lies within ``radius_m`` meters (haversine,
        the ST_DISTANCE geography semantics)."""
        cand = self.candidate_dict_ids(lng, lat, radius_m)
        if cand.size == 0:
            return cand
        if self.lngs is not None:
            xs, ys = self.lngs[cand], self.lats[cand]
        else:   # an index written without coordinate arrays
            xs = np.empty(cand.size)
            ys = np.empty(cand.size)
            for j, i in enumerate(cand):
                g = geo.parse_ewkt(self.dictionary.get_value(int(i)))
                xs[j], ys[j] = g.x, g.y
        d = geo.haversine_m(xs, ys, lng, lat)
        keep = d <= radius_m if inclusive else d < radius_m
        return cand[keep]
