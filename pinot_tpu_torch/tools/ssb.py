"""Star Schema Benchmark (SSB): generator, the 13 flights, a numpy oracle.

Counterpart of ``pinot_tpu/tools/ssb.py``. The flat ``lineorder`` table
(17 columns, dimension attributes denormalised onto the fact row) is drawn
with the same dbgen distributions and the same random draws as the JAX
package's ``generate_segment_frame``: per-segment seeds and contiguous
month windows, so a seed gives the same rows in both packages.

Strings are generated as codes into a sorted universe of values
(``UNIVERSE``) and integers as int64 values; ``segment_from_frame`` turns a
frame into dictIds over sorted dictionaries directly, without building
string arrays, so SF10 builds in seconds.

``numpy_answer`` is an independent oracle: each flight's predicates,
groups and sums written out in numpy over a frame, with exact int64 sums.
``DECLINED_QUERIES`` are five queries over the same table that the fused
scan declines (a group space past its cap, int min/max past 2^24,
DISTINCTCOUNT and DISTINCTCOUNTHLL), with their oracle
(``declined_answer``: distinct sets of values, HLL registers from
``utils/hll`` over the raw values). ``sql_queries`` are seven more over
the same table (LIKE, NOT LIKE and REGEXP_LIKE of 1 to 100 dictId runs,
HAVING with OFFSET and OPTION, a query the segment metadata answers),
with their oracle: string predicates evaluated on the universe of values
and gathered by code. ``host_queries`` are seven the host engine and the
device top-k serve (percentile and mode, a grouped t-digest, a grouped
DISTINCTCOUNT, SELECT DISTINCT, unordered and ordered selections), with
their oracle written out in numpy over the frames.

``frame_rows`` turns a frame into the JSON row dicts a realtime
``lineorder`` table's stream carries.

``ssb_indexing_config()`` is the table's five star-trees (the JAX
package's), which ``build_segments(..., star_tree=True)`` builds in a
process pool; ``STARTREE_QUERIES`` are the star-tree's other routes on
such segments (the host walker, three declines, the opt-out), with their
oracle.

``ssb_schema``, ``generate_flat``, ``generate_table`` and
``generate_partitioned_frame`` are the JAX module's generators (strings
as codes here too: ``decode_frame`` gives the JAX arrays).
``build_segments(..., out_dir=DIR)`` writes the segments to ``DIR`` in a
spawned pool (``write_segment``) and loads them back (``load_segment``);
with ``partitioned=True`` each segment holds one ``d_year`` and records
Modulo partition metadata on it (``ssb_indexing_config(num_partitions=)``),
which the broker's partition pruner and the segment pruner read.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from pinot_tpu_torch.segment.convert import (
    ColumnArrays,
    attach_star_trees,
    segment_from_arrays,
    star_trees_of,
)
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.spi.table import (
    IndexingConfig,
    SegmentPartitionConfig,
    StarTreeIndexConfig,
)
from pinot_tpu_torch.utils.partition import get_partition_function
from pinot_tpu_torch.utils.hll import (
    DEFAULT_LOG2M,
    HyperLogLog,
    dictionary_register_luts,
)

ROWS_PER_SF = 6_000_000
TABLE = "ssb_lineorder"

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}

# (column, data type, field type) in schema order
COLUMNS: List[Tuple[str, DataType, FieldType]] = [
    ("lo_quantity", DataType.INT, FieldType.DIMENSION),
    ("lo_discount", DataType.INT, FieldType.DIMENSION),
    ("lo_extendedprice", DataType.INT, FieldType.METRIC),
    ("lo_revenue", DataType.INT, FieldType.METRIC),
    ("lo_supplycost", DataType.INT, FieldType.METRIC),
    ("d_year", DataType.INT, FieldType.DIMENSION),
    ("d_yearmonthnum", DataType.INT, FieldType.DIMENSION),
    ("d_weeknuminyear", DataType.INT, FieldType.DIMENSION),
    ("c_region", DataType.STRING, FieldType.DIMENSION),
    ("c_nation", DataType.STRING, FieldType.DIMENSION),
    ("c_city", DataType.STRING, FieldType.DIMENSION),
    ("s_region", DataType.STRING, FieldType.DIMENSION),
    ("s_nation", DataType.STRING, FieldType.DIMENSION),
    ("s_city", DataType.STRING, FieldType.DIMENSION),
    ("p_mfgr", DataType.STRING, FieldType.DIMENSION),
    ("p_category", DataType.STRING, FieldType.DIMENSION),
    ("p_brand1", DataType.STRING, FieldType.DIMENSION),
]


def ssb_schema() -> Schema:
    """The flat lineorder table's schema (JAX ``ssb_schema``)."""
    return Schema(TABLE, [FieldSpec(c, dt, ft) for c, dt, ft in COLUMNS])


def _sorted_universe(values: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted unique values, generation index -> sorted code)."""
    uniq, inv = np.unique(np.asarray(values, dtype=np.str_),
                          return_inverse=True)
    return uniq, inv.astype(np.int16)


# generation order of each string family, as the JAX generator indexes it
_NATION_GEN = [nat for r in REGIONS for nat in NATIONS[r]]                # 25
_CITY_GEN = [f"{nat[:9]:<9}{c}" for nat in _NATION_GEN for c in range(10)]
_MFGR_GEN = [f"MFGR#{m}" for m in range(1, 6)]
_CAT_GEN = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
_BRAND_GEN = [f"MFGR#{m}{c}{b:02d}" for m in range(1, 6) for c in range(1, 6)
              for b in range(1, 41)]

_FAMILIES = {"region": _sorted_universe(REGIONS),
             "nation": _sorted_universe(_NATION_GEN),
             "city": _sorted_universe(_CITY_GEN),
             "mfgr": _sorted_universe(_MFGR_GEN),
             "category": _sorted_universe(_CAT_GEN),
             "brand": _sorted_universe(_BRAND_GEN)}
_FAMILY_OF = {"c_region": "region", "s_region": "region",
              "c_nation": "nation", "s_nation": "nation",
              "c_city": "city", "s_city": "city", "p_mfgr": "mfgr",
              "p_category": "category", "p_brand1": "brand"}
# string column -> sorted value table its codes index
UNIVERSE: Dict[str, np.ndarray] = {c: _FAMILIES[f][0]
                                   for c, f in _FAMILY_OF.items()}


def _code(family: str, gen_idx: np.ndarray) -> np.ndarray:
    return _FAMILIES[family][1][gen_idx]


def _geo(rng: np.random.Generator, n: int):
    region_idx = rng.integers(0, len(REGIONS), n)
    nation_pick = rng.integers(0, 5, n)
    city_pick = rng.integers(0, 10, n)
    nation_flat = region_idx * 5 + nation_pick
    return (_code("region", region_idx), _code("nation", nation_flat),
            _code("city", nation_flat * 10 + city_pick))


def _flat_columns(rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
    """Every column except d_year/d_yearmonthnum, with the JAX generator's
    draws in its order."""
    quantity = rng.integers(1, 51, n).astype(np.int64)
    discount = rng.integers(0, 11, n).astype(np.int64)
    price = rng.integers(905, 111_000, n)
    extended = (quantity * price).astype(np.int64)
    revenue = (extended * (100 - discount) // 100).astype(np.int64)
    supplycost = rng.integers(540, 66_600, n).astype(np.int64)
    week = rng.integers(1, 54, n).astype(np.int64)
    c_region, c_nation, c_city = _geo(rng, n)
    s_region, s_nation, s_city = _geo(rng, n)
    mfgr_i = rng.integers(1, 6, n)
    cat_i = rng.integers(1, 6, n)
    brand_i = rng.integers(1, 41, n)
    cat_flat = (mfgr_i - 1) * 5 + (cat_i - 1)
    return {
        "lo_quantity": quantity, "lo_discount": discount,
        "lo_extendedprice": extended, "lo_revenue": revenue,
        "lo_supplycost": supplycost, "d_weeknuminyear": week,
        "c_region": c_region, "c_nation": c_nation, "c_city": c_city,
        "s_region": s_region, "s_nation": s_nation, "s_city": s_city,
        "p_mfgr": _code("mfgr", mfgr_i - 1),
        "p_category": _code("category", cat_flat),
        "p_brand1": _code("brand", cat_flat * 40 + (brand_i - 1)),
    }


_ALL_MONTHS = [y * 100 + m for y in range(1992, 1999) for m in range(1, 13)]


def _segment_months(i: int, num_segments: int) -> List[int]:
    per = -(-len(_ALL_MONTHS) // num_segments)
    return _ALL_MONTHS[i * per:(i + 1) * per] or [_ALL_MONTHS[-1]]


def generate_segment_frame(i: int, num_segments: int, n: int,
                           seed: int = 42) -> Dict[str, np.ndarray]:
    """Segment ``i``'s rows: ints as int64 values, strings as int16 codes
    into ``UNIVERSE[col]``."""
    rng = np.random.default_rng(seed * 1_000_003 + i)
    cols = _flat_columns(rng, n)
    months = np.asarray(_segment_months(i, num_segments))
    ym = months[rng.integers(0, len(months), n)]
    cols["d_yearmonthnum"] = ym.astype(np.int64)
    cols["d_year"] = (ym // 100).astype(np.int64)
    return cols


def generate_flat(sf: float, seed: int = 42,
                  rows: int = 0) -> Dict[str, np.ndarray]:
    """``rows or int(sf * ROWS_PER_SF)`` flat rows with globally uniform
    years and months (JAX ``generate_flat``)."""
    n = rows or int(sf * ROWS_PER_SF)
    rng = np.random.default_rng(seed)
    cols = _flat_columns(rng, n)
    year = rng.integers(1992, 1999, n).astype(np.int64)
    month = rng.integers(1, 13, n).astype(np.int64)
    cols["d_year"] = year
    cols["d_yearmonthnum"] = year * 100 + month
    return cols


def generate_table(num_segments: int, rows: int,
                   seed: int = 42) -> Dict[str, np.ndarray]:
    """The rows ``build_segments(rows=rows, num_segments=num_segments)``
    indexes, concatenated (JAX ``generate_table``)."""
    frames = [generate_segment_frame(i, num_segments, take, seed)
              for i, take in enumerate(segment_rows(num_segments, rows))]
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


PARTITION_COLUMN = "d_year"
NUM_YEARS = 7   # dbgen's 1992..1998


def generate_partitioned_frame(i: int, num_segments: int, n: int,
                               seed: int = 42) -> Dict[str, np.ndarray]:
    """Segment ``i``'s rows of the partitioned layout: one ``d_year``
    (1992 + i mod 7) a segment (JAX ``generate_partitioned_frame``)."""
    rng = np.random.default_rng(seed * 2_000_003 + i)
    cols = _flat_columns(rng, n)
    year = 1992 + (i % NUM_YEARS)
    cols["d_year"] = np.full(n, year, dtype=np.int64)
    cols["d_yearmonthnum"] = (year * 100
                              + rng.integers(1, 13, n)).astype(np.int64)
    return cols


def segment_rows(num_segments: int, rows: int) -> List[int]:
    """Rows per segment, split the way the JAX package splits them."""
    per = -(-rows // num_segments)
    out, left = [], rows
    for _ in range(num_segments):
        take = min(per, left)
        if take <= 0:
            break
        out.append(take)
        left -= take
    return out


def decode_frame(frame: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """String codes -> numpy string arrays (for comparisons at small size)."""
    return {c: (UNIVERSE[c][v] if c in UNIVERSE else v)
            for c, v in frame.items()}


def frame_rows(frame: Dict[str, np.ndarray], start: int = 0,
               stop: Optional[int] = None) -> List[Dict[str, Any]]:
    """Rows ``[start, stop)`` of a frame as the row dicts a stream carries
    (``json.dumps`` of each is its message): strings for the coded
    columns, ints for the rest, in ``COLUMNS`` order."""
    n = len(frame["lo_quantity"])
    stop = n if stop is None else min(stop, n)
    cols = {col: (UNIVERSE[col][frame[col][start:stop]].tolist()
                  if col in UNIVERSE
                  else np.asarray(frame[col][start:stop]).tolist())
            for col, _, _ in COLUMNS}
    names = list(cols)
    return [dict(zip(names, vals)) for vals in zip(*cols.values())]


def _dict_encode(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Non-negative int array -> (sorted present values, dictIds), in O(n)
    when the value span is small enough for a presence table."""
    lo = int(codes.min())
    span = int(codes.max()) - lo + 1
    if span > (1 << 26):
        uniq, ids = np.unique(codes, return_inverse=True)
        return uniq, ids.reshape(-1)
    shifted = codes - lo
    present = np.bincount(shifted, minlength=span) > 0
    remap = np.cumsum(present) - 1
    ids_dtype = np.int32 if span > (1 << 15) else np.int16
    return (np.nonzero(present)[0] + lo,
            remap.astype(ids_dtype)[shifted])


def ssb_indexing_config(star_tree: bool = True, num_partitions: int = 0,
                        partition_column: str = PARTITION_COLUMN
                        ) -> IndexingConfig:
    """The lineorder table's indexing (JAX ``ssb_indexing_config``,
    :198-273): five star-trees, one per flight family, so the pick serves
    every flight from the cheapest fitting tree:

    - tree 0 (Q2.x): category / brand under the region filters, revenue
      and supplycost, and the Q1.x derived pair;
    - tree 1 (Q1.x): ``sum(lo_extendedprice * lo_discount)`` over the
      date, discount and quantity dimensions;
    - tree 2 (Q3.x): region -> nation -> city on both sides, with
      d_yearmonthnum for Q3.4;
    - tree 3 (Q4.1, Q4.2): ``sum(lo_revenue - lo_supplycost)`` by nation
      and category;
    - tree 4 (Q4.3): the same pair by supplier city and brand.

    ``star_tree=False`` gives no trees. ``num_partitions`` > 0 adds a
    Modulo partition config on ``partition_column``, so the builder records
    each segment's partitions (the pruners' input)."""
    trees = [
        StarTreeIndexConfig(
            dimensions_split_order=["d_year", "c_region", "s_region",
                                    "p_category", "p_brand1"],
            function_column_pairs=["SUM__lo_revenue", "SUM__lo_supplycost",
                                   "SUM__lo_extendedprice*lo_discount",
                                   "COUNT__*"],
            max_leaf_records=10_000),
        StarTreeIndexConfig(
            dimensions_split_order=["d_year", "d_yearmonthnum",
                                    "d_weeknuminyear", "lo_discount",
                                    "lo_quantity"],
            function_column_pairs=["SUM__lo_extendedprice*lo_discount",
                                   "SUM__lo_revenue", "COUNT__*"],
            max_leaf_records=10_000),
        StarTreeIndexConfig(
            dimensions_split_order=["d_year", "d_yearmonthnum", "c_region",
                                    "s_region", "c_nation", "s_nation",
                                    "c_city", "s_city"],
            function_column_pairs=["SUM__lo_revenue", "COUNT__*"],
            max_leaf_records=10_000),
        StarTreeIndexConfig(
            dimensions_split_order=["d_year", "c_region", "s_region",
                                    "p_mfgr", "c_nation", "s_nation",
                                    "p_category"],
            function_column_pairs=["SUM__lo_revenue-lo_supplycost",
                                   "COUNT__*"],
            max_leaf_records=10_000),
        StarTreeIndexConfig(
            dimensions_split_order=["d_year", "s_nation", "p_category",
                                    "s_city", "p_brand1"],
            function_column_pairs=["SUM__lo_revenue-lo_supplycost",
                                   "COUNT__*"],
            max_leaf_records=10_000),
    ] if star_tree else []
    spc = SegmentPartitionConfig(column_partition_map={
        partition_column: {"functionName": "Modulo",
                           "numPartitions": num_partitions},
    }) if num_partitions > 0 else None
    return IndexingConfig(star_tree_index_configs=trees,
                          segment_partition_config=spc)


def segment_from_frame(name: str, frame: Dict[str, np.ndarray],
                       star_tree: bool = False,
                       num_partitions: int = 0) -> ImmutableSegment:
    """A port segment with sorted dictionaries built from the frame; with
    ``star_tree``, ``ssb_indexing_config()``'s five trees built over it;
    with ``num_partitions``, the Modulo partitions of ``PARTITION_COLUMN``
    recorded on it (as the JAX builder records them)."""
    num_docs = len(frame["lo_quantity"])
    fn = get_partition_function("Modulo", num_partitions) \
        if num_partitions > 0 else None
    columns = {}
    for col, dt, ft in COLUMNS:
        values, ids = _dict_encode(np.asarray(frame[col]))
        dictionary = UNIVERSE[col][values] if col in UNIVERSE else values
        arrays = ColumnArrays(data_type=dt, field_type=ft,
                              dictionary=dictionary, dict_ids=ids)
        if fn is not None and col == PARTITION_COLUMN:
            arrays.partition_function = fn.name
            arrays.num_partitions = fn.num_partitions
            arrays.partitions = sorted({fn.partition(v)
                                        for v in dictionary.tolist()})
        columns[col] = arrays
    indexing = None
    if star_tree or num_partitions:
        indexing = ssb_indexing_config(star_tree=star_tree,
                                       num_partitions=num_partitions)
    return segment_from_arrays(name, num_docs, columns, table_name=TABLE,
                               indexing=indexing)


def _segment_trees(i: int, num_segments: int, n: int, seed: int
                   ) -> Tuple[List[Dict[str, Any]], List[float]]:
    """Worker: segment ``i``'s five trees as arrays, and their build
    seconds (the frame is drawn again from the seed)."""
    frame = generate_segment_frame(i, num_segments, n, seed)
    seg = segment_from_frame(f"ssb_{i}", frame, star_tree=True)
    return star_trees_of(seg), seg.metadata.star_tree_build_s


def _frame_of(i: int, num_segments: int, n: int, seed: int,
              partitioned: bool) -> Dict[str, np.ndarray]:
    return (generate_partitioned_frame if partitioned
            else generate_segment_frame)(i, num_segments, n, seed)


def _write_one(i: int, num_segments: int, n: int, seed: int, out_dir: str,
               partitioned: bool, star_tree: bool) -> str:
    """Worker: draw, build and write segment ``i`` under ``out_dir``."""
    from pinot_tpu_torch.segment.creator import write_segment

    name = f"ssb_part_{i}" if partitioned else f"ssb_{i}"
    frame = _frame_of(i, num_segments, n, seed, partitioned)
    write_segment(segment_from_frame(
        name, frame, star_tree=star_tree,
        num_partitions=num_segments if partitioned else 0), out_dir)
    return name


def _build_on_disk(sizes: List[int], num_segments: int, seed: int,
                   out_dir: str, partitioned: bool, star_tree: bool,
                   workers: int) -> Tuple[List[ImmutableSegment],
                                          List[Dict[str, np.ndarray]]]:
    from pinot_tpu_torch.segment.immutable import load_segment

    os.makedirs(out_dir, exist_ok=True)
    jobs = [(i, num_segments, take, seed, out_dir, partitioned, star_tree)
            for i, take in enumerate(sizes)]
    workers = workers or min(len(jobs), os.cpu_count() or 1)
    frames = []
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        # spawn, not fork: the caller may hold a CUDA context
        with mp.get_context("spawn").Pool(workers) as pool:
            pending = pool.starmap_async(_write_one, jobs)
            frames = [_frame_of(i, num_segments, take, seed, partitioned)
                      for i, take in enumerate(sizes)]
            names = pending.get()
    else:
        names = [_write_one(*j) for j in jobs]
        frames = [_frame_of(i, num_segments, take, seed, partitioned)
                  for i, take in enumerate(sizes)]
    return ([load_segment(os.path.join(out_dir, nm)) for nm in names],
            frames)


def build_segments(sf: float, num_segments: int = 8, seed: int = 42,
                   rows: int = 0, star_tree: bool = False,
                   workers: int = 0, out_dir: Optional[str] = None,
                   partitioned: bool = False
                   ) -> Tuple[List[ImmutableSegment],
                              List[Dict[str, np.ndarray]]]:
    """(segments, their frames) for ``rows or sf * ROWS_PER_SF`` rows.
    ``star_tree`` builds ``ssb_indexing_config()``'s trees on every
    segment in a spawned pool of ``workers`` processes (0: min(segments,
    cpu count), as the JAX package's ``build_segments``), while this
    process draws the frames and builds the segments. With ``out_dir``,
    the pool's workers write the segments there (``ssb_<i>``, or
    ``ssb_part_<i>`` with ``partitioned``: one ``d_year`` a segment and
    its Modulo partition metadata) and this process loads them."""
    n = rows or int(sf * ROWS_PER_SF)
    sizes = segment_rows(num_segments, n)
    if out_dir is not None:
        return _build_on_disk(sizes, num_segments, seed, out_dir,
                              partitioned, star_tree, workers)
    if partitioned:
        raise ValueError("the partitioned layout is built on disk: "
                         "pass out_dir")

    def segments():
        segs, frames = [], []
        for i, take in enumerate(sizes):
            frame = generate_segment_frame(i, num_segments, take, seed)
            segs.append(segment_from_frame(f"ssb_{i}", frame))
            frames.append(frame)
        return segs, frames

    if not star_tree:
        return segments()
    jobs = [(i, num_segments, take, seed) for i, take in enumerate(sizes)]
    workers = workers or min(len(jobs), os.cpu_count() or 1)
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        # spawn, not fork: the caller may hold a CUDA context
        with mp.get_context("spawn").Pool(workers) as pool:
            pending = pool.starmap_async(_segment_trees, jobs)
            segs, frames = segments()
            trees = pending.get()
    else:
        segs, frames = segments()
        trees = [_segment_trees(*j) for j in jobs]
    for seg, (arrays, build_s) in zip(segs, trees):
        attach_star_trees(seg, arrays)
        seg.metadata.star_tree_build_s = build_s
    return segs, frames


# The 13 SSB flights on the flat schema.
QUERIES: Dict[str, str] = {
    "Q1.1": "SELECT sum(lo_extendedprice * lo_discount) FROM ssb_lineorder "
            "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3 "
            "AND lo_quantity < 25",
    "Q1.2": "SELECT sum(lo_extendedprice * lo_discount) FROM ssb_lineorder "
            "WHERE d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6 "
            "AND lo_quantity BETWEEN 26 AND 35",
    "Q1.3": "SELECT sum(lo_extendedprice * lo_discount) FROM ssb_lineorder "
            "WHERE d_weeknuminyear = 6 AND d_year = 1994 "
            "AND lo_discount BETWEEN 5 AND 7 "
            "AND lo_quantity BETWEEN 26 AND 35",
    "Q2.1": "SELECT d_year, p_brand1, sum(lo_revenue) FROM ssb_lineorder "
            "WHERE p_category = 'MFGR#12' AND s_region = 'AMERICA' "
            "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1",
    "Q2.2": "SELECT d_year, p_brand1, sum(lo_revenue) FROM ssb_lineorder "
            "WHERE p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228' "
            "AND s_region = 'ASIA' "
            "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1",
    "Q2.3": "SELECT d_year, p_brand1, sum(lo_revenue) FROM ssb_lineorder "
            "WHERE p_brand1 = 'MFGR#2239' AND s_region = 'EUROPE' "
            "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1",
    "Q3.1": "SELECT c_nation, s_nation, d_year, sum(lo_revenue) "
            "FROM ssb_lineorder "
            "WHERE c_region = 'ASIA' AND s_region = 'ASIA' "
            "AND d_year BETWEEN 1992 AND 1997 "
            "GROUP BY c_nation, s_nation, d_year "
            "ORDER BY d_year ASC, sum(lo_revenue) DESC",
    "Q3.2": "SELECT c_city, s_city, d_year, sum(lo_revenue) "
            "FROM ssb_lineorder "
            "WHERE c_nation = 'UNITED STATES' AND s_nation = 'UNITED STATES' "
            "AND d_year BETWEEN 1992 AND 1997 "
            "GROUP BY c_city, s_city, d_year "
            "ORDER BY d_year ASC, sum(lo_revenue) DESC",
    "Q3.3": "SELECT c_city, s_city, d_year, sum(lo_revenue) "
            "FROM ssb_lineorder "
            "WHERE c_city IN ('UNITED KI1', 'UNITED KI5') "
            "AND s_city IN ('UNITED KI1', 'UNITED KI5') "
            "AND d_year BETWEEN 1992 AND 1997 "
            "GROUP BY c_city, s_city, d_year "
            "ORDER BY d_year ASC, sum(lo_revenue) DESC",
    "Q3.4": "SELECT c_city, s_city, d_year, sum(lo_revenue) "
            "FROM ssb_lineorder "
            "WHERE c_city IN ('UNITED KI1', 'UNITED KI5') "
            "AND s_city IN ('UNITED KI1', 'UNITED KI5') "
            "AND d_yearmonthnum = 199712 "
            "GROUP BY c_city, s_city, d_year "
            "ORDER BY d_year ASC, sum(lo_revenue) DESC",
    "Q4.1": "SELECT d_year, c_nation, sum(lo_revenue - lo_supplycost) "
            "FROM ssb_lineorder "
            "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' "
            "AND p_mfgr IN ('MFGR#1', 'MFGR#2') "
            "GROUP BY d_year, c_nation ORDER BY d_year, c_nation",
    "Q4.2": "SELECT d_year, s_nation, p_category, "
            "sum(lo_revenue - lo_supplycost) FROM ssb_lineorder "
            "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' "
            "AND p_mfgr IN ('MFGR#1', 'MFGR#2') "
            "AND d_year IN (1997, 1998) "
            "GROUP BY d_year, s_nation, p_category "
            "ORDER BY d_year, s_nation, p_category",
    "Q4.3": "SELECT d_year, s_city, p_brand1, "
            "sum(lo_revenue - lo_supplycost) FROM ssb_lineorder "
            "WHERE s_nation = 'UNITED STATES' AND d_year IN (1997, 1998) "
            "AND p_category = 'MFGR#14' "
            "GROUP BY d_year, s_city, p_brand1 "
            "ORDER BY d_year, s_city, p_brand1",
}

# -- the oracle -------------------------------------------------------------

_US_CITIES_KI = ("UNITED KI1", "UNITED KI5")
# flight -> (conditions, group columns, summed value); a condition is
# (column, "eq" | "between" | "in", operands)
_ORACLE = {
    "Q1.1": ([("d_year", "eq", 1993), ("lo_discount", "between", (1, 3)),
              ("lo_quantity", "between", (None, 24))], (), "price_disc"),
    "Q1.2": ([("d_yearmonthnum", "eq", 199401),
              ("lo_discount", "between", (4, 6)),
              ("lo_quantity", "between", (26, 35))], (), "price_disc"),
    "Q1.3": ([("d_weeknuminyear", "eq", 6), ("d_year", "eq", 1994),
              ("lo_discount", "between", (5, 7)),
              ("lo_quantity", "between", (26, 35))], (), "price_disc"),
    "Q2.1": ([("p_category", "eq", "MFGR#12"), ("s_region", "eq", "AMERICA")],
             ("d_year", "p_brand1"), "revenue"),
    "Q2.2": ([("p_brand1", "between", ("MFGR#2221", "MFGR#2228")),
              ("s_region", "eq", "ASIA")], ("d_year", "p_brand1"), "revenue"),
    "Q2.3": ([("p_brand1", "eq", "MFGR#2239"), ("s_region", "eq", "EUROPE")],
             ("d_year", "p_brand1"), "revenue"),
    "Q3.1": ([("c_region", "eq", "ASIA"), ("s_region", "eq", "ASIA"),
              ("d_year", "between", (1992, 1997))],
             ("c_nation", "s_nation", "d_year"), "revenue"),
    "Q3.2": ([("c_nation", "eq", "UNITED STATES"),
              ("s_nation", "eq", "UNITED STATES"),
              ("d_year", "between", (1992, 1997))],
             ("c_city", "s_city", "d_year"), "revenue"),
    "Q3.3": ([("c_city", "in", _US_CITIES_KI), ("s_city", "in", _US_CITIES_KI),
              ("d_year", "between", (1992, 1997))],
             ("c_city", "s_city", "d_year"), "revenue"),
    "Q3.4": ([("c_city", "in", _US_CITIES_KI), ("s_city", "in", _US_CITIES_KI),
              ("d_yearmonthnum", "eq", 199712)],
             ("c_city", "s_city", "d_year"), "revenue"),
    "Q4.1": ([("c_region", "eq", "AMERICA"), ("s_region", "eq", "AMERICA"),
              ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))],
             ("d_year", "c_nation"), "profit"),
    "Q4.2": ([("c_region", "eq", "AMERICA"), ("s_region", "eq", "AMERICA"),
              ("p_mfgr", "in", ("MFGR#1", "MFGR#2")),
              ("d_year", "in", (1997, 1998))],
             ("d_year", "s_nation", "p_category"), "profit"),
    "Q4.3": ([("s_nation", "eq", "UNITED STATES"),
              ("d_year", "in", (1997, 1998)),
              ("p_category", "eq", "MFGR#14")],
             ("d_year", "s_city", "p_brand1"), "profit"),
}


# -- the star-tree's other routes ---------------------------------------------

# On segments with ssb_indexing_config()'s trees: ST1 fits tree 4, but its
# group space (d_year x 25 nations x 250 cities x 1000 brands per segment:
# its two brands are the dictionary's first and last) is past the
# device's MAX_DEVICE_GROUPS, so the host walker serves it;
# ST2-ST4 fit no tree (an OR filter, a group expression, a pair no tree
# stores); ST5 is Q2.1 opted out of the trees. ST2-ST5 go to the scan
# rungs.
STARTREE_QUERIES: Dict[str, str] = {
    "ST1": "SELECT d_year, s_nation, s_city, p_brand1, "
           "sum(lo_revenue - lo_supplycost) FROM ssb_lineorder "
           "WHERE p_brand1 IN ('MFGR#1101', 'MFGR#5540') "
           "GROUP BY d_year, s_nation, s_city, p_brand1 LIMIT 100000",
    "ST2": "SELECT d_year, sum(lo_revenue) FROM ssb_lineorder "
           "WHERE c_region = 'ASIA' OR s_region = 'ASIA' "
           "GROUP BY d_year LIMIT 100000",
    "ST3": "SELECT lo_quantity + 0, sum(lo_revenue) FROM ssb_lineorder "
           "WHERE d_year = 1994 GROUP BY lo_quantity + 0 LIMIT 100000",
    "ST4": "SELECT d_year, sum(lo_quantity) FROM ssb_lineorder "
           "WHERE s_region = 'AMERICA' GROUP BY d_year LIMIT 100000",
    "ST5": QUERIES["Q2.1"] + " LIMIT 100000 OPTION(useStarTree=false)",
}
# per query: "walker", the code every tree declines with, or None (opted
# out: no star-tree decision)
STARTREE_ROUTE: Dict[str, Optional[str]] = {
    "ST1": "walker", "ST2": "startree_filter_or_not_shape",
    "ST3": "startree_group_expression",
    "ST4": "startree_missing_function_pair", "ST5": None}
_STARTREE_ORACLE = {
    "ST1": ([("p_brand1", "in", ("MFGR#1101", "MFGR#5540"))],
            ("d_year", "s_nation", "s_city", "p_brand1"), "profit"),
    "ST2": ([("c_region", "or", [("c_region", "eq", "ASIA"),
                                 ("s_region", "eq", "ASIA")])],
            ("d_year",), "revenue"),
    "ST3": ([("d_year", "eq", 1994)], ("lo_quantity",), "revenue"),
    "ST4": ([("s_region", "eq", "AMERICA")], ("d_year",), "quantity"),
    "ST5": _ORACLE["Q2.1"],
}

# -- Q2.1 with other literals (concurrent same-shape traffic) -----------------

# C1-C8: Q2.1's shape with another category (MFGR#11-#15) and supplier
# region. Every variant keeps every segment (no date condition) and plans
# to one program layout, so concurrent variants share one launch of the
# batch scan's query axis.
_COALESCE = {f"C{i + 1}": (cat, reg) for i, (cat, reg) in enumerate([
    ("MFGR#11", "AFRICA"), ("MFGR#12", "AMERICA"), ("MFGR#13", "ASIA"),
    ("MFGR#14", "EUROPE"), ("MFGR#15", "MIDDLE EAST"),
    ("MFGR#11", "AMERICA"), ("MFGR#13", "EUROPE"), ("MFGR#15", "ASIA")])}
COALESCE_QUERIES: Dict[str, str] = {
    cid: QUERIES["Q2.1"].replace("'MFGR#12'", f"'{cat}'")
    .replace("'AMERICA'", f"'{reg}'") + " LIMIT 100000"
    for cid, (cat, reg) in _COALESCE.items()}
_COALESCE_ORACLE = {
    cid: ([("p_category", "eq", cat), ("s_region", "eq", reg)],
          ("d_year", "p_brand1"), "revenue")
    for cid, (cat, reg) in _COALESCE.items()}
# P1-P8: Q3.2's shape for another nation. Each probes its group space
# when it binds over a batch (the probe programs share one layout); the
# pruner keeps Q3.2's segments.
_PROBE = {f"P{i + 1}": nat for i, nat in enumerate([
    "UNITED STATES", "CHINA", "JAPAN", "BRAZIL", "FRANCE", "GERMANY",
    "INDIA", "CANADA"])}
PROBE_QUERIES: Dict[str, str] = {
    pid: QUERIES["Q3.2"].replace("'UNITED STATES'", f"'{nat}'")
    + " LIMIT 100000" for pid, nat in _PROBE.items()}
_COALESCE_ORACLE.update({
    pid: ([("c_nation", "eq", nat), ("s_nation", "eq", nat),
           ("d_year", "between", (1992, 1997))],
          ("c_city", "s_city", "d_year"), "revenue")
    for pid, nat in _PROBE.items()})


def _condition(frame, col: str, op: str, arg) -> np.ndarray:
    if op == "or":   # any of the (column, op, operand) conditions
        m = np.zeros(len(frame[col]), dtype=bool)
        for c, o, a in arg:
            m |= _condition(frame, c, o, a)
        return m
    v = frame[col]
    if op in ("prefix", "notprefix", "regex"):
        # a string predicate: evaluated once per universe value
        vals = [str(x) for x in UNIVERSE[col]]
        hit = np.array([re.search(arg, x) is not None if op == "regex"
                        else x.startswith(arg) for x in vals])
        return (~hit if op == "notprefix" else hit)[v]
    if col in UNIVERSE:   # translate string operands to universe codes
        table = UNIVERSE[col]

        def code(s):
            i = int(np.searchsorted(table, s))
            return i if i < len(table) and table[i] == s else -1

        if op == "eq":
            arg = code(arg)
        elif op == "in":
            arg = tuple(code(s) for s in arg)
        else:
            lo, hi = arg
            arg = (int(np.searchsorted(table, lo, side="left")),
                   int(np.searchsorted(table, hi, side="right")) - 1)
    if op == "eq":
        return v == arg
    if op == "in":
        return np.isin(v, np.asarray(arg))
    lo, hi = arg
    m = np.ones(v.shape[0], dtype=bool)
    if lo is not None:
        m &= v >= lo
    if hi is not None:
        m &= v <= hi
    return m


def bounds_may_match(frame: Dict[str, np.ndarray], qid: str) -> bool:
    """Whether the frame's per-column min/max leave query ``qid``'s
    conditions satisfiable: False when one equality, IN list or range
    lies wholly outside its column's [min, max] (pattern conditions never
    prune). An oracle of min/max segment pruning, independent of the
    engine's metadata."""
    conds = {**_ORACLE, **_SQL_ORACLE, **_DECLINED_ORACLE,
             **_HOST_ORACLE, **_STARTREE_ORACLE}.get(qid, ([],))[0]
    for col, op, arg in conds:
        if op in ("prefix", "notprefix", "regex", "or"):
            continue
        v = frame[col]
        lo, hi = int(v.min()), int(v.max())
        if col in UNIVERSE:   # codes index the sorted universe: same order
            table = UNIVERSE[col]
            lo, hi = str(table[lo]), str(table[hi])
        if op == "eq":
            ok = lo <= arg <= hi
        elif op == "in":
            ok = any(lo <= a <= hi for a in arg)
        else:
            a, b = arg
            ok = (a is None or a <= hi) and (b is None or lo <= b)
        if not ok:
            return False
    return True


def numpy_answer(frame: Dict[str, np.ndarray], qid: str
                 ) -> Union[int, Dict[Tuple, int]]:
    """Exact answer of flight ``qid`` over one frame: an int for the Q1
    flights, else {group key tuple: int sum}. Partials of several frames
    add up (``merge_answers``)."""
    conds, groups, value = {**_ORACLE, **_SQL_ORACLE, **_STARTREE_ORACLE,
                            **_COALESCE_ORACLE}[qid]
    m = np.ones(len(frame["lo_quantity"]), dtype=bool)
    for col, op, arg in conds:
        m &= _condition(frame, col, op, arg)
    if value == "price_disc":
        vals = frame["lo_extendedprice"][m] * frame["lo_discount"][m]
    elif value == "revenue":
        vals = frame["lo_revenue"][m]
    elif value == "quantity":
        vals = frame["lo_quantity"][m]
    else:
        vals = frame["lo_revenue"][m] - frame["lo_supplycost"][m]
    vals = vals.astype(np.int64)
    if not groups:
        return int(vals.sum(dtype=np.int64))
    # the group keys as one mixed-radix i64 a row (each column offset by
    # its minimum), grouped by a 1-d unique: a row-wise unique of the key
    # matrix sorts a void view, several times slower
    keys = [frame[g][m].astype(np.int64) for g in groups]
    los = [int(k.min()) if k.size else 0 for k in keys]
    spans = [int(k.max()) - lo + 1 if k.size else 1
             for k, lo in zip(keys, los)]
    if np.prod(np.array(spans, dtype=np.float64)) >= 2.0 ** 62:
        raise ValueError(f"{qid}: group key space over i64")
    code = np.zeros(len(vals), dtype=np.int64)
    for k, lo, span in zip(keys, los, spans):
        code = code * span + (k - lo)
    uniq, inv = np.unique(code, return_inverse=True)
    sums = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), vals)
    digits = []
    rest = uniq
    for lo, span in zip(reversed(los), reversed(spans)):
        digits.append(rest % span + lo)
        rest = rest // span
    rows = np.stack(digits[::-1], axis=1) if digits else uniq[:, None]
    out: Dict[Tuple, int] = {}
    for row, s in zip(rows.tolist(), sums.tolist()):
        key = tuple(str(UNIVERSE[g][x]) if g in UNIVERSE else int(x)
                    for g, x in zip(groups, row))
        out[key] = int(s)
    return out


def merge_answers(parts: List[Union[int, Dict[Tuple, int]]]
                  ) -> Union[int, Dict[Tuple, int]]:
    if isinstance(parts[0], int):
        return sum(parts)
    out: Dict[Tuple, int] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


# -- the SQL slice: patterns, HAVING / OFFSET / OPTION, metadata answers ------

# S1 is a one-run LIKE (an interval leaf of the fused scan), S2 Q3.3 with
# its city IN as a REGEXP_LIKE (Q3.3's rows), S3 a REGEXP_LIKE of 9-64
# runs (one interval-set node), S4 one of more than 64 runs (the general
# rung), S5 HAVING over the median with OFFSET and OPTION, S6 a filter-less
# count/min/max (segment metadata per segment), S7 a NOT LIKE in a Q2.1
# shape. S5's HAVING literal is the oracle's median, filled in by
# ``sql_queries``.
_SQL_TEXT: Dict[str, str] = {
    "S1": "SELECT d_year, p_brand1, sum(lo_revenue) FROM ssb_lineorder "
          "WHERE p_brand1 LIKE 'MFGR#22%' AND s_region = 'AMERICA' "
          "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1 LIMIT 100000",
    "S2": "SELECT c_city, s_city, d_year, sum(lo_revenue) "
          "FROM ssb_lineorder "
          "WHERE REGEXP_LIKE(c_city, '^UNITED KI[15]$') "
          "AND s_city IN ('UNITED KI1', 'UNITED KI5') "
          "AND d_year BETWEEN 1992 AND 1997 "
          "GROUP BY c_city, s_city, d_year "
          "ORDER BY d_year ASC, sum(lo_revenue) DESC LIMIT 100000",
    "S3": "SELECT d_year, sum(lo_revenue) FROM ssb_lineorder "
          "WHERE REGEXP_LIKE(p_brand1, '^MFGR#2.*7$') GROUP BY d_year "
          "ORDER BY d_year LIMIT 100000",
    "S4": "SELECT d_year, sum(lo_revenue) FROM ssb_lineorder "
          "WHERE REGEXP_LIKE(p_brand1, '7$') GROUP BY d_year ORDER BY d_year "
          "LIMIT 100000",
    "S5": "SELECT c_nation, sum(lo_revenue) FROM ssb_lineorder "
          "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY c_nation "
          "HAVING sum(lo_revenue) > {median} ORDER BY sum(lo_revenue) DESC "
          "LIMIT 5 OFFSET 5 OPTION(timeoutMs=60000)",
    "S6": "SELECT count(*), min(lo_revenue), max(lo_quantity) "
          "FROM ssb_lineorder",
    "S7": "SELECT d_year, p_brand1, sum(lo_revenue) FROM ssb_lineorder "
          "WHERE p_category = 'MFGR#12' AND c_nation NOT LIKE 'UNITED%' "
          "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1 LIMIT 100000",
}
_SQL_ORACLE = {
    "S1": ([("p_brand1", "prefix", "MFGR#22"), ("s_region", "eq", "AMERICA")],
           ("d_year", "p_brand1"), "revenue"),
    "S2": ([("c_city", "regex", "^UNITED KI[15]$"),
            ("s_city", "in", _US_CITIES_KI),
            ("d_year", "between", (1992, 1997))],
           ("c_city", "s_city", "d_year"), "revenue"),
    "S3": ([("p_brand1", "regex", "^MFGR#2.*7$")], ("d_year",), "revenue"),
    "S4": ([("p_brand1", "regex", "7$")], ("d_year",), "revenue"),
    "S5": ([("lo_discount", "between", (1, 3))], ("c_nation",), "revenue"),
    "S7": ([("p_category", "eq", "MFGR#12"),
            ("c_nation", "notprefix", "UNITED")],
           ("d_year", "p_brand1"), "revenue"),
}


def sql_queries(frames: List[Dict[str, np.ndarray]]
                ) -> Tuple[Dict[str, str], Dict[str, Any]]:
    """-> ({id: SQL}, {id: the answer}) of S1-S7 over ``frames``: a
    ``merge_answers`` dict for the grouped ones, S5's and S6's rows."""
    wants: Dict[str, Any] = {
        sid: merge_answers([numpy_answer(f, sid) for f in frames])
        for sid in _SQL_ORACLE}
    sums = wants["S5"]
    median = int(np.median(list(sums.values())))
    kept = sorted(((k[0], v) for k, v in sums.items() if v > median),
                  key=lambda kv: -kv[1])
    wants["S5"] = [[k, float(v)] for k, v in kept[5:10]]
    wants["S6"] = [[sum(len(f["lo_revenue"]) for f in frames),
                    float(min(int(f["lo_revenue"].min()) for f in frames)),
                    float(max(int(f["lo_quantity"].max()) for f in frames))]]
    sqls = dict(_SQL_TEXT)
    sqls["S5"] = sqls["S5"].format(median=median)
    return sqls, wants


# -- declined queries ---------------------------------------------------------

# Queries the fused scan declines, each served by the general rung
# (engine/kernels.py): id -> SQL. At SF10 in 8 segments (seed 42), G1's
# matched segment (10832 live docs, 1000 groups) takes the hash rung and
# G2's two (about 163 k live docs each, past the hash rung's 65536-doc
# window) the sort rung. With s_region = 'ASIA' in G1 (27162 docs, 2500
# groups) a probe pass of the hash table steals a claim and the sort rung
# serves it too.
DECLINED_QUERIES: Dict[str, str] = {
    "G1": "SELECT c_city, s_city, SUM(lo_revenue) FROM ssb_lineorder "
          "WHERE c_region = 'ASIA' AND s_nation IN ('CHINA', 'VIETNAM') "
          "AND d_yearmonthnum = 199712 GROUP BY c_city, s_city LIMIT 100000",
    "G2": "SELECT c_city, s_city, SUM(lo_revenue) FROM ssb_lineorder "
          "WHERE c_region = 'ASIA' AND s_region = 'ASIA' AND d_year = 1997 "
          "GROUP BY c_city, s_city LIMIT 100000",
    "G3": "SELECT d_year, MIN(lo_extendedprice * lo_discount), "
          "MAX(lo_extendedprice * lo_discount) FROM ssb_lineorder "
          "GROUP BY d_year LIMIT 100000",
    "G4": "SELECT DISTINCTCOUNT(p_brand1) FROM ssb_lineorder "
          "WHERE s_region = 'AMERICA' AND d_year = 1993",
    "G5": "SELECT d_year, DISTINCTCOUNTHLL(p_brand1) FROM ssb_lineorder "
          "WHERE s_region = 'EUROPE' GROUP BY d_year LIMIT 100000",
}
# the fused scan's decline reason code for each
DECLINED_REASONS: Dict[str, str] = {
    "G1": "pallas_too_many_groups", "G2": "pallas_too_many_groups",
    "G3": "pallas_minmax_not_f32_exact", "G4": "pallas_distinct_agg",
    "G5": "pallas_distinct_agg"}

_ASIA = [("c_region", "eq", "ASIA"), ("s_region", "eq", "ASIA")]
# id -> (conditions, group columns, aggregate, its argument)
_DECLINED_ORACLE = {
    "G1": ([("c_region", "eq", "ASIA"),
            ("s_nation", "in", ("CHINA", "VIETNAM")),
            ("d_yearmonthnum", "eq", 199712)],
           ("c_city", "s_city"), "sum", "revenue"),
    "G2": (_ASIA + [("d_year", "eq", 1997)],
           ("c_city", "s_city"), "sum", "revenue"),
    "G3": ([], ("d_year",), "minmax", "price_disc"),
    "G4": ([("s_region", "eq", "AMERICA"), ("d_year", "eq", 1993)], (),
           "distinct", "p_brand1"),
    "G5": ([("s_region", "eq", "EUROPE")], ("d_year",), "hll", "p_brand1"),
}


def _values(frame, arg: str, m: np.ndarray) -> np.ndarray:
    if arg == "revenue":
        return frame["lo_revenue"][m].astype(np.int64)
    if arg == "price_disc":
        return (frame["lo_extendedprice"][m]
                * frame["lo_discount"][m]).astype(np.int64)
    return frame[arg][m]


def _declined_partial(frame, gid: str) -> Dict[Tuple, object]:
    """{group key: state} of one frame: an int sum, a (min, max) pair, a
    set of string codes, or HLL registers."""
    conds, groups, agg, arg = _DECLINED_ORACLE[gid]
    m = np.ones(len(frame["lo_quantity"]), dtype=bool)
    for col, op, operand in conds:
        m &= _condition(frame, col, op, operand)
    vals = _values(frame, arg, m)
    # composite group index over each column's present values
    comp = np.zeros(vals.shape[0], dtype=np.int64)
    present = []
    for g in groups:
        u, inv = np.unique(frame[g][m], return_inverse=True)
        comp = comp * len(u) + inv.reshape(-1)
        present.append(u)
    uniq, gi = np.unique(comp, return_inverse=True)
    gi = gi.reshape(-1)
    if agg == "sum":
        states = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(states, gi, vals)
        states = states.tolist()
    elif agg == "minmax":
        lo = np.full(len(uniq), np.iinfo(np.int64).max)
        hi = np.full(len(uniq), np.iinfo(np.int64).min)
        np.minimum.at(lo, gi, vals)
        np.maximum.at(hi, gi, vals)
        states = list(zip(lo.tolist(), hi.tolist()))
    elif agg == "distinct":
        states = [set(np.unique(vals[gi == k]).tolist())
                  for k in range(len(uniq))]
    else:
        bucket, rank = _register_luts(arg)
        regs = np.zeros((len(uniq), 1 << DEFAULT_LOG2M), dtype=np.uint8)
        np.maximum.at(regs, (gi, bucket[vals]), rank[vals].astype(np.uint8))
        states = list(regs)
    out: Dict[Tuple, object] = {}
    for c, st in zip(uniq.tolist(), states):
        key = []
        for g, u in zip(reversed(groups), reversed(present)):
            c, j = divmod(c, len(u))
            key.append(str(UNIVERSE[g][u[j]]) if g in UNIVERSE
                       else int(u[j]))
        out[tuple(reversed(key))] = st
    return out


_LUTS: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}


def _register_luts(col: str) -> Tuple[np.ndarray, np.ndarray]:
    """(bucket, rank) per code of a string column, from the raw values."""
    if col not in _LUTS:
        _LUTS[col] = dictionary_register_luts(UNIVERSE[col].tolist(),
                                              DEFAULT_LOG2M)
    return _LUTS[col]


def _merge_state(agg: str, a, b):
    if agg == "sum":
        return a + b
    if agg == "minmax":
        return (min(a[0], b[0]), max(a[1], b[1]))
    if agg == "distinct":
        return a | b
    return np.maximum(a, b)


def declined_answer(frames: List[Dict[str, np.ndarray]], gid: str
                    ) -> Dict[Tuple, object]:
    """Exact answer of declined query ``gid`` over the frames: {group key
    tuple (``()`` for G4): its value, or (min, max) for G3}. DISTINCTCOUNT
    counts the distinct values, DISTINCTCOUNTHLL estimates from the
    registers of every row's raw value."""
    agg = _DECLINED_ORACLE[gid][2]
    merged: Dict[Tuple, object] = {}
    for frame in frames:
        for k, st in _declined_partial(frame, gid).items():
            merged[k] = st if k not in merged else _merge_state(agg, merged[k],
                                                                st)
    if agg == "distinct":
        return {k: len(v) for k, v in merged.items()} or {(): 0}
    if agg == "hll":
        return {k: HyperLogLog(DEFAULT_LOG2M, v).cardinality()
                for k, v in merged.items()}
    if agg == "minmax":
        return {k: (float(v[0]), float(v[1])) for k, v in merged.items()}
    return {k: float(v) for k, v in merged.items()}


def declined_rows(gid: str, rows: List[List]) -> Dict[Tuple, object]:
    """A result table's rows in ``declined_answer``'s form."""
    n_keys = len(_DECLINED_ORACLE[gid][1])
    if _DECLINED_ORACLE[gid][2] == "minmax":
        return {tuple(r[:n_keys]): tuple(r[n_keys:]) for r in rows}
    return {tuple(r[:n_keys]): r[n_keys] for r in rows}


# -- the host engine and the device top-k --------------------------------------

# H1 percentile and mode over one year (the host engine, scalar), H2 a
# t-digest percentile per nation (host, grouped), H3 DISTINCTCOUNT per year
# (host, grouped), H4 SELECT DISTINCT of 25 rows, H5 an unordered
# selection with OFFSET, H6 an ordered selection on dictionary keys (the
# device top-k), H7 one ordered by an expression (the host engine).
_AMERICA_1997 = "WHERE d_year = 1997 AND c_region = 'AMERICA'"
HOST_QUERIES: Dict[str, str] = {
    "H1": "SELECT percentile90(lo_revenue), mode(lo_discount) "
          "FROM ssb_lineorder WHERE d_year = 1997",
    "H2": "SELECT c_nation, percentiletdigest95(lo_extendedprice) "
          "FROM ssb_lineorder WHERE c_region = 'ASIA' GROUP BY c_nation "
          "ORDER BY c_nation",
    "H3": "SELECT d_year, distinctcount(c_city) FROM ssb_lineorder "
          "WHERE lo_discount = 0 AND lo_quantity <= 2 "
          "AND s_nation = 'CHINA' GROUP BY d_year ORDER BY d_year",
    "H4": "SELECT DISTINCT c_region, s_region FROM ssb_lineorder LIMIT 100",
    "H5": "SELECT d_yearmonthnum, c_city, lo_revenue FROM ssb_lineorder "
          "WHERE s_nation = 'BRAZIL' LIMIT 10 OFFSET 5",
    "H6": "SELECT d_yearmonthnum, c_city, lo_revenue FROM ssb_lineorder "
          f"{_AMERICA_1997} ORDER BY lo_revenue DESC, d_yearmonthnum "
          "LIMIT 20",
    "H7": "SELECT d_yearmonthnum, lo_revenue, lo_supplycost "
          f"FROM ssb_lineorder {_AMERICA_1997} "
          "ORDER BY lo_revenue - lo_supplycost DESC LIMIT 20",
}
# the t-digest's estimate of H2 against the exact percentile
TDIGEST_REL_TOL = 1e-2
_AMERICA_1997_CONDS = [("d_year", "eq", 1997), ("c_region", "eq", "AMERICA")]
_HOST_ORACLE = {
    "H1": ([("d_year", "eq", 1997)],),
    "H2": ([("c_region", "eq", "ASIA")],),
    "H3": ([("lo_discount", "eq", 0), ("lo_quantity", "between", (None, 2)),
            ("s_nation", "eq", "CHINA")],),
    "H4": ([],),
    "H5": ([("s_nation", "eq", "BRAZIL")],),
    "H6": (_AMERICA_1997_CONDS,),
    "H7": (_AMERICA_1997_CONDS,),
}


def _matching(frame, qid: str) -> np.ndarray:
    m = np.ones(len(frame["lo_quantity"]), dtype=bool)
    for col, op, arg in _HOST_ORACLE[qid][0]:
        m &= _condition(frame, col, op, arg)
    return m


def _cell(col: str, v) -> Any:
    return str(UNIVERSE[col][v]) if col in UNIVERSE else int(v)


def _ordered_rows(frames, qid: str, keys, select: List[str], limit: int
                  ) -> List[List]:
    """The first ``limit`` matching rows by ``keys(frame, mask)`` (a list
    of ascending sort keys, most significant first), ties in segment and
    doc order."""
    parts = []
    for si, f in enumerate(frames):
        m = _matching(f, qid)
        docs = np.nonzero(m)[0]
        parts.append((si, docs, keys(f, m)))
    seg = np.concatenate([np.full(len(d), si) for si, d, _ in parts])
    doc = np.concatenate([d for _, d, _ in parts])
    ks = [np.concatenate([k[i] for _, _, k in parts])
          for i in range(len(parts[0][2]))]
    order = np.lexsort([doc, seg] + ks[::-1])[:limit]
    return [[_cell(c, frames[int(seg[o])][c][doc[o]]) for c in select]
            for o in order]


def host_queries(frames: List[Dict[str, np.ndarray]]
                 ) -> Tuple[Dict[str, str], Dict[str, Any]]:
    """-> (``HOST_QUERIES``, {id: the rows}) over ``frames``; H2's cells
    are the exact 95th percentiles (``TDIGEST_REL_TOL``)."""
    wants: Dict[str, Any] = {}
    rev = np.concatenate([f["lo_revenue"][_matching(f, "H1")]
                          for f in frames])
    disc = np.concatenate([f["lo_discount"][_matching(f, "H1")]
                           for f in frames])
    rev.sort()
    counts = np.bincount(disc)
    top = np.nonzero(counts == counts.max())[0].max()
    wants["H1"] = [[float(rev[min(int(rev.size * 90.0 / 100.0), rev.size - 1)]),
                    float(top)]]
    by_nation: Dict[int, List[np.ndarray]] = {}
    for f in frames:
        m = _matching(f, "H2")
        nat, price = f["c_nation"][m], f["lo_extendedprice"][m]
        for c in np.unique(nat).tolist():
            by_nation.setdefault(c, []).append(price[nat == c])
    h2 = []
    for c, parts in sorted(by_nation.items()):
        v = np.sort(np.concatenate(parts))
        h2.append([_cell("c_nation", c),
                   float(v[min(int(v.size * 95.0 / 100.0),
                               v.size - 1)])])
    wants["H2"] = sorted(h2)
    cities: Dict[int, set] = {}
    for f in frames:
        m = _matching(f, "H3")
        for y, c in set(zip(f["d_year"][m].tolist(),
                            f["c_city"][m].tolist())):
            cities.setdefault(y, set()).add(c)
    wants["H3"] = [[y, len(c)] for y, c in sorted(cities.items())]
    seen: List[Tuple[int, int]] = []
    for f in frames:
        pair = f["c_region"].astype(np.int64) * 8 + f["s_region"]
        uniq, first = np.unique(pair, return_index=True)
        for p in uniq[np.argsort(first)].tolist():
            if (p // 8, p % 8) not in seen:
                seen.append((p // 8, p % 8))
    wants["H4"] = [[_cell("c_region", a), _cell("s_region", b)]
                   for a, b in seen][:100]
    rows = []
    for f in frames:
        docs = np.nonzero(_matching(f, "H5"))[0][:15 - len(rows)]
        rows += [[_cell(c, f[c][d]) for c in ("d_yearmonthnum", "c_city",
                                             "lo_revenue")] for d in docs]
    wants["H5"] = rows[5:15]
    wants["H6"] = _ordered_rows(
        frames, "H6", lambda f, m: [-f["lo_revenue"][m],
                                    f["d_yearmonthnum"][m]],
        ["d_yearmonthnum", "c_city", "lo_revenue"], 20)
    wants["H7"] = _ordered_rows(
        frames, "H7", lambda f, m: [f["lo_supplycost"][m]
                                    - f["lo_revenue"][m]],
        ["d_yearmonthnum", "lo_revenue", "lo_supplycost"], 20)
    return dict(HOST_QUERIES), wants


def check_host_rows(qid: str, rows: List[List], want: List[List]) -> None:
    """Raise unless a result's rows equal ``host_queries``' in order:
    exact, but H2's within ``TDIGEST_REL_TOL`` of the exact percentile."""
    got = [list(r) for r in rows]
    if len(got) != len(want):
        raise AssertionError(f"{qid}: {len(got)} rows, oracle {len(want)}")
    for g, w in zip(got, want):
        ok = len(g) == len(w) and all(
            abs(a - b) <= TDIGEST_REL_TOL * abs(b)
            if qid == "H2" and isinstance(b, float) else a == b
            for a, b in zip(g, w))
        if not ok:
            raise AssertionError(f"{qid}: row {g} != oracle {w}")
