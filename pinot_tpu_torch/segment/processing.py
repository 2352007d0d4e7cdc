"""Segment processing framework: map -> partition -> reduce -> build.

Counterpart of ``pinot_tpu/segment/processing.py`` (the reference's
``SegmentProcessorFramework`` with its mapper, partitioner, reducer and
time handler), which the minion tasks run (MergeRollup,
RealtimeToOffline, Purge):

- **map**: read the input segments back into columns (dictionary
  decoded, an upsert segment's valid docs only), drop the rows outside a
  time window and the rows a record filter matches;
- **partition**: bucket the rows by time (``bucket_time_ms``), one output
  partition a bucket, in the JAX package's order of its bucket keys (as
  strings);
- **reduce**: CONCAT (rows as they are), DEDUP (the first of each
  distinct row) or ROLLUP (one row per distinct dimension key, in the
  order the keys were first seen, its metrics aggregated: SUM, MIN or
  MAX; integral sums are exact int64 sums, past 2^53 too);
- **build**: one segment per ``max_docs_per_segment`` rows of a
  partition, named ``<prefix>_<partition>_<seq>``, through
  ``SegmentBuilder`` (``segment/creator.py``).

The JAX framework walks Python lists row by row; this one works column by
column on numpy arrays, and its output directories are byte-equal to
JAX's on the same inputs (creation and build times aside): the same rows
in the same order, the same names and the same splits. A float SUM adds
each group's values in row order with numpy's ``sum``, as JAX does.

One difference: ``record_filter`` takes the columns of one input segment
(column -> values, as ``read_columnar`` gives them) and returns a bool
mask of the rows to drop; the JAX filter is called once a row with a dict.
"""

from __future__ import annotations

import enum

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import FieldType, Schema
from pinot_tpu_torch.spi.table import TableConfig

TIME_UNIT_MS = {
    "MILLISECONDS": 1, "SECONDS": 1000, "MINUTES": 60_000,
    "HOURS": 3_600_000, "DAYS": 86_400_000,
}


class MergeType(enum.Enum):
    CONCAT = "CONCAT"
    ROLLUP = "ROLLUP"
    DEDUP = "DEDUP"


@dataclass
class SegmentProcessorConfig:
    """What one run of the framework does (the reference's
    SegmentProcessorConfig and the MergeRollup task's configs)."""

    schema: Schema
    table_config: TableConfig
    merge_type: MergeType = MergeType.CONCAT
    # metric column -> SUM | MIN | MAX (ROLLUP; default SUM)
    aggregation_types: Dict[str, str] = field(default_factory=dict)
    # one output partition per bucket of this many ms of the time column
    bucket_time_ms: Optional[int] = None
    # the half-open [start, end) window of the time column, in ms; rows
    # outside are dropped (RealtimeToOffline)
    window_start_ms: Optional[int] = None
    window_end_ms: Optional[int] = None
    # columns -> bool mask of the rows to DROP (Purge)
    record_filter: Optional[Callable[[Dict[str, Any]], np.ndarray]] = None
    segment_name_prefix: str = "processed"
    max_docs_per_segment: int = 5_000_000

    @property
    def time_column(self) -> Optional[str]:
        return self.table_config.validation_config.time_column_name

    @property
    def time_unit_ms(self) -> int:
        return TIME_UNIT_MS.get(
            self.table_config.validation_config.time_type.upper(), 1)


class Columns:
    """Rows as columns: ``values[c]`` a numpy array (single-value) or a
    list of lists (multi-value), ``nulls[c]`` the bool mask of a column's
    null rows (absent: none)."""

    def __init__(self, values: Dict[str, Any],
                 nulls: Optional[Dict[str, np.ndarray]] = None):
        self.values = values
        self.nulls = dict(nulls or {})

    def __len__(self) -> int:
        return len(next(iter(self.values.values()))) if self.values else 0

    def take(self, idx: np.ndarray) -> "Columns":
        return Columns({c: _take(v, idx) for c, v in self.values.items()},
                       {c: m[idx] for c, m in self.nulls.items()})

    def frame(self) -> Dict[str, Any]:
        """The segment builder's frame: a column with nulls as a list with
        None at its null rows."""
        out = {}
        for c, v in self.values.items():
            m = self.nulls.get(c)
            if m is not None and m.any():
                v = [None if isnull else x
                     for x, isnull in zip(_as_list(v), m.tolist())]
            out[c] = v
        return out


def _take(v, idx: np.ndarray):
    if isinstance(v, np.ndarray):
        return v[idx]
    return [v[i] for i in idx.tolist()]


def _as_list(v) -> list:
    return v.tolist() if isinstance(v, np.ndarray) else list(v)


def _concat(parts: List[Columns]) -> Columns:
    names = list(parts[0].values)
    values = {}
    for c in names:
        vs = [p.values[c] for p in parts]
        if all(isinstance(v, np.ndarray) for v in vs):
            values[c] = np.concatenate(vs)
        else:
            values[c] = [x for v in vs for x in _as_list(v)]
    nulls = {}
    for c in {c for p in parts for c in p.nulls}:
        nulls[c] = np.concatenate([p.nulls.get(c, np.zeros(len(p), bool))
                                   for p in parts])
    return Columns(values, nulls)


def read_columnar(segment: ImmutableSegment) -> Columns:
    """A segment's rows, dictionary-decoded (JAX ``read_columnar``), an
    upsert segment's valid docs only."""
    n = segment.num_docs
    keep = np.ones(n, dtype=bool)
    valid = getattr(segment, "valid_doc_ids", None)
    if valid is not None:
        keep = np.asarray(valid[:n], dtype=bool)
    values: Dict[str, Any] = {}
    nulls: Dict[str, np.ndarray] = {}
    for name, cm in segment.metadata.columns.items():
        ds = segment.data_source(name)
        if cm.single_value:
            fwd = np.asarray(ds.forward_index[:n])[keep]
            if cm.has_dictionary:
                vals = np.asarray(ds.dictionary.values)[fwd]
            else:
                vals = fwd.astype(cm.data_type.stored_np)
        else:
            dense, counts = ds.dense_mv()
            d = ds.dictionary
            vals = [list(d.get_values(dense[i, :int(counts[i])]))
                    for i in np.nonzero(keep)[0]]
        if cm.has_nulls:
            nulls[name] = np.asarray(ds.null_bitmap[:n], dtype=bool)[keep]
        values[name] = vals
    return Columns(values, nulls)


def _codes(col, null: Optional[np.ndarray]) -> np.ndarray:
    """Dense int64 codes of a column's values (equal values, equal code;
    a null row its own value)."""
    if isinstance(col, np.ndarray):
        _u, inv = np.unique(col, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
    else:
        seen: Dict[Any, int] = {}
        inv = np.fromiter((seen.setdefault(tuple(x) if isinstance(
            x, list) else x, len(seen)) for x in col), dtype=np.int64,
            count=len(col))
    if null is not None and null.any():
        inv = np.where(null, -1, inv)
    return inv


def group_rows(cols: Columns, names: List[str]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (group of each row, first row of each group), the groups of the
    rows' values over ``names`` numbered in the order they first appear."""
    n = len(cols)
    key = np.zeros(n, dtype=np.int64)
    for c in names:
        codes = _codes(cols.values[c], cols.nulls.get(c))
        _u, codes = np.unique(codes, return_inverse=True)
        # mixed radix over the codes so far, renumbered densely so the
        # key never overflows
        width = int(codes.max()) + 1 if n else 1
        _u, key = np.unique(key * width + codes.reshape(-1),
                            return_inverse=True)
        key = key.reshape(-1).astype(np.int64)
    _u, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return rank[inv.reshape(-1)], first[order]


class SegmentProcessorFramework:
    """The map / partition / reduce / build pipeline over segments."""

    def __init__(self, segments: List[ImmutableSegment],
                 config: SegmentProcessorConfig):
        self.segments = segments
        self.config = config

    def process(self, out_dir: str) -> List[str]:
        """-> the directories of the segments built under ``out_dir``."""
        cols = self._map_phase()
        if cols is None or len(cols) == 0:
            return []
        out_dirs: List[str] = []
        seq = 0
        for part_key, pcols in self._partition_phase(cols):
            pcols = self._reduce_phase(pcols)
            for chunk in self._split(pcols):
                name = f"{self.config.segment_name_prefix}_{part_key}_{seq}"
                seq += 1
                SegmentBuilder(self.config.schema, name,
                               indexing=self.config.table_config
                               .indexing_config).build(chunk.frame(), out_dir)
                out_dirs.append(f"{out_dir}/{name}")
        return out_dirs

    # -- map -----------------------------------------------------------------
    def _time_ms(self, cols: Columns) -> np.ndarray:
        cfg = self.config
        return (np.asarray(cols.values[cfg.time_column], dtype=np.int64)
                * cfg.time_unit_ms)

    def _map_phase(self) -> Optional[Columns]:
        cfg = self.config
        parts = []
        for seg in self.segments:
            cols = read_columnar(seg)
            keep = np.ones(len(cols), dtype=bool)
            tc = cfg.time_column
            if tc is not None and tc in cols.values and (
                    cfg.window_start_ms is not None
                    or cfg.window_end_ms is not None):
                t_ms = self._time_ms(cols)
                if cfg.window_start_ms is not None:
                    keep &= t_ms >= cfg.window_start_ms
                if cfg.window_end_ms is not None:
                    keep &= t_ms < cfg.window_end_ms
            if cfg.record_filter is not None:
                keep &= ~np.asarray(cfg.record_filter(cols.values),
                                    dtype=bool)
            parts.append(cols.take(np.nonzero(keep)[0]))
        return _concat(parts) if parts else None

    # -- partition -----------------------------------------------------------
    def _partition_phase(self, cols: Columns):
        """-> (key, columns) per partition, in the JAX package's order
        (its keys sorted as strings)."""
        cfg = self.config
        tc = cfg.time_column
        if cfg.bucket_time_ms is None or tc is None or tc not in cols.values:
            yield "all", cols
            return
        bucket = self._time_ms(cols) // cfg.bucket_time_ms
        keys = {str(int(b)): b for b in np.unique(bucket)}
        for k in sorted(keys):
            yield k, cols.take(np.nonzero(bucket == keys[k])[0])

    # -- reduce --------------------------------------------------------------
    def _reduce_phase(self, cols: Columns) -> Columns:
        mt = self.config.merge_type
        if mt is MergeType.CONCAT:
            return cols
        if mt is MergeType.DEDUP:
            _g, first = group_rows(cols, list(cols.values))
            return cols.take(first)
        return self._rollup(cols)

    def _rollup(self, cols: Columns) -> Columns:
        """Group by every non-metric column of the schema, aggregate the
        metrics (JAX ``_rollup``: the group's first row's dimensions)."""
        schema = self.config.schema
        dims = [fs.name for fs in schema.field_specs
                if fs.field_type is not FieldType.METRIC
                and fs.name in cols.values]
        metrics = [fs.name for fs in schema.field_specs
                   if fs.field_type is FieldType.METRIC
                   and fs.name in cols.values]
        gid, first = group_rows(cols, dims)
        out = cols.take(first)
        order = np.argsort(gid, kind="stable")
        starts = np.r_[0, np.nonzero(np.diff(gid[order]))[0] + 1]
        ends = np.r_[starts[1:], len(gid)]
        for m in metrics:
            agg = self.config.aggregation_types.get(m, "SUM").upper()
            dt = schema.field_spec(m).data_type
            vals = np.asarray(cols.values[m])[order]
            if dt.is_integral:
                vals = vals.astype(np.int64)
                ufunc = (np.add if agg == "SUM" else
                         np.minimum if agg == "MIN" else np.maximum)
                res = ufunc.reduceat(vals, starts)
            elif agg == "SUM":
                vals = vals.astype(np.float64)
                # numpy's pairwise sum of each group in row order, as JAX
                # adds them (reduceat adds in another order)
                res = np.add.reduceat(vals, starts)
                for i in np.nonzero(ends - starts > 2)[0]:
                    res[i] = vals[starts[i]:ends[i]].sum()
            else:
                ufunc = np.minimum if agg == "MIN" else np.maximum
                res = ufunc.reduceat(vals.astype(np.float64), starts)
            out.values[m] = res
            out.nulls.pop(m, None)
        return out

    def _split(self, cols: Columns):
        n = len(cols)
        step = self.config.max_docs_per_segment
        for s in range(0, n, step):
            yield cols.take(np.arange(s, min(s + step, n)))
