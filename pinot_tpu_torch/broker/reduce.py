"""Broker reduce: merge the servers' DataTables into the final ResultTable.

Counterpart of ``pinot_tpu/broker/reduce.py`` (``ReduceAccumulator``
:124, ``BrokerReduceService`` :638, ``MixedResponseTypeError``), with its
three rungs:

- **vectorized** (the default): each server's table folds as it arrives
  (``ReduceAccumulator.add``), its typed wire columns kept as numpy
  arrays. A group-by merges by one stable ``np.lexsort`` and a boundary
  ``reduceat`` (``engine/results.py`` ``lexsort_runs`` /
  ``fold_grouped_runs``); a selection merges the servers' pre-trimmed
  ORDER BY blocks with one lexsort and boxes only the output rows; a
  DISTINCT dedups by run detection over the concatenated columns.
- **row path** (``vectorized=False`` or ``OPTION(vectorizedReduce=
  false)``): the per-row reducers, the bit-parity oracle. A shape the
  vectorized path cannot prove exact (object keys, column kinds that
  differ across servers, NaN order keys, i64 sums near overflow) falls to
  it, recorded as ``reduce:vectorized->row_path:<reason>``
  (``REDUCE_DECISION_REASONS``).
- **device** (``device_reduce=True`` or ``OPTION(deviceReduce=true)``; off
  by default): where the tables never crossed a wire, the concatenated
  (keys, states) block of a group-by merges on the card
  (``parallel/reduce_device.py``) and only the host finalisation runs on
  the CPU. A shape the device fold cannot prove exact falls one rung to
  the vectorized path, recorded as ``reduce:device->host:<reason>``
  (``REDUCE_DEVICE_REASONS``).

The service takes ``device=`` (default ``"cuda"``); its merge runs there
or raises. Two declines of the JAX reduce are not copied, since each would
hide a device or a failed merge: the one for a missing merge mesh (there
is no mesh on one card, and a missing card raises when the service is
built) and the catch-all around the merge (JAX :436-439; a failed merge
raises here).
"""

from __future__ import annotations

import time

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.common.bounds import I64_FOLD_BOUND
from pinot_tpu_torch.common.datatable import Column, DataTable, ResponseType
from pinot_tpu_torch.common.tracing import record_decision
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.aggregates import AggDef, resolve_agg
from pinot_tpu_torch.engine.errors import QueryError
from pinot_tpu_torch.engine.executor import DEFAULT_NUM_GROUPS_LIMIT
from pinot_tpu_torch.engine.host_engine import _lexsort
from pinot_tpu_torch.engine.results import (
    _VEC_STATE_FOLDS,
    AggResult,
    DataSchema,
    GroupByResult,
    QueryStats,
    ResultTable,
    _eval_scalar_filter,
    _result_schema,
    _Reversible,
    fold_grouped_runs,
    lexsort_runs,
    reduce_aggregation,
    reduce_group_by,
)
from pinot_tpu_torch.parallel import reduce_device as rdev
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.spi.config import CommonConstants

# the codes of reduce:vectorized->row_path:<reason> (JAX
# pinot_tpu/common/tracing.py:442 REDUCE_DECISION_REASONS)
REDUCE_DECISION_REASONS = frozenset({
    "reduce_group_key_not_sortable",
    "reduce_distinct_key_not_sortable",
    "reduce_order_key_not_sortable",
    "reduce_column_kind_mismatch",
    "reduce_nan_numeric_state",
    "reduce_nan_order_key",
    "reduce_i64_sum_bound",
})

# the codes of reduce:device->host:<reason> (JAX :458
# REDUCE_DEVICE_REASONS, less the two declines not copied)
REDUCE_DEVICE_REASONS = frozenset({
    "reduce_device_obj_state",
    "reduce_device_cross_process",
    "reduce_device_rows_over_capacity",
    "reduce_device_nan_key",
    "reduce_device_key_space_overflow",
    "reduce_device_f64_sum_order",
    "reduce_device_i64_sum_bound",
})

# vectorized state bases -> the device merge's fold (count states fold by
# addition)
DEVICE_OPS = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


class MixedResponseTypeError(QueryError):
    """Servers answered one scatter with different response types: a
    merge across them would be silently wrong-shaped, so it raises."""


def _selection_key_spec(ctx: QueryContext, schema: DataSchema,
                        num_hidden: int) -> Tuple[List[int], List[bool]]:
    """Resolve ORDER BY expressions to column indices over a selection
    schema (visible by name/alias, order-by-only keys in the hidden
    tail). ONE resolver for the row-path oracle and the vectorized
    merge — the two paths cannot drift on key lookup."""
    names = schema.column_names
    visible_n = len(names) - num_hidden
    # aliased select expressions: ORDER BY references the expression,
    # the schema shows the alias — map through select_expressions
    alias_of: Dict[str, int] = {}
    if visible_n == len(ctx.select_expressions):
        for i, e in enumerate(ctx.select_expressions):
            alias_of.setdefault(str(e), i)
    key_idx: List[int] = []
    for ob in ctx.order_by:
        key = str(ob.expr)
        if key in names:
            key_idx.append(names.index(key))
        elif key in alias_of:
            key_idx.append(alias_of[key])
        else:
            hidden_names = names[visible_n:]
            if key not in hidden_names:
                raise QueryError(
                    f"ORDER BY {key} not found in selection schema")
            key_idx.append(visible_n + hidden_names.index(key))
    return key_idx, [ob.ascending for ob in ctx.order_by]


def _sortable_arrays(cols: List[np.ndarray]) -> List[np.ndarray]:
    """Rank-encode string arrays so ``lexsort_runs`` compares integers;
    numeric arrays pass through (NaN semantics preserved)."""
    out = []
    for a in cols:
        if a.dtype.kind in ("U", "S", "O"):
            _, codes = np.unique(a, return_inverse=True)
            a = codes
        out.append(a)
    return out


class ReduceAccumulator:
    """Streaming reduce state: ``add()`` one DataTable per arrival (the
    gather loop calls it the moment a server answers), ``finish()`` runs
    the final merge/trim/HAVING/post-agg pass. Fold timings land in
    ``fold_spans`` — the Reduce span's per-table split."""

    def __init__(self, service: "BrokerReduceService", ctx: QueryContext):
        self._svc = service
        self.ctx = ctx
        self.stats = QueryStats()
        self.exceptions: List[str] = []
        self.tables: List[DataTable] = []
        self.fold_spans: List[Dict[str, Any]] = []
        self.rtype: Optional[ResponseType] = None
        self._mixed: Optional[MixedResponseTypeError] = None
        self.vectorized = service.vectorized and ctx.options.get(
            "vectorizedReduce", "true").lower() != "false"
        dev_opt = ctx.options.get("deviceReduce")
        self.device_route = self.vectorized and (
            dev_opt.lower() == "true" if dev_opt is not None
            else service.device_reduce)
        self._served_device = False
        # the device merge's rung ("dense" | "sort") where it served
        self.merge_rung: Optional[str] = None
        self._wire_decoded = False
        self._fallback: Optional[str] = None
        self._aggs: List[AggDef] = [resolve_agg(f)
                                    for f in ctx.aggregations]
        # aggregation
        self._agg_merged: Optional[AggResult] = None
        # group-by
        self._gb_types: Dict[str, str] = {}
        self._gb_key_kinds: Optional[List[int]] = None
        self._gb_state_vec: Optional[List[bool]] = None
        self._gb_state_kinds: Optional[List[int]] = None
        self._gb_keys: List[List[np.ndarray]] = []
        self._gb_states: List[List[Any]] = []
        self._gb_i64_bound = 0
        # selection / distinct
        self._schema: Optional[DataSchema] = None
        self._num_hidden = 0
        self._col_kinds: Optional[List[int]] = None
        self._row_cols: List[List[Column]] = []
        self._row_counts: List[int] = []
        self._all_sorted = True

    # -- arrival fold --------------------------------------------------------
    def add(self, table: DataTable, instance: Optional[str] = None) -> None:
        t0 = time.perf_counter()
        self.stats.merge(table.stats)
        self.exceptions.extend(table.exceptions)
        if table.exceptions:
            return
        if self.rtype is None:
            self.rtype = table.response_type
        elif table.response_type is not self.rtype:
            if self._mixed is None:
                self._mixed = MixedResponseTypeError(
                    f"servers disagree on response type: "
                    f"{self.rtype.value} vs {table.response_type.value} — "
                    f"refusing a wrong-shaped merge")
            return
        self.tables.append(table)
        if table.wire_decoded:
            # crossed a process boundary: the device route's premise
            # (states already resident, no D2H paid) does not hold
            self._wire_decoded = True
        if self.vectorized and self._fallback is None:
            self._fold(table)
        span = {"name": "Fold", "rows": table.num_rows(),
                "ms": round((time.perf_counter() - t0) * 1e3, 3)}
        if instance is not None:
            span["instance"] = instance
        self.fold_spans.append(span)

    def _decline(self, reason: str) -> None:
        self._fallback = reason
        record_decision(self.stats, "reduce", "row_path", "vectorized",
                        reason)

    def _decline_device(self, reason: str) -> None:
        """Device merge cannot serve this shape: fall back ONE rung (to
        the vectorized host path, not the oracle) and say why."""
        self.device_route = False
        record_decision(self.stats, "reduce", "host", "device", reason)

    def _fold(self, table: DataTable) -> None:
        rtype = table.response_type
        if rtype is ResponseType.AGGREGATION:
            part = AggResult(table.agg_states())
            if self._agg_merged is None:
                self._agg_merged = part
            else:
                self._agg_merged.merge(part, self._aggs)
            return
        if rtype is ResponseType.GROUP_BY:
            self._fold_group_by(table)
            return
        self._fold_rows(table)

    def _fold_group_by(self, table: DataTable) -> None:
        self._gb_types.update(table.schema_types())
        if table.num_rows() == 0:
            return  # nothing to merge (empty wire columns carry no
            #         kind): not a decline
        key_cols, agg_cols = table.group_columns()
        kinds = [c.kind for c in key_cols]
        if any(not (c.is_numeric or c.is_string) for c in key_cols):
            return self._decline("reduce_group_key_not_sortable")
        if self._gb_key_kinds is None:
            self._gb_key_kinds = kinds
            self._gb_state_vec = [
                a.base in _VEC_STATE_FOLDS and c.is_numeric
                for a, c in zip(self._aggs, agg_cols)]
            self._gb_state_kinds = [c.kind for c in agg_cols]
        elif kinds != self._gb_key_kinds:
            return self._decline("reduce_column_kind_mismatch")
        states: List[Any] = []
        for vec, agg, col, want in zip(self._gb_state_vec, self._aggs,
                                       agg_cols, self._gb_state_kinds):
            if vec:
                if col.kind != want:
                    # i64 on one server, f64 on another: the oracle's
                    # exact-int-then-float arithmetic is the contract
                    return self._decline("reduce_column_kind_mismatch")
                arr = col.array()
                if arr.dtype.kind == "i" and agg.base in ("count", "sum"):
                    self._gb_i64_bound += max(
                        abs(int(arr.max())), abs(int(arr.min())))
                elif arr.dtype.kind == "f" \
                        and agg.base in ("min", "max") \
                        and bool(np.isnan(arr).any()):
                    # np.minimum propagates NaN; python min() does not —
                    # only the oracle's semantics are the contract
                    return self._decline("reduce_nan_numeric_state")
                states.append(("vec", arr))
            else:
                states.append(("obj", col.tolist()))
        self._gb_keys.append([c.array() for c in key_cols])
        self._gb_states.append(states)

    def _fold_rows(self, table: DataTable) -> None:
        """SELECTION / DISTINCT arrival: keep the typed columns, box
        nothing. Kind consistency across servers is the exactness guard
        (the oracle would coerce, e.g. int and float keys comparing
        equal — a mix falls back to it)."""
        if self._schema is None:
            self._schema = table.data_schema()
        self._num_hidden = max(self._num_hidden, table.num_hidden)
        self._all_sorted = self._all_sorted and table.selection_sorted
        if table.num_rows() == 0:
            return  # empty arrival: not a decline
        cols = table.columns()
        kinds = [c.kind for c in cols]
        if self._col_kinds is None:
            self._col_kinds = kinds
        elif kinds != self._col_kinds:
            return self._decline("reduce_column_kind_mismatch")
        if self.rtype is ResponseType.DISTINCT \
                and any(not (c.is_numeric or c.is_string) for c in cols):
            return self._decline("reduce_distinct_key_not_sortable")
        self._row_cols.append(cols)
        self._row_counts.append(table.num_rows())

    # -- final pass ----------------------------------------------------------
    def finish(self) -> Tuple[ResultTable, QueryStats, List[str]]:
        if not self.tables:
            raise QueryError("; ".join(self.exceptions)
                             or "no server responses")
        if self._mixed is not None:
            raise self._mixed
        svc, ctx = self._svc, self.ctx
        if not self.vectorized or self._fallback is not None:
            table = svc._reduce_rows(ctx, self.rtype, self.tables,
                                     self.stats)
            self.stats.reduce_path = "oracle"
            return table, self.stats, self.exceptions
        if self.rtype is ResponseType.AGGREGATION:
            table = reduce_aggregation(ctx, self._aggs, self._agg_merged)
        elif self.rtype is ResponseType.GROUP_BY:
            table = self._finish_group_by()
        elif self.rtype is ResponseType.SELECTION:
            table = self._finish_selection()
        else:
            table = self._finish_distinct()
        if self._fallback is not None:
            # a finish-time guard tripped (NaN order key, i64 bound):
            # rerun the retained tables through the oracle
            table = svc._reduce_rows(ctx, self.rtype, self.tables,
                                     self.stats)
            self.stats.reduce_path = "oracle"
        else:
            self.stats.reduce_path = ("device" if self._served_device
                                      else "vectorized")
        return table, self.stats, self.exceptions

    def _finish_group_by(self) -> Optional[ResultTable]:
        ctx, aggs = self.ctx, self._aggs
        if self._gb_i64_bound >= I64_FOLD_BOUND:
            if self.device_route:
                self._decline_device("reduce_device_i64_sum_bound")
            self._decline("reduce_i64_sum_bound")
            return None
        if not self._gb_keys:
            merged = GroupByResult()
            if merged.trim(self._svc.num_groups_limit):
                self.stats.num_groups_limit_reached = True
            return reduce_group_by(ctx, aggs, merged, self._gb_types)
        key_concat, entries, n = self.group_block()
        arity = len(key_concat)
        merged = self._device_group_by(key_concat, entries, n) \
            if self.device_route else None
        if merged is not None:
            # device contract == host contract: per group (any fixed
            # enumeration), earliest input index + exactly-folded state;
            # the stable argsort below restores insertion order either way
            first_idx, folded = merged
            self._served_device = True
        else:
            first_idx, folded = host_group_merge(key_concat, entries, n,
                                                 aggs)
        # restore the oracle's dict-insertion order: groups appear in
        # first-occurrence order of the concatenated input (stable
        # lexsort -> each run's first sorted element IS its earliest)
        perm = np.argsort(first_idx, kind="stable")
        if len(perm) > self._svc.num_groups_limit:
            # the oracle trims the merged dict to its first
            # num_groups_limit INSERTION-ordered entries — same cut
            perm = perm[: self._svc.num_groups_limit]
            self.stats.num_groups_limit_reached = True

        table = self._finalize_group_by_vectorized(
            key_concat, first_idx, perm, folded)
        if table is not None:
            return table

        # shape outside the vectorized finalization (HAVING, post-agg
        # arithmetic, unsortable finals): build the merged GroupByResult
        # and run the UNCHANGED trim/HAVING/post-agg pass — the merge
        # itself stayed array-native
        boxed_keys = [_box_indexed(key_concat[k], first_idx)
                      for k in range(arity)]
        groups: Dict[Tuple, List[Any]] = {}
        for j in perm:
            j = int(j)
            key = tuple(bk[j] for bk in boxed_keys)
            groups[key] = [_box_state(folded[a][j],
                                      self._gb_state_vec[a])
                           for a in range(len(aggs))]
        return reduce_group_by(ctx, aggs, GroupByResult(groups),
                               self._gb_types)

    def group_block(self) -> Tuple[List[np.ndarray], List[Tuple[str, Any]],
                                   int]:
        """The concatenated group-by block the merge folds: (the key
        columns, one ``("vec", array)`` or ``("obj", list)`` entry an
        aggregation, its rows), servers in arrival order."""
        arity = len(self._gb_keys[0])
        key_concat = [
            np.concatenate([t[k] for t in self._gb_keys])
            for k in range(arity)]
        n = int(key_concat[0].shape[0])
        entries = []
        for a in range(len(self._aggs)):
            parts = [t[a] for t in self._gb_states]
            if self._gb_state_vec[a]:
                entries.append(
                    ("vec", np.concatenate([p[1] for p in parts])))
            else:
                flat: List[Any] = []
                for p in parts:
                    flat.extend(p[1])
                entries.append(("obj", flat))
        return key_concat, entries, n

    def _device_group_by(self, key_concat, entries, n
                         ) -> Optional[Tuple[np.ndarray, List[np.ndarray]]]:
        """The merge on the service's device -> ``(first_idx, folded)``,
        or None after a ``reduce:device->host:<reason>`` record. Every
        guard here is an exactness obligation: only folds whose result is
        order-independent bit for bit leave the host. A failed merge
        raises."""
        if self._wire_decoded:
            # decoded wire tables already paid the copy and the
            # serialization: the host lexsort is their natural frame
            self._decline_device("reduce_device_cross_process")
            return None
        if any(kind != "vec" for kind, _ in entries):
            self._decline_device("reduce_device_obj_state")
            return None
        if n > rdev.MAX_MERGE_ROWS:
            self._decline_device("reduce_device_rows_over_capacity")
            return None
        for a in key_concat:
            if a.dtype.kind == "f" and bool(np.isnan(a).any()):
                # NaN != NaN breaks the composite key's group identity
                self._decline_device("reduce_device_nan_key")
                return None
        comp, space = rdev.encode_composite_keys(key_concat)
        if comp is None:
            self._decline_device("reduce_device_key_space_overflow")
            return None
        ops: List[str] = []
        vals: List[np.ndarray] = []
        for agg, (_, arr) in zip(self._aggs, entries):
            if agg.base == "sum" and arr.dtype.kind == "f" \
                    and not rdev.f64_sum_exact(arr):
                # f64 addition depends on order, and the device's is not
                # the reduceat's: only provably exact sums go
                self._decline_device("reduce_device_f64_sum_order")
                return None
            ops.append(DEVICE_OPS[agg.base])
            vals.append(arr)
        self.merge_rung = rdev.merge_rung(space)
        return rdev.device_group_merge(comp, space, vals, ops,
                                       self._svc.device)

    def _finalize_group_by_vectorized(self, key_concat, first_idx, perm,
                                      folded) -> Optional[ResultTable]:
        """Array-native HAVING-free finalization: when every SELECT
        expression is a group key or an aggregation (no post-agg
        arithmetic) the final columns build straight from the folded
        arrays, ORDER BY runs as one more stable lexsort, and only the
        offset..offset+limit OUTPUT rows ever box. Returns None when the
        shape needs the row-path ``reduce_group_by`` (semantics there are
        the contract — this is purely the fast lane)."""
        ctx, aggs = self.ctx, self._aggs
        if ctx.having is not None:
            return None
        key_of = {str(g): k for k, g in enumerate(ctx.group_by)}
        agg_of = {str(fn): a for a, fn in enumerate(ctx.aggregations)}

        final_cache: Dict[str, Any] = {}

        def final_column(name: str):
            """Final values for a key/agg column over ``perm`` order —
            an ndarray for vectorized finals, a boxed list otherwise."""
            if name in final_cache:
                return final_cache[name]
            if name in key_of:
                out = key_concat[key_of[name]][first_idx[perm]]
            else:
                a = agg_of[name]
                agg = aggs[a]
                if self._gb_state_vec[a]:
                    arr = folded[a][perm]
                    # mirror _FINAL: count -> int, sum/min/max -> float
                    out = (arr.astype(np.int64) if agg.base == "count"
                           else arr.astype(np.float64))
                else:
                    states = folded[a]
                    out = [agg.finalize(states[int(j)]) for j in perm]
            final_cache[name] = out
            return out

        for e in ctx.select_expressions:
            if str(e) not in key_of and str(e) not in agg_of:
                return None  # post-aggregation arithmetic -> row path
        for ob in ctx.order_by:
            if str(ob.expr) not in key_of and str(ob.expr) not in agg_of:
                return None

        ngroups = len(perm)
        if ctx.order_by and ngroups:
            sort_cols = []
            for ob in ctx.order_by:
                col = final_column(str(ob.expr))
                arr = np.asarray(col) if not isinstance(col, np.ndarray) \
                    else col
                if arr.dtype == object:
                    return None  # non-uniform finals: oracle comparisons
                if arr.dtype.kind == "f" and bool(np.isnan(arr).any()):
                    return None
                sort_cols.append(arr)
            window = _lexsort(sort_cols,
                              [ob.ascending for ob in ctx.order_by])
            window = window[ctx.offset: ctx.offset + ctx.limit]
        else:
            lo = min(ctx.offset, ngroups)
            hi = min(ctx.offset + ctx.limit, ngroups)
            window = np.arange(lo, hi, dtype=np.int64)

        out_cols = []
        for e in ctx.select_expressions:
            col = final_column(str(e))
            if isinstance(col, np.ndarray):
                taken = col[window]
                if taken.dtype.kind in ("U", "S", "O"):
                    out_cols.append([str(v) for v in taken])
                else:
                    out_cols.append(taken.tolist())
            else:
                out_cols.append([col[int(j)] for j in window])
        rows = [[c[i] for c in out_cols] for i in range(len(window))]
        names, types = _result_schema(ctx, aggs, self._gb_types)
        return ResultTable(DataSchema(names, types), rows)

    def _selected_rows(self, sel: np.ndarray, visible: int
                       ) -> List[List[Any]]:
        """Box ONLY the chosen global row indices (output order = sel
        order), gathering per table through ``Column.take_boxed``."""
        bounds = np.concatenate(
            (np.zeros(1, np.int64),
             np.cumsum(self._row_counts))).astype(np.int64)
        rows: List[Optional[List[Any]]] = [None] * len(sel)
        tno = np.searchsorted(bounds, sel, side="right") - 1
        for ti, cols in enumerate(self._row_cols):
            pos = np.flatnonzero(tno == ti)
            if pos.size == 0:
                continue
            local = sel[pos] - bounds[ti]
            cells = [c.take_boxed(local) for c in cols[:visible]]
            for j, p in enumerate(pos):
                rows[int(p)] = [c[j] for c in cells]
        return rows  # type: ignore[return-value]

    def _finish_selection(self) -> Optional[ResultTable]:
        ctx = self.ctx
        schema = self._schema
        if schema is None:  # every ok table was empty AND schema-less
            schema = self.tables[0].data_schema()
        num_hidden = self._num_hidden
        total = int(sum(self._row_counts))
        visible = len(schema.column_names) - num_hidden
        out_schema = schema if not num_hidden else DataSchema(
            schema.column_names[:visible], schema.column_types[:visible])

        if not ctx.order_by or total == 0:
            lo = min(ctx.offset, total)
            hi = min(ctx.offset + ctx.limit, total)
            sel = np.arange(lo, hi, dtype=np.int64)
            return ResultTable(out_schema,
                               self._selected_rows(sel, visible))

        # resolve ORDER BY -> column indices (shared with the oracle)
        key_idx, directions = _selection_key_spec(ctx, schema, num_hidden)
        if any(not (self._row_cols[0][i].is_numeric
                    or self._row_cols[0][i].is_string)
               for i in key_idx):
            self._decline("reduce_order_key_not_sortable")
            return None
        if len(self._row_cols) == 1 and self._all_sorted:
            # a single pre-sorted block (the one-server case): the trim
            # window is the answer
            lo = min(ctx.offset, total)
            hi = min(ctx.offset + ctx.limit, total)
            sel = np.arange(lo, hi, dtype=np.int64)
            return ResultTable(out_schema,
                               self._selected_rows(sel, visible))
        key_cols = [
            np.concatenate([cols[i].array() for cols in self._row_cols])
            for i in key_idx]
        for a in key_cols:
            if a.dtype.kind == "f" and bool(np.isnan(a).any()):
                # python-sort NaN comparisons are order-dependent; only
                # the oracle's (ill-defined but historical) order counts
                self._decline("reduce_nan_order_key")
                return None
        order = _lexsort(key_cols, directions)
        sel = order[ctx.offset: ctx.offset + ctx.limit].astype(np.int64)
        return ResultTable(out_schema, self._selected_rows(sel, visible))

    def _finish_distinct(self) -> Optional[ResultTable]:
        ctx = self.ctx
        schema = self._schema
        if schema is None:
            schema = self.tables[0].data_schema()
        names = schema.column_names
        rows: List[List[Any]] = []
        if self._row_cols:
            cols_concat = [
                np.concatenate([cols[i].array()
                                for cols in self._row_cols])
                for i in range(len(names))]
            order, starts = lexsort_runs(_sortable_arrays(cols_concat))
            first_idx = order[starts]
            first_idx.sort()  # first-occurrence (insertion) order
            rows = self._selected_rows(first_idx.astype(np.int64),
                                       len(names))
        if ctx.having is not None:
            rows = [r for r in rows
                    if _eval_scalar_filter(ctx.having,
                                           dict(zip(names, r)))]
        if ctx.order_by:
            idx_of = {n: i for i, n in enumerate(names)}

            def sort_key(row):
                parts = []
                for ob in ctx.order_by:
                    i = idx_of.get(str(ob.expr))
                    if i is None:
                        raise QueryError(
                            f"ORDER BY {ob.expr} not in DISTINCT list")
                    parts.append(_Reversible(row[i], ob.ascending))
                return tuple(parts)

            rows.sort(key=sort_key)
        return ResultTable(schema,
                           rows[ctx.offset: ctx.offset + ctx.limit])


def host_group_merge(key_concat: List[np.ndarray],
                     entries: List[Tuple[str, Any]], n: int,
                     aggs: List[AggDef]) -> Tuple[np.ndarray, List[Any]]:
    """The vectorized host merge of a group-by block -> ``(first_idx,
    folded)``, the contract of ``reduce_device.device_group_merge``: one
    stable lexsort, a fold a run, each run's earliest row."""
    order, starts = lexsort_runs(_sortable_arrays(key_concat))
    folded = fold_grouped_runs(order, starts, n, entries, aggs)
    return order[starts], folded


def _box_indexed(arr: np.ndarray, idx: np.ndarray) -> list:
    """Box the selected key cells (one per OUTPUT group, never per row)."""
    taken = arr[idx]
    if taken.dtype.kind in ("U", "S", "O"):
        return [str(v) for v in taken]
    return taken.tolist()


def _box_state(v: Any, vec: bool) -> Any:
    return v.item() if vec else v


class BrokerReduceService:
    """The broker's reduce (JAX :638). ``device`` is where the device
    route merges (default ``"cuda"``; raises without a card)."""

    def __init__(self, num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT,
                 vectorized: bool = True,
                 device_reduce: bool =
                 CommonConstants.DEFAULT_BROKER_DEVICE_REDUCE,
                 device: Union[str, torch.device] = "cuda"):
        self.num_groups_limit = num_groups_limit
        self.vectorized = vectorized
        self.device_reduce = device_reduce
        self.device = resolve_device(device)

    def accumulator(self, ctx: QueryContext) -> ReduceAccumulator:
        """Streaming entry: the gather loop folds tables as they arrive
        (reduce-as-arrivals), then calls ``finish()``."""
        return ReduceAccumulator(self, ctx)

    def reduce(self, ctx: QueryContext, tables: List[DataTable]
               ) -> Tuple[ResultTable, QueryStats, List[str]]:
        """-> (result, merged stats, per-server error messages). A partial
        failure still reduces the successful servers' tables, and the
        errors reach the response, so the caller can tell a partial result
        from a complete one."""
        acc = self.accumulator(ctx)
        for t in tables:
            acc.add(t)
        return acc.finish()

    # -- row-path reducers (the bit-parity oracle) ---------------------------
    def _reduce_rows(self, ctx: QueryContext, rtype: ResponseType,
                     ok: List[DataTable], stats: QueryStats) -> ResultTable:
        if rtype is ResponseType.AGGREGATION:
            return self._reduce_aggregation(ctx, ok)
        if rtype is ResponseType.GROUP_BY:
            return self._reduce_group_by(ctx, ok, stats)
        if rtype is ResponseType.SELECTION:
            return self._reduce_selection(ctx, ok)
        return self._reduce_distinct(ctx, ok)

    def _reduce_aggregation(self, ctx: QueryContext,
                            tables: List[DataTable]) -> ResultTable:
        aggs = [resolve_agg(f) for f in ctx.aggregations]
        merged: AggResult = None
        for t in tables:
            part = AggResult(t.agg_states())
            if merged is None:
                merged = part
            else:
                merged.merge(part, aggs)
        return reduce_aggregation(ctx, aggs, merged)

    def _reduce_group_by(self, ctx: QueryContext, tables: List[DataTable],
                         stats: QueryStats) -> ResultTable:
        aggs = [resolve_agg(f) for f in ctx.aggregations]
        merged = GroupByResult()
        schema_types: Dict[str, str] = {}
        for t in tables:
            schema_types.update(t.schema_types())
            merged.merge(GroupByResult(t.group_by_groups()), aggs)
        if merged.trim(self.num_groups_limit):
            stats.num_groups_limit_reached = True
        return reduce_group_by(ctx, aggs, merged, schema_types)

    def _reduce_selection(self, ctx: QueryContext,
                          tables: List[DataTable]) -> ResultTable:
        schema = tables[0].data_schema()
        num_hidden = max(t.num_hidden for t in tables)
        rows: List[List[Any]] = []
        for t in tables:
            rows.extend(t.rows())

        if ctx.order_by and rows:
            # hidden trailing columns hold the order-by expression values;
            # visible order-by columns are found by name
            key_idx, directions = _selection_key_spec(ctx, schema,
                                                      num_hidden)

            def sort_key(row):
                return tuple(_Reversible(row[i], asc)
                             for i, asc in zip(key_idx, directions))

            rows.sort(key=sort_key)

        rows = rows[ctx.offset: ctx.offset + ctx.limit]
        if num_hidden:
            visible = len(schema.column_names) - num_hidden
            schema = DataSchema(schema.column_names[:visible],
                                schema.column_types[:visible])
            rows = [r[:visible] for r in rows]
        return ResultTable(schema, rows)

    def _reduce_distinct(self, ctx: QueryContext,
                         tables: List[DataTable]) -> ResultTable:
        schema = tables[0].data_schema()
        seen: Dict[Tuple, List[Any]] = {}
        for t in tables:
            for r in t.rows():
                key = tuple(tuple(v) if isinstance(v, list) else v for v in r)
                if key not in seen:
                    seen[key] = r
        rows = list(seen.values())
        names = schema.column_names
        if ctx.having is not None:
            rows = [r for r in rows
                    if _eval_scalar_filter(ctx.having, dict(zip(names, r)))]
        if ctx.order_by:
            idx_of = {n: i for i, n in enumerate(names)}

            def sort_key(row):
                parts = []
                for ob in ctx.order_by:
                    i = idx_of.get(str(ob.expr))
                    if i is None:
                        raise QueryError(
                            f"ORDER BY {ob.expr} not in DISTINCT list")
                    parts.append(_Reversible(row[i], ob.ascending))
                return tuple(parts)

            rows.sort(key=sort_key)
        return ResultTable(schema, rows[ctx.offset: ctx.offset + ctx.limit])


__all__ = ["BrokerReduceService", "DEVICE_OPS", "MixedResponseTypeError",
           "REDUCE_DECISION_REASONS", "REDUCE_DEVICE_REASONS",
           "ReduceAccumulator", "host_group_merge"]
