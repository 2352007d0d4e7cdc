"""Host (numpy) evaluation of filters and expressions over a segment.

Counterpart of ``pinot_tpu/engine/host_eval.py``: the filter mask, value
expressions and selected values of the host engine
(``engine/host_engine.py``), which serves what the device rungs do not.
Predicates follow the JAX package's semantics: on a multi-value column a
predicate matches a doc if ANY value matches (NOT_EQ / NOT_IN need every
value to pass), and an upsert segment's valid-doc snapshot is ANDed into
every mask.

A column's indexes serve where it has them, as in the JAX package: an
inverted column's postings for a selective single-value predicate, a
raw column's range permutation for RANGE, the FST index for REGEXP_LIKE,
the text index for TEXT_MATCH and the JSON index for JSON_MATCH. Without
one, a dictionary predicate is a dictId compare and TEXT_MATCH /
JSON_MATCH / REGEXP_LIKE evaluate per distinct value; both give the same
mask. The geo index is not ported (no port segment carries one). A
consuming segment (``segment/mutable.py``) reads the same way through
its ``MutableDataSource``; its dictionary is arrival-ordered, so a RANGE
scans its values.
A multi-value column is the port's dense ``[capacity, max values]``
dictIds with ``mv_counts`` (the JAX package keeps offsets over a flat
forward index): a row's entries past its count are not values.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Any, List, Optional

import numpy as np

from pinot_tpu_torch.engine.aggregates import MVValues
from pinot_tpu_torch.engine.errors import QueryError, UnsupportedQueryError
from pinot_tpu_torch.query.expressions import (
    Expr,
    FilterNode,
    FilterOp,
    Function,
    Identifier,
    Literal,
    Predicate,
    PredicateType,
)
from pinot_tpu_torch.segment.immutable import DataSource, ImmutableSegment
from pinot_tpu_torch.segment.mutable import is_arrival_ordered
from pinot_tpu_torch.spi.data import DataType

# columns every segment serves, with their result types
VIRTUAL_COLUMNS = {"$docId": "LONG", "$segmentName": "STRING",
                   "$hostName": "STRING"}


# -- filter evaluation -> boolean doc mask ------------------------------------

def eval_filter(segment: ImmutableSegment,
                node: Optional[FilterNode]) -> np.ndarray:
    n = segment.num_docs
    mask = np.ones(n, dtype=bool) if node is None else _eval_node(segment,
                                                                   node)
    valid = segment.valid_doc_ids
    if valid is not None:
        # upsert: only the live doc per primary key is visible
        mask = mask & np.asarray(valid[:n])
    return mask


def _eval_node(segment: ImmutableSegment, node: FilterNode) -> np.ndarray:
    if node.op in (FilterOp.AND, FilterOp.OR):
        out = _eval_node(segment, node.children[0])
        for c in node.children[1:]:
            x = _eval_node(segment, c)
            out = (out & x) if node.op is FilterOp.AND else (out | x)
        return out
    if node.op is FilterOp.NOT:
        return ~_eval_node(segment, node.children[0])
    return eval_predicate(segment, node.predicate)


def _matching_dict_ids(ds: DataSource, pred: Predicate) -> np.ndarray:
    """Predicate -> sorted array of the dictIds it matches."""
    d = ds.dictionary
    card = d.cardinality
    t = pred.type
    dt = ds.metadata.data_type

    def conv(v):
        try:
            return dt.convert(v)
        except (ValueError, TypeError) as e:
            raise QueryError(f"cannot convert {v!r} for column "
                             f"{ds.name!r} ({dt.label}): {e}")

    if t is PredicateType.EQ:
        i = d.index_of(conv(pred.value))
        return np.array([i] if i >= 0 else [], dtype=np.int64)
    if t is PredicateType.NOT_EQ:
        i = d.index_of(conv(pred.value))
        ids = np.arange(card, dtype=np.int64)
        return ids[ids != i] if i >= 0 else ids
    if t is PredicateType.IN:
        ids = sorted({d.index_of(conv(v)) for v in pred.values} - {-1})
        return np.array(ids, dtype=np.int64)
    if t is PredicateType.NOT_IN:
        hit = {d.index_of(conv(v)) for v in pred.values} - {-1}
        return np.array([i for i in range(card) if i not in hit],
                        dtype=np.int64)
    if t is PredicateType.RANGE:
        lo = conv(pred.lower) if pred.lower is not None else None
        hi = conv(pred.upper) if pred.upper is not None else None
        if is_arrival_ordered(d):
            # an arrival-ordered (consuming) dictionary: a scan of its
            # values, not a dictId interval (JAX :102-104)
            return d.matching_range_ids(lo, hi, pred.lower_inclusive,
                                        pred.upper_inclusive)
        a, b = d.range_to_dict_id_interval(lo, hi, pred.lower_inclusive,
                                           pred.upper_inclusive)
        return np.arange(max(a, 0), min(b, card - 1) + 1, dtype=np.int64)
    if t is PredicateType.REGEXP_LIKE:
        try:
            rx = re.compile(str(pred.value))
        except re.error as e:
            raise QueryError(f"bad regex {pred.value!r}: {e}")
        reader = getattr(ds, "fst_index", None)
        if reader is not None:
            return reader.matching_ids(str(pred.value))
        return np.array([i for i in range(card)
                         if rx.search(str(d.get_value(i)))], dtype=np.int64)
    if t is PredicateType.TEXT_MATCH:
        from pinot_tpu_torch.segment.textindex import (
            match_text_value,
            parse_text_query,
        )

        try:
            reader = getattr(ds, "text_index", None)
            if reader is not None:
                # the postings of the query's terms, as dictIds
                return reader.matching_ids(str(pred.value))
            ast = parse_text_query(str(pred.value))
        except ValueError as e:
            raise QueryError(f"bad TEXT_MATCH query: {e}")
        return np.array([i for i in range(card)
                         if match_text_value(d.get_value(i), ast)],
                        dtype=np.int64)
    raise UnsupportedQueryError(f"predicate {t} not supported on "
                                f"dictionary column {ds.name!r}")


def eval_predicate(segment: ImmutableSegment, pred: Predicate) -> np.ndarray:
    n = segment.num_docs
    # IS_NULL / IS_NOT_NULL read the null bitmap regardless of encoding
    if pred.type in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
        ds = segment.data_source(_predicate_column(pred))
        nb = ds.null_bitmap
        isnull = (np.asarray(nb[:n]) if nb is not None
                  else np.zeros(n, dtype=bool))
        return isnull if pred.type is PredicateType.IS_NULL else ~isnull

    if not isinstance(pred.lhs, Identifier):
        return _eval_expr_predicate(segment, pred)

    if pred.lhs.name.startswith("$"):
        vals = _virtual_column_values(segment, pred.lhs.name, n)
        dt = DataType.LONG if vals.dtype.kind == "i" else DataType.STRING
        return _compare_values(vals, pred, dt)

    ds = segment.data_source(pred.lhs.name)
    cm = ds.metadata

    if pred.type is PredicateType.JSON_MATCH:
        return _eval_json_match(ds, pred, n)

    # RANGE over a range-indexed raw column: binary search and a slice of
    # the sorted-order permutation instead of a compare over every doc
    if (pred.type is PredicateType.RANGE and not cm.has_dictionary
            and cm.single_value and ds.range_order is not None):
        return _range_index_mask(ds, pred, n)

    # exclusive predicates on MV columns: every value must pass, the NOT of
    # the inclusive form
    if not cm.single_value and pred.type in (PredicateType.NOT_EQ,
                                             PredicateType.NOT_IN):
        inner_t = (PredicateType.EQ if pred.type is PredicateType.NOT_EQ
                   else PredicateType.IN)
        return ~eval_predicate(segment, replace(pred, type=inner_t))

    if cm.has_dictionary:
        ids = _matching_dict_ids(ds, pred)
        if len(ids) == 0:
            return np.zeros(n, dtype=bool)
        if cm.single_value:
            if (cm.has_inverted_index
                    and len(ids) <= max(4, cm.cardinality // 8)):
                # the postings beat a compare over every doc when few
                # dictIds match
                mask = np.zeros(n, dtype=bool)
                for i in ids:
                    mask[ds.doc_ids_for_dict_id(int(i))] = True
                return mask
            fwd = np.asarray(ds.forward_index[:n])
            if len(ids) == int(ids[-1] - ids[0]) + 1:  # contiguous interval
                return (fwd >= ids[0]) & (fwd <= ids[-1])
            return np.isin(fwd, ids)
        dense, counts = ds.dense_mv()
        dense = np.asarray(dense[:n])
        hit = np.isin(dense, ids) & (np.arange(dense.shape[1])[None, :]
                                     < np.asarray(counts[:n])[:, None])
        return hit.any(axis=1)

    # raw column: compare the values
    vals = np.asarray(ds.forward_index[:n])
    return _compare_values(vals, pred, cm.data_type)


def _eval_json_match(ds: DataSource, pred: Predicate, n: int) -> np.ndarray:
    """JSON_MATCH through the column's JSON index where it has one, else
    parsed per distinct value over the dictionary (per doc on a raw
    column)."""
    from pinot_tpu_torch.segment.jsonindex import (
        match_json_value,
        parse_match_filter,
    )

    cm = ds.metadata
    if not cm.single_value:
        raise UnsupportedQueryError(
            f"JSON_MATCH on multi-value column {ds.name!r}")
    try:
        reader = getattr(ds, "json_index", None)
        if reader is not None:
            return np.asarray(reader.match(str(pred.value))[:n])
        ast = parse_match_filter(str(pred.value))
    except ValueError as e:
        raise QueryError(f"bad JSON_MATCH filter: {e}")
    if cm.has_dictionary:
        d = ds.dictionary
        lut = np.fromiter(
            (match_json_value(d.get_value(i), ast)
             for i in range(cm.cardinality)), dtype=bool,
            count=cm.cardinality)
        return lut[np.asarray(ds.forward_index[:n])]
    vals = ds.forward_index[:n]
    return np.fromiter((match_json_value(v, ast) for v in vals),
                       dtype=bool, count=n)


def search_sorted(sorted_vals: np.ndarray, v, side: str) -> int:
    """``np.searchsorted`` of one value without promoting the sorted array
    (a promotion copies it whole): an integer bound is cast to the array's
    dtype, or lands at an end past its range."""
    if sorted_vals.dtype.kind in "iu":
        info = np.iinfo(sorted_vals.dtype)
        if v < info.min:
            return 0
        if v > info.max:
            return int(sorted_vals.shape[0])
        v = sorted_vals.dtype.type(v)
    return int(np.searchsorted(sorted_vals, v, side=side))


def _range_index_mask(ds: DataSource, pred: Predicate, n: int) -> np.ndarray:
    order = np.asarray(ds.range_order)
    sorted_vals = ds.range_sorted_values
    dt = ds.metadata.data_type
    lo_i, hi_i = 0, n
    if pred.lower is not None:
        lo_i = search_sorted(sorted_vals, dt.convert(pred.lower),
                             "left" if pred.lower_inclusive else "right")
    if pred.upper is not None:
        hi_i = search_sorted(sorted_vals, dt.convert(pred.upper),
                             "right" if pred.upper_inclusive else "left")
    mask = np.zeros(n, dtype=bool)
    if hi_i > lo_i:
        mask[order[lo_i:hi_i]] = True
    return mask


def _compare_values(vals: np.ndarray, pred: Predicate,
                    dt: DataType) -> np.ndarray:
    t = pred.type

    def conv(v):
        try:
            return dt.convert(v)
        except (ValueError, TypeError) as e:
            raise QueryError(f"cannot convert {v!r} to {dt.label}: {e}")

    if t is PredicateType.EQ:
        return vals == conv(pred.value)
    if t is PredicateType.NOT_EQ:
        return vals != conv(pred.value)
    if t is PredicateType.IN:
        return np.isin(vals, [conv(v) for v in pred.values])
    if t is PredicateType.NOT_IN:
        return ~np.isin(vals, [conv(v) for v in pred.values])
    if t is PredicateType.RANGE:
        mask = np.ones(vals.shape, dtype=bool)
        if pred.lower is not None:
            lo = conv(pred.lower)
            mask &= (vals >= lo) if pred.lower_inclusive else (vals > lo)
        if pred.upper is not None:
            hi = conv(pred.upper)
            mask &= (vals <= hi) if pred.upper_inclusive else (vals < hi)
        return mask
    raise UnsupportedQueryError(f"predicate {t} not supported on raw column")


def _virtual_column_values(segment: ImmutableSegment, name: str,
                           n: int) -> np.ndarray:
    if name == "$docId":
        return np.arange(n, dtype=np.int64)
    if name == "$segmentName":
        return np.full(n, segment.segment_name, dtype=object)
    if name == "$hostName":
        import socket

        return np.full(n, socket.gethostname(), dtype=object)
    raise UnsupportedQueryError(f"unknown virtual column {name!r}")


def _eval_expr_predicate(segment: ImmutableSegment,
                         pred: Predicate) -> np.ndarray:
    vals = np.asarray(eval_expr_values(segment, pred.lhs))
    dt = (DataType.DOUBLE if np.issubdtype(vals.dtype, np.floating)
          else DataType.LONG)
    if vals.dtype == object:
        dt = DataType.STRING
    return _compare_values(vals, pred, dt)


def _predicate_column(pred: Predicate) -> str:
    cols = pred.lhs.columns()
    if not cols:
        raise QueryError(f"predicate references no column: {pred}")
    return cols[0]


# -- expression evaluation -> value arrays -------------------------------------

_ARITH = {
    "plus": np.add,
    "minus": np.subtract,
    "times": np.multiply,
    "divide": np.true_divide,
    "mod": np.mod,
}

_UNARY = {
    "abs": np.abs,
    "ceil": np.ceil,
    "floor": np.floor,
    "exp": np.exp,
    "ln": np.log,
    "sqrt": np.sqrt,
}


def string_values(ds: DataSource) -> np.ndarray:
    """A string dictionary's values as python ``str`` objects (what the
    JAX package's ``get_values`` gives), gathered by dictId."""
    return ds.dictionary.values.astype(object)


def eval_expr_values(segment: ImmutableSegment, expr: Expr,
                     doc_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """An expression's values per doc (of ``doc_ids``, else of every doc):
    numeric arrays, or object arrays of strings. Single-value only."""
    n = segment.num_docs

    if isinstance(expr, Literal):
        return np.full(n if doc_ids is None else len(doc_ids), expr.value)

    if isinstance(expr, Identifier):
        if expr.name.startswith("$"):
            vals = _virtual_column_values(segment, expr.name, n)
            return vals if doc_ids is None else vals[doc_ids]
        ds = segment.data_source(expr.name)
        cm = ds.metadata
        if not cm.single_value:
            raise UnsupportedQueryError(
                f"multi-value column {expr.name!r} in expression position")
        fwd = np.asarray(ds.forward_index[:n])
        if doc_ids is not None:
            fwd = fwd[doc_ids]
        if not cm.has_dictionary:
            return fwd
        if cm.data_type.is_numeric:
            return ds.dictionary.device_values()[fwd]
        return string_values(ds)[fwd]

    if isinstance(expr, Function):
        name = expr.name
        if name in _ARITH:
            a = _to_float(eval_expr_values(segment, expr.args[0], doc_ids))
            b = _to_float(eval_expr_values(segment, expr.args[1], doc_ids))
            return _ARITH[name](a, b)
        if name in _UNARY:
            a = _to_float(eval_expr_values(segment, expr.args[0], doc_ids))
            return _UNARY[name](a)
        # any registered scalar function evaluates row by row over the
        # argument arrays
        from pinot_tpu_torch.query import functions as fnreg

        fn = fnreg.lookup(name)
        if fn is not None:
            arg_arrays = [eval_expr_values(segment, a, doc_ids)
                          for a in expr.args]
            fast = _vectorized(name, expr.args, arg_arrays)
            if fast is not None:
                return fast
            n_rows = (len(arg_arrays[0]) if arg_arrays
                      else (n if doc_ids is None else len(doc_ids)))
            out = [fn(*(arr[i] for arr in arg_arrays))
                   for i in range(n_rows)]
            arr = np.asarray(out)
            return arr if arr.dtype != object or not out \
                else np.asarray(out, dtype=object)
        raise UnsupportedQueryError(f"transform function {name!r} not "
                                    "supported")

    raise UnsupportedQueryError(f"cannot evaluate expression {expr}")


def _vectorized(name: str, args, arrays: List[np.ndarray]
                ) -> Optional[np.ndarray]:
    """The values the row-by-row registry call would give, computed on
    the whole array where numpy gives the same integers: ``dateTrunc``
    of integer epoch milliseconds to a fixed-length unit. None
    otherwise."""
    from pinot_tpu_torch.query.functions import TRUNC_UNIT_MS

    if (name.lower() == "datetrunc" and len(args) == 2
            and isinstance(args[0], Literal)
            and str(args[0].value).lower() in TRUNC_UNIT_MS
            and arrays[1].dtype.kind in "iu"):
        q = TRUNC_UNIT_MS[str(args[0].value).lower()]
        return arrays[1].astype(np.int64) // q * q
    return None


def _to_float(a: np.ndarray) -> np.ndarray:
    if a.dtype == object:
        raise QueryError("arithmetic on non-numeric column")
    return (a.astype(np.float64) if not np.issubdtype(a.dtype, np.floating)
            else a)


def mv_values(segment: ImmutableSegment, column: str) -> MVValues:
    """An MV column's dictIds over the segment's docs and the values they
    index: numeric, or the strings."""
    ds = segment.data_source(column)
    n = segment.num_docs
    dense, counts = ds.dense_mv()
    d = ds.dictionary
    vals = d.device_values() if d.data_type.is_numeric else string_values(ds)
    return MVValues(np.asarray(dense[:n]), np.asarray(counts[:n]), vals)


def read_values(segment: ImmutableSegment, column: str,
                doc_ids: np.ndarray) -> List[Any]:
    """Python values of a column at ``doc_ids`` (an MV row is a list)."""
    if column.startswith("$"):
        vals = _virtual_column_values(segment, column, segment.num_docs)
        return [v.item() if hasattr(v, "item") else v
                for v in vals[doc_ids]]
    ds = segment.data_source(column)
    cm = ds.metadata
    if cm.single_value:
        fwd = np.asarray(ds.forward_index)[doc_ids]
        if not cm.has_dictionary:
            return [cm.data_type.convert(v) for v in fwd]
        return ds.dictionary.get_values(fwd)
    dense, counts = ds.dense_mv()
    d = ds.dictionary
    return [d.get_values(np.asarray(dense[i][:int(counts[i])]))
            for i in doc_ids]
