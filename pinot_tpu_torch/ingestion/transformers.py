"""Record transformers: the ingestion-time row pipeline.

Counterpart of ``pinot_tpu/ingestion/transformers.py``:
``CompositeTransformer.for_table`` chains, in the reference's order,
nested-object flattening, derived columns (the schema's
``transform_function`` and the table's transform configs), the row
filter (rows it matches are dropped), coercion to the schema's types,
null defaults (the null fields listed under ``__nulls__``) and string
sanitisation, over row dicts on their way to ``MutableSegment.index``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pinot_tpu_torch.query.functions import (
    EvalError,
    eval_row_filter,
    eval_scalar,
)
from pinot_tpu_torch.query.parser import (
    parse_expression,
    parse_filter_expression,
)
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.table import TableConfig

Row = Dict[str, Any]

# a transformer's answer for a dropped row
SKIP = None


class RecordTransformer:
    """``transform(row)`` -> the row, or None to drop it."""

    def transform(self, row: Row) -> Optional[Row]:
        raise NotImplementedError


class ExpressionTransformer(RecordTransformer):
    """Derived columns from SQL expressions over the row's fields; an
    existing non-null value is kept."""

    def __init__(self, expressions: Dict[str, str]):
        self._exprs = {col: parse_expression(e)
                       for col, e in expressions.items()}

    def transform(self, row: Row) -> Optional[Row]:
        for col, expr in self._exprs.items():
            if row.get(col) is None:
                try:
                    row[col] = eval_scalar(expr, row)
                except EvalError:
                    row[col] = None
        return row


class FilterTransformer(RecordTransformer):
    """Drops the rows the filter function matches."""

    def __init__(self, filter_function: str):
        self._filter = parse_filter_expression(filter_function)

    def transform(self, row: Row) -> Optional[Row]:
        try:
            if eval_row_filter(self._filter, row):
                return SKIP
        except EvalError:
            pass
        return row


class DataTypeTransformer(RecordTransformer):
    """Coerces values to the schema's types and drops the fields the
    schema does not name; a value that does not convert becomes null."""

    def __init__(self, schema: Schema):
        self._fields = [(fs.name, fs.single_value, fs.data_type.converter)
                        for fs in schema.field_specs]

    def transform(self, row: Row) -> Optional[Row]:
        out: Row = {}
        for name, single, conv in self._fields:
            v = row.get(name)
            if v is None:
                out[name] = None
                continue
            try:
                if single:
                    if isinstance(v, (list, tuple)):
                        v = v[0] if v else None
                    out[name] = None if v is None else conv(v)
                else:
                    vals = v if isinstance(v, (list, tuple)) else [v]
                    out[name] = [conv(x) for x in vals if x is not None]
            except (ValueError, TypeError):
                out[name] = None
        return out


class NullValueTransformer(RecordTransformer):
    """Replaces nulls with the field's default null value and lists the
    null fields under ``NULL_FIELDS_KEY``."""

    NULL_FIELDS_KEY = "__nulls__"

    def __init__(self, schema: Schema):
        self._fields = [(fs.name, fs.single_value, fs.default_null_value)
                        for fs in schema.field_specs]

    def transform(self, row: Row) -> Optional[Row]:
        nulls: List[str] = []
        for name, single, default in self._fields:
            v = row.get(name)
            if v is None or (not single and v == []):
                nulls.append(name)
                row[name] = default if single else [default]
        if nulls:
            row[self.NULL_FIELDS_KEY] = nulls
        return row


class SanitizationTransformer(RecordTransformer):
    """Strips NUL characters and cuts strings at the field's
    ``max_length``."""

    def __init__(self, schema: Schema):
        self._string_cols = {fs.name: fs.max_length
                             for fs in schema.field_specs
                             if not fs.data_type.is_numeric}

    def transform(self, row: Row) -> Optional[Row]:
        for name, max_len in self._string_cols.items():
            v = row.get(name)
            if isinstance(v, str):
                row[name] = self._clean(v, max_len)
            elif isinstance(v, list):
                row[name] = [self._clean(x, max_len) if isinstance(x, str)
                             else x for x in v]
        return row

    @staticmethod
    def _clean(s: str, max_len: int) -> str:
        if "\x00" in s:
            s = s.replace("\x00", "")
        return s[:max_len]


class ComplexTypeTransformer(RecordTransformer):
    """Flattens nested objects into dotted columns."""

    def __init__(self, delimiter: str = "."):
        self._delim = delimiter

    def transform(self, row: Row) -> Optional[Row]:
        out: Row = {}
        for k, v in row.items():
            if isinstance(v, dict):
                self._flatten(k, v, out)
            else:
                out[k] = v
        return out

    def _flatten(self, prefix: str, obj: Dict[str, Any], out: Row) -> None:
        for k, v in obj.items():
            key = f"{prefix}{self._delim}{k}"
            if isinstance(v, dict):
                self._flatten(key, v, out)
            else:
                out[key] = v


class CompositeTransformer(RecordTransformer):
    def __init__(self, transformers: List[RecordTransformer]):
        self._transformers = transformers

    def transform(self, row: Row) -> Optional[Row]:
        for t in self._transformers:
            row = t.transform(row)
            if row is None:
                return SKIP
        return row

    @classmethod
    def for_table(cls, table_config: Optional[TableConfig],
                  schema: Schema) -> "CompositeTransformer":
        """complex type -> expression -> filter -> data type -> null ->
        sanitize."""
        chain: List[RecordTransformer] = [ComplexTypeTransformer()]
        expressions: Dict[str, str] = {}
        for fs in schema.field_specs:
            if fs.transform_function:
                expressions[fs.name] = fs.transform_function
        ic = table_config.ingestion_config if table_config else None
        if ic:
            for tc in ic.transform_configs:
                expressions[tc.column] = tc.transform_function
        if expressions:
            chain.append(ExpressionTransformer(expressions))
        if ic and ic.filter_function:
            chain.append(FilterTransformer(ic.filter_function))
        chain.append(DataTypeTransformer(schema))
        chain.append(NullValueTransformer(schema))
        chain.append(SanitizationTransformer(schema))
        return cls(chain)

