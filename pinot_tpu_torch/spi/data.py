"""Schema and field-spec data model: INT/LONG/FLOAT/DOUBLE/STRING columns,
single-value or multi-value, with their default null values, the
ingestion length cap and derived-column expression.

Counterpart of ``pinot_tpu/spi/data.py``, cut to what the port uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


class DataType(Enum):
    """Column value types; ``stored_np`` is the dtype of a numeric
    dictionary's value array."""

    INT = ("INT", np.int32, True)
    LONG = ("LONG", np.int64, True)
    FLOAT = ("FLOAT", np.float32, True)
    DOUBLE = ("DOUBLE", np.float64, True)
    STRING = ("STRING", np.object_, False)

    def __init__(self, label: str, stored_np: Any, numeric: bool):
        self.label = label
        self.stored_np = stored_np
        self.numeric = numeric

    @property
    def is_numeric(self) -> bool:
        return self.numeric

    @property
    def is_integral(self) -> bool:
        return self in (DataType.INT, DataType.LONG)

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT, DataType.DOUBLE)

    def convert(self, value: Any) -> Any:
        """Coerce a python value to this type (filter literals)."""
        if value is None:
            return None
        if self.is_integral:
            return int(value)
        if self.is_floating:
            return float(value)
        return value if isinstance(value, str) else str(value)

    @property
    def converter(self):
        """``convert`` for a value that is not None, as a plain function
        (the ingestion path calls it per value)."""
        return _CONVERTERS[self]

    @classmethod
    def from_string(cls, s: str) -> "DataType":
        return cls[s.upper()]


def _to_str(value: Any) -> str:
    return value if isinstance(value, str) else str(value)


_CONVERTERS = {DataType.INT: int, DataType.LONG: int, DataType.FLOAT: float,
               DataType.DOUBLE: float, DataType.STRING: _to_str}


class FieldType(Enum):
    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    TIME = "TIME"
    DATE_TIME = "DATE_TIME"


# the value a null row stores, by field kind (the JAX package's
# _DEFAULT_DIMENSION_NULL / _DEFAULT_METRIC_NULL)
_DEFAULT_DIMENSION_NULL = {
    DataType.INT: int(np.iinfo(np.int32).min),
    DataType.LONG: int(np.iinfo(np.int64).min),
    DataType.FLOAT: float("-inf"),
    DataType.DOUBLE: float("-inf"),
    DataType.STRING: "null",
}
_DEFAULT_METRIC_NULL = {
    DataType.INT: 0,
    DataType.LONG: 0,
    DataType.FLOAT: 0.0,
    DataType.DOUBLE: 0.0,
    DataType.STRING: "null",
}


@dataclass
class FieldSpec:
    """``max_length`` caps a string value at ingestion and
    ``transform_function`` derives the column from a row's fields (the
    ingestion transformers read both)."""

    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True
    default_null_value: Any = None
    max_length: int = 512
    transform_function: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.data_type, str):
            self.data_type = DataType.from_string(self.data_type)
        if isinstance(self.field_type, str):
            self.field_type = FieldType[self.field_type.upper()]
        if self.default_null_value is None:
            metric = self.field_type is FieldType.METRIC
            table = _DEFAULT_METRIC_NULL if metric else _DEFAULT_DIMENSION_NULL
            self.default_null_value = table[self.data_type]
        else:
            self.default_null_value = self.data_type.convert(
                self.default_null_value)


class Schema:
    """A named, ordered collection of fields."""

    def __init__(self, schema_name: str, field_specs: Iterable[FieldSpec],
                 primary_key_columns: Optional[List[str]] = None):
        self.schema_name = schema_name
        self._fields: Dict[str, FieldSpec] = {}
        for fs in field_specs:
            if fs.name in self._fields:
                raise ValueError(f"duplicate column {fs.name!r}")
            self._fields[fs.name] = fs
        #: an upsert table's key (``segment/upsert.py``)
        self.primary_key_columns = list(primary_key_columns or [])
        for pk in self.primary_key_columns:
            if pk not in self._fields:
                raise ValueError(f"primary key column {pk!r} not in schema")

    @property
    def column_names(self) -> List[str]:
        return list(self._fields)

    @property
    def field_specs(self) -> List[FieldSpec]:
        return list(self._fields.values())

    def field_spec(self, name: str) -> FieldSpec:
        try:
            return self._fields[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in schema "
                           f"{self.schema_name!r}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._fields
