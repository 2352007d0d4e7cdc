"""Schema and field-spec data model: INT/LONG/FLOAT/DOUBLE/STRING columns,
single-value or multi-value, with their default null values, the
ingestion length cap and derived-column expression, and a time column's
granularity and format.

Counterpart of ``pinot_tpu/spi/data.py``, cut to what the port uses.
``Schema.to_dict`` / ``from_dict`` are the reference's JSON layout
(``dimensionFieldSpecs`` / ``metricFieldSpecs`` / ``dateTimeFieldSpecs``,
JAX :300-324), which a segment's ``metadata.json`` embeds; a schema
written by either package reads back in the other.
"""

from __future__ import annotations

import json
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
class TimeGranularity:
    """Time unit and size of a TIME / DATE_TIME field (JAX :128-146)."""

    unit: str = "MILLISECONDS"  # MILLISECONDS | SECONDS | MINUTES | HOURS | DAYS
    size: int = 1

    _MILLIS = {
        "MILLISECONDS": 1,
        "SECONDS": 1000,
        "MINUTES": 60_000,
        "HOURS": 3_600_000,
        "DAYS": 86_400_000,
    }

    def to_millis(self, value: int) -> int:
        """``value`` of this granularity in milliseconds."""
        return int(value) * self.size * self._MILLIS[self.unit.upper()]

    def to_dict(self) -> Dict[str, Any]:
        return {"unit": self.unit, "size": self.size}

    @classmethod
    def from_dict(cls, d: Any) -> "TimeGranularity":
        # a DATE_TIME granularity is serialized "size:UNIT" ("1:DAYS"),
        # a TIME one as a dict
        if isinstance(d, str):
            parts = d.split(":")
            return cls(unit=parts[1], size=int(parts[0]))
        return cls(unit=d.get("unit", "MILLISECONDS"),
                   size=int(d.get("size", 1)))


@dataclass
class FieldSpec:
    """``max_length`` caps a string value at ingestion and
    ``transform_function`` derives the column from a row's fields (the
    ingestion transformers read both); ``granularity`` and ``format``
    describe a TIME / DATE_TIME column."""

    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True
    default_null_value: Any = None
    max_length: int = 512
    transform_function: Optional[str] = None
    granularity: Optional[TimeGranularity] = None
    format: Optional[str] = None

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

    @property
    def is_dimension(self) -> bool:
        """A dimension, TIME or DATE_TIME field."""
        return self.field_type in (FieldType.DIMENSION, FieldType.TIME,
                                   FieldType.DATE_TIME)

    @property
    def is_metric(self) -> bool:
        return self.field_type is FieldType.METRIC

    def to_dict(self) -> Dict[str, Any]:
        """JAX ``FieldSpec.to_dict`` (:191-209)."""
        d: Dict[str, Any] = {"name": self.name,
                             "dataType": self.data_type.label,
                             "fieldType": self.field_type.value}
        if not self.single_value:
            d["singleValueField"] = False
        if self.default_null_value is not None:
            d["defaultNullValue"] = self.default_null_value
        if self.granularity is not None:
            d["granularity"] = self.granularity.to_dict()
        if self.format is not None:
            d["format"] = self.format
        if self.max_length != 512:
            d["maxLength"] = self.max_length
        if self.transform_function:
            d["transformFunction"] = self.transform_function
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any],
                  field_type: Optional[FieldType] = None) -> "FieldSpec":
        """``field_type`` is the kind when the dict names none (an explicit
        ``fieldType`` wins, so a TIME spec under ``dateTimeFieldSpecs``
        reads back as TIME)."""
        gran = d.get("granularity")
        explicit = d.get("fieldType")
        ft = (FieldType[explicit.upper()] if explicit
              else (field_type or FieldType.DIMENSION))
        return cls(name=d["name"],
                   data_type=DataType.from_string(d["dataType"]),
                   field_type=ft,
                   single_value=d.get("singleValueField", True),
                   default_null_value=d.get("defaultNullValue"),
                   max_length=d.get("maxLength", 512),
                   transform_function=d.get("transformFunction"),
                   granularity=(TimeGranularity.from_dict(gran) if gran
                                else None),
                   format=d.get("format"))


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

    @property
    def dimension_names(self) -> List[str]:
        return [n for n, fs in self._fields.items() if fs.is_dimension]

    @property
    def metric_names(self) -> List[str]:
        return [n for n, fs in self._fields.items() if fs.is_metric]

    def has_column(self, name: str) -> bool:
        return name in self._fields

    def field_spec(self, name: str) -> FieldSpec:
        try:
            return self._fields[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in schema "
                           f"{self.schema_name!r}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    @property
    def time_column(self) -> Optional[str]:
        """The first TIME / DATE_TIME field, or None."""
        for name, fs in self._fields.items():
            if fs.field_type in (FieldType.TIME, FieldType.DATE_TIME):
                return name
        return None

    def to_dict(self) -> Dict[str, Any]:
        """The reference's schema JSON: dimensions, metrics and time
        fields in their own lists, each in field order."""
        dims, mets, dts = [], [], []
        for fs in self._fields.values():
            if fs.field_type is FieldType.METRIC:
                mets.append(fs.to_dict())
            elif fs.field_type in (FieldType.DATE_TIME, FieldType.TIME):
                dts.append(fs.to_dict())
            else:
                dims.append(fs.to_dict())
        d: Dict[str, Any] = {"schemaName": self.schema_name}
        if dims:
            d["dimensionFieldSpecs"] = dims
        if mets:
            d["metricFieldSpecs"] = mets
        if dts:
            d["dateTimeFieldSpecs"] = dts
        if self.primary_key_columns:
            d["primaryKeyColumns"] = self.primary_key_columns
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Schema":
        """The fields come back dimensions first, then metrics, then the
        time fields (a legacy ``timeFieldSpec`` among them)."""
        specs: List[FieldSpec] = []
        for fd in d.get("dimensionFieldSpecs", []):
            specs.append(FieldSpec.from_dict(fd, FieldType.DIMENSION))
        for fd in d.get("metricFieldSpecs", []):
            specs.append(FieldSpec.from_dict(fd, FieldType.METRIC))
        tfs = d.get("timeFieldSpec")
        if tfs:
            inner = tfs.get("incomingGranularitySpec", tfs)
            specs.append(FieldSpec(
                name=inner["name"],
                data_type=DataType.from_string(inner["dataType"]),
                field_type=FieldType.TIME,
                granularity=TimeGranularity(
                    unit=inner.get("timeType", "MILLISECONDS"))))
        for fd in d.get("dateTimeFieldSpecs", []):
            specs.append(FieldSpec.from_dict(fd, FieldType.DATE_TIME))
        return cls(d["schemaName"], specs, d.get("primaryKeyColumns"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Schema":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "Schema":
        """The reference's JSON file (JAX ``spi/data.py:349``)."""
        with open(path) as f:
            return cls.from_dict(json.load(f))
