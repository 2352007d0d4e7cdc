"""The record reader SPI: rows of a data file, whatever its format.

Counterpart of ``pinot_tpu/spi/readers.py`` (the reference's
``RecordReader.java`` and ``GenericRow.java``): a reader opens a file in
``init``, yields ``GenericRow`` dicts (None is a null, a list a
multi-value cell) and may return the whole file as columns from
``read_columnar``, the path the batch job prefers where the table has no
row transforms. The format readers are in ``ingestion/readers.py``.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterator, Optional, Sequence


class GenericRow(dict):
    """One ingestion row: column -> value."""

    def put_value(self, column: str, value: Any) -> None:
        self[column] = value

    def get_value(self, column: str) -> Any:
        return self.get(column)


class RecordReaderConfig(dict):
    """A format's reader settings, as a plain key/value map."""


class RecordReader(abc.ABC):
    """Ref: ``RecordReader.java`` init / hasNext / next / rewind / close."""

    @abc.abstractmethod
    def init(self, data_file: str,
             fields_to_read: Optional[Sequence[str]] = None,
             config: Optional[RecordReaderConfig] = None) -> None:
        """Open ``data_file``, reading only ``fields_to_read`` when given."""

    @abc.abstractmethod
    def __iter__(self) -> Iterator[GenericRow]:
        """The rows from the current position."""

    @abc.abstractmethod
    def rewind(self) -> None:
        """Back to the first row."""

    def close(self) -> None:  # noqa: B027 (optional hook)
        pass

    def read_columnar(self) -> Optional[Dict[str, Any]]:
        """Column -> array or list for the whole file, or None where the
        format reads row by row only."""
        return None

    def __enter__(self) -> "RecordReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["GenericRow", "RecordReaderConfig", "RecordReader"]
