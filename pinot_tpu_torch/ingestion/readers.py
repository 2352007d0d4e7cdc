"""Input-format readers: CSV, JSON, Parquet, Avro and ProtoBuf.

Counterpart of ``pinot_tpu/ingestion/readers.py`` (JAX :24-221, the
reference's pinot-input-format plugins): each format is a
``spi.readers.RecordReader``, and ``create_record_reader`` picks the
reader by declared format or file extension.

CSV follows the reference's CSVRecordReaderConfig defaults: a header
row, the ``,`` delimiter, an empty cell is a null, and the ``;``
multi-value delimiter splits only the columns the caller declares as
multi-value (``multiValueColumns``; with no declaration any cell holding
it splits). A column the file lacks fills with nulls, and an empty file
raises. Parquet goes through ``pyarrow``, imported at ``init``: a reader
whose library does not import raises there.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Type

from pinot_tpu_torch.spi.readers import GenericRow, RecordReader, RecordReaderConfig


class CSVRecordReader(RecordReader):
    """Ref: pinot-csv CSVRecordReader + CSVRecordReaderConfig."""

    def init(self, data_file: str,
             fields_to_read: Optional[Sequence[str]] = None,
             config: Optional[RecordReaderConfig] = None) -> None:
        cfg = config or {}
        self._path = data_file
        self._fields = list(fields_to_read) if fields_to_read else None
        self._delimiter = str(cfg.get("delimiter", ","))
        self._mv_delimiter = str(cfg.get("multiValueDelimiter", ";"))
        # when the caller declares which columns are multi-value (the job
        # runner passes the schema's MV set), ONLY those cells split on the
        # MV delimiter — a ';' inside a single-value string survives intact.
        # With no declaration, any cell containing the delimiter splits
        # (the reference CSVRecordExtractor's schema-less behavior).
        mv = cfg.get("multiValueColumns")
        self._mv_columns = set(mv) if mv is not None else None
        with open(data_file, "r", newline="") as f:
            try:
                self._header = next(csv.reader(f, delimiter=self._delimiter))
            except StopIteration:
                raise ValueError(f"empty CSV file {data_file!r}") from None

    def _cell(self, name: str, v: str) -> Any:
        if v == "":
            return None
        if (self._mv_delimiter
                and (self._mv_columns is None or name in self._mv_columns)
                and self._mv_delimiter in v):
            return [x for x in v.split(self._mv_delimiter) if x != ""]
        return v

    def _column(self, name: str, cells: Sequence[str]) -> List[Any]:
        """``_cell`` over one column's cells."""
        if self._mv_delimiter and (self._mv_columns is None
                                   or name in self._mv_columns):
            return [self._cell(name, v) for v in cells]
        if "" not in cells:
            return list(cells)
        return [None if v == "" else v for v in cells]

    def __iter__(self) -> Iterator[GenericRow]:
        fields = set(self._fields or self._header)
        with open(self._path, "r", newline="") as f:
            reader = csv.reader(f, delimiter=self._delimiter)
            next(reader)  # header
            for rec in reader:
                row = GenericRow()
                for name, val in zip(self._header, rec):
                    if name in fields:
                        row[name] = self._cell(name, val)
                yield row

    def rewind(self) -> None:  # iteration reopens the file
        pass

    def read_columnar(self) -> Optional[Dict[str, List[Any]]]:
        cols: Dict[str, List[Any]] = {}
        fields = self._fields or self._header
        idx = [(i, n) for i, n in enumerate(self._header) if n in fields]
        for name in self._header:
            if name in fields:
                cols[name] = []
        with open(self._path, "r", newline="") as f:
            reader = csv.reader(f, delimiter=self._delimiter)
            next(reader)
            recs = list(reader)
        n_rows = len(recs)
        width = len(self._header)
        if len(set(self._header)) == width \
                and set(map(len, recs)) <= {width}:
            # every row as wide as the header: a column at a time, the
            # cells JAX's row-by-row loop below gives
            by_col = list(zip(*recs)) if recs else [()] * width
            for i, name in idx:
                cols[name] = self._column(name, by_col[i])
        else:
            for rec in recs:
                for i, name in idx:
                    cols[name].append(self._cell(name, rec[i])
                                      if i < len(rec) else None)
        # schema columns absent from the CSV null-fill (parity with the
        # row path, where row.get returns None)
        for name in fields:
            if name not in cols:
                cols[name] = [None] * n_rows
        return cols


class JSONRecordReader(RecordReader):
    """JSON lines or a top-level array of objects
    (ref: pinot-json JSONRecordReader)."""

    def init(self, data_file: str,
             fields_to_read: Optional[Sequence[str]] = None,
             config: Optional[RecordReaderConfig] = None) -> None:
        self._path = data_file
        self._fields = list(fields_to_read) if fields_to_read else None

    def _records(self) -> Iterator[Dict[str, Any]]:
        with open(self._path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                yield from json.load(f)
            else:
                for line in f:
                    line = line.strip()
                    if line:
                        yield json.loads(line)

    def __iter__(self) -> Iterator[GenericRow]:
        for rec in self._records():
            row = GenericRow()
            for k, v in rec.items():
                if self._fields is None or k in self._fields:
                    row[k] = v
            yield row

    def rewind(self) -> None:
        pass


class ParquetRecordReader(RecordReader):
    """Parquet via pyarrow (ref: pinot-parquet ParquetRecordReader)."""

    def init(self, data_file: str,
             fields_to_read: Optional[Sequence[str]] = None,
             config: Optional[RecordReaderConfig] = None) -> None:
        import pyarrow.parquet as pq

        cols = None
        self._missing: List[str] = []
        if fields_to_read:
            # columns absent from the file null-fill (parity with the CSV
            # path; pyarrow raises on unknown column names)
            present = set(pq.read_schema(data_file).names)
            cols = [c for c in fields_to_read if c in present]
            self._missing = [c for c in fields_to_read if c not in present]
        self._table = pq.read_table(data_file, columns=cols)

    def __iter__(self) -> Iterator[GenericRow]:
        for rec in self._table.to_pylist():
            for c in self._missing:
                rec[c] = None
            yield GenericRow(rec)

    def rewind(self) -> None:
        pass

    def read_columnar(self) -> Dict[str, Any]:
        out = {name: col.to_numpy(zero_copy_only=False)
               for name, col in zip(self._table.column_names,
                                    self._table.columns)}
        for c in self._missing:
            out[c] = [None] * self._table.num_rows
        return out


class AvroRecordReader(RecordReader):
    """Avro container files via the from-scratch binary decoder
    (ingestion/avro.py; ref: pinot-avro AvroRecordReader over
    org.apache.avro DataFileStream)."""

    def init(self, data_file: str,
             fields_to_read: Optional[Sequence[str]] = None,
             config: Optional[RecordReaderConfig] = None) -> None:
        self._path = data_file
        self._fields = set(fields_to_read) if fields_to_read else None

    def __iter__(self) -> Iterator[GenericRow]:
        from pinot_tpu_torch.ingestion.avro import read_container

        _, values = read_container(self._path)
        for rec in values:
            if not isinstance(rec, dict):
                rec = {"value": rec}
            row = GenericRow()
            for k, v in rec.items():
                if self._fields is None or k in self._fields:
                    row[k] = v
            yield row

    def rewind(self) -> None:  # iteration re-reads the file
        pass


from pinot_tpu_torch.ingestion.protobuf import ProtoBufRecordReader  # noqa: E402
# (protobuf.py defers the google.protobuf import to first use)

_FORMATS: Dict[str, Type[RecordReader]] = {
    "csv": CSVRecordReader,
    "json": JSONRecordReader,
    "jsonl": JSONRecordReader,
    "parquet": ParquetRecordReader,
    "avro": AvroRecordReader,
    "proto": ProtoBufRecordReader,
    "pb": ProtoBufRecordReader,
}


def create_record_reader(data_file: str, data_format: Optional[str] = None,
                         fields_to_read: Optional[Sequence[str]] = None,
                         config: Optional[RecordReaderConfig] = None
                         ) -> RecordReader:
    """Factory by declared format or file extension (the RecordReader
    plugin registry, ref: RecordReaderFactory.java)."""
    fmt = (data_format or os.path.splitext(data_file)[1].lstrip(".")).lower()
    cls = _FORMATS.get(fmt)
    if cls is None:
        raise ValueError(f"unsupported input format {fmt!r} "
                         f"(supported: {sorted(_FORMATS)})")
    reader = cls()
    reader.init(data_file, fields_to_read, config)
    return reader
