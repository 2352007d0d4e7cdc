"""In-memory segment builder from a column frame.

Counterpart of ``pinot_tpu/segment/creator.py`` (``SegmentBuilder``), cut
to the slice: every column is dictionary-encoded and single-value, and the
segment lives in memory (no on-disk format yet).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from pinot_tpu_torch.segment.convert import ColumnArrays, segment_from_arrays
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import Schema


class SegmentBuilder:
    def __init__(self, schema: Schema, segment_name: str,
                 table_name: Optional[str] = None):
        self.schema = schema
        self.segment_name = segment_name
        self.table_name = table_name or schema.schema_name

    def build(self, frame: Mapping[str, Sequence[Any]]) -> ImmutableSegment:
        sizes = {len(frame[c]) for c in self.schema.column_names}
        if len(sizes) != 1:
            raise ValueError(f"ragged column lengths: {sorted(sizes)}")
        num_docs = sizes.pop()
        columns = {}
        for fs in self.schema.field_specs:
            dt = fs.data_type
            if dt.is_numeric:
                vals = np.asarray(frame[fs.name], dtype=dt.stored_np)
            else:
                vals = np.asarray([dt.convert(v) for v in frame[fs.name]],
                                  dtype=np.str_)
            uniq, ids = np.unique(vals, return_inverse=True)
            columns[fs.name] = ColumnArrays(
                data_type=dt, field_type=fs.field_type, dictionary=uniq,
                dict_ids=ids.reshape(-1))
        return segment_from_arrays(self.segment_name, num_docs, columns,
                                   table_name=self.table_name)
