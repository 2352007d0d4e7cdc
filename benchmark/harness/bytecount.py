"""The bytes a query must read, counted from the data.

For each column a query reads (filters, group keys, aggregates), each
segment the reference's min/max test keeps contributes its rows times the
column's least width there: ``ceil(log2(cardinality))`` bits (at least one)
for a dictionary column, over the distinct values the segment holds; the
type's width for a raw column (4 bytes for an INT); a multi-value column
counts its entries. The count depends on the data and the query alone,
never on how the program lays its columns out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from benchmark.harness.frame import Frame
from benchmark.reference.evaluate import kept_segments, query_columns

RAW_BYTES = {"INT": 4}


def segment_widths(frame: Frame) -> List[Dict[str, float]]:
    """Per segment, each column's bytes a row (an entry, for a multi-value
    column) and its entry count."""
    out = []
    for a, b in frame.segments:
        seg = {}
        for col, c in frame.columns.items():
            d = frame.data[col]
            if c.multi_value:
                codes, counts = d[0][a:b], d[1][a:b]
                entry = (torch.arange(codes.shape[1],
                                      device=codes.device)[None, :]
                         < counts[:, None])
                v = codes[entry]
            else:
                v = d[a:b]
            if c.encoding == "raw":
                width = float(RAW_BYTES[c.data_type])
            else:
                card = int(torch.unique(v).numel())
                width = max(1, math.ceil(math.log2(max(card, 1)))) / 8.0
            seg[col] = (width, int(v.numel()))
        out.append(seg)
    return out


def query_bytes(frame: Frame, q: dict, widths: List[Dict],
                ranges: Optional[List[Dict]] = None) -> float:
    cols = query_columns(q)
    total = 0.0
    for i in kept_segments(frame, q, ranges):
        for col in cols:
            width, n = widths[i][col]
            total += width * n
    return total
