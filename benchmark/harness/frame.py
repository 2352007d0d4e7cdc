"""The table a cell runs on, as the benchmark holds it.

A generator (``generators/<name>.py``) draws a ``Frame`` from the seed: one
tensor a column, rows in segment order, and the row range of each segment.
String columns hold codes into a sorted universe of values, so a code's
order is its string's order and no string is built per row. A multi-value
column holds a dense ``[rows, K]`` code matrix and a count a row; entries
past a row's count are 0 and mean nothing.

Both the port's segments and the reference are made from the same frame:
the port takes it as dictionary or raw columns (``harness/port.py``), the
reference evaluates queries over it (``reference/evaluate.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch


@dataclass
class Column:
    """How one column is stored and served.

    ``data_type``: ``INT`` or ``STRING``; ``field_type``: ``DIMENSION`` or
    ``METRIC``; ``encoding``: ``dictionary`` (the port builds a sorted
    dictionary of the values present) or ``raw`` (values as they are);
    ``universe``: a string column's sorted values, which its codes index;
    ``multi_value``: the column holds ``(codes [rows, K], counts [rows])``.
    """

    data_type: str
    field_type: str
    encoding: str = "dictionary"
    universe: Optional[List[str]] = None
    multi_value: bool = False


@dataclass
class Frame:
    table: str
    columns: Dict[str, Column]
    data: Dict[str, object]            # name -> tensor, or (codes, counts)
    segments: List[Tuple[int, int]]    # row range [start, stop) a segment

    @property
    def num_rows(self) -> int:
        return self.segments[-1][1] if self.segments else 0

    def to(self, device) -> "Frame":
        """The same frame with every tensor on ``device``."""
        def move(v):
            if isinstance(v, tuple):
                return tuple(t.to(device) for t in v)
            return v.to(device)
        return Frame(self.table, self.columns,
                     {k: move(v) for k, v in self.data.items()},
                     list(self.segments))


def device_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (the seed is
    folded to 63 bits, so seeds past 2**63 still give one stream each)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen
