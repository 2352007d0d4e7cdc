"""The system under test: one Pinot server's query path in the port.

The only module of the benchmark that imports the program
(``pinot_tpu_torch``). It hands the port each column of a frame as the
port's ``ColumnArrays`` (a sorted dictionary of the values a segment holds
and its dictIds, or a raw column's values), lets the port build its
segments with ``segment_from_arrays``, and drives
``ShardedQueryExecutor.execute`` with a context compiled from the SQL text.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness.frame import Frame


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def column_arrays(frame: Frame, col: str, a: int, b: int):
    """Rows ``[a, b)`` of one column as the port's ``ColumnArrays``."""
    from pinot_tpu_torch.segment.convert import ColumnArrays
    from pinot_tpu_torch.spi.data import DataType, FieldType

    c = frame.columns[col]
    dt = DataType.STRING if c.data_type == "STRING" else DataType.INT
    ft = FieldType.METRIC if c.field_type == "METRIC" else \
        FieldType.DIMENSION
    data = frame.data[col]
    if c.multi_value:
        codes, counts = data[0][a:b].long(), data[1][a:b].long()
        entry = (torch.arange(codes.shape[1], device=codes.device)[None, :]
                 < counts[:, None])
        present = torch.unique(codes[entry])
        lut = torch.zeros(len(c.universe), dtype=torch.long,
                          device=codes.device)
        lut[present] = torch.arange(present.numel(), device=codes.device)
        ids = torch.where(entry, lut[codes], torch.zeros_like(codes))
        return ColumnArrays(dt, ft, np.asarray(c.universe)[_numpy(present)],
                            _numpy(ids.to(torch.int32)),
                            mv_counts=_numpy(counts.to(torch.int32)))
    v = data[a:b]
    if c.encoding == "raw":
        return ColumnArrays(dt, ft, values=_numpy(v.to(torch.int32)))
    uniq, inv = torch.unique(v.long(), sorted=True, return_inverse=True)
    ids = _numpy(inv.to(torch.int32))
    if c.universe is not None:
        dictionary = np.asarray(c.universe)[_numpy(uniq)]
    else:
        dictionary = _numpy(uniq.to(torch.int32))
    return ColumnArrays(dt, ft, dictionary, ids)


class Port:
    """The port's server over the frame's segments."""

    def __init__(self, device: str, server: Dict[str, Any]):
        self.device = device
        self.server = server      # the server's settings, as Pinot's keys
        self.segments: List[Any] = []
        self.executor = None

    def build(self, frame: Frame) -> Tuple[float, float]:
        """Build the segments; -> (seconds preparing the columns, seconds
        in ``segment_from_arrays``)."""
        from pinot_tpu_torch.parallel import ShardedQueryExecutor
        from pinot_tpu_torch.segment.convert import segment_from_arrays
        from pinot_tpu_torch.spi.config import PinotConfiguration

        prep = build = 0.0
        for i, (a, b) in enumerate(frame.segments):
            t0 = time.perf_counter()
            cols = {c: column_arrays(frame, c, a, b) for c in frame.columns}
            t1 = time.perf_counter()
            self.segments.append(segment_from_arrays(
                f"{frame.table}_{i}", b - a, cols, table_name=frame.table))
            build += time.perf_counter() - t1
            prep += t1 - t0
        self.executor = ShardedQueryExecutor(
            device=self.device,
            config=PinotConfiguration(self.server, use_env=False))
        return prep, build

    def compile(self, sql: str):
        from pinot_tpu_torch.query import compile_query

        return compile_query(sql)

    def run(self, ctx) -> Tuple[List[List], Any]:
        """The query's rows on the host and its stats."""
        table, stats = self.executor.execute(ctx, self.segments)
        return table.rows, stats

    def launcher_counters(self) -> Dict[str, float]:
        return dict(self.executor.launcher.stats_snapshot())

    def close(self) -> None:
        """Stop the executor's threads and drop every segment and tensor."""
        from pinot_tpu_torch.common.telemetry import TELEMETRY

        if self.executor is not None:
            self.executor.close()
        TELEMETRY.reset()
        self.executor = None
        self.segments = []
