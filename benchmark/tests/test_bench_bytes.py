"""The byte count: kept segments times each read column's least width."""

import torch

from benchmark.harness.bytecount import query_bytes, segment_widths
from benchmark.harness.frame import Column, Frame


def _frame() -> Frame:
    cols = {"k": Column("STRING", "DIMENSION", universe=list("abcdefgh")),
            "v": Column("INT", "METRIC"),
            "r": Column("INT", "METRIC", encoding="raw"),
            "t": Column("STRING", "DIMENSION", universe=["x", "y"],
                        multi_value=True)}
    data = {"k": torch.tensor([0, 1, 2, 3, 4, 5, 6, 7]),   # 4 a segment
            "v": torch.tensor([1, 1, 1, 1, 2, 3, 4, 5]),
            "r": torch.tensor([9, 9, 9, 9, 9, 9, 9, 9]),
            "t": (torch.tensor([[0, 1]] * 8), torch.tensor([2] * 4 + [1] * 4))}
    return Frame("t", cols, data, [(0, 4), (4, 8)])


def test_widths_from_the_data():
    w = segment_widths(_frame())
    # 4 distinct k a segment: 2 bits; v: 1 value (1 bit, the least), then 4
    assert w[0]["k"] == (2 / 8, 4) and w[1]["k"] == (2 / 8, 4)
    assert w[0]["v"] == (1 / 8, 4) and w[1]["v"] == (2 / 8, 4)
    assert w[0]["r"] == (4.0, 4)
    assert w[0]["t"] == (1 / 8, 8) and w[1]["t"] == (1 / 8, 4)


def test_query_bytes_over_kept_segments():
    f = _frame()
    w = segment_widths(f)
    q = {"select": [{"agg": "sum", "arg": "r"}], "where": [["v", ">=", 2]]}
    # segment 0 (v = 1) is pruned; segment 1 reads v (2 bits) and r (4 B)
    assert query_bytes(f, q, w) == 4 * 2 / 8 + 4 * 4.0
    q = {"select": [{"col": "k"}, {"agg": "count"}], "group_by": ["k"],
         "where": [["t", "=", "y"]]}
    # segment 1's rows hold x alone, so its min/max prunes it: segment 0
    # reads t's 8 entries (1 bit) and k (2 bits) on its 4 rows
    assert query_bytes(f, q, w) == 8 / 8 + 4 * 2 / 8
