"""The port's DataTable wire against the JAX package's.

``pinot_tpu_torch/common/datatable.py`` is a copy of
``pinot_tpu/common/datatable.py`` (oracle: ``tests/test_datatable_wire.py``).
Every response type and column kind round-trips in the port; the legacy
JSON framing decodes; bytes encoded by either package decode in the other
to the same states, rows and schema; and for the same content the two
packages' byte sections after the stats section are equal (the stats
section holds each package's own counters). The port's stats carry the
JAX wire keys, its own counters under their own names, and never the
residency lease.
"""

import json
import math
import struct

import numpy as np
import pytest

from pinot_tpu.common.datatable import DataTable as JDT
from pinot_tpu.engine.results import DataSchema as JSchema
from pinot_tpu.engine.results import QueryStats as JStats
from pinot_tpu_torch.common.datatable import MAGIC, DataTable, ResponseType
from pinot_tpu_torch.engine.results import DataSchema, QueryStats

SCHEMA_COLS = (["s", "i", "f", "o"], ["STRING", "LONG", "DOUBLE", "STRING"])

# name -> a maker of the table's content from one package's classes
CONTENTS = {
    "agg": lambda DT, S, Q: DT.for_aggregation(
        [3, (12.5, 4), float("-inf"), b"\x01sketch", frozenset({"a", "b"}),
         None, 2.25, "123.5", (1.0, 9.0)],
        Q(num_docs_scanned=42, total_docs=100)),
    "agg_empty": lambda DT, S, Q: DT.for_aggregation([], Q()),
    "group_by": lambda DT, S, Q: DT.for_group_by(
        {("east", 2019): [10, 1.5, (2.0, 3)],
         ("west", 2020): [20, -2.5, (1.0, 1)],
         ("north", -(1 << 40)): [1, float("nan"), (0.0, 0)]},
        {"region": "STRING", "year": "INT"},
        Q(num_groups_limit_reached=True, group_by_rung="dense")),
    "group_by_objects": lambda DT, S, Q: DT.for_group_by(
        {(1.5,): [frozenset({1, 2}), b"\x02"], (2.5,): [frozenset(), b""]},
        {"k": "DOUBLE"}, Q()),
    "group_by_empty": lambda DT, S, Q: DT.for_group_by({}, {"k": "INT"},
                                                       Q()),
    "selection": lambda DT, S, Q: DT.for_selection(
        S(*SCHEMA_COLS),
        [["x", 1, 1.5, "p"], ["yy", -9, float("inf"), None],
         ["é", 1 << 62, -0.0, "q"]], Q(), num_hidden=1),
    "selection_sorted": lambda DT, S, Q: DT.for_selection(
        S(["a", "b"], ["INT", "STRING_ARRAY"]),
        [[1, ["x", "y"]], [2, []]], Q(), sorted_rows=True),
    "selection_empty": lambda DT, S, Q: DT.for_selection(
        S(["a"], ["INT"]), [], Q()),
    "distinct": lambda DT, S, Q: DT.for_distinct(
        S(["name", "n"], ["STRING", "LONG"]), [["α", 1], ["b", 2]], Q()),
}


def _port(name):
    return CONTENTS[name](DataTable, DataSchema, QueryStats)


def _jax(name):
    return CONTENTS[name](JDT, JSchema, JStats)


def _same(a, b):
    """Equal, NaN included, types included."""
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    return a == b and type(a) is type(b)


def _content(dt):
    """A package-neutral view of a decoded table."""
    t = dt.response_type.value
    if t == "AGGREGATION":
        body = dt.agg_states() if dt.num_rows() else []
    elif t == "GROUP_BY":
        body = (dt.group_by_groups() if dt.num_rows() else {},
                dt.schema_types())
    else:
        body = (dt.data_schema().to_dict(), dt.rows(), dt.num_hidden,
                dt.selection_sorted)
    return t, body, dt.exceptions


def _sections_after_stats(raw: bytes) -> bytes:
    off = len(MAGIC) + 1
    (n,) = struct.unpack_from("<I", raw, off)
    return raw[off + 4 + n:]


@pytest.mark.parametrize("name", sorted(CONTENTS))
def test_round_trip_in_the_port(name):
    dt = _port(name)
    raw = dt.to_bytes()
    assert raw.startswith(MAGIC)
    out = DataTable.from_bytes(raw)
    assert out.wire_decoded and not dt.wire_decoded
    assert _same(_content(out), _content(dt))
    assert out.stats.to_dict() == dt.stats.to_dict()
    # a decoded table encodes to the same bytes again
    assert out.to_bytes() == raw


@pytest.mark.parametrize("name", sorted(CONTENTS))
def test_legacy_json_framing(name):
    dt = _port(name)
    out = DataTable.from_bytes(dt.to_json_bytes())
    assert out.wire_decoded
    assert _same(_content(out), _content(dt))
    # and across packages
    assert _same(_content(JDT.from_bytes(dt.to_json_bytes())),
                 _content(dt))


@pytest.mark.parametrize("name", sorted(CONTENTS))
def test_bytes_decode_across_packages(name):
    port_raw, jax_raw = _port(name).to_bytes(), _jax(name).to_bytes()
    from_jax = DataTable.from_bytes(jax_raw)
    from_port = JDT.from_bytes(port_raw)
    want = _content(JDT.from_bytes(jax_raw))
    assert _same(_content(from_jax), want)
    assert _same(_content(from_port), want)
    assert from_jax.wire_decoded and from_port.wire_decoded


@pytest.mark.parametrize("name", sorted(CONTENTS))
def test_sections_after_stats_equal_jax(name):
    assert _sections_after_stats(_port(name).to_bytes()) \
        == _sections_after_stats(_jax(name).to_bytes())


def test_column_kinds_and_zero_copy():
    dt = DataTable.from_bytes(_port("selection").to_bytes())
    kinds = [c.kind for c in dt.columns()]
    jkinds = [c.kind for c in JDT.from_bytes(_jax("selection").to_bytes())
              .columns()]
    assert kinds == jkinds == [2, 0, 1, 3]   # str, i64, f64, obj
    i64 = dt.columns()[1].array()
    assert i64.dtype == np.dtype("<i8") and not i64.flags.owndata
    assert dt.columns()[1].take_boxed([2, 0]) == [1 << 62, 1]
    assert dt.columns()[0].take_boxed([2]) == ["é"]


def test_stats_on_the_wire():
    st = QueryStats(num_segments_queried=4, num_docs_scanned=7,
                    total_docs=11, group_by_rung="sort",
                    startree_tree_index=2, reduce_path="device",
                    num_servers_queried=3, num_servers_responded=2,
                    staging={"hits": 1, "stagedBytes": 99},
                    launch={"launches": 1, "batchSize": 2},
                    decisions={"a:b->c:d": 2}, scan_launches=3,
                    batch_general_launches=1, rung_segments={"sort": 2},
                    lease=object())
    st.add_phase_ms("SEGMENT_PRUNING", 0.25)
    d = st.to_dict()
    assert "lease" not in json.dumps(d)
    assert d["scanLaunches"] == 3 and "probeLaunches" not in d
    raw = DataTable.for_aggregation([1], st).to_bytes()
    back = DataTable.from_bytes(raw).stats
    assert back.to_dict() == d and back.lease is None
    # the JAX decoder reads its keys and ignores the port's
    jback = JDT.from_bytes(raw).stats
    assert jback.to_dict() == {k: v for k, v in d.items()
                               if k in jback.to_dict()}
    for k in ("numServersQueried", "reducePath", "phaseTimesMs",
              "startreeTreeIndex", "staging", "launch", "decisions"):
        assert jback.to_dict()[k] == d[k]
    # and the port decodes the JAX stats
    js = JStats(num_docs_scanned=5, reduce_path="oracle",
                decisions={"x:y->z:w": 1})
    got = DataTable.from_bytes(JDT.for_aggregation([1], js).to_bytes()).stats
    assert (got.num_docs_scanned, got.reduce_path, got.decisions) == \
        (5, "oracle", {"x:y->z:w": 1})


def test_stats_merge_sums_servers_and_phases():
    a = QueryStats(num_servers_queried=2, num_servers_responded=2)
    a.add_phase_ms("SEGMENT_PRUNING", 1.0)
    b = QueryStats(reduce_path="vectorized")
    b.add_phase_ms("SEGMENT_PRUNING", 0.5)
    a.merge(b)
    assert (a.num_servers_queried, a.reduce_path, a.phase_ms) == \
        (2, "vectorized", {"SEGMENT_PRUNING": 1.5})


def test_exception_table_and_unknown_kind():
    dt = DataTable.for_exception("boom", ResponseType.GROUP_BY)
    out = DataTable.from_bytes(dt.to_bytes())
    assert out.exceptions == ["boom"] and out.num_rows() == 0
    assert JDT.from_bytes(dt.to_bytes()).exceptions == ["boom"]
    raw = bytearray(_port("selection").to_bytes())
    # corrupt the first column's kind byte: past the exceptions and the
    # schema sections and the (rows, columns, hidden) header
    tail = _sections_after_stats(bytes(raw))
    (exc,) = struct.unpack_from("<I", tail, 0)
    (sch,) = struct.unpack_from("<I", tail, 4 + exc)
    at = len(raw) - len(tail) + 4 + exc + 4 + sch + 8
    assert raw[at] == 2     # the string column
    raw[at] = 9
    with pytest.raises(ValueError, match="column kind"):
        DataTable.from_bytes(bytes(raw))
