"""The port's broker reduce and device merge against the JAX package's.

``pinot_tpu_torch/broker/reduce.py`` and ``parallel/reduce_device.py``
are copies of ``pinot_tpu/broker/reduce.py`` and
``pinot_tpu/parallel/reduce_device.py`` (the merge as PyTorch ops, run
here with ``device="cpu"``; JAX's runs on the 8 virtual CPU devices of
``tests/conftest.py``). Oracle: ``tests/test_reduce_device.py``,
``tests/test_reduce_vectorized.py``. The same DataTables (built by each
package's constructors from the same content, or by the port's servers and
handed to JAX as the same content) go to both services on each rung:
device, vectorized host and the row oracle. The results are bit-identical
(cells and their types) and the ``reduce:`` decisions equal, on the SSB
flights, the forced sort rung, the ``numGroupsLimit`` trim, the
``deviceReduce`` option, every decline the port keeps, ``reducePath``
across the wire and mixed response types. ``device_group_merge`` is held
leaf by leaf to JAX's on the same ``(comp, space, vals, ops)``. The two
declines the port does not copy are absent from its registry and its
modules.
"""

import math
import random

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.broker.reduce import BrokerReduceService as JReduce  # noqa: E402
from pinot_tpu.broker.reduce import MixedResponseTypeError as JMixed  # noqa: E402
from pinot_tpu.common import tracing  # noqa: E402
from pinot_tpu.common.datatable import DataTable as JDT  # noqa: E402
from pinot_tpu.engine.results import DataSchema as JSchema  # noqa: E402
from pinot_tpu.engine.results import QueryStats as JStats  # noqa: E402
from pinot_tpu.parallel import reduce_device as j_rdev  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.broker import reduce as t_reduce  # noqa: E402
from pinot_tpu_torch.broker.reduce import (  # noqa: E402
    BrokerReduceService,
    MixedResponseTypeError,
)
from pinot_tpu_torch.common.datatable import DataTable  # noqa: E402
from pinot_tpu_torch.engine.results import DataSchema, QueryStats  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import reduce_device as t_rdev  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402

pytestmark = pytest.mark.reduce_device

NOT_COPIED = ("reduce_device_kernel_error", "reduce_device_mesh_unavailable")


def _services(**kw):
    """(port, jax) services per rung."""
    return {
        "device": (BrokerReduceService(device="cpu", device_reduce=True,
                                       **kw),
                   JReduce(vectorized=True, device_reduce=True, **kw)),
        "vectorized": (BrokerReduceService(device="cpu", **kw),
                       JReduce(vectorized=True, **kw)),
        "oracle": (BrokerReduceService(device="cpu", vectorized=False, **kw),
                   JReduce(vectorized=False, **kw)),
    }


def _cells_identical(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_cells_identical(x, y) for x, y in zip(a, b)))
    return a == b and type(a) is type(b)


def assert_bit_identical(got, want, label=""):
    assert got.schema.to_dict() == want.schema.to_dict(), label
    assert len(got.rows) == len(want.rows), (label, len(got.rows),
                                             len(want.rows))
    for rg, rw in zip(got.rows, want.rows):
        assert _cells_identical(rg, rw), (label, rg, rw)


def _reduce_keys(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("reduce:")}


def _pair_tables(build):
    """The same content as (port tables, JAX tables), in process."""
    return (build(DataTable, DataSchema, QueryStats),
            build(JDT, JSchema, JStats))


def _wire(tables):
    return [type(t).from_bytes(t.to_bytes()) for t in tables]


def run_both(sql, tables, rung, wire=False, **kw):
    """(port result, port stats, JAX result, JAX stats) on ``rung``; the
    results bit-identical and the reduce decisions equal."""
    port_svc, jax_svc = _services(**kw)[rung]
    pt, jt = tables
    if wire:
        pt, jt = _wire(pt), _wire(jt)
    pr, ps, pe = port_svc.reduce(t_compile(sql), pt)
    jr, js, je = jax_svc.reduce(j_compile(sql), jt)
    assert_bit_identical(pr, jr, (rung, sql))
    assert _reduce_keys(ps) == _reduce_keys(js), (rung, sql)
    assert ps.reduce_path == js.reduce_path, (rung, sql)
    assert ps.num_groups_limit_reached == js.num_groups_limit_reached
    assert pe == je
    return pr, ps, jr, js


def _gb_build(seed, n_servers, per_server, aggs_fn, key_fn,
              schema_types=None):
    """A maker of group-by tables from one seeded content."""
    rng = random.Random(seed)
    content = []
    for _ in range(n_servers):
        groups = {}
        for _ in range(per_server):
            groups.setdefault(key_fn(rng), aggs_fn(rng))
        content.append(groups)
    types = schema_types or {"k1": "STRING", "k2": "INT"}
    return lambda DT, S, Q: [DT.for_group_by(dict(g), types, Q())
                             for g in content]


PARITY_SQL = [
    "SELECT k1, k2, sum(v), count(*) FROM t GROUP BY k1, k2 LIMIT 100000",
    "SELECT k1, k2, sum(v), count(*), min(v), max(v) FROM t "
    "GROUP BY k1, k2 ORDER BY sum(v) DESC, k1 LIMIT 97",
    "SELECT k2, count(*) FROM t GROUP BY k2, k1 "
    "ORDER BY count(*) DESC, k2 LIMIT 13, 29",
    "SELECT k1, sum(v) FROM t GROUP BY k1, k2 "
    "HAVING sum(v) > 300 ORDER BY k1, sum(v) LIMIT 50",
]


def _parity_tables(sql, seed):
    ctx = t_compile(sql)
    names = [str(f) for f in ctx.aggregations]

    def aggs_fn(r):
        states = {"sum(v)": float(r.randint(0, 1000)),
                  "count(*)": r.randint(1, 50),
                  "min(v)": float(r.randint(-100, 100)),
                  "max(v)": float(r.randint(-100, 100))}
        return [states[n] for n in names]

    return _pair_tables(_gb_build(
        seed, 5, 400, aggs_fn,
        lambda r: ("b%02d" % r.randint(0, 25), r.randint(0, 40))))


@pytest.mark.parametrize("rung", ["device", "vectorized", "oracle"])
@pytest.mark.parametrize("sql", PARITY_SQL)
def test_group_by_parity_on_each_rung(sql, rung, eight_devices):
    tables = _parity_tables(sql, PARITY_SQL.index(sql) + 11)
    pr, ps, _, _ = run_both(sql, tables, rung)
    assert ps.reduce_path == {"device": "device",
                              "vectorized": "vectorized",
                              "oracle": "oracle"}[rung]
    # and every rung gives the same answer
    if rung != "oracle":
        orr, _, _, _ = run_both(sql, tables, "oracle")
        assert_bit_identical(pr, orr, sql)


@pytest.mark.parametrize("sql", PARITY_SQL[:2])
def test_forced_sort_rung_parity(sql, monkeypatch, eight_devices):
    monkeypatch.setattr(t_rdev, "DENSE_SLOTS", 1)
    monkeypatch.setattr(j_rdev, "DENSE_SLOTS", 1)
    tables = _parity_tables(sql, 5)
    svc = BrokerReduceService(device="cpu", device_reduce=True)
    acc = svc.accumulator(t_compile(sql))
    for t in tables[0]:
        acc.add(t)
    acc.finish()
    assert acc.merge_rung == "sort"
    pr, ps, _, _ = run_both(sql, tables, "device")
    assert ps.reduce_path == "device"
    orr, _, _, _ = run_both(sql, tables, "oracle")
    assert_bit_identical(pr, orr)


def test_sort_rung_on_wide_i64_keys(eight_devices):
    """A key space past the dense slots takes the sort rung by itself."""
    sql = ("SELECT k, sum(v), count(*) FROM t GROUP BY k "
           "ORDER BY sum(v) DESC, k LIMIT 500")
    tables = _pair_tables(_gb_build(
        3, 6, 500, lambda r: [float(r.randint(0, 9999)), r.randint(1, 5)],
        lambda r: (r.randint(-(1 << 40), 1 << 40),),
        schema_types={"k": "LONG"}))
    acc = BrokerReduceService(device="cpu", device_reduce=True) \
        .accumulator(t_compile(sql))
    for t in tables[0]:
        acc.add(t)
    acc.finish()
    assert acc.merge_rung == "sort"
    _, ps, _, _ = run_both(sql, tables, "device")
    assert ps.reduce_path == "device"


@pytest.mark.parametrize("rung", ["device", "vectorized", "oracle"])
def test_num_groups_limit_trim(rung, eight_devices):
    sql = "SELECT k, count(*) FROM t GROUP BY k LIMIT 100000"
    tables = _pair_tables(_gb_build(
        2, 4, 60, lambda r: [r.randint(1, 9)],
        lambda r: (r.randint(0, 999),), schema_types={"k": "INT"}))
    pr, ps, _, _ = run_both(sql, tables, rung, num_groups_limit=50)
    assert ps.num_groups_limit_reached and len(pr.rows) == 50


def test_device_reduce_option(eight_devices):
    tables = _pair_tables(_gb_build(
        4, 3, 40, lambda r: [r.randint(1, 9)],
        lambda r: (r.randint(0, 30),), schema_types={"k": "INT"}))
    base = "SELECT k, count(*) FROM t GROUP BY k LIMIT 1000"
    _, on, _, _ = run_both(base + " OPTION(deviceReduce=true)", tables,
                           "vectorized")
    assert on.reduce_path == "device"
    _, off, _, _ = run_both(base + " OPTION(deviceReduce=false)", tables,
                            "device")
    assert off.reduce_path == "vectorized" and not _reduce_keys(off)
    _, ora, _, _ = run_both(base + " OPTION(vectorizedReduce=false)",
                            tables, "device")
    assert ora.reduce_path == "oracle"
    # off by default, as JAX's
    assert BrokerReduceService(device="cpu").device_reduce is False


# -- every decline the port keeps ---------------------------------------------

def _decl(*pairs):
    return {f"reduce:{a}:{r}": 1 for a, r in pairs}


DEV_HOST = "device->host"
VEC_ROW = "vectorized->row_path"

DECLINES = {
    "obj_state": (
        "SELECT k, avg(v), count(*) FROM t GROUP BY k LIMIT 100",
        lambda DT, S, Q: [
            DT.for_group_by({("a",): [(3.0, 2), 2], ("b",): [(1.0, 1), 1]},
                            {}, Q()),
            DT.for_group_by({("a",): [(5.0, 1), 1]}, {}, Q())],
        _decl((DEV_HOST, "reduce_device_obj_state"))),
    "nan_key": (
        "SELECT k, count(*) FROM t GROUP BY k LIMIT 100",
        lambda DT, S, Q: [
            DT.for_group_by({(1.5,): [3], (float("nan"),): [5]},
                            {"k": "DOUBLE"}, Q()),
            DT.for_group_by({(1.5,): [2], (2.5,): [1]}, {"k": "DOUBLE"},
                            Q())],
        _decl((DEV_HOST, "reduce_device_nan_key"))),
    "i64_sum_bound": (
        "SELECT k, sum(v) FROM t GROUP BY k LIMIT 10",
        lambda DT, S, Q: [DT.for_group_by({("a",): [1 << 61]}, {}, Q()),
                          DT.for_group_by({("a",): [1 << 61]}, {}, Q())],
        _decl((DEV_HOST, "reduce_device_i64_sum_bound"),
              (VEC_ROW, "reduce_i64_sum_bound"))),
    "key_space_overflow": (
        "SELECT k1, k2, count(*) FROM t GROUP BY k1, k2 LIMIT 100",
        lambda DT, S, Q: [
            DT.for_group_by({(0, 0): [1], (1 << 40, 1 << 40): [2]},
                            {"k1": "LONG", "k2": "LONG"}, Q()),
            DT.for_group_by({(0, 0): [3], (1 << 40, 0): [4]},
                            {"k1": "LONG", "k2": "LONG"}, Q())],
        _decl((DEV_HOST, "reduce_device_key_space_overflow"))),
    "f64_sum_order": (
        "SELECT k, sum(v) FROM t GROUP BY k LIMIT 100",
        lambda DT, S, Q: [DT.for_group_by({("a",): [1.5]}, {}, Q()),
                          DT.for_group_by({("a",): [2.25]}, {}, Q())],
        _decl((DEV_HOST, "reduce_device_f64_sum_order"))),
    "group_key_not_sortable": (
        "SELECT k, count(*) FROM t GROUP BY k ORDER BY count(*) DESC "
        "LIMIT 10",
        lambda DT, S, Q: [
            DT.for_group_by({("a",): [3], (None,): [5]}, {}, Q()),
            DT.for_group_by({("a",): [2], ("b",): [1]}, {}, Q())],
        _decl((VEC_ROW, "reduce_group_key_not_sortable"))),
    "column_kind_mismatch": (
        "SELECT k, sum(v) FROM t GROUP BY k LIMIT 10",
        lambda DT, S, Q: [DT.for_group_by({("a",): [3]}, {}, Q()),
                          DT.for_group_by({("a",): [2.5]}, {}, Q())],
        _decl((VEC_ROW, "reduce_column_kind_mismatch"))),
    "nan_numeric_state": (
        "SELECT k, min(v) FROM t GROUP BY k LIMIT 10",
        lambda DT, S, Q: [
            DT.for_group_by({("a",): [float("nan")]}, {}, Q()),
            DT.for_group_by({("a",): [2.0]}, {}, Q())],
        _decl((VEC_ROW, "reduce_nan_numeric_state"))),
    "nan_order_key": (
        "SELECT x FROM t ORDER BY x LIMIT 5",
        lambda DT, S, Q: [
            DT.for_selection(S(["x"], ["DOUBLE"]), [[1.0], [float("nan")]],
                             Q(), sorted_rows=True),
            DT.for_selection(S(["x"], ["DOUBLE"]), [[0.5]], Q(),
                             sorted_rows=True)],
        _decl((VEC_ROW, "reduce_nan_order_key"))),
    "order_key_not_sortable": (
        "SELECT x FROM t ORDER BY x LIMIT 5",
        lambda DT, S, Q: [
            DT.for_selection(S(["x"], ["BYTES"]), [[b"a"], [b"c"]], Q()),
            DT.for_selection(S(["x"], ["BYTES"]), [[b"b"]], Q())],
        _decl((VEC_ROW, "reduce_order_key_not_sortable"))),
    "distinct_key_not_sortable": (
        "SELECT DISTINCT x FROM t LIMIT 5",
        lambda DT, S, Q: [
            DT.for_distinct(S(["x"], ["STRING"]), [["a"], [None]], Q()),
            DT.for_distinct(S(["x"], ["STRING"]), [["a"], ["b"]], Q())],
        _decl((VEC_ROW, "reduce_distinct_key_not_sortable"))),
}


@pytest.mark.parametrize("name", sorted(DECLINES))
def test_every_kept_decline_with_its_code(name, eight_devices):
    sql, build, want = DECLINES[name]
    tables = _pair_tables(build)
    pr, ps, _, _ = run_both(sql, tables, "device")
    assert _reduce_keys(ps) == want
    orr, _, _, _ = run_both(sql, tables, "oracle")
    assert_bit_identical(pr, orr, name)
    for k in want:
        reason = k.rsplit(":", 1)[1]
        assert reason in (t_reduce.REDUCE_DEVICE_REASONS
                          | t_reduce.REDUCE_DECISION_REASONS)


def test_decline_rows_over_capacity(monkeypatch, eight_devices):
    monkeypatch.setattr(t_rdev, "MAX_MERGE_ROWS", 16)
    monkeypatch.setattr(j_rdev, "MAX_MERGE_ROWS", 16)
    tables = _pair_tables(_gb_build(
        6, 4, 50, lambda r: [r.randint(1, 9)],
        lambda r: (r.randint(0, 999),), schema_types={"k": "INT"}))
    _, ps, _, _ = run_both("SELECT k, count(*) FROM t GROUP BY k LIMIT 1000",
                           tables, "device")
    assert _reduce_keys(ps) == _decl(
        (DEV_HOST, "reduce_device_rows_over_capacity"))
    assert ps.reduce_path == "vectorized"


def test_cross_process_and_reduce_path_across_the_wire(eight_devices):
    sql = "SELECT k, sum(v) FROM t GROUP BY k LIMIT 1000"
    tables = _pair_tables(_gb_build(
        9, 3, 80, lambda r: [float(r.randint(0, 100))],
        lambda r: (r.randint(0, 40),), schema_types={"k": "INT"}))
    pr, ps, _, _ = run_both(sql, tables, "device", wire=True)
    assert _reduce_keys(ps) == _decl(
        (DEV_HOST, "reduce_device_cross_process"))
    assert ps.reduce_path == "vectorized"
    vr, _, _, _ = run_both(sql, tables, "vectorized", wire=True)
    assert_bit_identical(pr, vr)
    # reducePath rides the stats section, in both directions
    st = QueryStats(reduce_path="device")
    back = DataTable.from_bytes(
        DataTable.for_group_by({("a",): [1]}, {}, st).to_bytes())
    assert back.stats.reduce_path == "device" and back.wire_decoded
    assert JDT.from_bytes(DataTable.for_group_by(
        {("a",): [1]}, {}, st).to_bytes()).stats.reduce_path == "device"


def test_mixed_response_types_raise(eight_devices):
    sql = "SELECT k, count(*) FROM t GROUP BY k LIMIT 10"

    def build(DT, S, Q):
        return [DT.for_group_by({("a",): [1]}, {}, Q()),
                DT.for_aggregation([3], Q())]

    pt, jt = _pair_tables(build)
    with pytest.raises(JMixed):
        JReduce(vectorized=True).reduce(j_compile(sql), jt)
    for rung in ("device", "vectorized", "oracle"):
        with pytest.raises(MixedResponseTypeError, match="disagree"):
            _services()[rung][0].reduce(t_compile(sql), pt)


def test_exceptions_reach_the_response(eight_devices):
    """A partial failure reduces the answering servers' tables and returns
    the failed one's message; with no answer at all the reduce raises."""
    sql = "SELECT k, count(*) FROM t GROUP BY k LIMIT 10"

    def build(DT, S, Q):
        return [DT.for_group_by({("a",): [1]}, {}, Q()),
                DT.for_exception("server 2 down")]

    pt, _ = _pair_tables(build)
    pr, _, pe = BrokerReduceService(device="cpu").reduce(t_compile(sql), pt)
    assert pe == ["server 2 down"] and pr.rows == [["a", 1]]
    run_both(sql, _pair_tables(build), "device")
    with pytest.raises(Exception, match="server 2 down"):
        BrokerReduceService(device="cpu").reduce(
            t_compile(sql), [DataTable.for_exception("server 2 down")])


@pytest.mark.parametrize("rung", ["vectorized", "oracle"])
@pytest.mark.parametrize("shape", ["agg", "selection", "selection_ordered",
                                   "distinct", "distinct_having"])
def test_other_response_types(shape, rung, eight_devices):
    sqls = {
        "agg": "SELECT count(*), sum(v), min(v), avg(v), "
               "distinctcount(v) FROM t",
        "selection": "SELECT x, y FROM t LIMIT 4 OFFSET 1",
        "selection_ordered": "SELECT x FROM t ORDER BY y DESC, x LIMIT 5 "
                             "OFFSET 1",
        "distinct": "SELECT DISTINCT x, y FROM t ORDER BY y, x LIMIT 6",
        "distinct_having": "SELECT DISTINCT y FROM t HAVING y > 1 "
                           "ORDER BY y LIMIT 10",
    }
    rng = random.Random(7)
    rows = [[[f"s{rng.randint(0, 5)}", rng.randint(0, 4)]
             for _ in range(8)] for _ in range(3)]

    def build(DT, S, Q):
        if shape == "agg":
            return [DT.for_aggregation(
                [i + 3, float(10 * i), float(-i), (float(i), i + 1),
                 frozenset({i, i + 1})], Q()) for i in range(3)]
        if shape == "selection":
            return [DT.for_selection(S(["x", "y"], ["STRING", "INT"]), r,
                                     Q()) for r in rows]
        if shape == "selection_ordered":
            return [DT.for_selection(
                S(["x", "y"], ["STRING", "INT"]),
                sorted(r, key=lambda v: (-v[1], v[0])), Q(), num_hidden=1,
                sorted_rows=True) for r in rows]
        if shape == "distinct":
            return [DT.for_distinct(S(["x", "y"], ["STRING", "INT"]),
                                    [list(v) for v in dict.fromkeys(
                                        tuple(x) for x in r)], Q())
                    for r in rows]
        return [DT.for_distinct(S(["y"], ["INT"]),
                                [[v] for v in dict.fromkeys(x[1] for x in r)],
                                Q()) for r in rows]

    tables = _pair_tables(build)
    pr, ps, _, _ = run_both(sqls[shape], tables, rung)
    orr, _, _, _ = run_both(sqls[shape], tables, "oracle")
    assert_bit_identical(pr, orr, shape)
    if rung == "vectorized":
        assert ps.reduce_path == "vectorized" and not _reduce_keys(ps)


# -- the SSB flights, from the port's servers ---------------------------------

@pytest.fixture(scope="module")
def ssb_server_tables(tmp_path_factory):
    """Each flight's DataTables from 2 port servers over 2 JAX-built
    segments each, and the same content as JAX tables."""
    jsegs = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_reduce_ssb")), num_segments=4,
        seed=3, rows=24_000, star_tree=False, workers=1)
    tsegs = [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                 table_name="ssb_lineorder") for j in jsegs]
    servers = [(ShardedQueryExecutor(device="cpu"), tsegs[:2]),
               (ShardedQueryExecutor(device="cpu"), tsegs[2:])]
    out = {}
    for qid, q in j_ssb.QUERIES.items():
        sql = q + " LIMIT 100000"
        port = [ex.execute_instance(t_compile(sql), part)
                for ex, part in servers]
        jax = [_as_jax(t) for t in port]
        whole = ShardedQueryExecutor(device="cpu").execute(
            t_compile(sql), tsegs)[0]
        out[qid] = (sql, (port, jax), whole)
    return out


def _as_jax(t):
    """The same content as an in-process JAX table."""
    st = JStats(num_docs_scanned=t.stats.num_docs_scanned,
                total_docs=t.stats.total_docs)
    rt = t.response_type.value
    if rt == "GROUP_BY":
        return JDT.for_group_by(t.group_by_groups(), t.schema_types(), st)
    return JDT.for_aggregation(t.agg_states(), st)


@pytest.mark.parametrize("rung", ["device", "vectorized", "oracle"])
@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_ssb_flights_on_each_rung(ssb_server_tables, qid, rung,
                                  eight_devices):
    sql, tables, whole = ssb_server_tables[qid]
    pr, ps, _, _ = run_both(sql, tables, rung)
    grouped = t_compile(sql).is_group_by \
        and any(t.num_rows() for t in tables[0])
    if rung == "device":
        assert ps.reduce_path == ("device" if grouped else "vectorized")
        assert not _reduce_keys(ps)
    # the broker's answer is the single executor's over every segment
    assert_bit_identical(pr, whole, qid)
    wr, ws, _, _ = run_both(sql, tables, rung, wire=True)
    assert_bit_identical(wr, pr, qid)
    if rung == "device" and grouped:
        assert _reduce_keys(ws) == _decl(
            (DEV_HOST, "reduce_device_cross_process"))


# -- the device merge, leaf by leaf -------------------------------------------

def _merge_case(seed, n, key_hi, ops):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, key_hi, n).astype(np.int64),
            np.asarray([f"s{v}" for v in rng.integers(0, 7, n)],
                       dtype=object)]
    comp, space = t_rdev.encode_composite_keys(keys)
    jcomp, jspace = j_rdev.encode_composite_keys(keys)
    assert space == jspace and np.array_equal(comp, jcomp)
    vals = []
    for i, op in enumerate(ops):
        if i % 2:
            vals.append(rng.integers(-50, 50, n).astype(np.int64))
        else:
            vals.append(rng.integers(-1000, 1000, n).astype(np.float64))
    return comp, space, vals


@pytest.mark.parametrize("rung", ["dense", "sort"])
@pytest.mark.parametrize("n", [1, 7, 300, 4099])
def test_device_group_merge_leaf_by_leaf(rung, n, monkeypatch,
                                         eight_devices):
    if rung == "sort":
        monkeypatch.setattr(t_rdev, "DENSE_SLOTS", 0)
        monkeypatch.setattr(j_rdev, "DENSE_SLOTS", 0)
    ops = ["sum", "sum", "min", "max", "min", "max"]
    comp, space, vals = _merge_case(n, n, 97, ops)
    assert t_rdev.merge_rung(space) == rung
    first, folded = t_rdev.device_group_merge(comp, space, vals, ops, "cpu")
    jfirst, jfolded = j_rdev.device_group_merge(j_rdev.broker_mesh(), comp,
                                                space, vals, ops)
    assert first.dtype == np.int64 and np.array_equal(first, jfirst)
    assert len(folded) == len(jfolded)
    for got, want in zip(folded, jfolded):
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_merge_helpers_match_jax():
    for n in (0, 1, 7, 8, 9, 1000, 4097):
        assert t_rdev._merge_cap(n) == j_rdev._merge_cap(n, 1)
    for dt in (np.int64, np.float64, np.int32):
        a = np.zeros(1, dtype=dt)
        for op in ("sum", "min", "max"):
            assert t_rdev._pad_identity(a, op) == j_rdev._pad_identity(a,
                                                                        op)
    for arr in (np.array([1.0, 2.0]), np.array([1.5]),
                np.array([np.inf]), np.array([2.0 ** 53])):
        assert t_rdev.f64_sum_exact(arr) == j_rdev.f64_sum_exact(arr)
    for keys in ([np.array([1.5, -0.0, 0.0, 2.5])],
                 [np.array([1 << 61, 0]), np.array([0, 3])]):
        got, want = (t_rdev.encode_composite_keys(keys),
                     j_rdev.encode_composite_keys(keys))
        assert got[1] == want[1]
        assert (got[0] is None and want[0] is None) \
            or np.array_equal(got[0], want[0])


# -- the registry and the declines not copied ---------------------------------

def test_registry_is_jax_less_the_two_not_copied():
    assert t_reduce.REDUCE_DECISION_REASONS \
        == tracing.REDUCE_DECISION_REASONS
    assert t_reduce.REDUCE_DEVICE_REASONS \
        == tracing.REDUCE_DEVICE_REASONS - set(NOT_COPIED)
    for code in NOT_COPIED:
        assert code in tracing.REDUCE_DEVICE_REASONS
        assert code not in t_reduce.REDUCE_DEVICE_REASONS
    for mod in (t_reduce, t_rdev):
        src = open(mod.__file__).read()
        for code in NOT_COPIED:
            assert code not in src, (mod.__name__, code)
        assert "except Exception" not in src


def test_every_recorded_code_is_registered():
    """Each ``_decline`` / ``_decline_device`` call site names a
    registered code."""
    import re

    src = open(t_reduce.__file__).read()
    vec = set(re.findall(r'self\._decline\("([a-z0-9_]+)"\)', src))
    dev = set(re.findall(r'self\._decline_device\("([a-z0-9_]+)"\)', src))
    assert vec == t_reduce.REDUCE_DECISION_REASONS
    assert dev == t_reduce.REDUCE_DEVICE_REASONS


def test_a_failed_merge_raises(monkeypatch):
    """No catch-all: a merge that fails raises in the query."""
    def boom(*a, **k):
        raise RuntimeError("synthetic merge failure")

    monkeypatch.setattr(t_rdev, "device_group_merge", boom)
    pt, _ = _pair_tables(_gb_build(
        8, 2, 30, lambda r: [r.randint(1, 9)],
        lambda r: (r.randint(0, 20),), schema_types={"k": "INT"}))
    with pytest.raises(RuntimeError, match="synthetic merge failure"):
        BrokerReduceService(device="cpu", device_reduce=True).reduce(
            t_compile("SELECT k, count(*) FROM t GROUP BY k LIMIT 100"), pt)


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        BrokerReduceService()
    with pytest.raises(RuntimeError, match="cuda"):
        t_rdev.device_group_merge(np.zeros(1, np.int64), 1,
                                  [np.zeros(1)], ["sum"])
