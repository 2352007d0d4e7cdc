"""The star-tree in the port against the JAX package's.

Trees: the port's lexsort builder emits ``dims``, ``nodes`` and
``metrics`` byte-equal to ``pinot_tpu.segment.startree.StarTreeBuilder``
on the same inputs (the cases of tests/test_startree.py, derived pairs,
the default tree, SSB's five trees), compared with
``np.testing.assert_array_equal``.

Queries: on segments the JAX package built with its trees (the
tests/test_startree.py fixtures: 4000 ``orders`` rows, two 6000-row
SSB-shaped segments) and their port counterparts (columns carried across
with ``columns_of``, trees built by the port's builder, or carried with
``star_trees_of``), the port's ``ServerQueryExecutor(device="cpu")`` (its
device rung, on the CPU) is held to the JAX executor (its jit device
rung): rows, ``startree:`` decisions, ``startree_tree_index``,
``num_docs_scanned`` and ``group_by_rung``. Float cells agree within
``rel=1e-5, abs=1e-6`` (the port adds sums in no fixed order); every
other cell is exact. The walker, the pick, the matches and the walk are
held to the JAX functions directly.
"""

import numpy as np
import pandas as pd
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.common import tracing  # noqa: E402
from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine import startree_exec as j_exec  # noqa: E402
from pinot_tpu.engine.aggregates import resolve_agg as j_resolve  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.query.expressions import (  # noqa: E402
    Identifier as JIdentifier,
    Predicate as JPredicate,
    PredicateType as JPredicateType,
)
from pinot_tpu.segment import SegmentBuilder as JBuilder  # noqa: E402
from pinot_tpu.segment import load_segment  # noqa: E402
from pinot_tpu.segment import startree as j_tree  # noqa: E402
from pinot_tpu.spi.table import IndexingConfig as JIndexing  # noqa: E402
from pinot_tpu.spi.table import StarTreeIndexConfig as JStarConfig  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import startree_device, startree_exec  # noqa: E402
from pinot_tpu_torch.engine.aggregates import resolve_agg  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import MAX_DEVICE_GROUPS  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.query.expressions import (  # noqa: E402
    Identifier,
    Predicate,
    PredicateType,
)
from pinot_tpu_torch.segment import (  # noqa: E402
    ColumnArrays,
    attach_star_trees,
    columns_of,
    segment_from_arrays,
    star_trees_of,
)
from pinot_tpu_torch.segment.startree import (  # noqa: E402
    _NODE_DTYPE,
    STAR,
    DictIdRange,
    StarTree,
    StarTreeBuilder,
    StarTreeConfig,
)
from pinot_tpu_torch.spi import (  # noqa: E402
    DataType,
    FieldType,
    IndexingConfig,
    StarTreeIndexConfig,
)
from pinot_tpu_torch.tools import ssb  # noqa: E402
from tests.test_startree import (  # noqa: E402
    PARITY_QUERIES,
    SSB_DIMS,
    make_df,
    make_schema,
    ssb_shaped_frame,
    ssb_shaped_schema,
)

pytestmark = pytest.mark.startree

REL, ABS = 1e-5, 1e-6
ORDERS_PAIRS = ["COUNT__*", "SUM__revenue", "MAX__revenue", "MIN__revenue",
                "SUM__units"]
SSB_PAIRS = ["COUNT__*", "SUM__lo_revenue", "SUM__lo_supplycost",
             "MIN__lo_revenue", "MAX__lo_revenue"]
EXPR_PAIRS = ["COUNT__*", "SUM__lo_revenue", "SUM__lo_revenue*lo_quantity",
              "SUM__lo_revenue-lo_supplycost"]


def _port_config(pairs, dims, max_leaf, skip=()):
    return IndexingConfig(star_tree_index_configs=[StarTreeIndexConfig(
        dimensions_split_order=list(dims), function_column_pairs=list(pairs),
        max_leaf_records=max_leaf,
        skip_star_node_creation_for_dimensions=list(skip))])


def _jax_config(pairs, dims, max_leaf, skip=()):
    return JIndexing(star_tree_index_configs=[JStarConfig(
        dimensions_split_order=list(dims), function_column_pairs=list(pairs),
        max_leaf_records=max_leaf,
        skip_star_node_creation_for_dimensions=list(skip))])


def _jax_segment(out, schema, name, frame, cfg):
    JBuilder(schema, name, indexing_config=cfg).build(frame, str(out))
    return load_segment(f"{out}/{name}")


def _port_segment(jseg, table, cfg=None, trees=None):
    """The JAX segment's columns carried across; its trees built by the
    port from them (``cfg``) or carried across (``trees``)."""
    return segment_from_arrays(jseg.segment_name, jseg.num_docs,
                               columns_of(jseg), table_name=table,
                               indexing=cfg, star_trees=trees)


def _assert_trees_equal(jtrees, ttrees):
    assert len(jtrees) == len(ttrees)
    for j, t in zip(jtrees, ttrees):
        assert t.config.to_dict() == j.config.to_dict()
        np.testing.assert_array_equal(t.dims, np.asarray(j.dims))
        assert t.dims.dtype == np.asarray(j.dims).dtype
        np.testing.assert_array_equal(t.nodes, np.asarray(j.nodes))
        assert t.nodes.dtype == np.asarray(j.nodes).dtype
        assert list(t.metrics) == list(j.metrics)
        for k in j.metrics:
            np.testing.assert_array_equal(t.metrics[k],
                                          np.asarray(j.metrics[k]),
                                          err_msg=k)
            assert t.metrics[k].dtype == np.asarray(j.metrics[k]).dtype, k


def _assert_rows(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), what
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=REL, abs=ABS), (what, g, w)
            else:
                assert x == y, (what, g, w)


def _startree_keys(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("startree:")}


def _compare(sql, tsegs, jsegs, port, jax):
    """-> the port's (table, stats), held to the JAX executor's."""
    t, ts = port.execute(t_compile(sql), tsegs)
    j, js = jax.execute(j_compile(sql), jsegs)
    _assert_rows(t.rows, j.rows, sql)
    assert _startree_keys(ts) == _startree_keys(js), (sql, ts.decisions,
                                                      js.decisions)
    for f in ("startree_tree_index", "num_docs_scanned", "group_by_rung",
              "num_segments_processed", "num_segments_matched",
              "total_docs"):
        assert getattr(ts, f) == getattr(js, f), (f, sql, getattr(ts, f),
                                                  getattr(js, f))
    return t, ts


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def executors():
    return {"port": ServerQueryExecutor(device="cpu"),
            "jax": JExecutor(), "jax_host": JExecutor(use_device=False)}


@pytest.fixture(scope="module", params=[10_000, 16],
                ids=["fat-leaves", "deep-split"])
def orders(request, tmp_path_factory):
    """tests/test_startree.py's ``seg_with_tree`` and its port copy, the
    tree built by the port's builder from the carried columns."""
    out = tmp_path_factory.mktemp("torch_st_orders")
    df = make_df()
    dims = ["country", "category", "channel"]
    jseg = _jax_segment(out, make_schema(), "orders_0",
                        {c: df[c].tolist() for c in df.columns},
                        _jax_config(ORDERS_PAIRS, dims, request.param))
    tseg = _port_segment(jseg, "orders",
                         _port_config(ORDERS_PAIRS, dims, request.param))
    return jseg, tseg


def _two_segments(out, prefix, seeds, pairs, dims, max_leaf):
    jsegs, tsegs = [], []
    for i, seed in enumerate(seeds):
        jseg = _jax_segment(out, ssb_shaped_schema(), f"{prefix}_{i}",
                            ssb_shaped_frame(6000, seed=seed),
                            _jax_config(pairs, dims, max_leaf))
        jsegs.append(jseg)
        tsegs.append(_port_segment(jseg, "lineorder_t",
                                   _port_config(pairs, dims, max_leaf)))
    return jsegs, tsegs


@pytest.fixture(scope="module")
def ssb_shaped(tmp_path_factory):
    """tests/test_startree.py's two SSB-shaped segments (max_leaf 64)."""
    return _two_segments(tmp_path_factory.mktemp("torch_st_ssb"), "lot",
                         (50, 51), SSB_PAIRS, SSB_DIMS, 64)


@pytest.fixture(scope="module")
def expr_shaped(tmp_path_factory):
    """tests/test_startree.py's segments with derived pairs."""
    return _two_segments(tmp_path_factory.mktemp("torch_st_expr"), "loe",
                         (90, 91), EXPR_PAIRS,
                         ["d_year", "c_region", "lo_quantity"], 64)


# -- the builder -----------------------------------------------------------------

def _codes(df):
    return {c: pd.Categorical(df[c]).codes.astype(np.int32)
            for c in ("country", "category", "channel")}


@pytest.mark.parametrize("max_leaf,skip", [
    (10_000, []), (16, []), (1, []), (64, ["country"]),
    (8, ["category", "channel"]),
])
def test_builder_byte_equal(max_leaf, skip):
    """test_startree.py:684's cases: every array byte-equal to JAX's."""
    df = make_df(4000, seed=3)
    pairs = [("count", "*"), ("sum", "revenue"), ("min", "revenue"),
             ("max", "revenue"), ("sum", "units")]
    dims = ["country", "category", "channel"]
    mets = {"revenue": df.revenue.to_numpy(), "units": df.units.to_numpy()}
    j = j_tree.StarTreeBuilder(j_tree.StarTreeConfig(
        dims, pairs, max_leaf_records=max_leaf, skip_star_creation=skip)
    ).build(_codes(df), dict(mets), len(df))
    t = StarTreeBuilder(StarTreeConfig(
        dims, pairs, max_leaf_records=max_leaf, skip_star_creation=skip)
    ).build(_codes(df), dict(mets), len(df))
    _assert_trees_equal([j], [t])
    if skip:
        assert not np.any(t.dims[:, dims.index(skip[0])] == STAR)


def test_derived_pair_builder_byte_equal():
    df = make_df(800, seed=31)
    pairs = [("count", "*"), ("sum", "(revenue*units)"),
             ("sum", "(revenue-units)")]
    mets = {"revenue": df.revenue.to_numpy(), "units": df.units.to_numpy()}
    dims = {"country": _codes(df)["country"]}
    j = j_tree.StarTreeBuilder(j_tree.StarTreeConfig(
        ["country"], pairs, max_leaf_records=8)).build(dict(dims),
                                                       dict(mets), len(df))
    t = StarTreeBuilder(StarTreeConfig(["country"], pairs,
                                       max_leaf_records=8)).build(
        dict(dims), dict(mets), len(df))
    _assert_trees_equal([j], [t])


def test_pair_keys_canonicalise_as_jax():
    for p in ("SUM__lo_extendedprice*lo_discount",
              "SUM__lo_revenue-lo_supplycost", "SUM__b*a", "COUNT__*",
              "MAX__x", "SUM__(a+b)*c"):
        spec = StarTreeIndexConfig(["d"], function_column_pairs=[p])
        jspec = JStarConfig(["d"], function_column_pairs=[p])
        assert (StarTreeConfig.from_spi(spec).function_column_pairs
                == j_tree.StarTreeConfig.from_spi(jspec).function_column_pairs)
    with pytest.raises(ValueError):
        StarTreeConfig.from_spi(StarTreeIndexConfig(
            ["d"], function_column_pairs=["SUM__a/b"]))


def test_default_star_tree_equals_jax(tmp_path):
    df = make_df(400, seed=13)
    jseg = _jax_segment(tmp_path, make_schema(), "orders_d",
                        {c: df[c].tolist() for c in df.columns},
                        JIndexing(enable_default_star_tree=True))
    tseg = _port_segment(jseg, "orders",
                         IndexingConfig(enable_default_star_tree=True))
    assert tseg.metadata.star_tree_count == 1
    assert len(tseg.metadata.star_tree_build_s) == 1
    _assert_trees_equal(jseg.star_trees, tseg.star_trees)


def test_tree_rules_skip_with_a_warning(orders, caplog):
    """A dimension that is no dictionary column, or a metric that is not
    numeric, skips its tree (JAX creator.py:227)."""
    jseg, _ = orders
    cols = columns_of(jseg)
    cfg = IndexingConfig(star_tree_index_configs=[
        StarTreeIndexConfig(["country"], function_column_pairs=[
            "SUM__channel"]),
        StarTreeIndexConfig(["revenue"], function_column_pairs=["COUNT__*"]),
        StarTreeIndexConfig(["country"], function_column_pairs=["COUNT__*"]),
    ])
    cols["revenue"] = ColumnArrays(DataType.DOUBLE, FieldType.METRIC,
                                   values=make_df().revenue.to_numpy())
    seg = segment_from_arrays("o", jseg.num_docs, cols, indexing=cfg)
    assert seg.metadata.star_tree_count == 1
    assert seg.star_trees[0].config.function_column_pairs == [("count", "*")]
    assert sum("skipping star-tree" in r.message for r in caplog.records) == 2


def test_ssb_trees_byte_equal_and_carried(tmp_path):
    """``ssb_indexing_config()``'s five trees (the derived pairs
    ``lo_extendedprice*lo_discount`` and ``lo_revenue-lo_supplycost``
    among them) built in the port's process pool equal the JAX creator's,
    and ``star_trees_of`` carries them across unchanged."""
    jsegs = j_ssb.build_segments(0, str(tmp_path), num_segments=2,
                                 rows=12_000, workers=1)
    tsegs, _ = ssb.build_segments(0, num_segments=2, rows=12_000,
                                  star_tree=True, workers=2)
    for j, t in zip(jsegs, tsegs):
        assert t.metadata.star_tree_count == 5
        assert len(t.metadata.star_tree_build_s) == 5
        _assert_trees_equal(j.star_trees, t.star_trees)
        carried = segment_from_arrays("c", t.num_docs, columns_of(t),
                                      star_trees=star_trees_of(j))
        _assert_trees_equal(j.star_trees, carried.star_trees)


# -- the pick --------------------------------------------------------------------

def _pick_segments(tmp_path, configs, name):
    df = make_df(1200, seed=21)
    jcfg = JIndexing(star_tree_index_configs=[
        JStarConfig(**c) for c in configs])
    tcfg = IndexingConfig(star_tree_index_configs=[
        StarTreeIndexConfig(**c) for c in configs])
    jseg = _jax_segment(tmp_path, make_schema(), name,
                        {c: df[c].tolist() for c in df.columns}, jcfg)
    return jseg, _port_segment(jseg, "orders", tcfg)


def _picks(sql, jseg, tseg):
    jctx, tctx = j_compile(sql), t_compile(sql)
    jr, tr = [], []
    jp = j_exec.pick_star_tree(jctx, [j_resolve(f) for f in
                                      jctx.aggregations], jseg,
                               on_decline=jr.append)
    tp = startree_exec.pick_star_tree(tctx, [resolve_agg(f) for f in
                                             tctx.aggregations], tseg,
                                      on_decline=tr.append)
    return (None if jp is None else jp.index, jr), \
        (None if tp is None else tp.index, tr)


PICK_CASES = {
    "cheapest": ([dict(dimensions_split_order=["country", "category"],
                       skip_star_node_creation_for_dimensions=["country"],
                       function_column_pairs=["COUNT__*", "SUM__revenue"],
                       max_leaf_records=4),
                  dict(dimensions_split_order=["category"],
                       function_column_pairs=["COUNT__*", "SUM__revenue"],
                       max_leaf_records=4)],
                 "SELECT sum(revenue) FROM orders WHERE category = 'k3'", 1),
    "tie": ([dict(dimensions_split_order=["country", "category"],
                  function_column_pairs=["COUNT__*", "SUM__revenue"],
                  max_leaf_records=4)] * 2,
            "SELECT sum(revenue) FROM orders WHERE country = 'c1'", 0),
    "second": ([dict(dimensions_split_order=["country"],
                     function_column_pairs=["COUNT__*"],
                     max_leaf_records=4),
                dict(dimensions_split_order=["category", "channel"],
                     function_column_pairs=["COUNT__*", "SUM__revenue"],
                     max_leaf_records=4)],
               "SELECT channel, sum(revenue) FROM orders GROUP BY channel "
               "ORDER BY channel", 1),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_equals_jax(tmp_path, case):
    configs, sql, want = PICK_CASES[case]
    jseg, tseg = _pick_segments(tmp_path, configs, f"pick_{case}")
    j, t = _picks(sql, jseg, tseg)
    assert t == j == (want, [])


def test_most_specific_decline_equals_jax(tmp_path):
    a = dict(dimensions_split_order=["country"],
             function_column_pairs=["COUNT__*"], max_leaf_records=4)
    b = dict(dimensions_split_order=["country", "category"],
             function_column_pairs=["COUNT__*"], max_leaf_records=4)
    for name, configs in (("mt_ab", [a, b]), ("mt_ba", [b, a])):
        jseg, tseg = _pick_segments(tmp_path, configs, name)
        for sql in (
            "SELECT category, sum(revenue) FROM orders GROUP BY category",
            "SELECT count(*) FROM orders WHERE revenue > 3",
            "SELECT channel, count(*) FROM orders GROUP BY channel",
            "SELECT count(*) FROM orders WHERE country LIKE 'c%'",
            "SELECT distinctcount(country) FROM orders",
            "SELECT sum(revenue / units) FROM orders",
            "SELECT count(*) FROM orders WHERE country = 'c1' "
            "OR category = 'k1'",
            "SELECT units + 1, count(*) FROM orders GROUP BY units + 1",
        ):
            j, t = _picks(sql, jseg, tseg)
            assert t == j, (name, sql, j, t)
            assert t[0] is None and len(t[1]) == 1, (name, sql, t)


# -- matches and the walk ----------------------------------------------------------

def _pred(kind, col, **kw):
    return (JPredicate(kind[0], JIdentifier(col), **kw),
            Predicate(kind[1], Identifier(col), **kw))


_EQ = (JPredicateType.EQ, PredicateType.EQ)
_RANGE = (JPredicateType.RANGE, PredicateType.RANGE)
_NOT_IN = (JPredicateType.NOT_IN, PredicateType.NOT_IN)
_IN = (JPredicateType.IN, PredicateType.IN)


@pytest.mark.parametrize("cap", [100_000, 4])
def test_resolve_matches_equal_jax(ssb_shaped, monkeypatch, cap):
    """Sets, DictIdRange past the cap (a RANGE), and the non-contiguous
    overflow's decline (a NOT_IN), as the JAX resolver gives them."""
    monkeypatch.setattr(j_exec, "_MAX_RANGE_IDS", cap)
    monkeypatch.setattr(startree_exec, "_MAX_RANGE_IDS", cap)
    (jseg, *_), (tseg, *_) = ssb_shaped
    cases = [
        [_pred(_RANGE, "p_brand1", lower="C0B0", upper="C0B3",
               lower_inclusive=True, upper_inclusive=True)],
        [_pred(_RANGE, "p_brand1", lower="C0B0", upper="C2B3",
               lower_inclusive=True, upper_inclusive=True),
         _pred(_RANGE, "p_brand1", lower="C1B0", upper="C4B3",
               lower_inclusive=False, upper_inclusive=True)],
        [_pred(_RANGE, "p_brand1", lower="C0B0", upper="C2B3",
               lower_inclusive=True, upper_inclusive=True),
         _pred(_IN, "p_brand1", values=("C1B1", "C3B0"))],
        [_pred(_NOT_IN, "p_brand1", values=("C2B1",))],
        [_pred(_EQ, "c_region", values=("ASIA",)),
         _pred(_RANGE, "d_year", lower=1993, upper=1996,
               lower_inclusive=True, upper_inclusive=True)],
        [_pred(_EQ, "c_region", values=("NOWHERE",))],
    ]
    kinds = set()
    for preds in cases:
        jr, tr = [], []
        jm = j_exec.resolve_matches(jseg, [p[0] for p in preds],
                                    on_decline=jr.append)
        tm = startree_exec.resolve_matches(tseg, [p[1] for p in preds],
                                           on_decline=tr.append)
        assert tr == jr, preds
        if jm is None:
            assert tm is None
            kinds.add("declined")
            continue
        assert set(tm) == set(jm)
        for col, m in jm.items():
            if isinstance(m, j_tree.DictIdRange):
                assert isinstance(tm[col], DictIdRange)
                assert (tm[col].lo, tm[col].hi) == (m.lo, m.hi)
                kinds.add("range")
            else:
                assert tm[col] == m
                kinds.add("set")
    assert kinds == ({"set", "range", "declined"} if cap == 4 else {"set"})


def test_select_records_equal_jax(ssb_shaped):
    """The walk picks the same records, in the same order; a range and
    the set of its ids pick the same ones."""
    (jseg, *_), (tseg, *_) = ssb_shaped
    jt, tt = jseg.star_trees[0], tseg.star_trees[0]
    for matches, group in (
            ({}, []), ({}, ["d_year"]), ({"c_region": {1}}, ["p_brand1"]),
            ({"p_brand1": set(range(3, 10))}, ["d_year"]),
            ({"d_year": {0, 3}, "s_region": {2}}, ["c_region", "p_category"]),
            ({"c_region": set()}, ["d_year"])):
        np.testing.assert_array_equal(tt.select_records(matches, group),
                                      jt.select_records(matches, group))
    as_range = tt.select_records({"p_brand1": DictIdRange(3, 9)}, ["d_year"])
    as_set = tt.select_records({"p_brand1": set(range(3, 10))}, ["d_year"])
    np.testing.assert_array_equal(np.sort(as_range), np.sort(as_set))


WALKER_QUERIES = PARITY_QUERIES + [
    "SELECT d_year, p_brand1, sum(lo_revenue), count(*) FROM lineorder_t "
    "WHERE s_region = 'EUROPE' GROUP BY d_year, p_brand1",
    "SELECT count(*), min(lo_revenue), max(lo_revenue), avg(lo_revenue) "
    "FROM lineorder_t WHERE c_region = 'AMERICA' AND c_region = 'ASIA'",
]


def test_host_walker_equals_jax(orders, ssb_shaped):
    """``execute_with_matches`` gives JAX's states and stats exactly."""
    from pinot_tpu.engine.results import QueryStats as JStats
    from pinot_tpu_torch.engine.results import QueryStats

    jseg, tseg = orders
    pairs = [(sql, jseg, tseg) for sql in PARITY_QUERIES]
    (js, _), (ts, _) = ssb_shaped
    pairs += [(sql, js, ts) for sql in WALKER_QUERIES[len(PARITY_QUERIES):]]
    for sql, j, t in pairs:
        jctx, tctx = j_compile(sql), t_compile(sql)
        jaggs = [j_resolve(f) for f in jctx.aggregations]
        taggs = [resolve_agg(f) for f in tctx.aggregations]
        jp = j_exec.pick_star_tree(jctx, jaggs, j)
        tp = startree_exec.pick_star_tree(tctx, taggs, t)
        jstats, tstats = JStats(), QueryStats()
        jr = j_exec.execute_with_matches(
            jctx, jaggs, j, jp.tree, j_exec.resolve_matches(j, jp.preds),
            jstats)
        tr = startree_exec.execute_with_matches(
            tctx, taggs, t, tp.tree,
            startree_exec.resolve_matches(t, tp.preds), tstats)
        if tctx.group_by:
            assert tr.groups == jr.groups, sql
        else:
            assert tr.states == jr.states, sql
        assert tstats.num_docs_scanned == jstats.num_docs_scanned


# -- the device rung against the JAX executor's ------------------------------------

@pytest.mark.parametrize("sql", PARITY_QUERIES)
def test_device_rung_equals_jax(orders, executors, sql):
    jseg, tseg = orders
    t, ts = _compare(sql, [tseg], [jseg], executors["port"], executors["jax"])
    assert ts.startree_launches == 1
    assert ts.decisions == {"startree:scan->startree_device:tree0": 1}
    if ts.group_by_rung:
        assert ts.group_by_rung == "startree_device"
    # the scan rungs give the same rows
    scan, ss = executors["port"].execute(
        t_compile(sql + " OPTION(useStarTree=false)"), [tseg])
    _assert_rows(t.rows, scan.rows, sql)
    assert not _startree_keys(ss) and ss.startree_launches == 0


def _fuzz_sqls(rng, trials, gpool, aggs_pool, preds_pool, table, min_g):
    out = []
    for _ in range(trials):
        gdims = list(rng.choice(gpool, size=int(rng.integers(min_g, 4)),
                                replace=False))
        aggs = list(rng.choice(aggs_pool, size=int(rng.integers(1, 4)),
                               replace=False))
        preds = list(rng.choice(preds_pool, size=int(rng.integers(0, 3)),
                                replace=False))
        out.append(f"SELECT {', '.join(gdims + aggs)} FROM {table} "
                   + (f"WHERE {' AND '.join(preds)} " if preds else "")
                   + (f"GROUP BY {', '.join(gdims)} "
                      f"ORDER BY {', '.join(gdims)} " if gdims else "")
                   + "LIMIT 100000")
    return out


SSB_FUZZ = _fuzz_sqls(
    np.random.default_rng(7), 20, SSB_DIMS,
    ["count(*)", "sum(lo_revenue)", "sum(lo_supplycost)", "min(lo_revenue)",
     "max(lo_revenue)", "avg(lo_revenue)"],
    ["c_region = 'ASIA'", "s_region IN ('AMERICA', 'EUROPE')",
     "p_category = 'C1'", "p_brand1 BETWEEN 'C1B0' AND 'C3B2'",
     "d_year BETWEEN 1993 AND 1996", "d_year IN (1992, 1995, 1998)"],
    "lineorder_t", 1)
EXPR_FUZZ = _fuzz_sqls(
    np.random.default_rng(23), 12, ["d_year", "c_region", "lo_quantity"],
    ["sum(lo_revenue * lo_quantity)", "sum(lo_quantity * lo_revenue)",
     "sum(lo_revenue - lo_supplycost)", "avg(lo_revenue * lo_quantity)",
     "count(*)"],
    ["c_region = 'ASIA'", "d_year BETWEEN 1993 AND 1996",
     "lo_quantity < 25", "d_year IN (1992, 1995)"],
    "lineorder_t", 0)


def test_device_rung_fuzz_equals_jax(ssb_shaped, expr_shaped, executors):
    """tests/test_startree.py's SSB-shaped and derived-pair fuzz: the
    port's rung against JAX's device rung, every query on a tree."""
    for sqls, (jsegs, tsegs) in ((SSB_FUZZ, ssb_shaped),
                                 (EXPR_FUZZ, expr_shaped)):
        for sql in sqls:
            _, ts = _compare(sql, tsegs, jsegs, executors["port"],
                             executors["jax"])
            assert ts.startree_tree_index == 0, sql
            assert ts.decisions == {
                "startree:scan->startree_device:tree0": 2}, sql


def test_carried_trees_answer_as_built(ssb_shaped, executors):
    """Trees carried across with ``star_trees_of`` give the rows and
    stats of the trees the port built."""
    jsegs, tsegs = ssb_shaped
    carried = [_port_segment(j, "lineorder_t", trees=star_trees_of(j))
               for j in jsegs]
    ex = ServerQueryExecutor(device="cpu")
    for sql in SSB_FUZZ[:6]:
        a, sa = ex.execute(t_compile(sql), tsegs)
        b, sb = ex.execute(t_compile(sql), carried)
        assert a.rows == b.rows, sql
        assert sa.decisions == sb.decisions
        assert sa.num_docs_scanned == sb.num_docs_scanned


def test_empty_slice_launches_nothing(ssb_shaped, executors):
    jsegs, tsegs = ssb_shaped
    for sql in ("SELECT d_year, sum(lo_revenue) FROM lineorder_t "
                "WHERE c_region = 'AMERICA' AND c_region = 'ASIA' "
                "GROUP BY d_year ORDER BY d_year",
                "SELECT count(*), sum(lo_revenue), min(lo_revenue), "
                "avg(lo_revenue) FROM lineorder_t WHERE c_region = 'NOWHERE'"):
        t, ts = _compare(sql, tsegs, jsegs, executors["port"],
                         executors["jax"])
        assert ts.startree_launches == 0 and ts.num_docs_scanned == 0
        assert set(ts.decisions) == {"startree:scan->startree_device:tree0"}


def test_almost_eligible_declines_equal_jax(ssb_shaped, expr_shaped,
                                            executors):
    """Queries one rule short fall to the scan rungs with JAX's codes."""
    for sql, segs in (
        ("SELECT d_year, sum(lo_revenue) FROM lineorder_t "
         "WHERE c_region = 'ASIA' OR s_region = 'ASIA' "
         "GROUP BY d_year ORDER BY d_year", ssb_shaped),
        ("SELECT lo_quantity, sum(lo_revenue) FROM lineorder_t "
         "WHERE c_region = 'ASIA' GROUP BY lo_quantity "
         "ORDER BY lo_quantity LIMIT 100", ssb_shaped),
        ("SELECT d_year, summv(tags) FROM lineorder_t GROUP BY d_year "
         "ORDER BY d_year", ssb_shaped),
        ("SELECT d_year, sum(lo_quantity) FROM lineorder_t GROUP BY d_year "
         "ORDER BY d_year", ssb_shaped),
        ("SELECT d_year, sum(lo_revenue * lo_quantity + lo_supplycost) "
         "FROM lineorder_t GROUP BY d_year ORDER BY d_year", expr_shaped),
        ("SELECT sum(lo_revenue / lo_quantity) FROM lineorder_t "
         "WHERE c_region = 'ASIA'", expr_shaped),
    ):
        jsegs, tsegs = segs
        t, ts = executors["port"].execute(t_compile(sql), tsegs)
        j, js = executors["jax_host"].execute(j_compile(sql), jsegs)
        _assert_rows(t.rows, j.rows, sql)
        assert _startree_keys(ts) == _startree_keys(js), sql
        assert len(_startree_keys(ts)) == 1
        assert ts.startree_tree_index is None and ts.startree_launches == 0


def test_opt_out_and_upsert_decline(ssb_shaped, executors):
    jsegs, tsegs = ssb_shaped
    sql = ("SELECT d_year, sum(lo_revenue) FROM lineorder_t "
           "GROUP BY d_year ORDER BY d_year")
    t, ts = executors["port"].execute(
        t_compile(sql + " OPTION(useStarTree=false)"), tsegs)
    assert not _startree_keys(ts) and ts.startree_launches == 0
    want, _ = executors["port"].execute(t_compile(sql), tsegs)
    _assert_rows(t.rows, want.rows, sql)
    # an upsert-managed segment: the records do not see the bitmap
    valid = np.ones(tsegs[0].num_docs, dtype=bool)
    valid[::3] = False
    useg = segment_from_arrays(tsegs[0].segment_name, tsegs[0].num_docs,
                               columns_of(tsegs[0]), valid_doc_ids=valid,
                               star_trees=star_trees_of(tsegs[0]))
    u, us = executors["port"].execute(t_compile(sql), [useg])
    assert _startree_keys(us) == {
        "startree:startree->scan:startree_upsert_valid_docs": 1}
    jseg = jsegs[0]
    jseg.valid_doc_ids = valid
    try:
        j, js = executors["jax_host"].execute(j_compile(sql), [jseg])
    finally:
        jseg.valid_doc_ids = None
    assert _startree_keys(js) == _startree_keys(us)
    _assert_rows(u.rows, j.rows, sql)


def test_group_space_over_cap_goes_to_the_walker(tmp_path, executors):
    """A node plan past MAX_DEVICE_GROUPS raises PlanError: the walker
    serves, recorded as the JAX executor records it."""
    n = 6000
    rng = np.random.default_rng(5)
    card = 3000
    frame = {"a": rng.integers(0, card, n), "b": rng.integers(0, card, n),
             "m": rng.integers(0, 100, n)}
    from pinot_tpu.spi import DataType as JDT
    from pinot_tpu.spi import FieldSpec as JFS
    from pinot_tpu.spi import FieldType as JFT
    from pinot_tpu.spi import Schema as JSchema

    schema = JSchema("wide", [JFS("a", JDT.INT), JFS("b", JDT.INT),
                              JFS("m", JDT.LONG, JFT.METRIC)])
    jseg = _jax_segment(tmp_path, schema, "wide_0",
                        {k: v.tolist() for k, v in frame.items()},
                        _jax_config(["COUNT__*", "SUM__m"], ["a", "b"], 16))
    tseg = _port_segment(jseg, "wide",
                         _port_config(["COUNT__*", "SUM__m"], ["a", "b"], 16))
    cards = [tseg.metadata.column(c).cardinality for c in ("a", "b")]
    assert cards[0] * cards[1] > MAX_DEVICE_GROUPS
    sql = "SELECT a, b, sum(m), count(*) FROM wide GROUP BY a, b LIMIT 100000"
    t, ts = _compare(sql, [tseg], [jseg], executors["port"],
                     executors["jax"])
    assert ts.decisions == {
        "startree:startree_device->startree_host:"
        "startree_group_space_over_limit": 1,
        "startree:scan->startree:tree0": 1}
    assert ts.group_by_rung == "startree" and ts.startree_launches == 0
    assert len(t.rows) > 1000


def _star_row0_segment(card: int):
    """A segment of two ``card``-value dimensions and a hand-made tree
    whose record 0 is the root's star child: STAR (-1) in both grouped
    dimensions, so every padding slot of the gather reads a key below
    the base."""
    n = 4
    cols = {
        "d0": ColumnArrays(DataType.INT, FieldType.DIMENSION,
                           dictionary=np.arange(card),
                           dict_ids=np.array([0, card - 1, 0, card - 1])),
        "d1": ColumnArrays(DataType.INT, FieldType.DIMENSION,
                           dictionary=np.arange(card),
                           dict_ids=np.array([0, card - 1, card - 1, 0])),
        "m": ColumnArrays(DataType.LONG, FieldType.METRIC,
                          dictionary=np.array([5, 7]),
                          dict_ids=np.array([0, 1, 1, 0])),
    }
    seg = segment_from_arrays("star0", n, cols, table_name="star0")
    dims = np.array([[STAR, STAR], [0, 0], [0, card - 1], [card - 1, 0],
                     [card - 1, card - 1]], dtype=np.int32)
    # root splits d0: value 0 -> records 1-2, value card-1 -> 3-4 (leaves),
    # star -> record 0
    nodes = np.array([(0, STAR, 0, 5, 1, 4), (-1, 0, 1, 3, -1, -1),
                      (-1, card - 1, 3, 5, -1, -1), (-1, STAR, 0, 1, -1, -1)],
                     dtype=_NODE_DTYPE)
    cfg = StarTreeConfig(["d0", "d1"], [("count", "*"), ("sum", "m")], 1)
    metrics = {"count__*": np.array([4, 1, 1, 1, 1], dtype=np.int64),
               "sum__m": np.array([24.0, 5.0, 7.0, 7.0, 5.0])}
    attach_star_trees(seg, [{"config": cfg.to_dict(), "dims": dims,
                             "nodes": nodes, "metrics": metrics}])
    return seg


@pytest.mark.parametrize("card,rung", [(8, "dense"), (400, "hash")])
def test_star_in_record_zero_pads_safely(card, rung):
    """Record 0 holds STAR in both grouped dimensions: the 124 padding
    slots gather it (keys of -1 - base); the mask keeps them out of every
    scatter (an out-of-range index raises on the CPU), on the dense rung
    and the hash rung alike. Rows equal the walker's."""
    from pinot_tpu_torch.engine import kernels

    seg = _star_row0_segment(card)
    tree = seg.star_trees[0]
    sql = ("SELECT d0, d1, sum(m), count(*) FROM star0 GROUP BY d0, d1 "
           "LIMIT 100")
    ctx = t_compile(sql)
    matches = {}
    idx = tree.select_records(matches, ["d0", "d1"])
    np.testing.assert_array_equal(np.sort(idx), [1, 2, 3, 4])
    ex = ServerQueryExecutor(device="cpu")
    t, ts = ex.execute(ctx, [seg])
    assert ts.decisions == {"startree:scan->startree_device:tree0": 1}
    assert ts.startree_launches == 1
    from pinot_tpu_torch.engine.plan import plan_star_tree

    plan = plan_star_tree(ctx, seg, tree, matches, idx.size)
    assert plan.spec[-1] == 128
    assert bool(kernels.sparse_mode(plan.spec)) == (rung == "hash")
    aggs = [resolve_agg(f) for f in ctx.aggregations]
    walker = startree_exec.execute_with_matches(ctx, aggs, seg, tree, {})
    assert {tuple(r[:2]): r[2:] for r in t.rows} == {
        k: [s[0], s[1]] for k, s in walker.groups.items()}
    assert sorted(tuple(r) for r in t.rows) == [
        (0, 0, 5.0, 1), (0, card - 1, 7.0, 1), (card - 1, 0, 7.0, 1),
        (card - 1, card - 1, 5.0, 1)]


def test_node_columns_staged_and_released(ssb_shaped):
    jsegs, tsegs = ssb_shaped
    ex = ServerQueryExecutor(device="cpu")
    ex.execute(t_compile("SELECT d_year, sum(lo_revenue) FROM lineorder_t "
                         "GROUP BY d_year"), tsegs)
    staged = ex.stage(tsegs[0])
    per_tree = staged.startree_nbytes()
    tree = tsegs[0].star_trees[0]
    assert list(per_tree) == [0]
    # int32 per dimension, 8 bytes per pair
    assert per_tree[0] == tree.num_records * (4 * len(SSB_DIMS)
                                              + 8 * len(SSB_PAIRS))
    before = staged.nbytes()
    assert staged.release_startree(0) == per_tree[0]
    assert staged.nbytes() == before - per_tree[0]
    assert staged.release_startree(0) == 0
    ex.execute(t_compile("SELECT count(*) FROM lineorder_t "
                         "WHERE c_region = 'ASIA'"), tsegs)
    assert ex.stage(tsegs[0]).startree_nbytes() == per_tree


def test_sharded_executor_routes_per_segment(ssb_shaped):
    """A tree fit leaves the batch: each segment's node slice serves,
    as in the JAX sharded executor; no batch is staged."""
    jsegs, tsegs = ssb_shaped
    bex = ShardedQueryExecutor(device="cpu")
    sql = ("SELECT d_year, p_brand1, sum(lo_revenue), count(*) "
           "FROM lineorder_t WHERE s_region = 'EUROPE' "
           "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1 "
           "LIMIT 100000")
    _, ts = _compare(sql, tsegs, jsegs, bex, JSharded())
    assert ts.group_by_rung == "startree_device"
    assert ts.num_segments_processed == 2 and ts.startree_launches == 2
    assert bex.batches_staged == 0 and ts.batch_general_launches == 0
    # no tree fits: the batch serves
    t, ts = bex.execute(t_compile(
        "SELECT d_year, sum(lo_quantity) FROM lineorder_t GROUP BY d_year"),
        tsegs)
    assert bex.batches_staged == 1 and not _startree_keys(ts)


def test_every_reason_code_is_registered(ssb_shaped, expr_shaped, orders,
                                         executors):
    """Every ``startree:`` decision the port records uses a code the JAX
    package registers (``tracing.STARTREE_DECISION_REASONS``, a chosen
    tree, or the node plan's classified PlanError), and every code the
    port's module names is registered."""
    import re

    registered = tracing.STARTREE_DECISION_REASONS
    seen = set()
    for sql, (jsegs, tsegs) in (
        ("SELECT d_year, sum(lo_revenue) FROM lineorder_t "
         "WHERE c_region = 'ASIA' OR s_region = 'ASIA' GROUP BY d_year",
         ssb_shaped),
        ("SELECT lo_quantity + 1, sum(lo_revenue) FROM lineorder_t "
         "GROUP BY lo_quantity + 1", ssb_shaped),
        ("SELECT lo_quantity, sum(lo_revenue) FROM lineorder_t "
         "GROUP BY lo_quantity", ssb_shaped),
        ("SELECT count(*) FROM lineorder_t WHERE lo_revenue > 5",
         ssb_shaped),
        ("SELECT count(*) FROM lineorder_t WHERE p_brand1 LIKE 'C1%'",
         ssb_shaped),
        ("SELECT summv(tags) FROM lineorder_t", ssb_shaped),
        ("SELECT sum(lo_revenue / lo_quantity) FROM lineorder_t",
         expr_shaped),
        ("SELECT sum(lo_quantity) FROM lineorder_t WHERE d_year = 1994",
         ssb_shaped),
        ("SELECT d_year, sum(lo_revenue) FROM lineorder_t GROUP BY d_year",
         ssb_shaped),
    ):
        _, s = executors["port"].execute(t_compile(sql), tsegs)
        seen |= {k.rsplit(":", 1)[1] for k in _startree_keys(s)}
    trees = {c for c in seen if tracing.STARTREE_TREE_REASON.match(c)}
    assert trees == {"tree0"}
    assert seen - trees <= registered, seen - trees
    assert {"startree_filter_or_not_shape", "startree_group_expression",
            "startree_group_off_split_order", "startree_filter_non_dimension",
            "startree_predicate_type_unsupported",
            "startree_agg_not_pairable", "startree_expression_agg_no_pair",
            "startree_missing_function_pair"} <= seen
    src = open(startree_exec.__file__).read()
    named = set(re.findall(r'"(startree_[a-z_]+)"', src))
    assert named and named <= registered, named - registered
    # the node plan's PlanError classifies as the JAX package's does
    from pinot_tpu_torch.engine.errors import classify_decline

    msg = "star-tree group key space too large -> host walker"
    assert classify_decline(msg) == tracing.classify_decline(msg) \
        == "startree_group_space_over_limit"
    assert startree_device.STARTREE_COUNTER.name == "startree_node_slice"


# -- SSB with the five trees: chip_smoke's phase 12 at a small size ------------------

@pytest.fixture(scope="module")
def ssb_trees(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_st_ssb5")
    jsegs = j_ssb.build_segments(0, str(out), num_segments=2, rows=24_000,
                                 workers=1)
    tsegs, _ = ssb.build_segments(0, num_segments=2, rows=24_000,
                                  star_tree=True, workers=1)
    return jsegs, tsegs


def test_ssb_flights_on_the_device_rung_as_jax(ssb_trees):
    """All 13 flights served by ``startree_device`` through both port
    executors with the JAX executor's tree (tests/test_ssb.py:127 for
    JAX), no scan and no general-rung call; rows, decisions, tree index,
    docs scanned and rung equal to the JAX executors'."""
    import chip_smoke

    jsegs, tsegs = ssb_trees
    for port, jax in ((ServerQueryExecutor(device="cpu"), JExecutor()),
                      (ShardedQueryExecutor(device="cpu"), JSharded())):
        for qid, sql in sorted(ssb.QUERIES.items()):
            _, ts = _compare(sql + " LIMIT 100000", tsegs, jsegs, port, jax)
            ti = chip_smoke.FLIGHT_TREE[qid]
            assert ts.startree_tree_index == ti, qid
            assert set(ts.decisions) == {
                f"startree:scan->startree_device:tree{ti}"}, qid
            assert ts.general_launches == 0 and ts.index_launches == 0
            assert ts.batch_general_launches == 0
            if ts.group_by_rung:
                assert ts.group_by_rung == "startree_device"


def test_ssb_other_routes_as_jax(ssb_trees):
    """Phase 12b's queries: the decisions the JAX executor records."""
    jsegs, tsegs = ssb_trees
    port, jax = ServerQueryExecutor(device="cpu"), JExecutor()
    for qid, sql in ssb.STARTREE_QUERIES.items():
        t, ts = port.execute(t_compile(sql), tsegs)
        j, js = jax.execute(j_compile(sql), jsegs)
        assert sorted(map(tuple, t.rows)) == sorted(map(tuple, j.rows)), qid
        assert _startree_keys(ts) == _startree_keys(js), qid
        assert ts.group_by_rung == js.group_by_rung, qid


def test_chip_smoke_phase_12_small():
    """chip_smoke's phase 12 (its oracle, routes and launch checks) on
    the CPU at a small size, the trees built in a process pool."""
    import chip_smoke

    run = chip_smoke.phase_startree(0.004, 2, 42, 1, device="cpu")
    assert sorted(run["flights"]) == sorted(ssb.QUERIES)
    assert {q: r["tree"] for q, r in run["flights"].items()} \
        == chip_smoke.FLIGHT_TREE
    assert run["routes"]["ST1"]["route"] == "walker"
    assert run["routes"]["ST1"]["records"] > 0
    assert set(run["trees"]) == {f"tree{i}" for i in range(5)}
    assert run["staged_bytes"] > 0
    # 13c: node arrays demoted and promoted under a budget, and concurrent
    # identical queries sharing node-slice launches
    budget = run["budget"]
    assert budget["passes"][1]["demotions"] > 0
    assert budget["passes"][1]["promotions"] \
        == budget["passes"][1]["misses"] > 0
    assert budget["flight_hits"] > 0
