"""The port's four repaired divergences from the JAX package, each on
JAX-built segments carried across with ``columns_of``:

- the ``numGroupsLimit`` trim: 14 segments of 8000 distinct ``uid``, the
  last segment's ``v`` largest; the merged groups are cut to the first
  100 000 in insertion order, so the top 5 come from the first 13
  segments, with ``num_groups_limit_reached`` set;
- the virtual columns ``$docId`` / ``$segmentName`` / ``$hostName``: known
  columns the planner refuses with JAX's reason code;
- the metadata answer of a filter-less COUNT(*) / MIN / MAX / MINMAXRANGE:
  no scan, ``num_docs_scanned`` 0 per segment; the batch path scans, as
  JAX's sharded executor does;
- the segment pruner: min/max and partition pruning on a time-bounded
  and a partitioned SSB layout and a two-partition table, the same
  segments kept on every path, pruned docs counted in ``total_docs``;
- the filter-blind caches: on a reused executor, a context of the same
  SQL whose filter was rewritten (``dataclasses.replace``) is served the
  rewritten filter's rows on every path (per segment with the fused scan
  on and off, the batch, the ordered selection on the top-k), equal to
  the JAX executors reused the same way; the plan cache holds its
  segments by weak reference.

Each is held against the JAX executor with ``use_pallas=False`` (port:
``use_fused_scan=False``), ``use_pallas=True`` in interpret mode (port:
the fused scan on) and the JAX sharded executor (port: the batch path).
Tolerance: counts, integer sums, min/max and keys exact.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine.aggregates import resolve_agg as j_resolve  # noqa: E402
from pinot_tpu.engine.plan import PlanError as JPlanError  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.engine.pruner import prune_segments as j_prune  # noqa: E402
from pinot_tpu.engine.results import QueryStats as JStats  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import (  # noqa: E402
    DataType,
    FieldSpec,
    FieldType,
    IndexingConfig,
    Schema,
    SegmentPartitionConfig,
)
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine.aggregates import resolve_agg as t_resolve  # noqa: E402
from pinot_tpu_torch.engine.errors import QueryError  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.pruner import prune_segments as t_prune  # noqa: E402
from pinot_tpu_torch.engine.results import QueryStats  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_torch_columns import build_stats  # noqa: E402
from tests.test_torch_executor import _assert_rows, carry  # noqa: E402
from tests.test_torch_general_rung import SELECTIVE_SQL, _hash_frame  # noqa: E402

GL_SQL = "SELECT uid, sum(v) FROM gl GROUP BY uid ORDER BY sum(v) DESC LIMIT 5"
STATS_FIELDS = ("num_segments_processed", "num_segments_pruned",
                "num_segments_matched", "num_docs_scanned", "total_docs",
                "num_groups_limit_reached")


def _gl_segments(out, num_segments, per_segment, seed=3):
    """``num_segments`` segments of ``per_segment`` distinct uids each
    (disjoint), distinct ``v`` within a segment, the last segment's ``v``
    above every other's."""
    rng = np.random.default_rng(seed)
    uids = rng.permutation(num_segments * per_segment)
    schema = Schema("gl", [FieldSpec("uid", DataType.INT),
                           FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    jsegs = []
    for i in range(num_segments):
        v = rng.permutation(10 ** 6)[:per_segment]
        if i == num_segments - 1:
            v = v + 10 ** 7
        u = uids[i * per_segment:(i + 1) * per_segment]
        SegmentBuilder(schema, f"gl_{i}").build(
            {"uid": u.tolist(), "v": v.tolist()}, str(out))
        jsegs.append(load_segment(str(out / f"gl_{i}")))
    return jsegs, carry(jsegs, "gl")


def _partition_table(out):
    """Four segments of a Modulo-2-partitioned ``yr`` and a Murmur-4
    ``city``: each segment holds one partition of each, and its yr values
    span the others' (yr = 1993 lies within every segment's min/max, so
    only the partitions can prune)."""
    rng = np.random.default_rng(17)
    cities = ["oslo", "rome", "lima", "kiev", "doha", "baku", "riga", "bern"]
    spc = SegmentPartitionConfig(column_partition_map={
        "yr": {"functionName": "Modulo", "numPartitions": 2},
        "city": {"functionName": "Murmur", "numPartitions": 4}})
    schema = Schema("pt", [FieldSpec("yr", DataType.INT),
                           FieldSpec("city", DataType.STRING),
                           FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    from pinot_tpu.utils.partition import get_partition_function

    murmur = get_partition_function("Murmur", 4)
    by_part = {}
    for c in cities:
        by_part.setdefault(murmur.partition(c), []).append(c)
    parts = sorted(by_part)
    jsegs = []
    for i in range(4):
        n = 2000
        years = np.array([1990, 1992, 1994, 1996]) + (i % 2)
        city = by_part[parts[i % len(parts)]]
        frame = {"yr": years[rng.integers(0, 4, n)].tolist(),
                 "city": np.array(city)[rng.integers(0, len(city), n)].tolist(),
                 "v": rng.integers(0, 1000, n).tolist()}
        SegmentBuilder(schema, f"pt_{i}", indexing_config=IndexingConfig(
            segment_partition_config=spc)).build(frame, str(out))
        jsegs.append(load_segment(str(out / f"pt_{i}")))
    return jsegs, carry(jsegs, "pt")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp
    jssb = j_ssb.build_segments(0, str(tmp("faults_ssb")), num_segments=4,
                                seed=5, rows=16_000, star_tree=False,
                                workers=1)
    jpart = j_ssb.build_segments(0, str(tmp("faults_ssbp")), num_segments=4,
                                 seed=5, rows=16_000, star_tree=False,
                                 workers=1, partitioned=True)
    hw = Schema("hw", [FieldSpec("a", DataType.STRING),
                       FieldSpec("b", DataType.STRING),
                       FieldSpec("year", DataType.INT),
                       FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    out = tmp("faults_hw")
    jhw = []
    for i in range(2):
        SegmentBuilder(hw, f"hw_{i}").build(_hash_frame(11 + i, False),
                                            str(out))
        jhw.append(load_segment(str(out / f"hw_{i}")))
    return {"gl": _gl_segments(tmp("faults_gl"), 14, 8000),
            "gl_small": _gl_segments(tmp("faults_gls"), 4, 1500, seed=4),
            "stats": build_stats(tmp("faults_stats")),
            "ssb": (jssb, carry(jssb, "ssb_lineorder")),
            "ssb_part": (jpart, carry(jpart, "ssb_lineorder")),
            "pt": _partition_table(tmp("faults_pt")),
            "hw": (jhw, carry(jhw, "hw"))}


# port path -> the JAX executor it is held to
PATHS = {"port_on": "pallas", "port_off": "jnp", "port_batch": "sharded"}


def _port(path, **kw):
    if path == "port_batch":
        return ShardedQueryExecutor(device="cpu", **kw)
    return ServerQueryExecutor(device="cpu",
                               use_fused_scan=path == "port_on", **kw)


def _jax(ref, **kw):
    if ref == "sharded":
        return JSharded(use_pallas=True, **kw)
    if ref == "sharded_jnp":
        return JSharded(use_pallas=False, **kw)
    if ref == "host":
        return JExecutor(use_device=False, **kw)
    return JExecutor(use_device=True, use_pallas=ref == "pallas", **kw)


def _same(data, key, sql, path, ref=None, **kw):
    """Rows and stats of the port path against its JAX executor."""
    jsegs, tsegs = data[key]
    got, stats = _port(path, **kw).execute(t_compile(sql), tsegs)
    want, jstats = _jax(ref or PATHS[path], **kw).execute(j_compile(sql),
                                                           jsegs)
    assert got.schema.column_names == want.schema.column_names
    _assert_rows(got.rows, want.rows, [True] * len(want.schema.column_names),
                 f"{path}: {sql}")
    for f in STATS_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), (path, f, sql)
    return got, stats, jstats


# -- 1. the numGroupsLimit trim ---------------------------------------------

@pytest.mark.parametrize("path", ["port_on", "port_off"])
def test_groups_limit_trim_matches_jax(data, path):
    """The ROADMAP repro: 112 000 groups cut to JAX's first 100 000 (the
    JAX jnp rung and host engine; the Pallas interpret run of 14 segments
    x 8000 groups takes a minute, so the smaller case below holds the
    trim to it)."""
    got, stats, _ = _same(data, "gl", GL_SQL, path, ref="jnp")
    host, hstats = _jax("host").execute(j_compile(GL_SQL), data["gl"][0])
    assert got.rows == host.rows and hstats.num_groups_limit_reached
    assert stats.num_groups_limit_reached
    # the untrimmed answer would come from the last segment
    _, tsegs = data["gl"]
    full, fstats = _port(path, num_groups_limit=10 ** 6).execute(
        t_compile(GL_SQL), tsegs)
    assert not fstats.num_groups_limit_reached
    assert full.rows[0][1] > 10 ** 7 > got.rows[0][1]


def test_groups_limit_trim_batch_path(data):
    """112 000 groups over one batch exceed the fused scan's key space:
    the jnp combine runs, its merged compact holds more live groups than
    the compact cap, and the per-segment path serves and trims, as in the
    JAX sharded executor (held here to its jnp combine: the Pallas
    interpret run of 14 segments x 8000 groups takes a minute)."""
    got, stats, jstats = _same(data, "gl", GL_SQL, "port_batch",
                               ref="sharded_jnp")
    assert stats.num_groups_limit_reached
    overflow = ("sharded_combine:sharded_combine->per_segment:"
                "compact_cap_overflow")
    assert stats.decisions[overflow] == jstats.decisions[overflow] == 1
    assert stats.decisions[
        "pallas:pallas_combine->jnp_combine:pallas_too_many_groups"] == 1
    assert stats.batch_general_launches == 1


@pytest.mark.parametrize("path", sorted(PATHS))
def test_groups_limit_trim_small_limit(data, path):
    """6000 groups in 4 segments cut to 4000 on every path (the batch one
    launch over the batch, decoded in the unified dictionary's order)."""
    _, stats, _ = _same(data, "gl_small", GL_SQL, path,
                        num_groups_limit=4000)
    assert stats.num_groups_limit_reached


def _insertion_order(ex, compile_, resolve, ctx_sql, segs, stats):
    ctx = compile_(ctx_sql)
    aggs = [resolve(f) for f in ctx.aggregations]
    return list(ex._execute_group_by(ctx, aggs, segs, stats).groups)


@pytest.mark.parametrize("rung_sql", [
    ("dense", "SELECT a, count(*) FROM hw WHERE v < 30 GROUP BY a"),
    ("hash", SELECTIVE_SQL),
    ("compact", "SELECT a, b, sum(v) FROM hw WHERE a < 'a040' "
                "GROUP BY a, b LIMIT 100000"),
], ids=lambda p: p[0])
@pytest.mark.parametrize("path", ["port_on", "port_off"])
def test_merged_groups_keep_jax_insertion_order(data, path, rung_sql):
    """The trim keeps groups in insertion order, so the merged groups must
    enter in JAX's order: segment by segment, each in decode order."""
    rung, sql = rung_sql
    jsegs, tsegs = data["hw"]
    stats = QueryStats()
    got = _insertion_order(_port(path), t_compile, t_resolve, sql, tsegs,
                           stats)
    want = _insertion_order(_jax(PATHS[path]), j_compile, j_resolve, sql,
                            jsegs, JStats())
    assert got == want
    assert stats.group_by_rung == rung


# -- 2. virtual columns -------------------------------------------------------

VIRTUAL_SQL = [
    "SELECT count(*) FROM stats WHERE $docId < 10",
    "SELECT $segmentName, count(*) FROM stats GROUP BY $segmentName",
    "SELECT sum($docId) FROM stats",
    "SELECT team, count(*) FROM stats WHERE $hostName != 'h' GROUP BY team",
]


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("sql", VIRTUAL_SQL)
def test_virtual_columns_raise_with_the_jax_code(data, path, sql):
    """JAX admits the virtual columns and serves them on its host engine
    with its planner's code; the port now does the same on every path
    (it raised NotPortedError with that code before the host engine was
    ported): the JAX rows, and the decision recorded per segment."""
    from tests.test_torch_host_engine import assert_same_answer, run

    jsegs, tsegs = data["stats"]
    with pytest.raises(JPlanError) as je:
        j_plan(j_compile(sql), jsegs[0])
    assert je.value.reason_code in ("virtual_column_predicate",
                                    "group_virtual_column",
                                    "value_virtual_column")
    got = run(_port(path), t_compile, sql, tsegs)
    assert_same_answer(got, run(_jax(PATHS[path]), j_compile, sql, jsegs),
                       f"{path}: {sql}")
    table, stats = got
    assert table.rows
    assert stats.decisions[f"plan:device_kernel->host_engine:"
                           f"{je.value.reason_code}"] == len(tsegs)


def test_unknown_column_is_still_a_query_error(data):
    _, tsegs = data["stats"]
    for path in PATHS:
        with pytest.raises(QueryError) as e:
            _port(path).execute(t_compile("SELECT count(*) FROM stats "
                                          "WHERE $rowId < 3"), tsegs)
        assert type(e.value) is QueryError


# -- 3. the metadata answer ---------------------------------------------------

METADATA_SQL = [
    "SELECT count(*), max(runs), min(year) FROM stats",
    "SELECT minmaxrange(salary), min(year), max(ratio), count(*) FROM stats",
]


@pytest.mark.parametrize("sql", METADATA_SQL)
@pytest.mark.parametrize("path", ["port_on", "port_off"])
def test_metadata_answer_per_segment(data, path, sql):
    """No scan and no launch: num_docs_scanned 0, total_docs every doc."""
    _, stats, _ = _same(data, "stats", sql, path)
    assert stats.num_docs_scanned == 0 and stats.total_docs == 3000
    assert (stats.scan_launches, stats.general_launches, stats.decisions) \
        == (0, 0, {})


@pytest.mark.parametrize("sql", METADATA_SQL)
def test_metadata_answer_not_on_the_batch(data, sql):
    """JAX's sharded executor sends a query over more than one segment to
    its batch scan before any metadata answer: every doc is scanned. A
    single segment takes the per-segment path and its metadata answer."""
    _, stats, _ = _same(data, "stats", sql, "port_batch")
    assert stats.num_docs_scanned == 3000
    jsegs, tsegs = data["stats"]
    _, one = _port("port_batch").execute(t_compile(sql), tsegs[:1])
    _, jone = _jax("sharded").execute(j_compile(sql), jsegs[:1])
    assert one.num_docs_scanned == jone.num_docs_scanned == 0


@pytest.mark.parametrize("sql", [
    "SELECT count(*), sum(runs) FROM stats",          # sum is no metadata
    "SELECT min(bonus), count(*) FROM stats",         # bonus has nulls
    "SELECT count(*) FROM stats WHERE team = 'BOS'",  # a filter
    "SELECT team, max(runs) FROM stats GROUP BY team",
])
@pytest.mark.parametrize("path", ["port_on", "port_off"])
def test_metadata_answer_declines_as_jax(data, path, sql):
    _, stats, _ = _same(data, "stats", sql, path)
    assert stats.num_docs_scanned > 0


def test_metadata_answer_skips_upsert_segments(data):
    """An upsert segment's metadata counts invalid docs: it scans."""
    from pinot_tpu_torch.segment import columns_of, segment_from_arrays

    _, tsegs = data["stats"]
    valid = np.arange(tsegs[0].num_docs) % 3 != 0
    useg = segment_from_arrays("stats_u", tsegs[0].num_docs,
                               columns_of(tsegs[0]), table_name="stats",
                               valid_doc_ids=valid)
    table, stats = _port("port_on").execute(
        t_compile("SELECT count(*) FROM stats"), [useg])
    assert table.rows == [[int(valid.sum())]]
    assert stats.num_docs_scanned == int(valid.sum())


# -- 4. the segment pruner ----------------------------------------------------

PRUNE_SQL = {
    "ssb": [j_ssb.QUERIES[q] + " LIMIT 100000" for q in sorted(j_ssb.QUERIES)]
    + ["SELECT count(*) FROM ssb_lineorder WHERE d_year = 2050",
       "SELECT count(*) FROM ssb_lineorder WHERE d_year > 1995 "
       "OR d_yearmonthnum < 199203",
       "SELECT count(*) FROM ssb_lineorder WHERE NOT d_year = 1992"],
    "ssb_part": ["SELECT d_year, sum(lo_revenue) FROM ssb_lineorder "
                 "WHERE d_year = 1994 GROUP BY d_year",
                 "SELECT count(*) FROM ssb_lineorder "
                 "WHERE d_year IN (1992, 1995)",
                 "SELECT count(*) FROM ssb_lineorder "
                 "WHERE d_year BETWEEN 1993 AND 1994 AND s_region = 'ASIA'"],
    "pt": ["SELECT count(*), sum(v) FROM pt WHERE yr = 1993",
           "SELECT city, sum(v) FROM pt WHERE city = 'rome' GROUP BY city",
           "SELECT count(*) FROM pt WHERE yr IN (1990, 1991) "
           "AND city IN ('oslo', 'lima')",
           "SELECT count(*) FROM pt WHERE yr = 1993 OR city = 'doha'"],
}
PRUNE_CASES = [(k, i) for k, qs in PRUNE_SQL.items() for i in range(len(qs))]
# executed on every path: the flights the pruner cuts (Q1.x, Q3.4, Q4.2,
# Q4.3; the others keep every segment, and tests/test_torch_general_rung.py
# and tests/test_torch_combine.py run them) and the other tables' queries
EXEC_CASES = [c for c in PRUNE_CASES
              if c[0] != "ssb" or c[1] in (0, 1, 2, 9, 11, 12, 13, 14, 15)]


def _kept(prune, compile_, sql, segs):
    return [s.segment_name for s in prune(compile_(sql), segs)]


@pytest.mark.parametrize("case", PRUNE_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_pruner_keeps_jax_segments(data, case):
    key, i = case
    sql = PRUNE_SQL[key][i]
    jsegs, tsegs = data[key]
    assert _kept(t_prune, t_compile, sql, tsegs) == \
        _kept(j_prune, j_compile, sql, jsegs)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case", EXEC_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_pruned_execution_matches_jax(data, path, case):
    key, i = case
    _same(data, key, PRUNE_SQL[key][i], path)


def test_partition_pruning_prunes_within_min_max(data):
    """yr = 1993 lies in every segment's min/max; the Modulo partitions
    keep only the odd-year segments, and the Murmur partitions of city
    keep one segment for one city."""
    jsegs, tsegs = data["pt"]
    assert all(s.metadata.column("yr").partitions for s in tsegs)
    kept = _kept(t_prune, t_compile, PRUNE_SQL["pt"][0], tsegs)
    assert kept == ["pt_1", "pt_3"]
    assert len(_kept(t_prune, t_compile, PRUNE_SQL["pt"][1], tsegs)) == 1


def test_everything_pruned_keeps_one_segment(data):
    _, stats, _ = _same(data, "ssb", PRUNE_SQL["ssb"][13], "port_on")
    assert (stats.num_segments_pruned, stats.num_segments_processed) == (3, 1)
    assert stats.total_docs == 16_000


def test_chip_smoke_holds_the_pruner_to_min_max_bounds(monkeypatch):
    """chip_smoke.py takes its launch counts from the segments the pruner
    keeps only after holding them to the frames' own min/max: on 8
    time-bounded SSB segments the 13 flights keep what the month windows
    allow, and a pruner that keeps every segment is caught."""
    import chip_smoke
    from pinot_tpu_torch.engine import pruner as t_pruner
    from pinot_tpu_torch.tools import ssb as t_ssb

    segs, frames = t_ssb.build_segments(0.01, num_segments=8, seed=42)
    ctxs = {q: t_compile(sql + " LIMIT 100000")
            for q, sql in t_ssb.QUERIES.items()}
    parts = {q: [t_ssb.numpy_answer(f, q) for f in frames] for q in ctxs}
    kept = chip_smoke._kept_segments(ctxs, segs, frames, parts)
    assert {q: len(v) for q, v in kept.items()} == {
        "Q1.1": 2, "Q1.2": 1, "Q1.3": 2, "Q2.1": 8, "Q2.2": 8, "Q2.3": 8,
        "Q3.1": 7, "Q3.2": 7, "Q3.3": 7, "Q3.4": 1, "Q4.1": 8, "Q4.2": 3,
        "Q4.3": 3}
    monkeypatch.setattr(t_pruner, "prune_segments",
                        lambda ctx, segments, stats=None: list(segments))
    with pytest.raises(AssertionError, match="Q1.1: the pruner keeps"):
        chip_smoke._kept_segments(ctxs, segs, frames, parts)


# -- 5. the filter-blind caches ------------------------------------------------

# (query of the first filter, the rewritten filter's SQL): the first
# context's caches must not serve the second
REWRITE_SQL = {
    "group_by": ("SELECT b, count(*) FROM rw WHERE a < 10 GROUP BY b "
                 "ORDER BY b LIMIT 100",
                 "SELECT b, count(*) FROM rw WHERE a >= 40 GROUP BY b "
                 "ORDER BY b LIMIT 100"),
    "aggregation": ("SELECT count(*), sum(b), max(a) FROM rw WHERE a < 10",
                    "SELECT count(*), sum(b), max(a) FROM rw WHERE a >= 40"),
    "selection": ("SELECT a, b FROM rw WHERE a < 10 ORDER BY a DESC, b "
                  "LIMIT 5",
                  "SELECT a, b FROM rw WHERE a >= 40 ORDER BY a DESC, b "
                  "LIMIT 5"),
}


@pytest.fixture(scope="module")
def rewrite_table(tmp_path_factory):
    """ROADMAP queue 3's reproduction: two INT columns, 2 x 1000 rows."""
    out = tmp_path_factory.mktemp("faults_rw")
    schema = Schema("rw", [FieldSpec("a", DataType.INT),
                           FieldSpec("b", DataType.INT, FieldType.METRIC)])
    rng = np.random.default_rng(21)
    jsegs = []
    for i in range(2):
        SegmentBuilder(schema, f"rw_{i}").build(
            {"a": rng.integers(0, 50, 1000).tolist(),
             "b": rng.integers(0, 8, 1000).tolist()}, str(out))
        jsegs.append(load_segment(str(out / f"rw_{i}")))
    return jsegs, carry(jsegs, "rw")


def _rewritten(compile_, first, second):
    """The first SQL's context, then a copy with the second's filter and
    the first's SQL text."""
    ctx = compile_(first)
    return ctx, dataclasses.replace(ctx, filter=compile_(second).filter)


@pytest.mark.parametrize("shape", sorted(REWRITE_SQL))
@pytest.mark.parametrize("path", ["port_on", "port_off", "port_batch"])
def test_rewritten_filter_under_the_same_sql(rewrite_table, path, shape):
    """A reused executor serves a same-SQL context with a rewritten filter
    the rewritten filter's rows, as both JAX executors do on the same
    reuse; the first query's rows differ, so a stale cache would show."""
    jsegs, tsegs = rewrite_table
    first, second = REWRITE_SQL[shape]
    port = _port(path)
    t1, t2 = _rewritten(t_compile, first, second)
    got1, _ = port.execute(t1, tsegs)
    got2, stats2 = port.execute(t2, tsegs)
    assert t2.sql == t1.sql and str(t2.filter) != str(t1.filter)
    fresh, _ = _port(path).execute(t_compile(second), tsegs)
    assert got2.rows == fresh.rows and got2.rows != got1.rows
    ncols = len(got2.schema.column_names)
    for ref in ("pallas", "sharded"):
        jex = _jax(ref)
        j1, j2 = _rewritten(j_compile, first, second)
        want1, _ = jex.execute(j1, jsegs)
        want2, jstats2 = jex.execute(j2, jsegs)
        _assert_rows(got1.rows, want1.rows, [True] * ncols,
                     f"{path} vs {ref}: {first}")
        _assert_rows(got2.rows, want2.rows, [True] * ncols,
                     f"{path} vs {ref}: rewritten {second}")
        assert stats2.num_docs_scanned == jstats2.num_docs_scanned, \
            (path, ref, shape)


def test_rewritten_filter_on_the_top_k(rewrite_table):
    """The ordered selection ran on the device top-k both times (a
    compiled filter per fingerprint), not on the host engine."""
    _, tsegs = rewrite_table
    port = _port("port_on")
    t1, t2 = _rewritten(t_compile, *REWRITE_SQL["selection"])
    for ctx in (t1, t2):
        _, stats = port.execute(ctx, tsegs)
        assert stats.topk_launches == len(tsegs)
        assert not stats.decisions, stats.decisions
    assert len(port.selection_cache) == 2 * len(tsegs)


def test_plan_cache_holds_segments_weakly(rewrite_table):
    """A plan cache entry does not keep its segment alive (JAX
    :901-919): once the caller drops a segment, the entry's reference is
    dead and a new segment of the same name plans again."""
    jsegs, _ = rewrite_table
    seg = carry(jsegs[:1], "rw")[0]
    ex = _port("port_off")
    ctx = t_compile(REWRITE_SQL["aggregation"][0])
    ex.execute(ctx, [seg])
    (ref, plan), = ex._plans.values()
    assert isinstance(ref, weakref.ref) and ref() is seg
    ex.residency.evict(seg.segment_name)
    del seg
    gc.collect()
    assert ref() is None
    again = carry(jsegs[:1], "rw")[0]
    assert ex._plan_for(ctx, again) is not plan
