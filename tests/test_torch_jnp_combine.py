"""The jnp combine over a segment batch in the port against the JAX
package's: port ShardedQueryExecutor(device="cpu") with the fused scan off
(every plan on ``batch_body_combine``) against the JAX
ShardedQueryExecutor(use_pallas=False) (its jnp combine, the conftest's 8
CPU devices), and with the fused scan on against use_pallas=True (interpret
mode, the jnp combine where the fused kernel declines), on JAX-built
segments carried across with segment_from_arrays. Cases: the queries of
tests/test_parallel.py on 5 uneven segments with a raw column, its
TestCompactGroupBy (the sparse hash rung, the forced hash -> sort rerun,
the compact overflow that leaves the batch), and the 13 SSB flights of
tests/test_mesh_combine.py on one card.

Equal on every case: rows, ``num_docs_scanned``, ``num_segments_matched``,
``num_segments_processed``, ``group_by_rung`` and the decisions. Tolerance:
counts, integer sums, min/max and keys exact; float cells rel 1e-5, abs
1e-6 (tests/test_pallas.py:101).
"""

import numpy as np
import pandas as pd
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import (  # noqa: E402
    DataType,
    FieldSpec,
    FieldType,
    IndexingConfig,
    Schema,
)
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import kernels as t_kernels  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import combine as t_combine  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_torch_executor import _assert_rows, carry  # noqa: E402
from tests.test_torch_general_rung import _hash_frame  # noqa: E402

JNP_OFF = "pallas:pallas_combine->jnp_combine:pallas_disabled_on_backend"
STATS = ("num_docs_scanned", "num_segments_matched", "num_segments_processed",
         "num_segments_pruned", "total_docs", "group_by_rung")


def _sales_schema():
    return Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("kind", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("raw_amt", DataType.LONG, FieldType.METRIC),
    ])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_parallel.py's 5 uneven sales segments (raw ``raw_amt``),
    its 2 wide segments (a ~2^17 key space) and 4 SSB segments."""
    tmp = tmp_path_factory.mktemp
    rng = np.random.default_rng(11)
    n = 4000
    regions, kinds = ["east", "west", "north", "south"], ["a", "b", "c"]
    df = pd.DataFrame({
        "region": [regions[i] for i in rng.integers(0, 4, n)],
        "kind": [kinds[i] for i in rng.integers(0, 3, n)],
        "year": rng.integers(2015, 2024, n).astype(np.int64),
        "qty": rng.integers(1, 50, n).astype(np.int64),
        "price": np.round(rng.normal(100, 25, n), 2),
        "raw_amt": rng.integers(0, 10_000, n).astype(np.int64),
    })
    out = tmp("jnp_sales")
    sales = []
    bounds = [0, 500, 1400, 2000, 3100, n]
    for i in range(5):
        sl = slice(bounds[i], bounds[i + 1])
        SegmentBuilder(_sales_schema(), f"sales_{i}", indexing_config=(
            IndexingConfig(no_dictionary_columns=["raw_amt"]))).build(
            {c: df[c].tolist()[sl] for c in df.columns}, str(out))
        sales.append(load_segment(str(out / f"sales_{i}")))
    wide_schema = Schema("wide", [
        FieldSpec("a", DataType.STRING), FieldSpec("b", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    out = tmp("jnp_wide")
    frame = _hash_frame(77, False)
    wide = []
    for i in range(2):
        SegmentBuilder(wide_schema, f"w{i}").build(frame, str(out))
        wide.append(load_segment(str(out / f"w{i}")))
    ssb = j_ssb.build_segments(0, str(tmp("jnp_ssb")), num_segments=4,
                               rows=10_000, star_tree=False, workers=1)
    return {"sales": (sales, carry(sales, "sales")),
            "wide": (wide, carry(wide, "wide")),
            "ssb": (ssb, carry(ssb, "ssb_lineorder"))}


# port fused scan on / off -> the JAX sharded executor it is held to
MODES = {"off": False, "on": True}


def _same(data, key, sql, mode):
    """Rows, stats and decisions of the port batch path against the JAX
    sharded executor; -> the port's stats."""
    jsegs, tsegs = data[key]
    port = ShardedQueryExecutor(device="cpu", use_fused_scan=MODES[mode])
    got, stats = port.execute(t_compile(sql), tsegs)
    want, jstats = JSharded(use_pallas=MODES[mode]).execute(j_compile(sql),
                                                            jsegs)
    assert got.schema.column_names == want.schema.column_names
    exact = [not isinstance(c, float) for c in
             (want.rows[0] if want.rows else [])]
    _assert_rows(got.rows, want.rows, exact, f"{mode}: {sql}")
    for f in STATS:
        assert getattr(stats, f) == getattr(jstats, f), (mode, f, sql)
    assert stats.decisions == jstats.decisions, (mode, sql)
    return stats


SALES_SQL = [
    "SELECT count(*) FROM sales",
    "SELECT count(*) FROM sales WHERE region = 'east'",
    "SELECT sum(qty), min(price), max(price), avg(qty) FROM sales",
    "SELECT sum(price) FROM sales WHERE year BETWEEN 2017 AND 2021 "
    "AND kind != 'c'",
    "SELECT minmaxrange(year), count(*) FROM sales "
    "WHERE region IN ('west','north')",
    "SELECT distinctcount(region) FROM sales WHERE qty > 25",
    "SELECT sum(raw_amt) FROM sales WHERE raw_amt > 5000",
    "SELECT region, sum(qty), count(*) FROM sales GROUP BY region "
    "ORDER BY region",
    "SELECT region, kind, sum(price), avg(price) FROM sales "
    "GROUP BY region, kind ORDER BY region, kind LIMIT 20",
    "SELECT year, min(price), max(qty) FROM sales WHERE kind = 'a' "
    "GROUP BY year ORDER BY year",
    "SELECT sum(qty * price) FROM sales WHERE region = 'south'",
]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("i", range(len(SALES_SQL)))
def test_sales_queries_match_jax(data, mode, i):
    """tests/test_parallel.py's queries: one call over the 5 segments,
    equal to the JAX sharded executor and its per-segment executor."""
    sql = SALES_SQL[i]
    stats = _same(data, "sales", sql, mode)
    if mode == "off":
        assert stats.decisions == {JNP_OFF: 1}
    if stats.decisions:
        assert stats.batch_general_launches == 1, sql
    assert stats.general_launches == 0
    jsegs, tsegs = data["sales"]
    got, _ = ShardedQueryExecutor(device="cpu", use_fused_scan=False).execute(
        t_compile(sql), tsegs)
    want, _ = JExecutor(use_device=True, use_pallas=False).execute(
        j_compile(sql), jsegs)
    _assert_rows(got.rows, want.rows,
                 [not isinstance(c, float) for c in want.rows[0]], sql)


WIDE_SQL = ("SELECT a, b, year, sum(v), count(*), min(v), max(v), avg(v) "
            "FROM wide WHERE v < 30 "
            "GROUP BY a, b, year ORDER BY a, b, year LIMIT 15000")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sparse_compacts_merge_across_segments(data, mode):
    """A ~2^17 key space rides the sparse rungs: each segment's compact
    holds its own keys, re-grouped by sort over the batch
    (_sparse_cross_combine)."""
    from pinot_tpu_torch.engine.plan import plan_segment

    _, tsegs = data["wide"]
    assert t_kernels.sparse_mode(
        plan_segment(t_compile(WIDE_SQL), tsegs[0]).spec) > 0
    stats = _same(data, "wide", WIDE_SQL, mode)
    assert stats.group_by_rung in ("hash", "sort")
    assert stats.batch_general_launches == 1


def test_hash_overflow_reruns_every_segment_on_sort(data, monkeypatch):
    """A hash table that overflows in any segment sends every segment to
    the sort body: a live-doc window of 64 docs, set in both packages."""
    from pinot_tpu.engine import kernels as jk

    monkeypatch.setattr(jk, "HASH_LIVE_DOCS", 64)
    monkeypatch.setattr(t_kernels, "HASH_LIVE_DOCS", 64)
    calls = []
    real = t_kernels.build_kernel_body

    def spy(spec, *a, **k):
        calls.append(k.get("sparse_rung"))
        return real(spec, *a, **k)

    monkeypatch.setattr(t_kernels, "build_kernel_body", spy)
    stats = _same(data, "wide", WIDE_SQL, "off")
    assert stats.group_by_rung == "sort"
    assert calls == ["hash", "sort"]


def test_compact_overflow_leaves_the_batch(data):
    """More live groups than the compact cap: the decode refuses the
    combined result, the batch records the code and the per-segment path
    serves, where each segment then meets the cap too and the host engine
    serves, as in the JAX package."""
    sql = ("SELECT a, b, year, sum(v) FROM wide "
           "GROUP BY a, b, year ORDER BY a, b, year LIMIT 100000")
    stats = _same(data, "wide", sql, "off")
    assert stats.decisions[
        "sharded_combine:sharded_combine->per_segment:"
        "compact_cap_overflow"] == 1
    assert stats.batch_general_launches == 1
    jsegs, tsegs = data["wide"]
    got, _ = ShardedQueryExecutor(device="cpu", use_fused_scan=False).execute(
        t_compile(sql), tsegs)
    want, _ = JExecutor(use_device=False).execute(j_compile(sql), jsegs)
    assert got.rows == want.rows and len(got.rows) > 8192


def test_segment_overflow_propagates_past_the_merge():
    """One segment whose compact overflowed makes the merged compact_n
    exceed K even where the merged keys fit: the decode refuses."""
    K = 4
    SENT = t_kernels._SENTINEL_KEY
    import torch

    parts = [{"ck": torch.tensor([1, 2, SENT, SENT], dtype=torch.int32),
              "compact_n": torch.tensor(9), "rung": torch.tensor(1),
              "presence": torch.tensor([1, 1, 0, 0])},
             {"ck": torch.tensor([2, 3, SENT, SENT], dtype=torch.int32),
              "compact_n": torch.tensor(2), "rung": torch.tensor(0),
              "presence": torch.tensor([2, 5, 0, 0])}]
    out = t_combine._sparse_cross_combine(parts, {"presence": ("sum",)}, K)
    assert out["ck"].tolist() == [1, 2, 3, SENT]
    assert out["presence"].tolist() == [1, 3, 5, 0]
    assert int(out["compact_n"]) == 9 and int(out["rung"]) == 1


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_ssb_flights_on_the_jnp_combine(data, qid):
    """tests/test_mesh_combine.py's flights over 4 segments: the port's jnp
    combine on one card against the JAX jnp combine on its 8-device mesh
    (the doc-axis split has no counterpart on one card)."""
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    stats = _same(data, "ssb", sql, "off")
    assert stats.num_segments_processed + stats.num_segments_pruned == 4
    if stats.num_segments_processed > 1:
        assert stats.batch_general_launches == 1
