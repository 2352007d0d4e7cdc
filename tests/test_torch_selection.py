"""Ordered selection on the device top-k in the port against the JAX
package.

tests/test_selection_device.py's table (9000 rows in two segments, a
LONG ``ts`` with only 40 distinct values, so ties are everywhere) is built
by the JAX package and carried across. Each of its ordered selections
runs through the port (``device="cpu"``: the top-k's PyTorch ops on the
CPU) per segment and through ``ShardedQueryExecutor``, against the JAX
executor with its device top-k and its host engine: the same eligibility
(the top-k serves, or the host engine with ``selection_not_device_
eligible``), the same rows, ties included. The top-k's stable sort
passes are held to the host engine's ``_lexsort`` on random tied keys;
upsert segments and raw i64 keys go to the host, as in JAX.
Tolerance: every cell exact.
"""

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu_torch.engine import host_engine  # noqa: E402
from pinot_tpu_torch.engine import selection_device as sd  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_selection_device import ORDERED  # noqa: E402
from tests.test_torch_columns import build_stats  # noqa: E402
from tests.test_torch_executor import carry  # noqa: E402
from tests.test_torch_host_engine import host_decisions  # noqa: E402
from tests.test_torch_upsert import upsert  # noqa: E402,F401

N = 9000
NOT_ELIGIBLE = "selection:device_topk->host_engine:selection_not_device_eligible"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_selection_device.py's segments, and their port copies."""
    out = tmp_path_factory.mktemp("torch_seldev")
    rng = np.random.default_rng(31)
    frame = {
        "host": np.array(["h1", "h2", "h3"])[rng.integers(0, 3, N)],
        "code": rng.integers(200, 600, N).astype(np.int64),
        "ts": rng.integers(1000, 1040, N).astype(np.int64),
        "lat": np.round(rng.uniform(0.1, 9.9, N), 3),
    }
    schema = Schema("ev", [
        FieldSpec("host", DataType.STRING),
        FieldSpec("code", DataType.INT),
        FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
        FieldSpec("lat", DataType.DOUBLE, FieldType.METRIC),
    ])
    segs = []
    for i, sl in enumerate([slice(0, N // 2), slice(N // 2, N)]):
        SegmentBuilder(schema, f"ev_{i}").build(
            {k: v[sl] for k, v in frame.items()}, str(out))
        segs.append(load_segment(str(out / f"ev_{i}")))
    return segs, carry(segs, "ev")


@pytest.fixture(scope="module")
def execs():
    return {"port": ServerQueryExecutor(device="cpu"),
            "batch": ShardedQueryExecutor(device="cpu"),
            "dev": JaxExecutor(use_device=True),
            "sharded": JSharded(use_pallas=True),
            "host": JaxExecutor(use_device=False)}


def _check(jsegs, tsegs, execs, sql, on_device):
    """The port per segment and over the batch against the JAX device
    path and host engine: rows, decisions, top-k calls."""
    want, jstats = execs["dev"].execute(j_compile(sql), jsegs)
    host, _ = execs["host"].execute(j_compile(sql), jsegs)
    assert want.rows == host.rows, sql
    for path, ref in (("port", jstats),
                      ("batch", execs["sharded"].execute(j_compile(sql),
                                                         jsegs)[1])):
        got, stats = execs[path].execute(t_compile(sql), tsegs)
        assert got.schema.column_names == want.schema.column_names, sql
        assert got.schema.column_types == want.schema.column_types, sql
        assert got.rows == want.rows, (path, sql)
        assert host_decisions(stats) == host_decisions(ref), (path, sql)
        assert stats.topk_launches == (len(tsegs) if on_device else 0), sql
        assert stats.num_docs_scanned == jstats.num_docs_scanned, sql
        assert stats.scan_launches == stats.general_launches == 0, sql
    return got


def test_device_path_engages(setup, execs):
    jsegs, tsegs = setup
    cache = len(execs["port"].selection_cache)
    got = _check(jsegs, tsegs, execs, ORDERED[0], on_device=True)
    assert got.rows and len(execs["port"].selection_cache) > cache


@pytest.mark.parametrize("sql", ORDERED, ids=[q[:55] for q in ORDERED])
def test_ordered_selection_exact_parity(setup, execs, sql):
    """Exact row-for-row equality over 40 distinct ts values: a deviation
    from the host's stable-sort ties fails here."""
    _check(*setup, execs, sql, on_device=True)


def test_string_dict_order_serves_on_device(setup, execs):
    """A STRING dictionary column orders by dictId on the card: the
    dictionary is sorted."""
    _check(*setup, execs, "SELECT host, code FROM ev ORDER BY host, code "
                          "LIMIT 20", on_device=True)


def test_expression_order_falls_back(setup, execs):
    """ORDER BY an expression is the host engine's, with the decision."""
    jsegs, tsegs = setup
    sql = "SELECT host, code FROM ev ORDER BY code + 1 LIMIT 20"
    _check(jsegs, tsegs, execs, sql, on_device=False)
    _, stats = execs["port"].execute(t_compile(sql), tsegs)
    assert stats.decisions == {NOT_ELIGIBLE: 1}


@pytest.mark.parametrize("sql", [
    "SELECT host FROM ev ORDER BY ts DESC LIMIT 8193",
    "SELECT host FROM ev ORDER BY ts DESC LIMIT 8000 OFFSET 500",
])
def test_past_the_top_k_cap_falls_back(setup, execs, sql):
    """offset + limit past MAX_DEVICE_SELECTION_K is the host engine's."""
    assert sd.MAX_DEVICE_SELECTION_K == 8192
    _check(*setup, execs, sql, on_device=False)


@pytest.mark.parametrize("qi", range(25))
def test_ordered_selection_fuzz(setup, execs, qi):
    """tests/test_selection_device.py's seeded random ordered selections."""
    rng = np.random.default_rng(777 + qi)
    cols = ["host", "code", "ts", "lat"]
    sel = list(rng.choice(cols, size=int(rng.integers(1, 4)),
                          replace=False))
    order = []
    for c in rng.choice(["code", "ts", "lat", "host"],
                        size=int(rng.integers(1, 3)), replace=False):
        order.append(f"{c} {'DESC' if rng.integers(0, 2) else 'ASC'}")
    where = ""
    if rng.integers(0, 2):
        where = f" WHERE code >= {int(rng.integers(200, 550))}"
    limit = int(rng.integers(1, 60))
    offset = int(rng.integers(0, 10)) if rng.integers(0, 2) else 0
    sql = (f"SELECT {', '.join(sel)} FROM ev{where} "
           f"ORDER BY {', '.join(order)} LIMIT {limit}"
           + (f" OFFSET {offset}" if offset else ""))
    _check(*setup, execs, sql, on_device=True)


@pytest.mark.parametrize("seed", range(6))
def test_stable_sort_passes_equal_lexsort(seed):
    """The top-k's stable sort passes (last key first, from docId order)
    against the host engine's ``_lexsort`` on heavily tied keys of mixed
    directions, with filtered-out docs and a padded tail."""
    from pinot_tpu_torch.engine.kernels import _Cols

    rng = np.random.default_rng(seed)
    cap, n = 4096, 4000
    nkeys = 1 + seed % 3
    keys = [rng.integers(0, 5 + 20 * i, cap).astype(np.int32)
            for i in range(nkeys)]
    if seed % 2:
        keys[0] = np.round(rng.uniform(-1, 1, cap), 1)  # -0.0 and 0.0
        keys[0][::7] = -0.0
    asc = tuple(bool(rng.integers(0, 2)) for _ in range(nkeys))
    mask = rng.random(cap) < 0.6
    k = 300
    out = sd.topk_docs(
        ("lut", "c"), _Cols({"c": {"fwd": torch.from_numpy(
            mask.astype(np.int32))}}),
        (torch.tensor([False, True]),), n, cap,
        [torch.from_numpy(np.ascontiguousarray(x)) for x in keys], asc, k,
        torch.device("cpu")).numpy()
    docs = np.nonzero(mask[:n])[0]
    order = host_engine._lexsort([x[docs] for x in keys], list(asc))
    assert out[-1] == docs.size
    assert np.array_equal(out[:k], docs[order][:k])


def test_raw_i64_keys_go_to_the_host(tmp_path_factory, execs):
    """A raw LONG past 2^31 would round through f64: the host engine
    serves it (as JAX's does); a raw DOUBLE with finite stats and a raw
    LONG inside i32 ride the card."""
    jsegs, tsegs = build_stats(tmp_path_factory.mktemp("torch_sel_stats"))
    for sql, on_device in (
            ("SELECT team, big FROM stats ORDER BY big DESC LIMIT 7", False),
            ("SELECT team FROM stats ORDER BY team, big LIMIT 7", False),
            ("SELECT team, ratio FROM stats ORDER BY ratio, team LIMIT 9",
             True),
            ("SELECT team, ratio FROM stats ORDER BY ratio DESC LIMIT 9",
             True),
            ("SELECT salary FROM stats WHERE team = 'BOS' "
             "ORDER BY salary LIMIT 4", True)):
        _check(jsegs, tsegs, execs, sql, on_device)


def test_upsert_segments_go_to_the_host(upsert, execs):  # noqa: F811
    """An upsert-managed segment's selection is the host engine's, over
    its live docs only (JAX's device_selection returns None for it)."""
    jseg, tseg = upsert
    sql = "SELECT uid, score FROM users ORDER BY score DESC, uid LIMIT 6"
    want, jstats = execs["dev"].execute(j_compile(sql), [jseg])
    got, stats = execs["port"].execute(t_compile(sql), [tseg])
    assert got.rows == want.rows
    assert stats.decisions == {NOT_ELIGIBLE: 1} == host_decisions(jstats)
    assert stats.topk_launches == 0
    assert stats.num_docs_scanned == int(np.asarray(
        tseg.valid_doc_ids).sum())


def test_cache_holds_a_plan_per_sql_and_segment(setup, execs):
    """The compiled filters are kept per (sql, segment), bounded."""
    _, tsegs = setup
    ex = ServerQueryExecutor(device="cpu")
    for lo in range(3):
        ex.execute(t_compile(f"SELECT ts FROM ev WHERE code > {200 + lo} "
                             "ORDER BY ts LIMIT 3"), tsegs)
    assert len(ex.selection_cache) == 3 * len(tsegs)
    cache = sd.SelectionCache()
    for i in range(sd._CACHE_CAP + 5):
        cache.put(("q", str(i)), tsegs[0], i)
    assert len(cache) == sd._CACHE_CAP
    assert cache.get(("q", "0"), tsegs[0]) is None
    assert cache.get(("q", str(sd._CACHE_CAP)), tsegs[1]) is None
