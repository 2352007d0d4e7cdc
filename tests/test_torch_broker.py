"""The port's broker front door (``pinot_tpu_torch/broker/``) against the
JAX package's (oracle: tests/test_fs_quota.py ``TestHitCounter`` /
``TestQueryQuota``, tests/test_gapfill_stunion.py ``TestGapfill``).

Checked: the hit counter and quota admission (429s, "no quota"), the
front-door single flight (concurrent identical SQL shares one run; SQL
with ``now()`` never does), gapfill rows equal to the JAX cluster's,
streaming selection, and ``BrokerResponse.to_dict`` equal to JAX's for the
same response. The port's clusters run on the CPU; every wait on them is
bounded.
"""

import threading
import time

import numpy as np
import pytest

from pinot_tpu.broker.quota import HitCounter as JHitCounter
from pinot_tpu.common.response import BrokerResponse as JResponse
from pinot_tpu.engine.results import DataSchema as JSchema
from pinot_tpu.engine.results import QueryStats as JStats
from pinot_tpu.engine.results import ResultTable as JTable
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi.table import TableConfig as JTableConfig
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
from pinot_tpu_torch.broker import quota as tquota
from pinot_tpu_torch.common.response import BrokerResponse as TResponse
from pinot_tpu_torch.engine.results import DataSchema as TSchema
from pinot_tpu_torch.engine.results import QueryStats as TStats
from pinot_tpu_torch.engine.results import ResultTable as TTable
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi.metrics import BrokerMeter
from pinot_tpu_torch.spi.table import QuotaConfig, TableConfig
from pinot_tpu_torch.tools.cluster import EmbeddedCluster

FRAME = {
    "bucket": [0, 10, 30, 40, 10, 20, 0, 30],
    "host": ["a", "a", "a", "a", "b", "b", "a", "a"],
    "v": [1, 2, 3, 4, 5, 6, 7, 8],
}


def _schema(data):
    return data.Schema("events", [
        data.FieldSpec("bucket", data.DataType.INT),
        data.FieldSpec("host", data.DataType.STRING),
        data.FieldSpec("v", data.DataType.LONG, data.FieldType.METRIC)])


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The events table of tests/test_gapfill_stunion.py (without the
    geometry and MV columns) in a JAX and a port cluster."""
    out = str(tmp_path_factory.mktemp("broker"))
    jc = JCluster(data_dir=out)
    jc.create_table(JTableConfig(table_name="events"), _schema(jdata))
    JBuilder(_schema(jdata), "events_0").build(FRAME, out)
    jc.upload_segment_dir("events_OFFLINE", f"{out}/events_0")
    tc = EmbeddedCluster(device="cpu")
    tc.create_table(TableConfig("events"), _schema(tdata))
    tc.ingest_rows("events_OFFLINE", _schema(tdata),
                   {k: np.array(v) for k, v in FRAME.items()},
                   segment_name="events_0")
    assert jc.wait_for_ev_converged("events_OFFLINE", timeout_s=30)
    assert tc.wait_for_ev_converged("events_OFFLINE", timeout_s=30)
    yield jc, tc
    jc.shutdown()
    tc.shutdown()


GAPFILL_SQL = [
    "SELECT gapfill(bucket, 0, 60, 10), sum(v) FROM events "
    "WHERE host = 'a' GROUP BY gapfill(bucket, 0, 60, 10) "
    "ORDER BY gapfill(bucket, 0, 60, 10) LIMIT 100",
    "SELECT host, gapfill(bucket, 0, 40, 10, 'FILL_PREVIOUS_VALUE'), sum(v) "
    "FROM events GROUP BY host, "
    "gapfill(bucket, 0, 40, 10, 'FILL_PREVIOUS_VALUE') "
    "ORDER BY host, gapfill(bucket, 0, 40, 10, 'FILL_PREVIOUS_VALUE') "
    "LIMIT 100",
    "SELECT gapfill(bucket, 0, 60, 10), sum(v) FROM events "
    "WHERE host = 'a' GROUP BY gapfill(bucket, 0, 60, 10) "
    "ORDER BY sum(v) DESC",
    "SELECT gapfill(bucket, 0, 60, 10), sum(v) FROM events "
    "WHERE host = 'a' GROUP BY gapfill(bucket, 0, 60, 10) "
    "ORDER BY gapfill(bucket, 0, 60, 10) DESC LIMIT 3",
]


@pytest.mark.parametrize("sql", GAPFILL_SQL)
def test_gapfill_rows_equal(clusters, sql):
    jc, tc = clusters
    j, t = jc.query(sql), tc.query(sql)
    assert not t.exceptions and not j.exceptions, (t.exceptions,
                                                   j.exceptions)
    assert t.result_table.rows == j.result_table.rows
    assert t.result_table.schema.column_names == \
        j.result_table.schema.column_names


@pytest.mark.parametrize("sql,needle", [
    ("SELECT gapfill(bucket, 0, 60, 10) FROM events LIMIT 5", "GROUP BY"),
    ("SELECT gapfill(bucket, 5, 60, 10), sum(v) FROM events WHERE "
     "host = 'a' GROUP BY gapfill(bucket, 5, 60, 10) LIMIT 100", "aligned"),
])
def test_gapfill_errors_equal(clusters, sql, needle):
    jc, tc = clusters
    j, t = jc.query(sql), tc.query(sql)
    assert [e["errorCode"] for e in t.exceptions] == \
        [e["errorCode"] for e in j.exceptions]
    assert needle in t.exceptions[0]["message"]


def test_streaming_selection(clusters):
    jc, tc = clusters
    sql = "SELECT host, v FROM events LIMIT 3"
    route = tc.broker.routing.route("events_OFFLINE")
    assert tc.broker._use_streaming(compile_query(sql), route.routing)
    t, j = tc.query(sql), jc.query(sql)
    assert not t.exceptions
    assert t.result_table.rows == j.result_table.rows
    assert len(t.result_table.rows) == 3


def test_hit_counter_equal():
    for cls in (JHitCounter, tquota.HitCounter):
        c = cls()
        t0 = 1_000_000
        for i in range(5):
            c.hit(t0 + i * 10)
        assert c.count(t0 + 50) == 5
        assert c.count(t0 + 2000) == 0      # the window slid past
        c = cls()
        c.hit(t0)
        c.hit(t0 + 1000)        # the same slot, a newer stamp: reset
        assert c.count(t0 + 1000) == 1


class _FrozenTime:
    """``time`` for the quota module: one fixed wall clock, so every query
    of a test lands in one window."""

    def __init__(self, now):
        self._now = now

    def time(self):
        return self._now


def test_quota_admission(monkeypatch):
    monkeypatch.setattr(tquota, "time", _FrozenTime(1_000_000.0))
    cluster = EmbeddedCluster(num_servers=1, device="cpu")
    try:
        cluster.create_table(TableConfig(
            "fsq", quota_config=QuotaConfig(max_queries_per_second=3)),
            _fsq_schema())
        cluster.ingest_rows("fsq_OFFLINE", _fsq_schema(), {
            "k": np.array(["a", "b"] * 50),
            "v": np.arange(100).astype(np.int64)})
        assert cluster.wait_for_ev_converged("fsq_OFFLINE", timeout_s=30)
        results = [cluster.query("SELECT count(*) FROM fsq")
                   for _ in range(8)]
        ok = [r for r in results if not r.has_exceptions]
        rejected = [r for r in results if r.has_exceptions]
        assert len(ok) == 3 and len(rejected) == 5
        assert all(r.result_table.rows == [[100]] for r in ok)
        assert all(r.exceptions[0]["errorCode"] == 429
                   and "quota" in r.exceptions[0]["message"]
                   for r in rejected)
        snap = cluster.broker.admission.stats_snapshot()
        assert snap["rejectedQuota"] == 5
        assert cluster.broker.metrics.meter(
            BrokerMeter.QUERIES_REJECTED).count == 5
    finally:
        cluster.shutdown()


def _fsq_schema():
    return tdata.Schema("fsq", [
        tdata.FieldSpec("k", tdata.DataType.STRING),
        tdata.FieldSpec("v", tdata.DataType.LONG, tdata.FieldType.METRIC)])


def test_no_quota_unlimited():
    cluster = EmbeddedCluster(num_servers=1, device="cpu")
    try:
        cluster.create_table(TableConfig("fsq"), _fsq_schema())
        cluster.ingest_rows("fsq_OFFLINE", _fsq_schema(), {
            "k": np.array(["a"]), "v": np.array([1], dtype=np.int64)})
        assert cluster.wait_for_ev_converged("fsq_OFFLINE", timeout_s=30)
        for _ in range(10):
            assert not cluster.query(
                "SELECT count(*) FROM fsq").has_exceptions
    finally:
        cluster.shutdown()


def test_single_flight_coalesces_identical_sql(clusters):
    """Eight threads send one SQL while the leader's server is held: the
    seven followers join its flight and get the leader's response."""
    _, tc = clusters
    server = next(iter(tc.servers.values()))
    real = server.execute_query
    gate = threading.Event()

    def held(ctx, table, segment_names=None):
        gate.wait(60)
        return real(ctx, table, segment_names)

    server.execute_query = held
    sql = "SELECT host, sum(v) FROM events GROUP BY host ORDER BY host"
    meter = tc.broker.metrics.meter(BrokerMeter.QUERIES_COALESCED)
    c0, h0 = meter.count, tc.broker._flights.hits
    out = [None] * 8
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, tc.query(sql))) for i in range(8)]
    try:
        for th in threads:
            th.start()
        deadline = time.monotonic() + 60
        while tc.broker._flights.hits - h0 < 7:
            assert time.monotonic() < deadline, "followers never joined"
            time.sleep(0.005)
    finally:
        gate.set()
        for th in threads:
            th.join(60)
        del server.execute_query
    assert meter.count - c0 == 7
    assert all(r is out[0] for r in out)
    assert out[0].result_table.rows == [["a", 25.0], ["b", 11.0]]


def test_now_never_coalesces(clusters):
    _, tc = clusters
    b = tc.broker
    assert b._flight_key("SELECT now() FROM events", None, None) is None
    assert b._flight_key("select NOW( ) from events", None, None) is None
    k1 = b._flight_key("SELECT  count(*)\n FROM events", None, None)
    assert k1 == b._flight_key("SELECT count(*) FROM events", None, None)
    tc.store.set("unrelated/key", 1)        # any mutation: a new generation
    assert b._flight_key("SELECT count(*) FROM events", None, None) != k1


def _response(table_cls, schema_cls, stats_cls, resp_cls):
    stats = stats_cls(num_segments_queried=4, num_segments_processed=3,
                      num_segments_matched=2, num_segments_pruned=1,
                      num_docs_scanned=700, total_docs=3000,
                      num_groups_limit_reached=True,
                      num_servers_queried=3, num_servers_responded=2)
    stats.decisions["routing:pruned->all_servers:no_time_bound"] = 1
    stats.staging.update(hits=4, stagedBytes=10)
    stats.phase_ms["QUERY_EXECUTION"] = 1.23456
    resp = resp_cls(result_table=table_cls(
        schema_cls(["region", "sum(qty)"], ["STRING", "DOUBLE"]),
        [["east", 1.0], ["west", 2.5]]),
        stats=stats, num_servers_queried=3, num_servers_responded=2,
        time_used_ms=5.4321)
    resp.phase_times_ms["REDUCE"] = 0.5
    resp.add_exception(427, "server s0 timed out after 0.2s")
    return resp


def test_broker_response_to_dict_equal():
    j = _response(JTable, JSchema, JStats, JResponse).to_dict()
    t = _response(TTable, TSchema, TStats, TResponse).to_dict()
    assert t == j
    assert t["partialResult"] is True


def test_cluster_response_keys_equal(clusters):
    """The same query through both clusters: the same response keys and
    the same values, timings and the per-package execution counters
    (staging bytes, backend decisions) aside."""
    jc, tc = clusters
    sql = "SELECT host, sum(v) FROM events GROUP BY host ORDER BY host"
    j, t = jc.query(sql).to_dict(), tc.query(sql).to_dict()
    assert set(t) == set(j)
    skip = {"timeUsedMs", "phaseTimesMs", "staging", "decisions"}
    assert {k: v for k, v in t.items() if k not in skip} == \
        {k: v for k, v in j.items() if k not in skip}
    broker_keys = ("routing:", "hybrid:", "gather:")
    assert {k: v for k, v in t["decisions"].items()
            if k.startswith(broker_keys)} == \
        {k: v for k, v in j["decisions"].items()
         if k.startswith(broker_keys)}
