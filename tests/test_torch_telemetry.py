"""The port's telemetry (``pinot_tpu_torch/common/telemetry.py``) against
the JAX package's (``pinot_tpu/common/telemetry.py``, oracle:
tests/test_telemetry.py).

The same seeded observations go into both packages' histograms, windows,
SLO trackers and telemetry centers, on one fake clock each: snapshots,
quantiles, bucket rows, burn rates and the Prometheus text must be equal.
The process center's collector pauses (the port's own) reach /metrics.
The flight recorder's burst trigger, debounce, p99-spike trigger and
bundles run on the fake clock too (bundles under ``tmp_path``), and the
servers' and the broker's debug views return JSON after a cluster query.
Every test leaves the process-wide ``TELEMETRY`` reset with its sampler
stopped.
"""

import gc
import json
import os

import numpy as np
import pytest

from pinot_tpu.common import telemetry as jtel
from pinot_tpu.spi.config import PinotConfiguration as JConfig
from pinot_tpu.spi.metrics import MetricsRegistry as JRegistry
from pinot_tpu_torch.common import telemetry as ttel
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.spi.config import PinotConfiguration as TConfig
from pinot_tpu_torch.spi.metrics import MetricsRegistry as TRegistry

SEED = 16


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture(autouse=True)
def _clean_telemetry():
    TELEMETRY.reset()
    jtel.TELEMETRY.stop_sampler()
    yield
    TELEMETRY.reset()
    jtel.TELEMETRY.stop_sampler()


def _observations(kind: str, n: int = 2000) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    if kind == "lognormal":
        return rng.lognormal(1.0, 1.2, n)
    if kind == "uniform":
        return rng.uniform(0.005, 900.0, n)
    # bimodal, with overflow past the last bound
    return np.concatenate([rng.exponential(2.0, n // 2),
                           rng.uniform(60_000.0, 120_000.0, n // 2)])


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "bimodal"])
def test_histogram_equal_to_jax(kind):
    """Snapshot, quantiles, count_over and the cumulative bucket rows."""
    assert ttel.BUCKET_BOUNDS_MS == jtel.BUCKET_BOUNDS_MS
    t, j = ttel.Histogram(), jtel.Histogram()
    for v in _observations(kind):
        t.record(float(v))
        j.record(float(v))
    assert t.snapshot() == j.snapshot()
    qs = (0.01, 0.25, 0.5, 0.9, 0.99, 0.999)
    assert t.quantiles(qs) == j.quantiles(qs)
    for thr in (0.5, 7.0, 50.0, 1234.5, 80_000.0):
        assert t.count_over(thr) == j.count_over(thr)
    assert t.bucket_rows() == j.bucket_rows()
    # merge, as a window merge does it
    t2, j2 = ttel.Histogram(), jtel.Histogram()
    t2.merge(t)
    j2.merge(j)
    t2.merge(t)
    j2.merge(j)
    assert t2.snapshot() == j2.snapshot()


def test_windows_equal_to_jax_on_fake_clock():
    """Sliding and lifetime views of WindowedHistogram and WindowCounter
    step by step: partial rotations, a whole horizon expiring."""
    tc, jc = FakeClock(), FakeClock()
    th = ttel.WindowedHistogram(10.0, 4, clock=tc)
    jh = jtel.WindowedHistogram(10.0, 4, clock=jc)
    tw = ttel.WindowCounter(10.0, 4, clock=tc)
    jw = jtel.WindowCounter(10.0, 4, clock=jc)
    rng = np.random.default_rng(SEED)
    for step, dt in enumerate((0.0, 3.0, 11.0, 9.5, 25.0, 1.0, 55.0, 4.0)):
        tc.advance(dt)
        jc.advance(dt)
        for v in rng.lognormal(2.0, 1.0, 50 + 10 * step):
            th.record(float(v))
            jh.record(float(v))
        tw.add(step + 1)
        jw.add(step + 1)
        assert th.snapshot() == jh.snapshot(), step
        for last in (None, 1, 2, 4):
            assert tw.in_window(last) == jw.in_window(last), (step, last)
    assert tw.total == jw.total


def _slo_pair():
    tc, jc = FakeClock(), FakeClock()
    t = ttel.Telemetry(window_s=10.0, num_windows=6, clock=tc)
    j = jtel.Telemetry(window_s=10.0, num_windows=6, clock=jc)
    keys = {"pinot.broker.slo.sales_OFFLINE.p99.ms": "50",
            "pinot.broker.slo.sales_OFFLINE.error.pct": "2",
            "pinot.broker.slo.events.freshness.ms": "200"}
    t.configure(TConfig(keys, use_env=False))
    j.configure(JConfig(keys, use_env=False))
    return t, j, tc, jc


def test_slo_burn_rates_equal_to_jax():
    """Objectives parsed from the raw keys (table names keep their case),
    latency, error and freshness burns on both windows, a healthy regime
    aging out of the short window."""
    t, j, tc, jc = _slo_pair()
    assert t.slo.objectives() == j.slo.objectives()
    rng = np.random.default_rng(SEED)
    for phase in range(3):
        for i in range(200):
            ms = float(rng.lognormal(2.5 + phase, 1.0))
            err = bool(rng.random() < 0.01 * (1 + 2 * phase))
            t.note_broker_query("sales_OFFLINE", ms, err)
            j.note_broker_query("sales_OFFLINE", ms, err)
            t.observe("events", "freshness", ms * 3)
            j.observe("events", "freshness", ms * 3)
        assert t.slo_snapshot() == j.slo_snapshot(), phase
        assert t.freshness_snapshot() == j.freshness_snapshot(), phase
        assert t.burn_gauges() == j.burn_gauges(), phase
        lat = t.slo_snapshot()["tables"]["sales_OFFLINE"]["latency"]
        assert lat["short"]["burnRate"] > 0, phase
        tc.advance(22.0)
        jc.advance(22.0)
    # past the short window: only the long one still holds requests
    lat = t.slo_snapshot()["tables"]["sales_OFFLINE"]["latency"]
    assert lat["short"]["burnRate"] is None and lat["long"]["requests"] > 0
    assert t.slo_snapshot() == j.slo_snapshot()


def test_prometheus_text_equal_to_jax():
    """The histogram and SLO-burn families a bound registry exports, and
    the center's own export, byte for byte."""
    t, j, _, _ = _slo_pair()
    rng = np.random.default_rng(SEED)
    for table, phase in (("sales_OFFLINE", "broker"),
                         ("sales_OFFLINE", "server_exec"),
                         ("", "launch_queue"), ("events", "freshness")):
        for v in rng.lognormal(1.5, 1.0, 300):
            t.observe(table, phase, float(v))
            j.observe(table, phase, float(v))
    for i in range(40):
        t.note_broker_query("sales_OFFLINE", 80.0 if i % 4 else 5.0, i < 3)
        j.note_broker_query("sales_OFFLINE", 80.0 if i % 4 else 5.0, i < 3)
    assert t.export_prometheus("pinot_server_") == \
        j.export_prometheus("pinot_server_")
    treg, jreg = TRegistry(role="broker"), JRegistry(role="broker")
    treg.bind_telemetry(t)
    jreg.bind_telemetry(j)
    for reg in (treg, jreg):
        reg.meter("queries_total").mark(3)
        reg.labeled_meter("decision_declined_total", point="pallas",
                          reason="pallas_distinct_agg").mark(2)
        reg.set_help("decision_declined_total", "declines")
    text = treg.export_prometheus()
    assert text == jreg.export_prometheus()
    assert "# TYPE pinot_broker_query_phase_latency_ms histogram" in text
    assert "# TYPE pinot_broker_slo_burn_rate gauge" in text


def test_gc_pauses_on_metrics_and_reset_keeps_the_hook():
    """The process center counts the collector's pauses by generation
    through one hook, exports them as the ``gc_pause_ms`` family on a
    bound registry's ``/metrics``, and its reset clears the counts and
    keeps the hook; a center of its own exports no such family."""
    pauses = TELEMETRY.gc_pauses
    assert pauses is ttel.GC_PAUSES
    assert gc.callbacks.count(pauses._hook) == 1
    pauses.install()
    assert gc.callbacks.count(pauses._hook) == 1
    gc.disable()
    try:
        TELEMETRY.reset()
        assert pauses.mark() == (0, 0, 0)
        gc.collect()
        gc.collect()
        ns, count, gen2 = pauses.mark()
        assert ns > 0 and count == gen2 == 2
        assert pauses.histos[2].count == 2
    finally:
        gc.enable()
    reg = TRegistry(role="server")
    reg.bind_telemetry(TELEMETRY)
    text = reg.export_prometheus()
    assert "# TYPE pinot_server_gc_pause_ms histogram" in text
    assert 'pinot_server_gc_pause_ms_count{generation="2"} 2' in text
    assert 'pinot_server_gc_pause_ms_bucket{generation="0",le="+Inf"}' in text
    assert "gc_pause_ms" not in ttel.Telemetry().export_prometheus("p_")


def test_snapshot_and_rings_on_fake_clock():
    """The center's snapshot equals JAX's (rings aside: they stamp the
    wall clock), and gauges sampled by ``sample_now`` land in rings."""
    t, j, _, _ = _slo_pair()
    for v in (1.0, 2.0, 40.0):
        t.observe("sales_OFFLINE", "kernel", v)
        j.observe("sales_OFFLINE", "kernel", v)
    depth = [3.0]
    t.track_gauge("queue", lambda: depth[0], start_sampler=False)
    t.sample_now()
    depth[0] = 5.0
    t.sample_now()
    assert [v for _ts, v in t.ring("queue").values()] == [3.0, 5.0]
    ts, js = t.snapshot(), j.snapshot()
    ts.pop("rings")
    js.pop("rings")
    assert ts == js
    t.untrack_gauge("queue")
    t.sample_now()
    assert len(t.ring("queue").values()) == 2


def test_flight_recorder_burst_and_debounce_on_fake_clock(tmp_path):
    """Events spread past the burst window never trip; a burst inside it
    trips once, freezes only when processed, and again only after the
    debounce interval."""
    clock = FakeClock()
    fr = ttel.FlightRecorder(out_dir=str(tmp_path), clock=clock,
                             min_freeze_interval_s=30.0)
    fr.bursts = {"rejection": (5, 5.0)}
    for _ in range(8):          # one every 2 s: never 5 within 5 s
        fr.note_event("rejection")
        clock.advance(2.0)
    assert fr.snapshot()["pendingTriggers"] == []
    for _ in range(5):
        fr.note_event("rejection")
    assert fr.snapshot()["pendingTriggers"] == ["rejection_burst"]
    assert fr.snapshot()["bundles"] == []      # note_event never freezes
    (bundle,) = fr.process_pending()
    assert bundle["trigger"] == "rejection_burst"
    assert bundle["eventTotals"] == {"rejection": 13}
    clock.advance(10.0)         # inside the debounce
    for _ in range(5):
        fr.note_event("rejection")
    assert fr.process_pending() == []
    clock.advance(25.0)         # past it
    for _ in range(5):
        fr.note_event("rejection")
    assert [b["trigger"] for b in fr.process_pending()] == \
        ["rejection_burst"]
    snap = fr.snapshot()
    assert snap["frozen"] == 2
    assert all(os.path.isfile(b["path"]) for b in snap["bundles"])


def test_flight_recorder_bundle_equal_to_jax(tmp_path):
    """The same feeds give the same bundle in both packages (its time
    stamps and path aside), persisted as JSON under ``tmp_path``."""
    bundles = []
    for mod, sub in ((ttel, "port"), (jtel, "jax")):
        fr = mod.FlightRecorder(out_dir=str(tmp_path / sub))
        fr.note_query({"sql": "SELECT 1", "spans": [{"name": "ServerQuery",
                                                     "ms": 5.0}]})
        fr.note_ledger_mark({"pallas:a->b:x": 1}, ts=100.0)
        fr.note_ledger_mark({"pallas:a->b:x": 4, "seal:c->d:y": 2}, ts=110.0)
        fr.register_provider("residency", lambda: {"stagedBytes": 123})
        fr.register_provider("broken", lambda: 1 / 0)
        fr.note_event("eviction", 3)
        b = fr.freeze("manual")
        with open(b["path"]) as f:
            assert json.load(f)["trigger"] == "manual"
        bundles.append({k: v for k, v in b.items()
                        if k not in ("ts", "iso", "path")})
    assert bundles[0] == bundles[1]
    assert bundles[0]["decisions"]["delta"] == {"pallas:a->b:x": 3,
                                                "seal:c->d:y": 2}


def test_p99_spike_trigger_equal_to_jax():
    """A windowed p99 far over its EWMA baseline trips the recorder in
    both packages; the bundles carry the ledger's marks."""
    triggers = []
    for mod in (ttel, jtel):
        clock = FakeClock()
        t = mod.Telemetry(window_s=10.0, num_windows=3, clock=clock)
        t.recorder.min_freeze_interval_s = 0.0
        for _ in range(100):
            t.observe("tbl", "broker", 2.0)
        t.sample_now()
        clock.advance(40.0)
        for _ in range(100):
            t.observe("tbl", "broker", 2000.0)
        t.sample_now()
        snap = t.recorder.snapshot()
        triggers.append([b["trigger"] for b in snap["bundles"]]
                        + snap["pendingTriggers"])
    assert triggers[0] == triggers[1] == ["p99_spike:tbl:broker"]


def test_storm_events_feed_the_recorder():
    """Residency meter names map to the recorder's storm kinds."""
    ttel.note_storm_event("STAGING_EVICTIONS", 2)
    ttel.note_storm_event("STAGING_HOST_DROPS")
    ttel.note_storm_event("STAGING_DEMOTIONS", 4)
    ttel.note_storm_event("STAGING_HITS", 9)
    ttel.note_storm_event(None)
    assert TELEMETRY.recorder.snapshot()["eventTotals"] == {
        "eviction": 3, "demotion": 4}


def test_debug_views_after_a_cluster_query(tmp_path):
    """Each server's queries / telemetry / slo / freshness /
    flight-recorder view and the broker's four snapshots serve JSON after
    a query; the query's phases are counted, and the cluster's shutdown
    leaves no sampler thread and no recorder directory behind."""
    from pinot_tpu_torch.spi import data as tdata
    from pinot_tpu_torch.spi import table as ttable
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    schema = tdata.Schema("tel", [
        tdata.FieldSpec("city", tdata.DataType.STRING),
        tdata.FieldSpec("v", tdata.DataType.LONG, tdata.FieldType.METRIC)])
    rng = np.random.default_rng(SEED)
    c = EmbeddedCluster(num_servers=2, device="cpu")
    flight_dir = TELEMETRY.recorder.out_dir
    assert flight_dir is not None and os.path.isdir(flight_dir)
    try:
        c.create_table(ttable.TableConfig("tel"), schema)
        for i in range(2):
            c.ingest_rows("tel_OFFLINE", schema, {
                "city": np.array(["sf", "nyc", "oak"])[
                    rng.integers(0, 3, 600)],
                "v": rng.integers(0, 50, 600).astype(np.int64)},
                segment_name=f"tel_{i}")
        assert c.wait_for_ev_converged("tel_OFFLINE", timeout_s=60)
        resp = c.query("SELECT city, sum(v) FROM tel GROUP BY city")
        assert not resp.exceptions
        views = {}
        for sid, srv in c.servers.items():
            for name in ("queries_debug", "telemetry_debug", "slo_debug",
                         "freshness_debug", "flightrecorder_debug"):
                views[f"{sid}.{name}"] = getattr(srv, name)()
        for name in ("telemetry_snapshot", "slo_snapshot",
                     "flightrecorder_snapshot", "freshness_snapshot"):
            views[f"broker.{name}"] = getattr(c.broker, name)()
        json.loads(json.dumps(views))
        hist = views["broker.telemetry_snapshot"]["histograms"]
        assert hist["tel:broker"]["lifetime"]["count"] == 1
        assert hist["tel:server_exec"]["lifetime"]["count"] == 2
        assert hist["tel_OFFLINE:scheduler_wait"]["lifetime"]["count"] == 2
        done = [q for sid in c.servers
                for q in views[f"{sid}.queries_debug"]["completed"]]
        assert len(done) == 2 and all(q["table"] == "tel" for q in done)
        text = list(c.servers.values())[0].metrics.export_prometheus()
        assert "pinot_server_query_phase_latency_ms_bucket" in text
    finally:
        c.shutdown()
    assert not os.path.exists(flight_dir)
    assert TELEMETRY.recorder.out_dir is None
    assert not TELEMETRY.sampling
