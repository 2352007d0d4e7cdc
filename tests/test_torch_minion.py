"""Minions and the segment processing framework against the JAX package
(oracles tests/test_minion.py and tests/test_scheduler_plugins.py:205).

- The processing framework (``segment/processing.py``): the same input
  directories (built by the JAX package, read by each package's loader)
  through both frameworks give byte-equal output directories, creation
  time aside: CONCAT partitioned by time bucket, ROLLUP (SUM / MIN / MAX,
  integral and float metrics, a multi-value and a nullable dimension),
  DEDUP, the RealtimeToOffline window, the split at
  ``max_docs_per_segment``, a purge filter and an upsert segment's valid
  docs; the exact long sum past 2^53.
- Both packages' clusters in lockstep (``EmbeddedCluster(data_dir=...)``
  with a minion): merge-rollup over a segment that straddles a bucket,
  the watermark advancing only once the bucket drains, the retry cap and
  the pruning of terminal records, realtime-to-offline on a hybrid table,
  purge, and convert-to-raw with its refresh push. Step by step the tasks
  (all but their random ids), segment sets, lineage states, watermarks
  and IdealStates are equal; counts and integer sums exact, float cells
  within ``rel=1e-5, abs=1e-6``.
- What the port does and JAX does not: the segment time range the
  generators read (a DIMENSION time column), the refresh push swapping
  the served segment (the plan reads the raw column), and one routing
  snapshot across the lineage swap (4 client threads hammer count(*)
  while merges run; every answer equals the oracle).
- chip_smoke's phase 20 at a small size on the CPU.
"""

import json
import os
import re
import threading

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.controller import tasks as jtasks  # noqa: E402
from pinot_tpu.ingestion import MemoryStream as JStream  # noqa: E402
from pinot_tpu.minion.tasks import PurgeTaskExecutor as JPurge  # noqa: E402
from pinot_tpu.segment import SegmentBuilder as JBuilder  # noqa: E402
from pinot_tpu.segment import load_segment as j_load  # noqa: E402
from pinot_tpu.segment import processing as jproc  # noqa: E402
from pinot_tpu.spi import data as jdata  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster  # noqa: E402
from pinot_tpu_torch.controller import tasks as ttasks  # noqa: E402
from pinot_tpu_torch.ingestion import MemoryStream as TStream  # noqa: E402
from pinot_tpu_torch.minion.tasks import PurgeTaskExecutor  # noqa: E402
from pinot_tpu_torch.segment import processing as tproc  # noqa: E402
from pinot_tpu_torch.segment.immutable import load_segment  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402
from pinot_tpu_torch.tools.cluster import EmbeddedCluster  # noqa: E402

DAY_MS = 86_400_000
D0 = 18_519 * DAY_MS
D1 = D0 + DAY_MS
D2 = D0 + 2 * DAY_MS

# -- the processing framework, byte for byte -----------------------------------


def _proc_schema(mod):
    S, DT, M, T = (mod.DataType.STRING, mod.DataType, mod.FieldType.METRIC,
                   mod.FieldType.DATE_TIME)
    return mod.Schema("events", [
        mod.FieldSpec("k", S), mod.FieldSpec("city", S),
        mod.FieldSpec("tags", S, single_value=False),
        mod.FieldSpec("qty", DT.LONG, M), mod.FieldSpec("price", DT.DOUBLE, M),
        mod.FieldSpec("units", DT.INT, M),
        mod.FieldSpec("ts", DT.LONG, T)])


def _proc_config(mod, no_dict=()):
    return mod.TableConfig(
        "events", validation_config=mod.SegmentsValidationConfig(
            time_column_name="ts"),
        indexing_config=mod.IndexingConfig(
            no_dictionary_columns=list(no_dict)))


def _proc_rows(seed, n, t0):
    rng = np.random.default_rng(seed)
    city = [None if x == 3 else f"c{x}" for x in rng.integers(0, 4, n)]
    tags = [[f"t{j}" for j in sorted(set(rng.integers(0, 3, 1 + x % 2)))]
            for x in rng.integers(0, 4, n)]
    return {"k": [f"k{x}" for x in rng.integers(0, 3, n)], "city": city,
            "tags": tags,
            "qty": rng.integers(0, 1 << 40, n).tolist(),
            "price": np.round(rng.normal(100, 50, n), 3).tolist(),
            "units": rng.integers(0, 5, n).tolist(),
            # three hours of distinct keys; rollup merges equal rows
            "ts": (t0 + rng.integers(0, 3, n) * 3_600_000).tolist()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("inputs"))
    dirs = []
    # three segments: day 0, straddling day 0 / 1, day 1
    for i, t0 in enumerate((D0 + 3_600_000, D1 - 7_200_000, D1 + 60_000)):
        name = f"in_{i}"
        JBuilder(_proc_schema(jdata), name,
                 table_config=_proc_config(jtable, ["units"])).build(
            _proc_rows(100 + i, 700, t0), d)
        dirs.append(os.path.join(d, name))
    return dirs


def _meta_equal(jd, td):
    jm = json.load(open(os.path.join(jd, "metadata.json")))
    tm = json.load(open(os.path.join(td, "metadata.json")))
    assert set(jm) == set(tm)
    differ = {k for k in jm if jm[k] != tm[k]}
    assert differ <= {"creationTimeMs"}, differ


def _dirs_equal(jdirs, tdirs):
    assert [os.path.basename(d) for d in jdirs] == \
        [os.path.basename(d) for d in tdirs]
    for jd, td in zip(jdirs, tdirs):
        jf = sorted(os.listdir(os.path.join(jd, "columns")))
        assert jf == sorted(os.listdir(os.path.join(td, "columns")))
        for f in jf:
            with open(os.path.join(jd, "columns", f), "rb") as a, \
                    open(os.path.join(td, "columns", f), "rb") as b:
                assert a.read() == b.read(), (td, f)
        _meta_equal(jd, td)


def _jax_purger(row):
    return row["k"] == "k1" and row["units"] >= 2


def _port_purger(cols):
    return (cols["k"] == "k1") & (cols["units"] >= 2)


PROC_CASES = {
    "concat_bucketed": dict(merge="CONCAT", bucket=DAY_MS),
    "rollup": dict(merge="ROLLUP", bucket=DAY_MS,
                   aggs={"price": "MAX", "units": "MIN"}),
    "rollup_sum": dict(merge="ROLLUP"),
    "dedup": dict(merge="DEDUP"),
    "window": dict(merge="CONCAT", window=(D0 + 4_000_000, D1 + 100_000)),
    "split": dict(merge="CONCAT", bucket=DAY_MS, max_docs=300),
    "purge": dict(merge="CONCAT", purge=True),
    "upsert_valid_docs": dict(merge="CONCAT", valid=True),
}


@pytest.mark.parametrize("case", sorted(PROC_CASES))
def test_processing_dirs_byte_equal(inputs, tmp_path, case):
    c = PROC_CASES[case]
    jsegs = [j_load(d) for d in inputs]
    tsegs = [load_segment(d) for d in inputs]
    if c.get("valid"):
        rng = np.random.default_rng(9)
        for js, ts in zip(jsegs, tsegs):
            v = rng.random(js.num_docs) < 0.6
            js.valid_doc_ids = v
            ts.valid_doc_ids = v
    runs = {}
    for mod, proc, segs, filt in (
            (jtable, jproc, jsegs, _jax_purger),
            (ttable, tproc, tsegs, _port_purger)):
        schema = _proc_schema(jdata if mod is jtable else tdata)
        window = c.get("window", (None, None))
        cfg = proc.SegmentProcessorConfig(
            schema=schema, table_config=_proc_config(mod),
            merge_type=proc.MergeType[c["merge"]],
            aggregation_types=c.get("aggs", {}),
            bucket_time_ms=c.get("bucket"),
            window_start_ms=window[0], window_end_ms=window[1],
            record_filter=filt if c.get("purge") else None,
            segment_name_prefix=f"out_{case}",
            max_docs_per_segment=c.get("max_docs", 5_000_000))
        out = str(tmp_path / ("j" if mod is jtable else "t"))
        runs[mod] = proc.SegmentProcessorFramework(segs, cfg).process(out)
    assert runs[jtable], case
    if case == "split":
        assert len(runs[jtable]) > 2
    _dirs_equal(runs[jtable], runs[ttable])


def test_long_sum_exact_past_float53(tmp_path):
    """A LONG rollup sum past 2^53 stays exact, as in JAX."""
    schema = tdata.Schema("events", [
        tdata.FieldSpec("k", tdata.DataType.STRING),
        tdata.FieldSpec("qty", tdata.DataType.LONG, tdata.FieldType.METRIC),
        tdata.FieldSpec("ts", tdata.DataType.LONG,
                        tdata.FieldType.DATE_TIME)])
    cfg = ttable.TableConfig("events", validation_config=ttable
                             .SegmentsValidationConfig(time_column_name="ts"))
    fw = tproc.SegmentProcessorFramework([], tproc.SegmentProcessorConfig(
        schema=schema, table_config=cfg, merge_type=tproc.MergeType.ROLLUP))
    cols = tproc.Columns({"k": np.array(["x", "x", "y", "x"]),
                          "qty": np.array([2 ** 53, 1, 5, 2], np.int64),
                          "ts": np.array([D0] * 4, np.int64)})
    out = fw._rollup(cols)
    assert out.values["qty"].tolist() == [2 ** 53 + 3, 5]
    assert out.values["k"].tolist() == ["x", "y"]
    jfw = jproc.SegmentProcessorFramework([], jproc.SegmentProcessorConfig(
        schema=_j_schema(), table_config=_j_cfg(),
        merge_type=jproc.MergeType.ROLLUP))
    jout = jfw._rollup({"k": ["x", "x", "y", "x"],
                        "qty": [2 ** 53, 1, 5, 2], "ts": [D0] * 4})
    assert jout["qty"] == out.values["qty"].tolist()


# -- both clusters in lockstep ---------------------------------------------------

def _j_schema(name="events"):
    return jdata.Schema(name, [
        jdata.FieldSpec("k", jdata.DataType.STRING),
        jdata.FieldSpec("qty", jdata.DataType.LONG, jdata.FieldType.METRIC),
        jdata.FieldSpec("ts", jdata.DataType.LONG, jdata.FieldType.DATE_TIME)])


def _schema(mod, name="events", ts_type=None):
    return mod.Schema(name, [
        mod.FieldSpec("k", mod.DataType.STRING),
        mod.FieldSpec("qty", mod.DataType.LONG, mod.FieldType.METRIC),
        mod.FieldSpec("ts", mod.DataType.LONG,
                      ts_type or mod.FieldType.DATE_TIME)])


def _j_cfg():
    return _cfg(jtable, jtasks)


def _cfg(mod, tasks, name="events", task=None, conf=None,
         table_type=None, topic=None, flush=100):
    kw = {}
    if topic is not None:
        kw["stream_config"] = mod.StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=flush)
    task = task or tasks.MERGE_ROLLUP_TASK
    conf = conf if conf is not None else {
        "bucketTimePeriod": "1d", "bufferTimePeriod": "0d",
        "mergeType": "CONCAT"}
    return mod.TableConfig(
        name, table_type or mod.TableType.OFFLINE,
        validation_config=mod.SegmentsValidationConfig(
            time_column_name="ts", replication=1),
        task_config={task: conf}, **kw)


def _rows(ts_list, k="x", qty=1):
    return {"k": [k] * len(ts_list), "qty": [qty] * len(ts_list),
            "ts": list(ts_list)}


LLC_SEED = "20240101T000000Z"


class Pair:
    """A JAX and a port cluster driven with the same calls."""

    def __init__(self, tmp_path, servers=1):
        # LLC segment names carry the wall-clock second of the seal unless
        # a seed fixes them; the two clusters seal at different instants.
        self.j = JCluster(num_servers=servers, data_dir=str(tmp_path / "j"),
                          llc_seed=LLC_SEED)
        self.t = EmbeddedCluster(num_servers=servers, device="cpu",
                                 data_dir=str(tmp_path / "t"),
                                 llc_seed=LLC_SEED)
        self.jm = self.j.add_minion(start=False)
        self.tm = self.t.add_minion(start=False)

    def both(self):
        return ((self.j, jtable, jdata, jtasks),
                (self.t, ttable, tdata, ttasks))

    def create(self, make_cfg, name="events", ts_type=None):
        for c, mod, dmod, tasks in self.both():
            c.create_table(make_cfg(mod, tasks),
                           _schema(dmod, name, ts_type and getattr(
                               dmod.FieldType, ts_type)))

    def ingest(self, table, rows, name, ts_type=None):
        for c, _mod, dmod, _t in self.both():
            c.ingest_rows(table, _schema(dmod, table.rsplit("_", 1)[0],
                                         ts_type and getattr(
                                             dmod.FieldType, ts_type)),
                          rows, segment_name=name)
        for c, *_ in self.both():
            assert c.wait_for_ev_converged(table)

    def generate(self, now_ms):
        out = []
        for c, *_ in self.both():
            tm = c.controller.task_manager
            out.append([_task_view(tm.get(i))
                        for i in tm.generate_tasks(now_ms=now_ms)])
        assert out[0] == out[1]
        return out[1]

    def run_all(self):
        for m in (self.jm, self.tm):
            while m.run_one_task():
                pass
        assert self.jm.tasks_failed == self.tm.tasks_failed
        assert self.jm.tasks_succeeded == self.tm.tasks_succeeded

    def state(self, table):
        """Segment set, lineage states, watermarks and the IdealState of
        each cluster, task ids masked; asserted equal."""
        got = []
        for c, *_ in self.both():
            names = sorted(_mask(n) for n in c.store.segment_names(table))
            lineage = [(e["state"], sorted(map(_mask, e["segmentsFrom"])),
                        sorted(map(_mask, e["segmentsTo"])))
                       for e in c.store.get(f"lineage/{table}") or []]
            marks = {t: c.controller.task_manager.get_watermark_ms(table, t)
                     for t in (jtasks.MERGE_ROLLUP_TASK,
                               jtasks.REALTIME_TO_OFFLINE_TASK)}
            ideal = {_mask(s): m for s, m in
                     c.store.get_ideal_state(table).items()}
            tasks = sorted((t.task_type, t.status, t.error is None,
                            sorted(map(_mask, t.output_segments)))
                           for t in c.controller.task_manager.list_tasks(
                               table=table))
            got.append((names, lineage, marks, ideal, tasks))
        assert got[0] == got[1]
        return got[1]

    def rows(self, sql):
        j, t = self.j.query_rows(sql), self.t.query_rows(sql)
        _close(t, j, sql)
        return t

    def shutdown(self):
        self.j.shutdown()
        self.jm.shutdown()
        self.t.shutdown()


def _close(got, want, what):
    assert len(got) == len(want), (what, got, want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-5, abs=1e-6), (what, g, w)
            else:
                assert a == b, (what, g, w)


_ID = re.compile(r"(merged_[A-Za-z]+_\d+_)[0-9a-f]{8}")


def _mask(name):
    return _ID.sub(r"\1<id>", name)


def _task_view(t):
    return (t.task_type, t.table, t.configs, t.input_segments, t.status)


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.shutdown()


def test_merge_rollup_straddling_segment(pair):
    pair.create(lambda mod, tasks: _cfg(mod, tasks))
    pair.ingest("events_OFFLINE", _rows(range(D0, D0 + 100)), "seg_a")
    pair.ingest("events_OFFLINE", _rows(range(D0 + 2000, D0 + 2100)), "seg_b")
    pair.ingest("events_OFFLINE", _rows(range(D1 - 50, D1 + 50)), "seg_c")
    assert pair.rows("SELECT count(*) FROM events") == [[300]]
    created = pair.generate(D2 + DAY_MS)
    assert len(created) == 1 and set(created[0][3]) == {"seg_a", "seg_b",
                                                         "seg_c"}
    pair.run_all()
    names, lineage, _marks, _ideal, tasks = pair.state("events_OFFLINE")
    assert all(n.startswith("merged_") for n in names) and len(names) == 2
    assert [s for s, *_ in lineage] == ["COMPLETED"]
    assert tasks == [(jtasks.MERGE_ROLLUP_TASK, "COMPLETED", True, names)]
    assert pair.rows("SELECT count(*), sum(qty) FROM events") == [[300, 300.0]]
    assert pair.rows(f"SELECT count(*) FROM events WHERE ts >= {D1}") == \
        [[50]]
    # the merged segments are not merged again
    assert pair.generate(D2 + DAY_MS) == []


def test_watermark_advances_on_completion(pair):
    pair.create(lambda mod, tasks: _cfg(mod, tasks))
    for name, lo in (("d0_a", D0), ("d0_b", D0 + 20), ("d2_a", D2),
                     ("d2_b", D2 + 20)):
        pair.ingest("events_OFFLINE", _rows(range(lo, lo + 10)), name)
    now = D2 + 2 * DAY_MS
    first = pair.generate(now)
    assert len(first) == 1 and first[0][2]["windowStartMs"] == str(D0)
    marks = pair.state("events_OFFLINE")[2]
    wm = marks[jtasks.MERGE_ROLLUP_TASK]
    assert wm is None or wm <= D0
    assert pair.generate(now) == []     # in flight: no duplicate
    pair.run_all()
    second = pair.generate(now)
    assert len(second) == 1 and second[0][2]["windowStartMs"] == str(D2)
    # the walk starts again from the oldest unmerged segment's bucket
    assert pair.state("events_OFFLINE")[2][jtasks.MERGE_ROLLUP_TASK] in (
        None, D2)
    pair.run_all()
    pair.state("events_OFFLINE")
    assert pair.rows("SELECT count(*) FROM events") == [[40]]


def _purge_cfg(mod, tasks):
    return _cfg(mod, tasks, name="purgeme", task=tasks.PURGE_TASK, conf={})


def test_retry_cap_and_pruning(pair):
    pair.create(_purge_cfg, name="purgeme")
    pair.ingest("purgeme_OFFLINE", _rows(range(D0, D0 + 10)), "p0")
    for _ in range(jtasks.MAX_TASK_ATTEMPTS + 2):
        pair.generate(D2)       # no purger registered: every task errors
        pair.run_all()
    tasks = pair.state("purgeme_OFFLINE")[4]
    assert [s for _t, s, *_ in tasks] == ["ERROR"] * jtasks.MAX_TASK_ATTEMPTS
    assert pair.tm.tasks_failed == jtasks.MAX_TASK_ATTEMPTS
    import time
    far = int(time.time() * 1000) + jtasks.TERMINAL_TASK_TTL_MS + 1000
    for c, *_ in pair.both():
        tm = c.controller.task_manager
        assert tm.prune_terminal_tasks(far) == jtasks.MAX_TASK_ATTEMPTS
        assert tm.list_tasks() == []


def test_purge(pair):
    pair.create(_purge_cfg, name="purgeme")
    rows = {"k": ["a", "b", "a", "c"] * 25, "qty": list(range(100)),
            "ts": list(range(D0, D0 + 100))}
    pair.ingest("purgeme_OFFLINE", rows, "p0")
    JPurge.PURGERS["purgeme"] = lambda row: row["k"] == "a"
    PurgeTaskExecutor.PURGERS["purgeme"] = lambda cols: cols["k"] == "a"
    try:
        assert len(pair.generate(D2)) == 1
        pair.run_all()
    finally:
        JPurge.PURGERS.pop("purgeme")
        PurgeTaskExecutor.PURGERS.pop("purgeme")
    names = pair.state("purgeme_OFFLINE")[0]
    assert names == ["purged_p0_all_0"]
    assert pair.rows("SELECT k, count(*), sum(qty) FROM purgeme GROUP BY k "
                     "ORDER BY k") == [["b", 25, float(sum(range(1, 100, 4)))],
                                       ["c", 25, float(sum(range(3, 100, 4)))]]
    assert pair.generate(D2) == []      # purged_ segments are left alone
    # the purged directory is byte-equal to JAX's
    jd = pair.j.store.get_segment_metadata("purgeme_OFFLINE", names[0])
    td = pair.t.store.get_segment_metadata("purgeme_OFFLINE", names[0])
    _dirs_equal([jd.download_url[7:]], [td.download_url[7:]])


def _raw_cfg(mod, tasks):
    return _cfg(mod, tasks, name="mnt", task=tasks.CONVERT_TO_RAW_TASK,
                conf={"columnsToConvert": "qty"})


def test_convert_to_raw_refresh_swap(pair):
    """The refresh push under the same name: the port's server swaps the
    converted segment in (a new object, raw ``qty``), its resident and
    plans follow, the rows equal JAX's; the generator stops."""
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.query import compile_query

    pair.create(_raw_cfg, name="mnt")
    rows = {"k": ["a", "b"] * 200, "qty": list(range(400)),
            "ts": list(range(D0, D0 + 400))}
    pair.ingest("mnt_OFFLINE", rows, "mnt_0")
    sql = "SELECT k, sum(qty), max(qty) FROM mnt GROUP BY k ORDER BY k"
    before = pair.rows(sql)
    srv = pair.t.servers["server_0"]
    old = srv.data_manager.get("mnt_OFFLINE").acquire_segments(["mnt_0"])
    old_seg = old[0].segment
    srv.data_manager.get("mnt_OFFLINE").release_segments(old)
    assert old_seg.metadata.columns["qty"].has_dictionary
    srv.executor.residency.drain_prefetch()
    assert len(pair.generate(None)) == 1
    pair.run_all()
    pair.state("mnt_OFFLINE")
    for c, *_ in pair.both():
        md = c.store.get_segment_metadata("mnt_OFFLINE", "mnt_0")
        assert md.custom.get("convertToRawDone") == "qty"
    assert pair.rows(sql) == before
    held = srv.data_manager.get("mnt_OFFLINE").acquire_segments(["mnt_0"])
    new_seg = held[0].segment
    srv.data_manager.get("mnt_OFFLINE").release_segments(held)
    assert new_seg is not old_seg
    assert not new_seg.metadata.columns["qty"].has_dictionary
    # the aggregations read qty as a raw value column (dictionary False)
    plan = plan_segment(compile_query(sql), new_seg)
    assert {a[2] for a in plan.spec[1]} == {("col", "qty", False)}
    assert {a[2] for a in plan_segment(compile_query(sql), old_seg)
            .spec[1]} == {("col", "qty", True)}
    srv.executor.residency.drain_prefetch()
    resident = srv.executor.residency._entries.get("mnt_0")
    assert resident is None or resident.resident.segment is new_seg
    assert pair.generate(None) == []


def test_reload_is_not_a_refresh(tmp_path):
    """A reload changes the served segment's CRC, not the pushed one: a
    later IdealState change fetches nothing again; a push under the name
    with a new CRC does."""
    cluster = EmbeddedCluster(num_servers=1, device="cpu",
                              data_dir=str(tmp_path))
    try:
        cluster.create_table(_cfg(ttable, ttasks), _schema(tdata))
        cluster.ingest_rows("events_OFFLINE", _schema(tdata),
                            _rows(range(D0, D0 + 50)), segment_name="a")
        assert cluster.wait_for_ev_converged("events_OFFLINE")
        cfg = cluster.store.get_table_config("events_OFFLINE")
        cfg.indexing_config.inverted_index_columns = ["k"]
        cluster.controller.update_table(cfg)
        cluster.controller.reload_table("events_OFFLINE")
        srv = cluster.servers["server_0"]

        def served():
            tdm = srv.data_manager.get("events_OFFLINE")
            held = tdm.acquire_segments(["a"])
            tdm.release_segments(held)
            return held[0].segment

        reloaded = served()
        assert reloaded.metadata.columns["k"].has_inverted_index
        cluster.ingest_rows("events_OFFLINE", _schema(tdata),
                            _rows(range(D1, D1 + 50)), segment_name="b")
        assert served() is reloaded
        cluster.ingest_rows("events_OFFLINE", _schema(tdata),
                            _rows(range(D0, D0 + 70)), segment_name="a")
        assert served() is not reloaded and served().num_docs == 70
        assert cluster.query_rows("SELECT count(*) FROM events") == [[120]]
    finally:
        cluster.shutdown()


def test_time_range_of_a_dimension_time_column(pair):
    """A time column declared as a DIMENSION: JAX's segment builder records
    no time range, so its generator finds no candidate; the port's
    controller reads the table's time column, so its generator merges."""
    pair.create(lambda mod, tasks: _cfg(mod, tasks), ts_type="DIMENSION")
    pair.ingest("events_OFFLINE", _rows(range(D0, D0 + 10)), "a",
                ts_type="DIMENSION")
    pair.ingest("events_OFFLINE", _rows(range(D0 + 50, D0 + 60)), "b",
                ts_type="DIMENSION")
    jtm, ttm = (c.controller.task_manager for c, *_ in pair.both())
    assert jtm.generate_tasks(now_ms=D2) == []
    created = ttm.generate_tasks(now_ms=D2)
    assert len(created) == 1
    assert sorted(ttm.get(created[0]).input_segments) == ["a", "b"]


def _hybrid_cfg(topic):
    def make(mod, tasks):
        return _cfg(mod, tasks, task=tasks.REALTIME_TO_OFFLINE_TASK,
                    conf={"bucketTimePeriod": "1d",
                          "bufferTimePeriod": "0d"},
                    table_type=mod.TableType.REALTIME,
                    topic=topic + ("_j" if mod is jtable else "_t"))
    return make


def _settled(pair, table):
    from tests.test_torch_hybrid import _settle

    _settle(pair.j, pair.t, table)


def test_realtime_to_offline(pair):
    topic = "rt2off_minion"
    JStream.create(topic + "_j", 1)
    TStream.create(topic + "_t", 1)
    try:
        pair.create(lambda mod, tasks: _cfg(mod, tasks, conf={}),
                    name="events")
        pair.create(_hybrid_cfg(topic), name="events")
        msgs = [{"k": f"k{i % 3}", "qty": i, "ts": D0 + i * 3_000_000}
                for i in range(250)]
        for m in msgs:
            JStream.get(topic + "_j").produce(m, partition=0)
            TStream.get(topic + "_t").produce(m, partition=0)
        _settled(pair, "events_REALTIME")
        sql = "SELECT k, count(*), sum(qty) FROM events GROUP BY k ORDER BY k"
        want = [[f"k{j}", len(range(j, 250, 3)), float(sum(range(j, 250, 3)))]
                for j in range(3)]
        assert pair.rows(sql) == want
        now = D0 + 20 * DAY_MS
        created = pair.generate(now)
        assert len(created) == 1
        assert created[0][2]["windowStartMs"] == str(D0)
        pair.run_all()
        offline = pair.state("events_OFFLINE")[0]
        assert offline == [f"rt2off_events_{D0}_all_0"]
        marks = pair.state("events_REALTIME")[2]
        assert marks[jtasks.REALTIME_TO_OFFLINE_TASK] == D1
        assert pair.rows(sql) == want
        # windows move one a round until the consuming segment blocks
        while pair.generate(now):
            pair.run_all()
        assert pair.rows(sql) == want
        got = pair.state("events_OFFLINE")[0]
        assert len(got) > 1
        for c, *_ in pair.both():
            tm = c.controller.task_manager
            assert tm.get_watermark_ms("events_REALTIME",
                                       jtasks.REALTIME_TO_OFFLINE_TASK) > D1
    finally:
        for c, *_ in pair.both():
            for table in ("events_REALTIME",):
                for cons in getattr(c, "consumers", lambda t: [])(table):
                    cons.stop()
        JStream.delete(topic + "_j")
        TStream.delete(topic + "_t")


# -- the lineage swap under running queries (the port) ---------------------------

def test_lineage_hammer(tmp_path):
    """4 client threads run count(*) and sum(qty) while merges swap
    segments behind lineage: every answer equals the oracle."""
    cluster = EmbeddedCluster(num_servers=2, device="cpu",
                              data_dir=str(tmp_path))
    try:
        cfg = _cfg(ttable, ttasks)
        cfg.validation_config.replication = 2
        cluster.create_table(cfg, _schema(tdata))
        total = 0
        for d in range(4):
            for j in range(3):
                lo = D0 + d * DAY_MS + j * 1000
                cluster.ingest_rows("events_OFFLINE", _schema(tdata),
                                    _rows(range(lo, lo + 50), qty=d + 1),
                                    segment_name=f"s_{d}_{j}")
                total += 50 * (d + 1)
        assert cluster.wait_for_ev_converged("events_OFFLINE")
        minion = cluster.add_minion(start=False)
        stop = threading.Event()
        bad, seen = [], [0]

        def client():
            while not stop.is_set():
                rows = cluster.query_rows(
                    "SELECT count(*), sum(qty) FROM events")
                seen[0] += 1
                if rows != [[600, float(total)]]:
                    bad.append(rows)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            while cluster.controller.run_task_generation(
                    now_ms=D0 + 10 * DAY_MS):
                while minion.run_one_task():
                    pass
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert not bad, bad[:3]
        assert seen[0] > 0 and minion.tasks_succeeded == 4
        names = cluster.store.segment_names("events_OFFLINE")
        assert len(names) == 4 and all(n.startswith("merged_")
                                       for n in names)
        assert [e["state"] for e in cluster.store.get(
            "lineage/events_OFFLINE")] == ["COMPLETED"] * 4
    finally:
        cluster.shutdown()
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("minion-", "controller-periodic"))]


def _merge_cluster(tmp_path, days=2):
    """2 servers at replication 2, ``days`` days of 3 segments (qty d+1)
    under a 1-day MergeRollup, and a minion run by hand."""
    cluster = EmbeddedCluster(num_servers=2, device="cpu",
                              data_dir=str(tmp_path))
    cfg = _cfg(ttable, ttasks)
    cfg.validation_config.replication = 2
    cluster.create_table(cfg, _schema(tdata))
    total = 0
    for d in range(days):
        for j in range(3):
            lo = D0 + d * DAY_MS + j * 1000
            cluster.ingest_rows("events_OFFLINE", _schema(tdata),
                                _rows(range(lo, lo + 50), qty=d + 1),
                                segment_name=f"s_{d}_{j}")
            total += 50 * (d + 1)
    assert cluster.wait_for_ev_converged("events_OFFLINE")
    return cluster, cluster.add_minion(start=False), [[days * 150,
                                                       float(total)]]


def test_merge_outputs_not_online_keep_the_inputs(tmp_path):
    """Outputs pushed but served nowhere (every server's fetch of them
    fails): the swap waits for them, reverts at its timeout, and the
    inputs keep answering. Without the wait the entry went COMPLETED, the
    inputs were hidden and deleted, and a day's rows were gone."""
    cluster, minion, oracle = _merge_cluster(tmp_path)
    try:
        cluster.controller.replace_timeout_s = 0.3
        for server in cluster.servers.values():
            fetch = server._fetch

            def refuse(url, _fetch=fetch):
                if "merged_" in url:
                    raise OSError("deep store unreachable")
                return _fetch(url)

            server._fetch = refuse
        assert cluster.controller.run_task_generation(
            now_ms=D0 + 10 * DAY_MS)
        assert minion.run_one_task()
        assert cluster.query_rows(
            "SELECT count(*), sum(qty) FROM events") == oracle
        assert minion.tasks_failed == 1 and minion.tasks_succeeded == 0
        assert [e["state"] for e in cluster.store.get(
            "lineage/events_OFFLINE")] == ["REVERTED"]
        assert {"s_0_0", "s_0_1", "s_0_2"} <= set(
            cluster.store.segment_names("events_OFFLINE"))
    finally:
        cluster.shutdown()


def test_query_routed_before_the_swap(tmp_path):
    """A query routed to a merge's inputs reaches its server only after
    the merge swapped them out and deleted them: the server reports the
    segments missing and the broker routes the query again, to the
    outputs. Without that the answer lost the inputs' rows. The route
    given up is a decision, and the launches its servers made stay in the
    response's counts (one stands in for each server answer: the plain
    version counts none). The second day's segments answer in the route
    given up, so it made launches of its own."""
    cluster, minion, oracle = _merge_cluster(tmp_path)
    try:
        routed, go = threading.Event(), threading.Event()
        blocked = []
        for server in cluster.servers.values():
            run = server.execute_query
            answer = server.executor.execute_instance

            def launched(ctx, segments, _answer=answer):
                dt = _answer(ctx, segments)
                dt.stats.scan_launches += 1
                return dt

            server.executor.execute_instance = launched

            def held(ctx, table, segments=None, _run=run):
                if not go.is_set():
                    blocked.append(segments)
                    routed.set()
                    assert go.wait(timeout=20)
                return _run(ctx, table, segments)

            server.execute_query = held
        out = []
        client = threading.Thread(target=lambda: out.append(
            cluster.query("SELECT count(*), sum(qty) FROM events")))
        client.start()
        try:
            assert routed.wait(timeout=20)
            assert cluster.controller.run_task_generation(
                now_ms=D0 + 10 * DAY_MS)
            assert minion.run_one_task() and minion.tasks_succeeded == 1
            assert not any(n.startswith("s_0_") for n in
                           cluster.store.segment_names("events_OFFLINE"))
        finally:
            go.set()
            client.join(timeout=20)
        assert not client.is_alive()
        assert any(s.startswith("s_0_") for b in blocked for s in b)
        resp = out[0]
        assert not resp.exceptions, resp.exceptions
        assert resp.result_table.rows == oracle
        assert resp.stats.decisions[
            "route:snapshot->rerouted:segments_missing"] == 1
        served = sum(s.launch_debug()["launches"].get("scanLaunches", 0)
                     for s in cluster.servers.values())
        assert resp.stats.scan_launches == served >= 2
    finally:
        cluster.shutdown()


def test_add_minion_needs_data_dir():
    cluster = EmbeddedCluster(num_servers=1, device="cpu")
    try:
        with pytest.raises(ValueError):
            cluster.add_minion()
    finally:
        cluster.shutdown()


def test_minion_thread_runs_and_joins(tmp_path):
    cluster = EmbeddedCluster(num_servers=1, device="cpu",
                              data_dir=str(tmp_path))
    try:
        cluster.create_table(_cfg(ttable, ttasks), _schema(tdata))
        for j in range(2):
            cluster.ingest_rows("events_OFFLINE", _schema(tdata),
                                _rows(range(D0 + j, D0 + j + 5)),
                                segment_name=f"s{j}")
        assert cluster.wait_for_ev_converged("events_OFFLINE")
        minion = cluster.add_minion(start=True)
        cluster.controller.run_task_generation(now_ms=D2)
        import time
        deadline = time.monotonic() + 20
        while minion.tasks_succeeded < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert cluster.query_rows("SELECT count(*) FROM events") == [[10]]
    finally:
        cluster.shutdown()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("minion-")]


def test_chip_smoke_phase_20_small():
    import chip_smoke

    out = chip_smoke.phase_lifecycle(1, device="cpu", **chip_smoke
                                     .LIFECYCLE_SMALL)
    assert out["merge"]["tasks"] > 0 and out["merge"]["bad_answers"] == 0
    assert out["merge"]["merged_segments"] > 0
    assert out["merge"]["lineage_entries"] == out["merge"]["tasks"]
    assert out["rollup"]["rows_out"] < out["rollup"]["rows_in"]
    assert out["realtime"]["tasks"] > 0
    assert out["realtime"]["boundary_after"] is not None
    assert out["purge_convert"]["replicas_converted"] == 2
    assert out["tiers"]["relocation"]["moved"] > 0
    assert out["tiers"]["rebalance"]["hosted"]["server_5"] > 0
    assert out["geo"]["queries"] == 5
