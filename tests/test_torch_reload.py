"""The reload: indexes a table config gained, added to its segments on disk
(``pinot_tpu_torch/segment/preprocessor.py``, the server's reload
transition, ``Controller.reload_table``) against the JAX package's
(oracle tests/test_reload.py).

- ``preprocess_segment`` adds every kind JAX's adds (inverted, bloom,
  text, JSON, range) with the same labels, and the directory comes out
  byte-equal to JAX's after the same reload, CRC included; a second call
  adds nothing.
- ``update_table`` then ``reload_table`` in ``EmbeddedCluster(device=
  "cpu", data_dir=...)``: every replica serves the new indexes (flags and
  the ``index:`` decisions JAX records), the rows unchanged and equal to
  JAX's cluster's.
- Replicas that share one ``file://`` directory (both serve it in place):
  in the port both swap in the reloaded segment (one adds the files, the
  other finds the directory's CRC changed); in JAX the second replica
  finds nothing to add and keeps serving the segment without the index
  (pinned here, ROADMAP queue 3).
- Concurrent reloads of one directory serialise on its lock and leave a
  directory whose CRC verifies. ``table_size`` is the bytes on disk.
"""

import json
import os
import threading

import numpy as np
import pytest

from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu.segment import load_segment as j_load
from pinot_tpu.segment.preprocessor import preprocess_segment as j_pre
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.segment.immutable import load_segment, verify_crc
from pinot_tpu_torch.segment.preprocessor import preprocess_segment
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.tools.cluster import EmbeddedCluster

N = 3000
FULL = dict(inverted_index_columns=["city"], bloom_filter_columns=["city"],
            text_index_columns=["city"], json_index_columns=["doc"],
            range_index_columns=["amt"], no_dictionary_columns=["amt"])


def _schema(mod):
    return mod.Schema("rl", [
        mod.FieldSpec("city", mod.DataType.STRING),
        mod.FieldSpec("doc", mod.DataType.STRING),
        mod.FieldSpec("amt", mod.DataType.LONG, mod.FieldType.METRIC),
        mod.FieldSpec("v", mod.DataType.LONG, mod.FieldType.METRIC)])


def _rows(n=N, seed=2):
    rng = np.random.default_rng(seed)
    return {"city": np.array(["sf", "nyc", "sea"])[rng.integers(0, 3, n)],
            "doc": np.array([json.dumps({"t": f"tag{i % 7}"})
                             for i in range(n)]),
            "amt": rng.integers(0, 10_000, n).astype(np.int64),
            "v": np.ones(n, dtype=np.int64)}


def _build_both(tmp_path, name="rl_0"):
    rows = _rows()
    JBuilder(_schema(jdata), name, indexing_config=jtable.IndexingConfig(
        no_dictionary_columns=["amt"])).build(rows, str(tmp_path / "j"))
    SegmentBuilder(_schema(tdata), name, indexing=ttable.IndexingConfig(
        no_dictionary_columns=["amt"])).build(rows, str(tmp_path / "t"))
    return str(tmp_path / "j" / name), str(tmp_path / "t" / name)


def _columns_bytes(seg_dir):
    col = os.path.join(seg_dir, "columns")
    return {f: open(os.path.join(col, f), "rb").read()
            for f in sorted(os.listdir(col))}


def test_adds_every_kind_as_jax_does(tmp_path):
    jd, td = _build_both(tmp_path)
    old_crc = load_segment(td).metadata.crc
    jadded = j_pre(jd, jtable.IndexingConfig(**FULL))
    tadded = preprocess_segment(td, ttable.IndexingConfig(**FULL))
    assert sorted(tadded) == sorted(jadded) == [
        "amt:range", "city:bloom", "city:inverted", "city:text", "doc:json"]
    assert _columns_bytes(td) == _columns_bytes(jd)
    seg, jseg = load_segment(td), j_load(jd)
    assert seg.metadata.crc == jseg.metadata.crc != old_crc
    assert verify_crc(td)
    for col, cm in seg.metadata.columns.items():
        jcm = jseg.metadata.column(col)
        assert (cm.has_inverted_index, cm.has_bloom_filter,
                cm.has_text_index, cm.has_json_index, cm.has_range_index) \
            == (jcm.has_inverted_index, jcm.has_bloom_filter,
                jcm.has_text_index, jcm.has_json_index, jcm.has_range_index)
    city = seg.data_source("city")
    assert len(city.doc_ids_for_dict_id(0)) > 0
    assert city.bloom_filter.might_contain("sf")
    assert len(city.text_index.matching_ids("sf")) == 1
    assert seg.data_source("doc").json_index.match(
        '"$.t"=\'tag3\'').sum() == N // 7 + (N % 7 > 3)
    # no temporary file is left beside the index files
    assert not [f for f in os.listdir(os.path.join(td, "columns"))
                if f.startswith(".")]


def test_reload_of_multi_value_and_raw_columns_equals_jax(tmp_path):
    """tests/test_torch_columns.py's stats rows (MV, raw, nullable
    columns) built without indexes, then both packages' reload of an
    inverted index on the MV and dictionary columns, a bloom filter on a
    raw and a nullable column and a range index on a raw one: the same
    labels and byte-equal directories."""
    from tests.test_torch_columns import RAW, stats_frame, stats_schema
    from tests.test_torch_segment_disk import _stats_schema

    rows = stats_frame()
    JBuilder(stats_schema(), "stats_0", indexing_config=jtable.IndexingConfig(
        no_dictionary_columns=RAW)).build(rows, str(tmp_path / "j"))
    SegmentBuilder(_stats_schema(tdata), "stats_0",
                   indexing=ttable.IndexingConfig(
                       no_dictionary_columns=RAW)).build(
        rows, str(tmp_path / "t"))
    cfg = dict(inverted_index_columns=["tags", "nums", "team"],
               bloom_filter_columns=["salary", "nick"],
               range_index_columns=["ratio"], no_dictionary_columns=RAW)
    jd, td = str(tmp_path / "j" / "stats_0"), str(tmp_path / "t" / "stats_0")
    assert sorted(preprocess_segment(td, ttable.IndexingConfig(**cfg))) \
        == sorted(j_pre(jd, jtable.IndexingConfig(**cfg)))
    assert _columns_bytes(td) == _columns_bytes(jd)
    seg, jseg = load_segment(td), j_load(jd)
    assert seg.metadata.crc == jseg.metadata.crc
    tags = seg.data_source("tags")
    for d in range(seg.metadata.column("tags").cardinality):
        np.testing.assert_array_equal(
            tags.doc_ids_for_dict_id(d),
            jseg.data_source("tags").doc_ids_for_dict_id(d))


def test_idempotent(tmp_path):
    _, td = _build_both(tmp_path)
    cfg = ttable.IndexingConfig(inverted_index_columns=["city"])
    assert preprocess_segment(td, cfg) == ["city:inverted"]
    crc = load_segment(td).metadata.crc
    assert preprocess_segment(td, cfg) == []
    assert load_segment(td).metadata.crc == crc


def test_concurrent_reloads_of_one_directory(tmp_path):
    _, td = _build_both(tmp_path)
    cfg = ttable.IndexingConfig(**FULL)
    got, errors = [], []

    def run():
        try:
            got.append(preprocess_segment(td, cfg))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    assert sorted(len(a) for a in got) == [0, 0, 0, 5]
    assert verify_crc(td)


SQL_JSON = "SELECT count(*) FROM rl WHERE json_match(doc, '\"$.t\"=''tag2''')"
SQL_CITY = "SELECT count(*), sum(amt) FROM rl WHERE city = 'sf'"


def _served(cluster, server, table="rl_OFFLINE"):
    tdm = cluster.servers[server].data_manager.get(table)
    held = tdm.acquire_segments(None)
    try:
        return [h.segment for h in held]
    finally:
        tdm.release_segments(held)


def _clusters(tmp_path, servers, replication):
    jc = JCluster(num_servers=servers, data_dir=str(tmp_path / "jc"))
    pc = EmbeddedCluster(num_servers=servers, device="cpu",
                         data_dir=str(tmp_path / "pc"))
    for mod, c in ((jtable, jc), (ttable, pc)):
        cfg = mod.TableConfig("rl", indexing_config=mod.IndexingConfig(
            no_dictionary_columns=["amt"]))
        cfg.validation_config.replication = replication
        c.create_table(cfg, _schema(jdata if mod is jtable else tdata))
    return jc, pc


def _update_and_reload(jc, pc):
    for mod, c in ((jtable, jc), (ttable, pc)):
        cfg = mod.TableConfig("rl", indexing_config=mod.IndexingConfig(
            no_dictionary_columns=["amt"], json_index_columns=["doc"],
            inverted_index_columns=["city"]))
        cfg.validation_config.replication = 2
        c.controller.update_table(cfg)
        c.controller.reload_table("rl_OFFLINE")


def test_update_table_then_reload_on_every_replica(tmp_path):
    jc, pc = _clusters(tmp_path, servers=2, replication=2)
    try:
        for c in (jc, pc):
            for i in range(2):
                c.ingest_rows("rl_OFFLINE", _schema(
                    jdata if c is jc else tdata), _rows(1000, seed=i),
                    segment_name=f"rl_{i}")
            assert c.wait_for_ev_converged("rl_OFFLINE")
        before = {sql: pc.query_rows(sql) for sql in (SQL_JSON, SQL_CITY)}
        for sql, rows in before.items():
            assert rows == jc.query_rows(sql), sql
        old = {s: _served(pc, s) for s in pc.servers}
        _update_and_reload(jc, pc)
        for s in pc.servers:
            segs = _served(pc, s)
            assert len(segs) == 2
            for seg in segs:
                assert seg not in old[s]        # swapped in
                assert seg.metadata.column("doc").has_json_index
                assert seg.metadata.column("city").has_inverted_index
                assert verify_crc(seg.segment_dir)
        assert not any(srv.reload_failures for srv in pc.servers.values())
        for sql, rows in before.items():
            got, want = pc.query(sql), jc.query(sql)
            assert got.result_table.rows == rows == want.result_table.rows
            idx = {k: v for k, v in got.stats.decisions.items()
                   if k.startswith("index:")}
            jidx = {k: v for k, v in want.stats.decisions.items()
                    if k.startswith("index:")}
            assert idx == jidx, sql
        # table_size: the bytes of each hosted directory
        for s, srv in pc.servers.items():
            size = srv.table_size("rl_OFFLINE")
            for seg in _served(pc, s):
                assert size["segments"][seg.segment_name] == sum(
                    os.path.getsize(os.path.join(r, f))
                    for r, _d, fs in os.walk(seg.segment_dir) for f in fs)
            assert size["totalBytes"] == sum(size["segments"].values()) > 0
            assert srv.memory_debug()["nativeMmapBuffers"] > 0
    finally:
        jc.shutdown()
        pc.shutdown()
        TELEMETRY.reset()
    assert not os.path.exists(tmp_path / "pc")


def test_replicas_sharing_one_directory(tmp_path):
    jc, pc = _clusters(tmp_path, servers=2, replication=2)
    try:
        for c, mod, b in ((jc, jdata, JBuilder), (pc, tdata, SegmentBuilder)):
            out = str(tmp_path / f"pushed_{c is pc}")
            if c is jc:
                b(_schema(mod), "rl_0", indexing_config=jtable.IndexingConfig(
                    no_dictionary_columns=["amt"])).build(_rows(), out)
            else:
                b(_schema(mod), "rl_0", indexing=ttable.IndexingConfig(
                    no_dictionary_columns=["amt"])).build(_rows(), out)
            c.upload_segment_dir("rl_OFFLINE", os.path.join(out, "rl_0"))
            assert c.wait_for_ev_converged("rl_OFFLINE")
        pdirs = {s: _served(pc, s)[0].segment_dir for s in pc.servers}
        assert len(set(pdirs.values())) == 1    # served in place, shared
        _update_and_reload(jc, pc)
        flags = [_served(pc, s)[0].metadata.column("doc").has_json_index
                 for s in sorted(pc.servers)]
        assert flags == [True, True]
        # JAX: the second replica found nothing to add and kept its old
        # segment (pinot_tpu/segment/preprocessor.py:117-119)
        jflags = []
        for s in sorted(jc.servers):
            tdm = jc.servers[s].data_manager.get("rl_OFFLINE")
            held = tdm.acquire_segments(None)
            jflags.append(held[0].segment.metadata.column(
                "doc").has_json_index)
            tdm.release_segments(held)
        assert sorted(jflags) == [False, True]
        assert pc.query_rows(SQL_JSON) == jc.query_rows(SQL_JSON)
    finally:
        jc.shutdown()
        pc.shutdown()
        TELEMETRY.reset()


def test_shutdown_keeps_what_the_cluster_did_not_make(tmp_path):
    """A ``data_dir`` that already held files: ``shutdown`` removes the
    two subdirectories the cluster made and leaves the caller's files,
    a segment directory pushed in place among them."""
    data = tmp_path / "data"
    data.mkdir()
    (data / "keep.txt").write_text("the caller's")
    pushed = data / "mine"
    SegmentBuilder(_schema(tdata), "rl_0", indexing=ttable.IndexingConfig(
        no_dictionary_columns=["amt"])).build(_rows(200), str(pushed))
    pc = EmbeddedCluster(num_servers=1, device="cpu", data_dir=str(data))
    try:
        cfg = ttable.TableConfig("rl", indexing_config=ttable.IndexingConfig(
            no_dictionary_columns=["amt"]))
        pc.create_table(cfg, _schema(tdata))
        pc.upload_segment_dir("rl_OFFLINE", str(pushed / "rl_0"))
        pc.ingest_rows("rl_OFFLINE", _schema(tdata), _rows(200, seed=1),
                       segment_name="rl_1")
        assert pc.wait_for_ev_converged("rl_OFFLINE")
        assert (data / "built_segments" / "rl_1").is_dir()
    finally:
        pc.shutdown()
        TELEMETRY.reset()
    assert sorted(os.listdir(data)) == ["keep.txt", "mine"]
    assert verify_crc(str(pushed / "rl_0"))


def test_fetch_segment_resolves_file_urls(tmp_path, monkeypatch):
    from pinot_tpu_torch.spi import filesystem

    seg_dir = tmp_path / "seg"
    seg_dir.mkdir()
    url = filesystem.file_url(str(seg_dir))
    assert filesystem.fetch_segment(url) == str(seg_dir)
    assert filesystem.fetch_segment(str(seg_dir)) == str(seg_dir)
    # a missing directory is tried FETCH_ATTEMPTS times, then raises (the
    # retry policy's AttemptsExceededError, the last failure beside it)
    from pinot_tpu_torch.spi import retry

    waits = []
    monkeypatch.setattr(retry.time, "sleep", waits.append)
    with pytest.raises(retry.AttemptsExceededError) as e:
        filesystem.fetch_segment(filesystem.file_url(str(tmp_path / "no")))
    assert isinstance(e.value.last, FileNotFoundError)
    assert waits == [filesystem.FETCH_BACKOFF_S * 2 ** i
                     for i in range(filesystem.FETCH_ATTEMPTS - 1)]
    # an unknown scheme, and a remote one with no local directory or
    # endpoint, fail at once
    waits.clear()
    monkeypatch.delenv("PINOT_S3_ENDPOINT", raising=False)
    for url in ("gs://bucket/seg", "s3://bucket/seg"):
        with pytest.raises(ValueError):
            filesystem.fetch_segment(url)
    assert waits == []


def test_segments_kept_in_memory_have_nothing_to_reload():
    pc = EmbeddedCluster(num_servers=1, device="cpu")
    try:
        cfg = ttable.TableConfig("rl")
        pc.create_table(cfg, _schema(tdata))
        pc.ingest_rows("rl_OFFLINE", _schema(tdata), _rows(500),
                       segment_name="rl_0")
        assert pc.wait_for_ev_converged("rl_OFFLINE")
        seg = _served(pc, "server_0")[0]
        assert seg.segment_dir is None
        pc.controller.update_table(ttable.TableConfig(
            "rl", indexing_config=ttable.IndexingConfig(
                inverted_index_columns=["city"])))
        pc.controller.reload_table("rl_OFFLINE")
        assert _served(pc, "server_0")[0] is seg
        assert not pc.servers["server_0"].reload_failures
        assert pc.servers["server_0"].table_size("rl_OFFLINE")[
            "totalBytes"] == 0
        with pytest.raises(KeyError):
            pc.controller.reload_table("nope_OFFLINE")
    finally:
        pc.shutdown()
        TELEMETRY.reset()


def test_chip_smoke_phase_19_small():
    """chip_smoke's phase 19 on the CPU: 48 k SSB rows in 8 segments
    written, verified, loaded and queried per segment and over the batch
    (rows identical to the in-memory segments'), pushed by file:// to 4
    servers at replication 2 (table_size == the bytes on disk), reloaded
    with the inverted and bloom indexes (Q2.1 and Q3.1 leave
    index_missing_index), a 2000-row upsert table flushed every 500 with
    a DISCARD replica a seal; then 19c's star-tree part on 2 segments with
    their five trees (the plain version counts no launch)."""
    import chip_smoke
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    segs, frames = ssb.build_segments(0, num_segments=8, seed=3,
                                      rows=48_000)
    ctxs = {q: compile_query(t + " LIMIT 100000")
            for q, t in ssb.QUERIES.items()}
    ex = ServerQueryExecutor(device="cpu")
    main = {"segs": segs, "ctxs": ctxs, "rows": 48_000,
            "wants": {q: ssb.merge_answers(
                [ssb.numpy_answer(f, q) for f in frames]) for q in ctxs},
            "results": {q: ex.execute(c, segs)[0] for q, c in ctxs.items()},
            "kept": {q: len(prune_segments(c, segs))
                     for q, c in ctxs.items()}}
    try:
        run = chip_smoke.phase_disk(main, reps=1, device="cpu",
                                    upsert_rows=2000, upsert_flush=500)
    finally:
        TELEMETRY.reset()
    assert run["segments"] == 8 and run["bytes"] > 0
    assert sum(run["table_size"].values()) == 2 * run["bytes"]
    assert set(run["reload_decisions"]) == set(
        chip_smoke.DISK_INDEXED_FLIGHTS)
    assert run["upsert"]["sealed"] == run["upsert"]["fetched"] == 4
    assert run["launches"] == {k: 0 for k in run["launches"]}

    tsegs, tframes = ssb.build_segments(0, num_segments=2, seed=42,
                                        rows=8000, star_tree=True,
                                        workers=1)
    texts = {q: t + " LIMIT 100000" for q, t in ssb.QUERIES.items()}
    tctxs = {q: compile_query(t) for q, t in texts.items()}
    twants = {q: ssb.merge_answers([ssb.numpy_answer(f, q)
                                    for f in tframes]) for q in texts}
    kept = {q: prune_segments(c, tsegs) for q, c in tctxs.items()}
    trees = chip_smoke.phase_startree_disk(tsegs, tctxs, twants, kept,
                                           device="cpu")
    assert trees["trees"] == 10 and trees["segments"] == 2
