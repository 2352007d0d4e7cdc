"""Realtime seals written to disk, and the DISCARD replica's fetch, in
``EmbeddedCluster(device="cpu", data_dir=...)`` against the JAX
``EmbeddedCluster(data_dir=...)`` (oracle tests/test_cluster.py's realtime
cases and tests/test_reload.py's layout).

- Every seal is a segment directory under its committing server's
  ``server_segments/<instance>/<table>/``, located by ``file://`` in the
  segment's metadata, its CRC verified, its stream offsets and partition
  in ``metadata.json``; the files under ``columns/`` and the default
  star-tree's directory equal, byte for byte, JAX's seal of the same rows,
  and the rows equal pandas and JAX's.
- An upsert table at replication 2 whose second replica is told DISCARD
  (``chip_smoke._DiscardReplica``: the controller's verdict for a replica
  whose offset differs from the committed one): it fetches the committer's directory in place, loads it
  and registers its keys, so every count equals the latest-row oracle
  through the broker and through each server asked alone.
"""

import json
import os

import numpy as np

import chip_smoke
import tests.test_cluster as tc
from pinot_tpu.ingestion import MemoryStream as JStream
from pinot_tpu.spi import table as jtable
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.ingestion import MemoryStream as TStream
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.segment.immutable import verify_crc
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.tools import usertable
from pinot_tpu_torch.tools.cluster import EmbeddedCluster
from tests.test_torch_realtime_cluster import (
    SEED,
    SQLS,
    _close,
    _config,
    _pandas,
    _schema,
    _until,
)

TABLE = "rtsales_REALTIME"
UPSERT_TABLE = "user_events_REALTIME"


def _seal_files(seg_dir):
    out = {}
    for root, _d, files in os.walk(seg_dir):
        for f in files:
            if f == "metadata.json":
                continue
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, seg_dir)] = fh.read()
    return out


def test_seals_are_directories_equal_to_jax(tmp_path):
    df = tc.make_df(1000, seed=41)
    JStream.create("rt_disk_j", 1)
    TStream.create("rt_disk_t", 1)
    jc = JCluster(num_servers=1, data_dir=str(tmp_path / "jc"),
                  llc_seed=SEED)
    pc = EmbeddedCluster(num_servers=1, device="cpu", llc_seed=SEED,
                         data_dir=str(tmp_path / "pc"))
    try:
        jc.create_table(_config(jtable, "rt_disk_j", 400),
                        tc.make_schema("rtsales"))
        pc.create_table(_config(ttable, "rt_disk_t", 400), _schema())
        for r in df.to_dict("records"):
            JStream.get("rt_disk_j").produce(r, partition=0)
            TStream.get("rt_disk_t").produce(r, partition=0)
        assert pc.wait_for_consumers(TABLE)
        online = sorted(md.segment_name
                        for md in pc.store.segment_metadata_list(TABLE)
                        if md.status == "ONLINE")
        assert len(online) == 2
        # the JAX seals land after its count: wait for both ONLINE
        assert _until(lambda: sorted(
            md.segment_name for md in jc.store.segment_metadata_list(TABLE)
            if md.status == "ONLINE") == online)
        tdm = pc.servers["server_0"].data_manager.get(TABLE)
        for seg in online:
            md = pc.store.get_segment_metadata(TABLE, seg)
            seg_dir = md.download_url[len("file://"):]
            assert md.download_url.startswith("file://")
            assert seg_dir == os.path.join(str(tmp_path / "pc"),
                                           "server_segments", "server_0",
                                           TABLE, seg)
            assert verify_crc(seg_dir)
            assert md.crc == json.load(open(os.path.join(
                seg_dir, "metadata.json")))["crc"] != 0
            custom = json.load(open(os.path.join(seg_dir, "metadata.json")))[
                "custom"]
            assert custom["segment.realtime.partition"] == 0
            assert int(custom["segment.realtime.endOffset"]) - int(
                custom["segment.realtime.startOffset"]) == 400
            held = tdm.acquire_segments([seg])
            assert held[0].segment.segment_dir == seg_dir
            tdm.release_segments(held)
            jmd = jc.store.get_segment_metadata(TABLE, seg)
            jdir = jmd.download_url.replace("file://", "")
            assert _seal_files(seg_dir) == _seal_files(jdir), seg
            assert md.crc == jmd.crc
        for key, sql in SQLS.items():
            got = pc.query(sql)
            _close(got.result_table.rows, _pandas(df, key), key)
            _close(got.result_table.rows, jc.query(sql).result_table.rows,
                   key)
    finally:
        jc.shutdown()
        pc.shutdown()
        JStream.delete("rt_disk_j")
        TStream.delete("rt_disk_t")
        TELEMETRY.reset()


def _upsert_cluster(tmp_path, topic, rows, flush, seed=5):
    """An upsert user-events table at replication 2 in an
    ``EmbeddedCluster(data_dir=...)`` whose second replica of each seal is
    told DISCARD, consumed to its end; -> (cluster, frame, gates,
    the ONLINE segment names)."""
    stream = TStream.create(topic, 1)
    frame = usertable.generate_frame(1, 2, rows, seed)
    stream.produce_many(usertable.frame_messages(frame))
    pc = EmbeddedCluster(num_servers=2, device="cpu", llc_seed=SEED,
                         data_dir=str(tmp_path / "pc"))
    # whichever replica the FSM elects, the other is told DISCARD
    gates = {s: chip_smoke._DiscardReplica(srv.completion_protocol)
             for s, srv in pc.servers.items()}
    for s, srv in pc.servers.items():
        srv.completion_protocol = gates[s]
    cfg = usertable.realtime_table_config(topic, flush, upsert=True)
    cfg.validation_config = ttable.SegmentsValidationConfig(
        time_column_name=cfg.validation_config.time_column_name,
        replication=2)
    pc.create_table(cfg, usertable.user_schema(["user_id"]))
    assert pc.wait_for_consumers(UPSERT_TABLE, timeout_s=120)
    online = sorted(md.segment_name
                    for md in pc.store.segment_metadata_list(UPSERT_TABLE)
                    if md.status == "ONLINE")
    return pc, frame, gates, online


def _hosted(pc, seg):
    """Each server's served object of ``seg``."""
    out = []
    for srv in pc.servers.values():
        tdm = srv.data_manager.get(UPSERT_TABLE)
        held = tdm.acquire_segments([seg])
        out.append(held[0].segment)
        tdm.release_segments(held)
    return out


def _check_latest_rows(pc, frame, user=1):
    """U1-U7 through the broker == the oracle over each user's latest
    row, and count(*) == the number of users through each server asked
    alone."""
    wants = usertable.realtime_answers(usertable.latest_per_user(frame),
                                       user)
    for qid, sql in usertable.queries(user).items():
        resp = pc.query(sql)
        assert not resp.exceptions, resp.exceptions
        usertable.check_rows(qid, resp.result_table.rows, wants[qid])
    latest = len(np.unique(frame["user_id"]))
    ctx = compile_query("SELECT count(*) FROM user_events")
    for srv in pc.servers.values():
        dt = srv.execute_query(ctx, UPSERT_TABLE)
        assert pc.broker.reduce_service.reduce(ctx, [dt])[0].rows == \
            [[latest]]


def test_discard_replica_fetches_the_committers_directory(tmp_path):
    rows, flush = 2200, 500
    topic = "user_events_upsert_disk"
    pc, frame, gates, online = _upsert_cluster(tmp_path, topic, rows, flush)
    try:
        assert len(online) == rows // flush
        assert sum(g.discards for g in gates.values()) == len(online)
        for seg in online:
            url = pc.store.get_segment_metadata(UPSERT_TABLE,
                                                seg).download_url
            seg_dir = url[len("file://"):]
            assert verify_crc(seg_dir)
            hosted = _hosted(pc, seg)
            # both replicas serve the committer's directory, each its own
            # loaded object with its own valid-doc view
            assert [h.segment_dir for h in hosted] == [seg_dir, seg_dir]
            assert hosted[0] is not hosted[1]
        fetched = {s: sum(e["fetched"] for e in
                          srv.data_manager.get(UPSERT_TABLE).seals)
                   for s, srv in pc.servers.items()}
        assert sum(fetched.values()) == len(online)
        _check_latest_rows(pc, frame)
    finally:
        pc.shutdown()
        TStream.delete(topic)
        TELEMETRY.reset()
    assert not os.path.exists(tmp_path / "pc")


def test_reload_keeps_the_upsert_valid_docs(tmp_path):
    """``update_table`` then ``reload_table`` on the upsert table: both
    replicas serve each seal reloaded with the new indexes, each still
    behind its own valid-doc view, so the counts stay those of each
    user's latest row."""
    rows, flush = 2200, 500
    topic = "user_events_upsert_reload"
    pc, frame, _gates, online = _upsert_cluster(tmp_path, topic, rows, flush)
    try:
        before = {seg: _hosted(pc, seg) for seg in online}
        _check_latest_rows(pc, frame)
        cfg = pc.store.get_table_config(UPSERT_TABLE)
        cfg.indexing_config.inverted_index_columns.append("device")
        cfg.indexing_config.bloom_filter_columns = ["device", "country"]
        pc.controller.update_table(cfg)
        pc.controller.reload_table(UPSERT_TABLE)
        assert not [f for srv in pc.servers.values()
                    for f in srv.reload_failures]
        for seg in online:
            for old, new in zip(before[seg], _hosted(pc, seg)):
                assert new is not old and verify_crc(new.segment_dir)
                cm = new.metadata.column("device")
                assert cm.has_inverted_index and cm.has_bloom_filter
                assert new.valid_doc_ids is old.valid_doc_ids
                assert not np.all(new.valid_doc_ids[:new.num_docs])
        _check_latest_rows(pc, frame)
    finally:
        pc.shutdown()
        TStream.delete(topic)
        TELEMETRY.reset()
