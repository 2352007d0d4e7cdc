"""The port's LLC segment manager and the controller's realtime path
(``pinot_tpu_torch/controller/llc.py``, ``controller/controller.py``)
against the JAX package's.

A JAX ``Controller(llc_seed=...)`` and the port's over the same servers
each add a 2-partition REALTIME table, commit partition 0's first segment
through ``_on_segment_commit``, and run ``run_realtime_validation`` after a
partition's CONSUMING segment is deleted. After each step the IdealStates
are equal, and so is each segment's metadata: name, status, start and end
offsets, partition, sequence, doc count, time range, and the download URL
past its scheme (JAX keeps a ``file://`` directory, the port ``memory://``).
Each package reads its own ``MemoryStream`` topic. All values are exact.
"""

import types

import numpy as np
import pytest

from pinot_tpu.controller import controller as jcontroller
from pinot_tpu.controller import llc as jllc
from pinot_tpu.controller import state as jstate
from pinot_tpu.ingestion import MemoryStream as JStream
from pinot_tpu.ingestion.stream import StreamOffset as JOffset
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu_torch.controller import controller as tcontroller
from pinot_tpu_torch.controller import llc as tllc
from pinot_tpu_torch.controller import state as tstate
from pinot_tpu_torch.ingestion import MemoryStream as TStream
from pinot_tpu_torch.ingestion.stream import StreamOffset as TOffset
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable

SEED = "20260729T0000Z"
TABLE = "ev_REALTIME"


def _controller(mod, state, data, table, topic, partitions, servers,
                replication):
    c = mod.Controller(llc_seed=SEED)
    for s in servers:
        c.register_instance(state.InstanceInfo(s, "SERVER"))
    c.add_schema(data.Schema("ev", [
        data.FieldSpec("k", data.DataType.INT),
        data.FieldSpec("ts", data.DataType.LONG, data.FieldType.DATE_TIME)]))
    c.add_table(table.TableConfig(
        "ev", table.TableType.REALTIME,
        validation_config=table.SegmentsValidationConfig(
            time_column_name="ts", replication=replication),
        stream_config=table.StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=400)))
    return c


@pytest.fixture
def pair(request):
    partitions, servers, replication = getattr(
        request, "param", (2, ["server_1", "server_0", "server_2"], 2))
    JStream.create("llc_j", partitions)
    TStream.create("llc_t", partitions)
    j = _controller(jcontroller, jstate, jdata, jtable, "llc_j", partitions,
                    servers, replication)
    t = _controller(tcontroller, tstate, tdata, ttable, "llc_t", partitions,
                    servers, replication)
    yield j, t
    JStream.delete("llc_j")
    TStream.delete("llc_t")


def _metadata(c):
    out = {}
    for md in c.store.segment_metadata_list(TABLE):
        url = md.download_url.partition("://")[2] if md.download_url else ""
        out[md.segment_name] = (md.status, md.start_offset, md.end_offset,
                                md.partition, md.sequence, md.total_docs,
                                md.start_time, md.end_time, url)
    return out


def _same(j, t):
    assert t.store.get_ideal_state(TABLE) == j.store.get_ideal_state(TABLE)
    assert _metadata(t) == _metadata(j)
    return _metadata(t)


def _commit(j, t, segment, end, docs, lo, hi):
    """Partition ``segment``'s commit at ``end`` on both controllers, the
    committed segment holding ``docs`` rows with ts in [lo, hi]."""
    j._on_segment_commit(
        segment, "server_0", JOffset(end), f"file://{TABLE}/{segment}",
        types.SimpleNamespace(num_docs=docs, crc=0, min_time=lo,
                              max_time=hi))
    schema = tdata.Schema("ev", [
        tdata.FieldSpec("k", tdata.DataType.INT),
        tdata.FieldSpec("ts", tdata.DataType.LONG,
                        tdata.FieldType.DATE_TIME)])
    seg = SegmentBuilder(schema, segment).build(
        {"k": np.arange(docs), "ts": np.linspace(lo, hi, docs).astype(
            np.int64)})
    url = t.deep_store.put_segment(TABLE, seg)
    t._on_segment_commit(segment, "server_0", TOffset(end), url,
                         seg.metadata)


def test_names_parse_alike():
    name = tllc.llc_segment_name("ev", 3, 7, SEED)
    assert name == jllc.llc_segment_name("ev", 3, 7, SEED)
    assert tllc.parse_llc_name(name) == jllc.parse_llc_name(name) == \
        ("ev", 3, 7)
    with pytest.raises(ValueError):
        tllc.parse_llc_name("ev_0")


def test_setup_commit_and_validation_equal(pair):
    j, t = pair
    md = _same(j, t)
    first = sorted(md)
    assert first == [f"ev__0__0__{SEED}", f"ev__1__0__{SEED}"]
    assert {v[0] for v in md.values()} == {"CONSUMING"}

    _commit(j, t, first[0], 400, 400, 1000, 1399)
    md = _same(j, t)
    assert md[first[0]][:3] == ("ONLINE", "0", "400")
    assert md[first[0]][6:8] == (1000, 1399)
    assert md[f"ev__0__1__{SEED}"][:2] == ("CONSUMING", "400")
    assert t.store.get_ideal_state(TABLE)[first[0]] == \
        {s: "ONLINE" for s in t.store.get_ideal_state(TABLE)[
            f"ev__0__1__{SEED}"]}

    # partition 1's consuming segment dies; partition 0's successor too
    for c in (j, t):
        c.delete_segment(TABLE, first[1])
        c.delete_segment(TABLE, f"ev__0__1__{SEED}")
    assert _same(j, t) and len(t.store.get_ideal_state(TABLE)) == 1
    created_j = j.run_realtime_validation()
    created_t = t.run_realtime_validation()
    assert created_t == created_j == [f"ev__0__1__{SEED}",
                                      f"ev__1__0__{SEED}"]
    md = _same(j, t)
    assert md[f"ev__0__1__{SEED}"][1] == "400"
    # a second pass finds every partition consuming
    assert t.run_realtime_validation() == j.run_realtime_validation() == []
    # the FSM resolves the new segments' table and replica count
    assert t._table_of(f"ev__1__0__{SEED}") == TABLE
    assert t._num_replicas_for_segment(f"ev__1__0__{SEED}") == \
        j._num_replicas_for_segment(f"ev__1__0__{SEED}") == 2
    assert t._table_of("unknown") is None
    assert t.deep_store.fetch_segment(
        f"memory://{TABLE}/{first[0]}").num_docs == 400


@pytest.mark.parametrize("pair", [
    (1, ["s0"], 1), (3, ["s2", "s0", "s1", "s3"], 2),
    (4, ["s0", "s1", "s2", "s3", "s4"], 3)], indirect=True)
def test_setup_equal_over_layouts(pair):
    j, t = pair
    _same(j, t)


def test_commit_of_an_unknown_segment_raises(pair):
    j, t = pair
    with pytest.raises(KeyError):
        t._on_segment_commit("nope__0__0__x", "server_0", TOffset(1), "u",
                             None)
    with pytest.raises(KeyError):
        t.llc.commit_segment(TABLE, f"ev__5__0__{SEED}", TOffset(1), "u")


def test_setup_of_a_table_without_a_stream_raises():
    c = tcontroller.Controller(llc_seed=SEED)
    with pytest.raises(ValueError, match="not a realtime table"):
        c.llc.setup_new_table("ev_OFFLINE")
