"""The port's wire forms against the JAX package's.

- ``common/serde.py`` ``dumps``: the same bytes as JAX's for the same
  values (seeded ints, floats with the non-finite ones, strings, bytes,
  tuples, frozensets, lists, numpy scalars, nesting), and ``loads`` of
  either package's bytes gives the value back.
- ``query/serde.py``: ``context_to_dict`` of the port's compiled SQL
  equals JAX's for the 13 SSB flights and for tests/test_torch_fuzz.py's
  seeded aggregation and selection SQL, and round-trips.
- ``spi/table.py``: ``TableConfig.to_dict`` equal to JAX's for the configs
  the port's tests build (offline, realtime with stream and upsert,
  indexing with star-trees and partitions, routing, quota, ingestion
  transforms, field configs, minion tasks, tiers); each package reads the
  other's dict and JSON back to the same dict.
- ``controller/state.py``: the mutation log and the snapshot carry a
  table config and a schema as JAX's store keeps them.
"""

import json
import math

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.common import serde as jserde  # noqa: E402
from pinot_tpu.controller import state as jstate  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.query import serde as jqserde  # noqa: E402
from pinot_tpu.spi import data as jdata  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu.tools import ssb as jssb  # noqa: E402
from pinot_tpu_torch.common import serde as tserde  # noqa: E402
from pinot_tpu_torch.controller import state as tstate  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.query import serde as tqserde  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402
from pinot_tpu_torch.tools import ssb as tssb  # noqa: E402

from tests import test_torch_fuzz as fuzz  # noqa: E402


# -- the object serde ----------------------------------------------------------

def _value(rng, depth=0):
    kind = rng.integers(0, 12 if depth < 3 else 8)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-2 ** 62, 2 ** 62))
    if kind == 3:
        return int(rng.integers(-300, 300)) * 10 ** int(rng.integers(0, 30))
    if kind == 4:
        return float(rng.choice([rng.normal() * 1e6, math.inf, -math.inf,
                                 math.nan, -0.0, 0.1]))
    if kind == 5:
        return "".join(rng.choice(list("abcé漢 ,'\n"), rng.integers(0, 9)))
    if kind == 6:
        return bytes(rng.integers(0, 256, rng.integers(0, 17)).tolist())
    if kind == 7:
        return np.float32(rng.normal()) if rng.integers(0, 2) \
            else np.int64(rng.integers(-9, 9))
    n = int(rng.integers(0, 5))
    items = [_value(rng, depth + 1) for _ in range(n)]
    if kind == 8:
        return tuple(items)
    if kind == 9:
        return list(items)
    return frozenset(x for x in items
                     if isinstance(x, (int, str, bytes)))


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("seed", range(8))
def test_dumps_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        v = _value(rng)
        raw = tserde.dumps(v)
        assert raw == jserde.dumps(v), v
        back = tserde.loads(jserde.dumps(v))
        want = v.item() if hasattr(v, "item") else v
        assert _same(back, want) or isinstance(want, frozenset), (v, back)
        assert _same(jserde.loads(raw), tserde.loads(raw))


def test_loads_refuses_what_jax_refuses():
    for raw in (b"\x0b", tserde.dumps(1) + b"\x00"):
        with pytest.raises(ValueError):
            jserde.loads(raw)
        with pytest.raises(ValueError):
            tserde.loads(raw)
    with pytest.raises(TypeError):
        tserde.dumps(object())


# -- the query context ---------------------------------------------------------

def _sqls():
    out = [q for q in jssb.QUERIES.values()]
    for qi in range(fuzz.N_QUERIES):
        out.append(fuzz._query(np.random.default_rng(fuzz.SEED + qi))[0])
    for qi in range(fuzz.N_SELECTIONS):
        out.append(fuzz._selection_query(
            np.random.default_rng(fuzz.SEED + 1000 + qi)))
    return out


def test_ssb_flights_are_the_ports():
    assert tssb.QUERIES == jssb.QUERIES


def test_context_dict_equals_jax():
    n = 0
    for sql in _sqls():
        try:
            jctx = j_compile(sql)
        except Exception:  # noqa: BLE001 - both packages refuse it
            with pytest.raises(Exception):
                t_compile(sql)
            continue
        d = tqserde.context_to_dict(t_compile(sql))
        assert d == jqserde.context_to_dict(jctx), sql
        assert json.dumps(d) == json.dumps(jqserde.context_to_dict(jctx))
        back = tqserde.context_from_dict(json.loads(json.dumps(d)))
        assert tqserde.context_to_dict(back) == d, sql
        n += 1
    assert n >= 150


def test_context_from_jax_dict_plans_the_same():
    """A JAX broker's dict decodes in the port to the context the port
    compiles from the SQL (less ``sql`` and ``explain``, which do not
    travel)."""
    for sql in jssb.QUERIES.values():
        d = json.loads(json.dumps(jqserde.context_to_dict(j_compile(sql))))
        got = tqserde.context_from_dict(d)
        want = t_compile(sql)
        want.sql = None
        assert got == want, sql


# -- table configs ---------------------------------------------------------------

def _configs(mod, ssb):
    out = [
        mod.TableConfig("sales"),
        mod.TableConfig("t", validation_config=mod.SegmentsValidationConfig(
            time_column_name="ts", replication=2, retention_time_unit="DAYS",
            retention_time_value=30, segment_push_type="REFRESH")),
        mod.TableConfig(
            "events", validation_config=mod.SegmentsValidationConfig(
                time_column_name="ts"),
            task_config={"MergeRollupTask": {
                "bucketTimePeriod": "1d", "bufferTimePeriod": "0d",
                "mergeType": "CONCAT"}},
            tier_configs=[{"name": "cold", "segmentSelectorType": "time",
                           "segmentAge": "7d", "storageType": "pinot_server",
                           "serverTag": "cold_OFFLINE"}]),
        mod.TableConfig(
            "rt", mod.TableType.REALTIME,
            validation_config=mod.SegmentsValidationConfig(
                time_column_name="ts", replication=2),
            stream_config=mod.StreamIngestionConfig(
                stream_type="memory", topic="t1",
                segment_flush_threshold_rows=25_000,
                properties={"stream.memory.topic.name": "t1"}),
            upsert_config=mod.UpsertConfig(mod.UpsertMode.FULL, "ts")),
        mod.TableConfig(
            "ssb_lineorder", indexing_config=ssb.ssb_indexing_config(),
            routing_config=mod.RoutingConfig(
                "replicaGroup", ["partition"]),
            quota_config=mod.QuotaConfig(max_queries_per_second=12.5,
                                         storage="10G")),
        mod.TableConfig(
            "rl", indexing_config=mod.IndexingConfig(
                inverted_index_columns=["a"], range_index_columns=["b"],
                bloom_filter_columns=["a"], fst_index_columns=["s"],
                text_index_columns=["s"], json_index_columns=["j"],
                no_dictionary_columns=["v"],
                segment_partition_config=mod.SegmentPartitionConfig(
                    {"a": {"functionName": "Murmur", "numPartitions": 4}}),
                enable_default_star_tree=True),
            field_config_list=[
                mod.FieldConfig("v", encoding_type="RAW",
                                compression_codec="ZSTANDARD"),
                mod.FieldConfig("loc", index_type="H3",
                                properties={"resolutions": "9"})],
            ingestion_config=mod.IngestionConfig(
                filter_function="v < 0",
                transform_configs=[mod.TransformConfig("d", "v * 2")])),
    ]
    return out


def test_table_config_dicts_equal_jax():
    from pinot_tpu.tools import ssb as jssb_mod

    for t, j in zip(_configs(ttable, tssb), _configs(jtable, jssb_mod)):
        td, jd = t.to_dict(), j.to_dict()
        assert td == jd, (td, jd)
        assert t.to_json() == j.to_json()
        assert ttable.TableConfig.from_dict(jd).to_dict() == jd
        assert jtable.TableConfig.from_dict(td).to_dict() == td
        assert ttable.TableConfig.from_json(j.to_json()) == t


def test_reference_stream_configs_map():
    """The reference's flat ``tableIndexConfig.streamConfigs`` reads the
    same in both packages."""
    d = {"tableName": "rt", "tableType": "REALTIME",
         "tableIndexConfig": {"streamConfigs": {
             "streamType": "kafka", "stream.kafka.topic.name": "ev",
             "realtime.segment.flush.threshold.size": "5000",
             "realtime.segment.flush.threshold.time": "1d12h"}}}
    assert ttable.TableConfig.from_dict(d).to_dict() == \
        jtable.TableConfig.from_dict(d).to_dict()


# -- the cluster state's wire --------------------------------------------------

def _schema(mod):
    return mod.Schema("sales", [
        mod.FieldSpec("region", mod.DataType.STRING),
        mod.FieldSpec("qty", mod.DataType.LONG, mod.FieldType.METRIC),
        mod.FieldSpec("ts", mod.DataType.LONG, mod.FieldType.DATE_TIME)])


def test_state_log_and_snapshot_carry_jax_dicts():
    js, ts = jstate.ClusterStateStore(), tstate.ClusterStateStore()
    for store, mod, dmod in ((js, jtable, jdata), (ts, ttable, tdata)):
        store.add_schema(_schema(dmod))
        store.add_table_config(mod.TableConfig(
            "sales", validation_config=mod.SegmentsValidationConfig(
                time_column_name="ts")))
        store.set("idealstate/sales_OFFLINE", {"s0": {"server_0": "ONLINE"}})
        store.delete("idealstate/sales_OFFLINE")
        store.update("counter", lambda v: (v or 0) + 1, default=0)
    assert ts.mutations_since(0) == js.mutations_since(0)
    assert ts.mutations_since(2) == js.mutations_since(2)
    assert ts.mutations_since(5) == (5, [])
    assert ts.snapshot_data() == js.snapshot_data()
    # the typed accessors still hand out objects
    assert ts.get_table_config("sales_OFFLINE").validation_config \
        .time_column_name == "ts"
    assert ts.get_schema("sales").column_names == ["region", "qty", "ts"]


def test_state_log_falls_off_its_tail():
    ts = tstate.ClusterStateStore()
    for i in range(ts._LOG_CAP + 5):
        ts.set("k", i)
    ver, muts = ts.mutations_since(1)
    assert muts is None and ver == ts._LOG_CAP + 5
    assert ts.mutations_since(ver - 2)[1] == [
        (ver - 1, "k", ts._LOG_CAP + 3), (ver, "k", ts._LOG_CAP + 4)]


def test_wire_forms_by_path():
    cfg = ttable.TableConfig("sales")
    assert tstate.to_wire(cfg) == cfg.to_dict()
    assert tstate.from_wire("tables/sales_OFFLINE", cfg.to_dict()) == cfg
    schema = tstate.from_wire("schemas/sales", _schema(tdata).to_dict())
    assert schema.column_names == ["region", "qty", "ts"]
    # a dict that is not a config stays a dict
    assert tstate.from_wire("tables/t1", {"n": 1}) == {"n": 1}
    assert tstate.from_wire("idealstate/t", {"tableName": 1}) == \
        {"tableName": 1}
    # compare-and-set compares wire forms
    store = tstate.ClusterStateStore()
    store.add_schema(_schema(tdata))
    assert store.compare_and_set("schemas/sales", _schema(tdata).to_dict(),
                                 _schema(tdata))
    assert not store.compare_and_set("schemas/sales", {"x": 1}, None)
