"""Hybrid and upsert tables through the port's front door against the JAX
``EmbeddedCluster`` (the broker's time-boundary split,
``pinot_tpu_torch/broker/broker.py`` ``_split_hybrid``; the servers'
upsert managers, ``server/server.py``, ``server/data_manager.py``).

tests/test_realtime_tier.py ``TestHybridRouting``'s two cases and
tests/test_cluster.py ``test_hybrid_time_boundary`` on both packages: the
boundary, the rows (pandas as the oracle too) and the ``hybrid:``
decisions equal. tests/test_upsert.py ``TestUpsertCluster::
test_realtime_upsert_e2e`` on both packages, and a replication-2 case in
which a third server takes each sealed segment from the deep store (the
committer's object): each server's valid docs stay its own, on its own
copy, and every server answers as the JAX server in its place. A seeded
share of tests/test_fuzz_cluster.py's hybrid and upsert front-door fuzz
on both packages.

Each package reads its own ``MemoryStream`` topic. Counts, integer sums,
min/max and keys are exact; float cells within ``rel=1e-5, abs=1e-6``.
Answers are compared once every consumer of both clusters has reached its
stream's end; every wait is bounded.
"""

import time

import numpy as np
import pandas as pd
import pytest

import tests.test_cluster as tc
import tests.test_fuzz_cluster as fz
import tests.test_realtime_tier as rtt
import tests.test_upsert as tu
from pinot_tpu.ingestion import MemoryStream as JStream
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
from pinot_tpu_torch.ingestion import MemoryStream as TStream
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.tools.cluster import EmbeddedCluster
from tests.test_fuzz import DIMS, _pandas_agg, _rand_filter

SEED = "20260802T0000Z"
HYBRID_KEYS = ("hybrid:",)


def _port_schema(jschema):
    """The port's copy of a JAX schema."""
    return tdata.Schema(jschema.schema_name, [
        tdata.FieldSpec(fs.name, tdata.DataType[fs.data_type.name],
                        tdata.FieldType[fs.field_type.name],
                        single_value=fs.single_value)
        for fs in jschema.field_specs], jschema.primary_key_columns)


def _config(mod, name, table_type, topic=None, flush=10_000,
            replication=1, upsert=False):
    kw = {}
    if topic is not None:
        kw["stream_config"] = mod.StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=flush)
    if upsert:
        kw["upsert_config"] = mod.UpsertConfig(mode=mod.UpsertMode.FULL)
    return mod.TableConfig(
        name, table_type,
        validation_config=mod.SegmentsValidationConfig(
            time_column_name="ts", replication=replication), **kw)


def _jax_settled(jc, table):
    """The JAX cluster's consumers of ``table`` at their stream's end,
    below their threshold, and its ExternalView converged."""
    cfg = jc.store.get_table_config(table)
    stream = JStream.get(cfg.stream_config.topic)
    ideal = jc.store.get_ideal_state(table)
    ev = jc.store.get_external_view(table)
    if any(ev.get(seg, {}).get(inst) != st for seg, m in ideal.items()
           for inst, st in m.items()):
        return False
    consumers = [c for s in jc.servers.values()
                 for c in getattr(s.data_manager.get(table), "_consumers",
                                  {}).values()]
    return len(consumers) == sum(st == "CONSUMING" for m in ideal.values()
                                 for st in m.values()) and all(
        c.state.value == "INITIAL_CONSUMING"
        and c.rows_indexed < c.flush_threshold_rows
        and c.current_offset.value >= stream.latest_offset(c.partition).value
        for c in consumers)


def _settle(jc, pc, table, timeout_s=60.0):
    assert pc.wait_for_consumers(table, timeout_s=timeout_s)
    deadline = time.monotonic() + timeout_s
    while not _jax_settled(jc, table):
        assert time.monotonic() < deadline, f"JAX {table} never settled"
        time.sleep(0.02)


def _close(got, want, what):
    assert len(got) == len(want), (what, got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (what, g, w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-5, abs=1e-6), (what, g, w)
            else:
                assert a == b, (what, g, w)


def _same(jc, pc, sql):
    """Both clusters' clean answers, rows and ``hybrid:`` decisions
    equal; -> the port's response."""
    j, t = jc.query(sql), pc.query(sql)
    assert not j.exceptions and not t.exceptions, (j.exceptions,
                                                   t.exceptions)
    _close(t.result_table.rows, j.result_table.rows, sql)
    assert {k: v for k, v in t.stats.decisions.items()
            if k.startswith(HYBRID_KEYS)} == \
        {k: v for k, v in j.stats.decisions.items()
         if k.startswith(HYBRID_KEYS)}, sql
    assert t.num_servers_responded == t.num_servers_queried
    return t


@pytest.fixture
def clusters(tmp_path):
    made = []

    def make(n, *topics):
        for topic, parts in topics:
            JStream.create(topic + "_j", parts)
            TStream.create(topic + "_t", parts)
        jc = JCluster(num_servers=n, data_dir=str(tmp_path), llc_seed=SEED)
        pc = EmbeddedCluster(num_servers=n, device="cpu", llc_seed=SEED)
        made.append((jc, pc, topics))
        return jc, pc

    yield make
    for jc, pc, topics in made:
        jc.shutdown()
        pc.shutdown()
        for topic, _ in topics:
            JStream.delete(topic + "_j")
            TStream.delete(topic + "_t")


def _hybrid(make, name, schema, df_offline, df_stream, flush=10_000):
    """An offline segment of ``df_offline`` and a realtime table fed
    ``df_stream`` on both packages."""
    jc, pc = make(2, (name, 1))
    for mod, c, sch, suffix in ((jtable, jc, schema, "_j"),
                                (ttable, pc, _port_schema(schema), "_t")):
        c.create_table(_config(mod, name, mod.TableType.OFFLINE), sch)
        c.controller.add_table(_config(mod, name, mod.TableType.REALTIME,
                                       name + suffix, flush))
        c.ingest_rows(f"{name}_OFFLINE", sch,
                      {col: df_offline[col].tolist()
                       for col in df_offline.columns},
                      segment_name=f"{name}_off_0")
        stream = (JStream if suffix == "_j" else TStream).get(name + suffix)
        for r in df_stream.to_dict("records"):
            stream.produce(r, partition=0)
        assert c.wait_for_ev_converged(f"{name}_OFFLINE", timeout_s=60)
    _settle(jc, pc, f"{name}_REALTIME")
    boundary = pc.broker.routing.time_boundary.get_boundary(f"{name}_OFFLINE")
    assert boundary == jc.broker.routing.time_boundary.get_boundary(
        f"{name}_OFFLINE")
    return jc, pc, boundary


def test_hybrid_time_boundary(clusters):
    df = tc.make_df(2000, seed=44).sort_values("ts").reset_index(drop=True)
    offline, stream = df.iloc[:1200], df.iloc[1000:]
    jc, pc, boundary = _hybrid(clusters, "hybrid", tc.make_schema("hybrid"),
                               offline, stream)
    assert boundary == int(offline.ts.max()) - 1
    want = int((offline.ts <= boundary).sum() + (stream.ts > boundary).sum())
    resp = _same(jc, pc, "SELECT count(*) FROM hybrid")
    assert resp.result_table.rows == [[want]]
    assert resp.stats.decisions[
        "hybrid:realtime_all->time_split:hybrid_time_split"] == 1


def test_hybrid_bit_identical_to_merged_oracle(clusters):
    rng = np.random.default_rng(11)
    df = pd.DataFrame([rtt.make_row(i, rng) for i in range(2000)]
                      ).sort_values("ts").reset_index(drop=True)
    offline, stream = df.iloc[:1200], df.iloc[1000:]
    jc, pc, boundary = _hybrid(clusters, "hy", rtt.make_schema("hy"),
                               offline, stream)
    oracle = pd.concat([offline[offline.ts <= boundary],
                        stream[stream.ts > boundary]])
    resp = _same(jc, pc, "SELECT count(*) FROM hy")
    assert resp.result_table.rows == [[len(oracle)]]
    resp = _same(jc, pc, "SELECT city, count(*), sum(clicks) FROM hy "
                 "GROUP BY city ORDER BY city LIMIT 50")
    want = oracle.groupby("city").agg(n=("city", "size"),
                                      s=("clicks", "sum")).sort_index()
    assert resp.result_table.rows == [[k, int(v.n), float(v.s)]
                                      for k, v in want.iterrows()]
    resp = _same(jc, pc, "SELECT sum(price), min(ts), max(ts) FROM hy")
    _close(resp.result_table.rows, [[float(oracle.price.sum()),
                                     float(oracle.ts.min()),
                                     float(oracle.ts.max())]], "scalar")
    # each side's filter is its own: the same SQL text planned twice
    resp = _same(jc, pc, "SELECT count(*) FROM hy WHERE clicks < 50")
    assert resp.result_table.rows == [[int((oracle.clicks < 50).sum())]]


def test_single_table_and_no_boundary_outcomes(clusters):
    jc, pc = clusters(1, ("hynb", 1))
    rng = np.random.default_rng(17)
    rows = [rtt.make_row(i, rng) for i in range(20)]
    schema = rtt.make_schema("hynb")
    for mod, c, sch, suffix in ((jtable, jc, schema, "_j"),
                                (ttable, pc, _port_schema(schema), "_t")):
        c.create_table(_config(mod, "hynb", mod.TableType.REALTIME,
                               "hynb" + suffix), sch)
        stream = (JStream if suffix == "_j" else TStream).get("hynb" + suffix)
        for r in rows:
            stream.produce(r, partition=0)
    _settle(jc, pc, "hynb_REALTIME")
    resp = _same(jc, pc, "SELECT count(*) FROM hynb")
    assert resp.stats.decisions == {
        **{k: v for k, v in resp.stats.decisions.items()
           if not k.startswith("hybrid:")},
        "hybrid:time_split->direct:hybrid_single_table": 1}
    # the offline half with no segment: no boundary, realtime serves all
    for mod, c in ((jtable, jc), (ttable, pc)):
        c.controller.add_table(_config(mod, "hynb", mod.TableType.OFFLINE))
    resp = _same(jc, pc, "SELECT count(*) FROM hynb")
    assert resp.result_table.rows == [[20]]
    assert resp.stats.decisions[
        "hybrid:time_split->realtime_all:hybrid_no_boundary"] == 1
    # an offline half without a time column cannot be split
    for c in (jc, pc):
        cfg = c.store.get_table_config("hynb_OFFLINE")
        cfg.validation_config.time_column_name = None
        c.controller.update_table(cfg)
    resp = _same(jc, pc, "SELECT count(*) FROM hynb")
    assert resp.stats.decisions[
        "hybrid:time_split->realtime_all:hybrid_no_time_column"] == 1


def _upsert_rows(seed=3, n=150):
    rng = np.random.default_rng(seed)
    out, latest, ts = [], {}, 1000
    for _ in range(n):
        uid = f"u{int(rng.integers(0, 20))}"
        score = int(rng.integers(0, 100))
        ts += 1
        latest[uid] = (score, ts)
        out.append({"uid": uid, "status": "s", "score": score, "ts": ts})
    return out, latest


def test_realtime_upsert_e2e(clusters):
    jc, pc = clusters(1, ("upsert", 1))
    rows, latest = _upsert_rows()
    for mod, c, sch, suffix in ((jtable, jc, tu.make_schema(), "_j"),
                                (ttable, pc, _port_schema(tu.make_schema()),
                                 "_t")):
        c.create_table(_config(mod, "users", mod.TableType.REALTIME,
                               "upsert" + suffix, flush=60, upsert=True), sch)
        stream = (JStream if suffix == "_j" else TStream).get(
            "upsert" + suffix)
        for r in rows:
            stream.produce(r, partition=0)
    _settle(jc, pc, "users_REALTIME")
    resp = _same(jc, pc, "SELECT count(*), sum(score) FROM users")
    assert resp.result_table.rows == [
        [len(latest), float(sum(s for s, _ in latest.values()))]]
    resp = _same(jc, pc, "SELECT uid, max(score) FROM users GROUP BY uid "
                 "ORDER BY uid LIMIT 100")
    assert {r[0]: r[1] for r in resp.result_table.rows} == \
        {k: float(s) for k, (s, _) in latest.items()}
    # the server compares on the table's time column (as JAX): an older
    # record arriving late never wins
    for c, stream in ((jc, JStream.get("upsert_j")),
                      (pc, TStream.get("upsert_t"))):
        stream.produce({"uid": "u0", "status": "late", "score": 999,
                        "ts": 5}, partition=0)
    _settle(jc, pc, "users_REALTIME")
    resp = _same(jc, pc, "SELECT count(*), sum(score) FROM users")
    assert resp.result_table.rows == [
        [len(latest), float(sum(s for s, _ in latest.values()))]]


def _direct(c, server, table, segments, sql, compile_query):
    """``server``'s own answer over ``segments`` through the broker's
    reduce."""
    ctx = compile_query(sql)
    dt = c.servers[server].execute_query(ctx, table, segments)
    assert not dt.exceptions, dt.exceptions
    return c.broker.reduce_service.reduce(ctx, [dt])[0].rows


def test_upsert_views_are_per_server(clusters):
    """Replication 2 on servers 0 and 1 (COMMIT and KEEP); then server 2
    takes each sealed segment from the deep store, as a rebalance would
    place it. Server 2's keys come from the sealed rows alone, so its
    answers over the sealed segments differ from the consuming replicas',
    and it must never overwrite their views: the committer's object keeps
    the committer's view."""
    jc, pc = clusters(3, ("upsert2", 1))
    rows, _ = _upsert_rows(seed=5)
    table = "users_REALTIME"
    for mod, c, sch, suffix in ((jtable, jc, tu.make_schema(), "_j"),
                                (ttable, pc, _port_schema(tu.make_schema()),
                                 "_t")):
        c.create_table(_config(mod, "users", mod.TableType.REALTIME,
                               "upsert2" + suffix, flush=60, replication=2,
                               upsert=True), sch)
        stream = (JStream if suffix == "_j" else TStream).get(
            "upsert2" + suffix)
        for r in rows:
            stream.produce(r, partition=0)
    _settle(jc, pc, table)
    sealed = sorted(s for s, m in pc.store.get_ideal_state(table).items()
                    if "ONLINE" in m.values())
    assert len(sealed) == 2 and sorted(
        s for s, m in jc.store.get_ideal_state(table).items()
        if "ONLINE" in m.values()) == sealed
    assert set(pc.store.get_ideal_state(table)[sealed[0]]) == \
        {"server_0", "server_1"}

    def add_server_2(ideal):
        for seg in sealed:
            ideal[seg]["server_2"] = "ONLINE"
        return ideal

    for c in (jc, pc):
        c.store.update_ideal_state(table, add_server_2)
        assert c.wait_for_ev_converged(table, timeout_s=60)
    tdm2 = pc.servers["server_2"].data_manager.get(table)
    pm2 = tdm2.upsert_manager.partition(0)
    for seg in sealed:
        kept = pc.controller.deep_store.fetch_segment(
            f"memory://{table}/{seg}")
        mine = tdm2._segments[seg].segment
        assert mine is not kept and mine._sources is kept._sources
        assert mine.valid_doc_ids._pm is pm2
        owners = [s for s in ("server_0", "server_1")
                  if pc.servers[s].data_manager.get(table)._segments[
                      seg].segment is kept]
        assert len(owners) == 1
        assert kept.valid_doc_ids._pm is pc.servers[owners[0]] \
            .data_manager.get(table).upsert_manager.partition(0)
    assert tdm2.seal_decisions == {
        "seal:consuming_segment->immutable_swap:seal_download": 2}

    sql = ("SELECT uid, count(*), max(score) FROM users GROUP BY uid "
           "ORDER BY uid LIMIT 100")
    latest_sealed = {}
    for r in rows[:120]:
        latest_sealed[r["uid"]] = r["score"]
    answers = {}
    for server in ("server_0", "server_1", "server_2"):
        answers[server] = _direct(pc, server, table, sealed, sql, t_compile)
        _close(answers[server],
               _direct(jc, server, table, sealed, sql, j_compile), server)
    assert answers["server_0"] == answers["server_1"]
    assert {r[0]: r[2] for r in answers["server_2"]} == \
        {k: float(v) for k, v in latest_sealed.items()}
    assert answers["server_2"] != answers["server_0"]


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """tests/test_fuzz_cluster.py's fleet on both packages: a hybrid table
    (2 offline segments, realtime rows after them) and an upsert table."""
    out = str(tmp_path_factory.mktemp("fuzz"))
    JStream.create("fzc_j", 2)
    JStream.create("fzu_j", 1)
    TStream.create("fzc_t", 2)
    TStream.create("fzu_t", 1)
    jc = JCluster(num_servers=2, data_dir=out, llc_seed=SEED)
    pc = EmbeddedCluster(num_servers=2, device="cpu", llc_seed=SEED)
    frames = [fz._frame(fz.OFF_DOCS, seed=70 + i, ts_base=i * fz.OFF_DOCS)
              for i in range(2)]
    rt = fz._frame(fz.RT_DOCS, seed=90, ts_base=2 * fz.OFF_DOCS + 1000)
    boundary = 2 * fz.OFF_DOCS - 2
    overlap = pd.concat(frames, ignore_index=True)
    overlap = overlap[overlap.ts > boundary]
    stream_rows = overlap.to_dict("records") + rt.to_dict("records")
    rng = np.random.default_rng(17)
    latest, urows = {}, []
    for t in range(400):
        rec = {"color": str(rng.choice(DIMS["color"])),
               "shape": str(rng.choice(DIMS["shape"])),
               "year": int(rng.integers(2000, 2020)),
               "qty": int(rng.integers(0, 100)),
               "price": float(np.round(rng.uniform(1, 500), 2)),
               "ts": 1000 + t}
        latest[rec["color"]] = rec
        urows.append(rec)
    try:
        for mod, c, data, suffix, streams in (
                (jtable, jc, jdata, "_j", JStream),
                (ttable, pc, tdata, "_t", TStream)):
            jschema = fz._schema("fzc")
            schema = jschema if suffix == "_j" else _port_schema(jschema)
            c.create_table(_config(mod, "fzc", mod.TableType.OFFLINE),
                           schema)
            c.create_table(_config(mod, "fzc", mod.TableType.REALTIME,
                                   "fzc" + suffix, flush=400), schema)
            for i, df in enumerate(frames):
                c.ingest_rows("fzc_OFFLINE", schema,
                              {col: df[col].tolist() for col in df.columns},
                              segment_name=f"fzc_off_{i}")
            assert c.wait_for_ev_converged("fzc_OFFLINE", timeout_s=60)
            stream = streams.get("fzc" + suffix)
            for i, rec in enumerate(stream_rows):
                stream.produce(rec, partition=i % 2)
            ujs = jdata.Schema("fzu", fz._schema("fzu").field_specs,
                               primary_key_columns=["color"])
            uschema = ujs if suffix == "_j" else _port_schema(ujs)
            c.create_table(_config(mod, "fzu", mod.TableType.REALTIME,
                                   "fzu" + suffix, flush=150, upsert=True),
                           uschema)
            ustream = streams.get("fzu" + suffix)
            for rec in urows:
                ustream.produce(rec, partition=0)
        for table in ("fzc_REALTIME", "fzu_REALTIME"):
            _settle(jc, pc, table)
        yield (jc, pc, pd.concat(frames + [rt], ignore_index=True),
               pd.DataFrame(list(latest.values())))
    finally:
        jc.shutdown()
        pc.shutdown()
        for topic in ("fzc_j", "fzu_j"):
            JStream.delete(topic)
        for topic in ("fzc_t", "fzu_t"):
            TStream.delete(topic)


def _fuzz_sql(qi, table):
    """tests/test_fuzz_cluster.py ``_check``'s query ``qi``; -> (sql, the
    filter's mask function, group columns, aggregations)."""
    rng = np.random.default_rng(4321 + qi)
    aggs = list(rng.choice(fz.AGGS, size=int(rng.integers(1, 4)),
                           replace=False))
    where, mask_fn = _rand_filter(rng)
    group = []
    if rng.integers(0, 2):
        group = list(rng.choice(list(DIMS), size=int(rng.integers(1, 3)),
                                replace=False))
    sql = f"SELECT {', '.join(group + aggs)} FROM {table}{where}"
    if group:
        sql += (f" GROUP BY {', '.join(group)}"
                f" ORDER BY {', '.join(group)} LIMIT 10000")
    return sql, mask_fn, group, aggs


@pytest.mark.parametrize("table,qi", [("fzc", q) for q in range(12)]
                         + [("fzu", 100_000 + q) for q in range(6)])
def test_fuzz_front_door(fleets, table, qi):
    jc, pc, union, upsert_df = fleets
    sql, mask_fn, group, aggs = _fuzz_sql(qi, table)
    resp = _same(jc, pc, sql)
    df = union if table == "fzc" else upsert_df
    sub = df[mask_fn(df)]
    rows = resp.result_table.rows
    if group:
        want = {}
        for key, g in sub.groupby(group, sort=True):
            key = key if isinstance(key, tuple) else (key,)
            want[tuple(str(k) for k in key)] = [_pandas_agg(g, a)
                                                for a in aggs]
        got = {tuple(str(v) for v in r[:len(group)]): r[len(group):]
               for r in rows}
        assert set(got) == set(want), sql
        for k, vals in want.items():
            for g_v, w_v in zip(got[k], vals):
                fz._assert_close(g_v, w_v, sql)
    else:
        for g_v, a in zip(rows[0], aggs):
            fz._assert_close(g_v, _pandas_agg(sub, a), sql)
