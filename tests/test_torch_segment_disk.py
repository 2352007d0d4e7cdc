"""Segments on disk: the port's writer and loader against the JAX
package's (oracles tests/test_segment.py and tests/test_startree.py).

The same seeded rows, with dictionary, raw, multi-value, nullable and
chunk-compressed columns and every index kind (inverted, range, bloom,
FST, text, JSON) plus two star-trees, go through JAX's
``SegmentBuilder(schema, name).build(rows, dir)`` and the port's
``SegmentBuilder(...).build(frame, dir)``:

- every file under ``columns/`` and the star-tree directories is
  byte-equal, and so are the CRCs; ``metadata.json`` differs only in the
  creation time and the star-trees' build seconds (the time range is the
  schema's time column's in both; the port's controller reads the table's
  time column instead, tests/test_torch_cluster_state.py);
- the port's ``load_segment`` of JAX's directory, and JAX's
  ``load_segment`` of the port's, answer tests/test_torch_fuzz.py's
  queries as JAX does over its own segment (counts, integer sums, keys
  exact; float cells within rel 1e-5, abs 1e-6);
- the codecs round-trip, a ZSTANDARD file JAX wrote reads back in the
  port, and where ``zstandard`` is missing the port writes ZLIB and
  refuses a ZSTANDARD file.

Also: a loaded segment's arrays are read-only maps that staging copies
(no tensor wraps a mapping), a segment deleted while a query holds it
still answers, and the star-trees load at first use.
"""

import gc
import json
import os
import shutil
import warnings

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import compression as jcomp  # noqa: E402
from pinot_tpu.segment.creator import SegmentBuilder as JBuilder  # noqa: E402
from pinot_tpu.segment.immutable import load_segment as j_load  # noqa: E402
from pinot_tpu.spi import data as jdata  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu_torch import native  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import compression as tcomp  # noqa: E402
from pinot_tpu_torch.segment.creator import (  # noqa: E402
    SegmentBuilder,
    compute_dir_crc,
    write_segment,
)
from pinot_tpu_torch.segment.immutable import (  # noqa: E402
    load_segment,
    verify_crc,
)
from pinot_tpu_torch.server.data_manager import TableDataManager  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402

from tests.test_torch_columns import RAW, stats_frame  # noqa: E402
from tests.test_torch_fuzz import _query, _rows_equal  # noqa: E402

N_QUERIES = 40
SEED = 2026


def _stats_schema(mod):
    S, M, DT = mod.DataType.STRING, mod.FieldType.METRIC, mod.DataType
    return mod.Schema("stats", [
        mod.FieldSpec("team", S), mod.FieldSpec("league", S),
        mod.FieldSpec("year", DT.INT),
        mod.FieldSpec("tags", S, single_value=False),
        mod.FieldSpec("nums", DT.INT, single_value=False),
        mod.FieldSpec("runs", DT.LONG, M),
        mod.FieldSpec("score", DT.DOUBLE, M),
        mod.FieldSpec("salary", DT.LONG, M),
        mod.FieldSpec("nick", S),
        mod.FieldSpec("bonus", DT.LONG, M),
        mod.FieldSpec("ratio", DT.DOUBLE, M),
        mod.FieldSpec("big", DT.LONG, M)])


def _stats_indexing(mod):
    return mod.IndexingConfig(
        no_dictionary_columns=RAW,
        inverted_index_columns=["team", "year", "tags", "nums"],
        range_index_columns=["salary", "ratio"],
        bloom_filter_columns=["team", "salary", "nick"],
        fst_index_columns=["team"], text_index_columns=["team"])


def _events_schema(mod):
    DT, M = mod.DataType, mod.FieldType.METRIC
    return mod.Schema("events", [
        mod.FieldSpec("city", DT.STRING), mod.FieldSpec("doc", DT.STRING),
        mod.FieldSpec("q", DT.INT), mod.FieldSpec("lat", DT.LONG, M),
        mod.FieldSpec("price", DT.DOUBLE, M),
        mod.FieldSpec("packed", DT.INT, M),
        mod.FieldSpec("ts", DT.LONG, mod.FieldType.DATE_TIME)])


def _events_config(mod, codec="ZSTANDARD"):
    idx = mod.IndexingConfig(
        inverted_index_columns=["city", "q"], range_index_columns=["lat"],
        bloom_filter_columns=["city", "lat"], fst_index_columns=["city"],
        text_index_columns=["city"], json_index_columns=["doc"],
        no_dictionary_columns=["lat"],
        star_tree_index_configs=[
            mod.StarTreeIndexConfig(dimensions_split_order=["city", "q"],
                                    function_column_pairs=["SUM__price",
                                                           "COUNT__*"],
                                    max_leaf_records=10),
            mod.StarTreeIndexConfig(dimensions_split_order=["q"],
                                    function_column_pairs=["SUM__lat",
                                                           "MAX__price"],
                                    max_leaf_records=5)])
    return mod.TableConfig("events", indexing_config=idx,
                           field_config_list=[mod.FieldConfig(
                               "packed", encoding_type="RAW",
                               compression_codec=codec)])


def _events_rows(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(["san jose", "new york", "x", "yy z"], n).tolist(),
        "doc": [json.dumps({"k": int(i % 5), "t": ["u", "v"][i % 2],
                            "a": [1, i % 3]}) for i in range(n)],
        "q": rng.integers(0, 100, n).tolist(),
        "lat": rng.integers(0, 10_000, n).tolist(),
        "price": [None if i % 37 == 0 else float(x)
                  for i, x in enumerate(rng.normal(size=n))],
        "packed": rng.integers(0, 1000, n).tolist(),
        "ts": (1_600_000_000_000 + rng.integers(0, 10**9, n)).tolist(),
    }


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{kind: (JAX's segment dirs, the port's)}: the stats table in two
    halves, and the events segment."""
    root = tmp_path_factory.mktemp("segment_disk")
    frame = stats_frame()
    out = {"stats": ([], []), "events": ([], [])}
    for i, sl in enumerate([slice(0, 1500), slice(1500, 3000)]):
        rows = {k: v[sl] for k, v in frame.items()}
        JBuilder(_stats_schema(jdata), f"stats_{i}",
                 indexing_config=_stats_indexing(jtable)).build(
            rows, str(root / "j"))
        SegmentBuilder(_stats_schema(tdata), f"stats_{i}",
                       indexing=_stats_indexing(ttable)).build(
            rows, str(root / "t"))
        for side, sub in zip(out["stats"], ("j", "t")):
            side.append(str(root / sub / f"stats_{i}"))
    rows = _events_rows()
    JBuilder(_events_schema(jdata), "events_0",
             table_config=_events_config(jtable)).build(rows, str(root / "j"))
    SegmentBuilder(_events_schema(tdata), "events_0",
                   table_config=_events_config(ttable)).build(
        rows, str(root / "t"))
    out["events"] = ([str(root / "j" / "events_0")],
                     [str(root / "t" / "events_0")])
    return out


def _all_dirs(dirs):
    for kind, (js, ts) in dirs.items():
        yield from zip(js, ts)


def _files(seg_dir):
    return sorted(os.path.relpath(os.path.join(r, f), seg_dir)
                  for r, _d, fs in os.walk(seg_dir) for f in fs
                  if f != "metadata.json")


def test_files_are_byte_equal(dirs):
    seen = set()
    for jd, td in _all_dirs(dirs):
        assert _files(jd) == _files(td)
        for rel in _files(jd):
            with open(os.path.join(jd, rel), "rb") as a, \
                    open(os.path.join(td, rel), "rb") as b:
                assert a.read() == b.read(), (td, rel)
            seen.add(rel.split(".", 1)[1] if rel.startswith("columns")
                     else os.path.basename(rel))
    # every file kind of the layout was compared
    for kind in ("dict.npy", "dictoff.npy", "dictblob.npy", "fwdpk.bin",
                 "fwd.npy", "mvoff.npy", "null.npy", "invoff.npy",
                 "invbo.npy", "inv.bin", "bloom.npy", "rangeord.npy",
                 "txtoff.npy", "txtblob.npy", "txtinvoff.npy",
                 "txtinvbo.npy", "txtinv.bin", "jkeysoff.npy",
                 "jkeysblob.npy", "jinvoff.npy", "jinvbo.npy", "jinv.bin",
                 "fstoff.npy", "fstlab.npy", "fsttgt.npy", "fstrng.npy",
                 "fwdcc.bin", "dims.npy", "nodes.npy",
                 "startree_metadata.json", "metric_count__*.npy"):
        assert kind in seen, kind


def test_metadata_equal_but_creation_and_build_times(dirs):
    for jd, td in _all_dirs(dirs):
        with open(os.path.join(jd, "metadata.json")) as f:
            jm = json.load(f)
        with open(os.path.join(td, "metadata.json")) as f:
            tm = json.load(f)
        assert set(jm) == set(tm)
        differ = {k for k in jm if jm[k] != tm[k]}
        assert differ <= {"creationTimeMs", "starTreeBuildS"}, differ
        assert len(jm["starTreeBuildS"]) == len(tm["starTreeBuildS"])
    jm = json.load(open(os.path.join(dirs["events"][0][0], "metadata.json")))
    assert jm["timeColumn"] == "ts" and jm["starTreeCount"] == 2
    assert jm["columns"]["packed"]["compressionCodec"] == "ZSTANDARD"


def test_crc_equal_and_verified_both_ways(dirs, tmp_path):
    from pinot_tpu.segment.immutable import verify_crc as j_verify

    for jd, td in _all_dirs(dirs):
        assert load_segment(jd).metadata.crc == load_segment(td).metadata.crc
        assert compute_dir_crc(os.path.join(jd, "columns")) == \
            load_segment(td).metadata.crc
        assert verify_crc(jd) and verify_crc(td)
        assert j_verify(td)
    bad = tmp_path / "bad"
    shutil.copytree(dirs["events"][1][0], bad)
    p = bad / "columns" / "q.fwdpk.bin"
    raw = bytearray(p.read_bytes())
    raw[0] ^= 1
    p.write_bytes(bytes(raw))
    assert not verify_crc(str(bad))


def _same_column(tds, jds, cm):
    if cm.has_dictionary:
        np.testing.assert_array_equal(
            tds.dictionary.values,
            np.asarray(jds.dictionary.get_values(range(cm.cardinality)),
                       dtype=tds.dictionary.values.dtype))
    if cm.single_value:
        np.testing.assert_array_equal(tds.forward_index, jds.forward_index)
    else:
        for t, j in zip(tds.dense_mv(), jds.dense_mv()):
            np.testing.assert_array_equal(t, j)
    if cm.has_nulls:
        np.testing.assert_array_equal(tds.null_bitmap, jds.null_bitmap)
    if cm.has_inverted_index:
        for d in range(cm.cardinality):
            np.testing.assert_array_equal(tds.doc_ids_for_dict_id(d),
                                          jds.doc_ids_for_dict_id(d))
    if cm.has_range_index:
        np.testing.assert_array_equal(tds.range_order, jds.range_order)
    if cm.has_bloom_filter:
        np.testing.assert_array_equal(tds.bloom_filter.to_array(),
                                      jds.bloom_filter.to_array())
    if cm.has_text_index:
        for q in ("san", "new york", "x OR z", "y*", '"yy z"'):
            np.testing.assert_array_equal(tds.text_index.matching_ids(q),
                                          jds.text_index.matching_ids(q))
    if cm.has_json_index:
        for q in ('"$.k" = \'3\'', '"$.t" != \'u\'', '"$.a[*]" = \'2\'',
                  '"$.zz" IS NULL'):
            np.testing.assert_array_equal(tds.json_index.match(q),
                                          jds.json_index.match(q))
    if cm.has_fst_index:
        for pat in ("^new.*", "s.*", ".*z$"):
            np.testing.assert_array_equal(tds.fst_index.matching_ids(pat),
                                          jds.fst_index.matching_ids(pat))


@pytest.mark.parametrize("which", ["port_loads_jax", "port_loads_port"])
def test_loaded_columns_equal_jax(dirs, which):
    for jd, td in _all_dirs(dirs):
        jseg = j_load(jd)
        tseg = load_segment(jd if which == "port_loads_jax" else td)
        assert tseg.segment_dir is not None and tseg.num_docs == jseg.num_docs
        for col, cm in tseg.metadata.columns.items():
            _same_column(tseg.data_source(col), jseg.data_source(col), cm)
            for doc in (0, 7, tseg.num_docs - 1):
                assert tseg.get_value(col, doc) == jseg.get_value(col, doc)


def test_star_trees_load_at_first_use(dirs):
    jseg = j_load(dirs["events"][0][0])
    tseg = load_segment(dirs["events"][1][0])
    assert tseg._star_trees is None
    assert len(tseg.star_trees) == 2
    for t, j in zip(tseg.star_trees, jseg.star_trees):
        assert t.config.to_dict() == j.config.to_dict()
        np.testing.assert_array_equal(t.dims, j.dims)
        np.testing.assert_array_equal(t.nodes, j.nodes)
        assert set(t.metrics) == set(j.metrics)
        for k in t.metrics:
            np.testing.assert_array_equal(t.metrics[k], j.metrics[k])


def _tree_rows(scale: int):
    n = 1000
    return {"d": [f"k{i % 10}" for i in range(n)],
            "m": [i * scale for i in range(n)]}


def _build_tree_segment(out_dir: str, scale: int) -> None:
    schema = tdata.Schema("tt", [
        tdata.FieldSpec("d", tdata.DataType.STRING),
        tdata.FieldSpec("m", tdata.DataType.LONG, tdata.FieldType.METRIC)])
    idx = ttable.IndexingConfig(star_tree_index_configs=[
        ttable.StarTreeIndexConfig(dimensions_split_order=["d"],
                                   function_column_pairs=["SUM__m"],
                                   max_leaf_records=1)])
    SegmentBuilder(schema, "tt_0", indexing=idx).build(_tree_rows(scale),
                                                       out_dir)


def test_star_trees_survive_a_replaced_directory(tmp_path):
    """A segment's directory written again under the same name (replaced
    whole, by rename) under a loaded segment: the loaded object still
    answers its own rows, on the star-tree rung and on the fused scan.
    The oracle is the first build's rows in numpy."""
    _build_tree_segment(str(tmp_path), 1)
    seg = load_segment(str(tmp_path / "tt_0"))
    assert seg._star_trees is None
    _build_tree_segment(str(tmp_path), 1000)
    rows = _tree_rows(1)
    d, m = np.array(rows["d"]), np.array(rows["m"], dtype=np.int64)
    want = {k: int(m[d == k].sum()) for k in np.unique(d)}
    assert want["k0"] == 49500
    sql = "SELECT d, SUM(m) FROM tt GROUP BY d LIMIT 100"
    ex = ServerQueryExecutor(device="cpu")
    tree, ts = ex.execute(t_compile(sql), [seg])
    assert ts.decisions == {"startree:scan->startree_device:tree0": 1}
    scan, ss = ex.execute(t_compile(sql + " OPTION(useStarTree=false)"),
                          [seg])
    assert not any(k.startswith("startree") for k in ss.decisions)
    assert ss.group_by_rung != "startree_device"
    for got in (tree, scan):
        assert {r[0]: int(r[1]) for r in got.rows} == want
    # the new directory answers its own rows
    fresh, _ = ex.execute(t_compile(sql),
                          [load_segment(str(tmp_path / "tt_0"))])
    assert {r[0]: int(r[1]) for r in fresh.rows} == {
        k: v * 1000 for k, v in want.items()}


@pytest.fixture(scope="module")
def crossed(dirs):
    jd, td = dirs["stats"]
    return {"jax_own": [j_load(d) for d in jd],
            "jax_loads_port": [j_load(d) for d in td],
            "port_loads_jax": [load_segment(d) for d in jd],
            "port_loads_port": [load_segment(d) for d in td]}


@pytest.mark.parametrize("qi", range(N_QUERIES))
def test_fuzz_across_directories(crossed, qi):
    from pinot_tpu.engine.errors import QueryError as JQueryError
    from pinot_tpu_torch.engine.errors import QueryError

    sql, exact, float_order = _query(np.random.default_rng(SEED + qi))
    jex = JExecutor(use_device=True, use_pallas=False)
    try:
        want, _ = jex.execute(j_compile(sql), crossed["jax_own"])
    except JQueryError:
        for segs in (crossed["port_loads_jax"], crossed["port_loads_port"]):
            with pytest.raises(QueryError):
                ServerQueryExecutor(device="cpu").execute(t_compile(sql),
                                                          segs)
        return
    got, _ = jex.execute(j_compile(sql), crossed["jax_loads_port"])
    assert got.rows == want.rows, sql
    for key in ("port_loads_jax", "port_loads_port"):
        got, _ = ServerQueryExecutor(device="cpu").execute(t_compile(sql),
                                                           crossed[key])
        assert got.schema.column_names == want.schema.column_names, sql
        assert _rows_equal(got.rows, want.rows, exact, float_order), \
            (key, sql, got.rows[:5], want.rows[:5])


@pytest.mark.parametrize("codec", ["ZSTANDARD", "ZLIB", "PASS_THROUGH",
                                   "SNAPPY", "LZ4"])
def test_codecs_round_trip_and_equal_jax(tmp_path, codec):
    vals = np.random.default_rng(1).integers(0, 1 << 40, 150_000)
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    assert tcomp.write_compressed(tp, vals, codec, chunk_docs=40_000) == \
        jcomp.write_compressed(jp, vals, codec, chunk_docs=40_000)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(tcomp.read_compressed(jp), vals)
    np.testing.assert_array_equal(
        tcomp.read_compressed(tp, doc_range=(39_990, 80_010)),
        vals[39_990:80_010])


def test_without_zstandard_a_write_is_zlib_and_a_zstd_read_raises(
        tmp_path, monkeypatch):
    vals = np.arange(5000, dtype=np.int32)
    jp = str(tmp_path / "j.bin")
    assert jcomp.write_compressed(jp, vals, "ZSTANDARD") == "ZSTANDARD"
    monkeypatch.setattr(tcomp, "_zstd_mod", None)
    tp = str(tmp_path / "t.bin")
    assert tcomp.write_compressed(tp, vals, "ZSTANDARD") == "ZLIB"
    np.testing.assert_array_equal(tcomp.read_compressed(tp), vals)
    with pytest.raises(RuntimeError, match="zstandard"):
        tcomp.read_compressed(jp)


def test_loaded_maps_are_read_only_and_staging_copies(dirs):
    seg = load_segment(dirs["stats"][1][0])
    for col in ("salary", "nick", "bonus"):
        cm = seg.metadata.column(col)
        ds = seg.data_source(col)
        if not cm.has_dictionary:
            assert not ds.forward_index.flags.writeable
        if cm.has_nulls:
            assert not ds.null_bitmap.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        staged = StagedSegment(seg, device="cpu")
        for col in seg.metadata.columns:
            staged.column(col)
            staged.value_column(col)
            staged.packed_column(col)
    null = staged.column("nick").null
    before = np.array(seg.data_source("nick").null_bitmap)
    null[:] = ~null        # the tensor owns its memory: the map is untouched
    np.testing.assert_array_equal(seg.data_source("nick").null_bitmap, before)
    # the batch path stacks the loaded arrays into arrays of its own
    from pinot_tpu_torch.parallel import ShardedQueryExecutor

    both = [load_segment(d) for d in dirs["stats"][1]]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, _ = ShardedQueryExecutor(device="cpu").execute(t_compile(
            "SELECT league, sum(salary), max(bonus), count(*) FROM stats "
            "WHERE nick IS NOT NULL GROUP BY league ORDER BY league"), both)
    assert len(got.rows) == 2
    tseg = load_segment(dirs["events"][1][0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nodes = StagedSegment(tseg, device="cpu").startree_nodes(0)
    key = next(k for k in nodes if "price" in k)
    nodes[key][:] = 0
    assert np.asarray(tseg.star_trees[0].metrics["sum__price"]).any()


def test_segment_deleted_while_held_still_answers(dirs, tmp_path):
    sql = ("SELECT team, count(*), sum(runs) FROM stats "
           "WHERE salary > 100000 GROUP BY team ORDER BY team")
    want, _ = ServerQueryExecutor(device="cpu").execute(
        t_compile(sql), [load_segment(dirs["stats"][1][0])])
    src = tmp_path / "copy"
    shutil.copytree(dirs["stats"][1][0], src)
    gc.collect()
    base = native.mmap_buffer_count()
    tdm = TableDataManager("stats_OFFLINE")
    tdm.add_segment_from_dir(str(src))
    assert native.mmap_buffer_count() > base
    held = tdm.acquire_segments(None)
    shutil.rmtree(src)
    tdm.remove_segment("stats_1")
    ex = ServerQueryExecutor(device="cpu")
    got, _ = ex.execute(t_compile(sql), [h.segment for h in held])
    assert got.rows == want.rows
    tdm.release_segments(held)
    ex.evict_segment("stats_1")     # the server's eviction hook
    del held
    gc.collect()
    assert native.mmap_buffer_count() == base


def test_writer_replaces_a_directory_whole(dirs, tmp_path):
    seg = load_segment(dirs["events"][1][0])
    md = write_segment(seg, str(tmp_path))
    assert verify_crc(str(tmp_path / "events_0"))
    (tmp_path / "events_0" / "columns" / "stale.npy").write_bytes(b"x")
    again = write_segment(seg, str(tmp_path))
    assert again.crc == md.crc
    assert not (tmp_path / "events_0" / "columns" / "stale.npy").exists()
    assert sorted(os.listdir(tmp_path)) == ["events_0"]
    assert _files(str(tmp_path / "events_0")) == \
        _files(dirs["events"][1][0])


def test_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_segment(str(tmp_path / "nothing"))


def test_from_host_copies_maps_and_keeps_shapes():
    """Staging copies a read-only array (a map of a segment file) and
    never wraps it; a plan's 0-d params keep shape ()."""
    from pinot_tpu_torch.engine.staging import from_host

    ro = np.arange(5, dtype=np.int32)
    ro.flags.writeable = False
    t = from_host(ro)
    assert t.tolist() == ro.tolist()
    assert not np.shares_memory(t.numpy(), ro)
    assert from_host(np.int32(3)).shape == ()
    assert from_host(np.float64(2.5)).shape == ()
    assert from_host(np.arange(6)[::-2]).tolist() == [5, 3, 1]
