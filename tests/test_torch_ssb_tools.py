"""The port's SSB tools against the JAX package's on the CPU, at small
sizes: the generators, the schema and indexing config, the partitioned
segments on disk (written by both packages, loaded by both, byte-equal
but for the creation time), the numpy baseline against JAX's pandas one,
partition pruning, the microbench's keys, and chip_smoke's phase 24."""

import json
import os

import numpy as np
import pytest

from pinot_tpu.engine.executor import ServerQueryExecutor as JExecutor
from pinot_tpu.query import compile_query as jcompile
from pinot_tpu.segment import load_segment as jload
from pinot_tpu.tools import microbench as jmb
from pinot_tpu.tools import ssb as J
from pinot_tpu.tools import ssb_baseline as JB
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.segment.immutable import load_segment
from pinot_tpu_torch.tools import microbench as tmb
from pinot_tpu_torch.tools import ssb as T
from pinot_tpu_torch.tools import ssb_baseline as TB

SEGMENTS = 7
ROWS = 7 * 1500


def _equal_frames(jcols, tcols):
    dec = T.decode_frame(tcols)
    assert set(jcols) == set(dec)
    for k in jcols:
        assert np.array_equal(jcols[k], dec[k]), k


@pytest.mark.parametrize("what", ["flat", "table", "segment",
                                  "partitioned"])
def test_generators_equal_jax(what):
    if what == "flat":
        _equal_frames(J.generate_flat(0, seed=3, rows=5000),
                      T.generate_flat(0, seed=3, rows=5000))
    elif what == "table":
        _equal_frames(J.generate_table(3, 10_001, seed=4),
                      T.generate_table(3, 10_001, seed=4))
    elif what == "segment":
        _equal_frames(J.generate_segment_frame(2, 5, 3000, seed=6),
                      T.generate_segment_frame(2, 5, 3000, seed=6))
    else:
        for i in range(SEGMENTS + 1):
            j = J.generate_partitioned_frame(i, SEGMENTS, 2000, seed=8)
            t = T.generate_partitioned_frame(i, SEGMENTS, 2000, seed=8)
            _equal_frames(j, t)
            assert set(t["d_year"].tolist()) == {1992 + i % 7}


def test_schema_and_indexing_config_equal_jax():
    js, ts = J.ssb_schema(), T.ssb_schema()
    assert js.schema_name == ts.schema_name
    assert [(f.name, f.data_type.name, f.field_type.name)
            for f in js.field_specs] == \
        [(f.name, f.data_type.name, f.field_type.name)
         for f in ts.field_specs]
    for kw in ({}, {"num_partitions": 7}, {"star_tree": False,
                                          "num_partitions": 4,
                                          "partition_column": "lo_discount"}):
        assert J.ssb_indexing_config(**kw).to_dict() == \
            T.ssb_indexing_config(**kw).to_dict(), kw


def _tree_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """The partitioned layout written by both packages: (JAX dir, port
    dir, port segments, port frames)."""
    d = tmp_path_factory.mktemp("ssb_part")
    J.build_segments(0, str(d / "j"), num_segments=SEGMENTS, rows=ROWS,
                     seed=9, workers=1, partitioned=True, star_tree=False)
    segs, frames = T.build_segments(0, num_segments=SEGMENTS, rows=ROWS,
                                    seed=9, out_dir=str(d / "t"),
                                    partitioned=True, workers=2)
    return str(d / "j"), str(d / "t"), segs, frames


def test_partitioned_dirs_equal_jax_file_for_file(partitioned):
    jdir, tdir, segs, _frames = partitioned
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        [f"ssb_part_{i}" for i in range(SEGMENTS)]
    for name in os.listdir(jdir):
        jf, tf = _tree_files(os.path.join(jdir, name)), \
            _tree_files(os.path.join(tdir, name))
        assert set(jf) == set(tf), name
        for rel in jf:
            a, b = open(jf[rel], "rb").read(), open(tf[rel], "rb").read()
            if rel == "metadata.json":
                ja, tb = json.loads(a), json.loads(b)
                ja.pop("creationTimeMs"), tb.pop("creationTimeMs")
                assert ja == tb, name
            else:
                assert a == b, (name, rel)
    md = segs[1].metadata.columns["d_year"]
    assert (md.partition_function, md.num_partitions, list(md.partitions)) \
        == ("Modulo", SEGMENTS, [1993 % SEGMENTS])


def _rows(table):
    return [tuple(r) for r in table.rows]


def test_partitioned_dirs_load_in_both_and_answer_alike(partitioned):
    """Each package's directories, loaded by the other package too: the
    13 flights on the JAX host engine and the port's executor on the CPU
    give the same rows, which equal the numpy baseline."""
    jdir, tdir, _segs, frames = partitioned
    whole = TB.make_frame({k: np.concatenate([f[k] for f in frames])
                           for k in frames[0]})
    names = sorted(os.listdir(tdir))
    jex = JExecutor(use_device=False)
    tex = ServerQueryExecutor(device="cpu")
    try:
        for d in (jdir, tdir):
            jsegs = [jload(os.path.join(d, n)) for n in names]
            tsegs = [load_segment(os.path.join(d, n)) for n in names]
            for qid, sql in T.QUERIES.items():
                sql += " LIMIT 100000"
                want = TB.run_query(whole, qid)
                jt, _ = jex.execute(jcompile(sql), jsegs)
                tt, _ = tex.execute(compile_query(sql), tsegs)
                assert TB.rows_match(_rows(jt), want), (d, qid)
                assert TB.rows_match(_rows(tt), want), (d, qid)
    finally:
        tex.close()


def test_partition_pruning_keeps_one_segment_for_1993(partitioned):
    _jdir, _tdir, segs, _frames = partitioned
    ex = ServerQueryExecutor(device="cpu")
    try:
        _t, stats = ex.execute(compile_query(
            "SELECT count(*) FROM ssb_lineorder WHERE d_year = 1993"), segs)
    finally:
        ex.close()
    assert stats.num_segments_pruned == SEGMENTS - 1
    assert stats.num_segments_processed == 1


@pytest.mark.parametrize("qid", list(J.QUERIES))
def test_numpy_baseline_equals_jax_pandas(qid):
    cols = J.generate_table(3, 30_000, seed=11)
    jdf = JB.make_frame(cols)
    want = JB.run_query(jdf, qid)
    # the JAX columns and the port's coded frame give the same rows
    assert TB.run_query(TB.make_frame(cols), qid) == want
    assert TB.run_query(TB.make_frame(T.generate_table(3, 30_000, seed=11)),
                        qid) == want
    if qid.startswith("Q1"):
        assert TB.run_query(TB.make_frame(cols), qid)[0][0] == \
            float(J.pandas_answer(cols, qid))
    assert TB.rows_match(want, TB.run_query(TB.make_frame(cols), qid))


def test_baseline_rows_match_is_order_blind():
    a = [("x", 1, 2.0), ("y", 1, 3.0)]
    assert TB.rows_match(a, list(reversed(a)))
    assert not TB.rows_match(a, [("x", 1, 2.0), ("y", 1, 3.5)])
    assert not TB.rows_match(a, a[:1])


@pytest.fixture
def small_microbench(monkeypatch):
    monkeypatch.setattr(jmb, "N_ROWS", 1 << 12)
    monkeypatch.setattr(tmb, "N_ROWS", 1 << 12)


@pytest.mark.parametrize("name", sorted(jmb.BENCHMARKS))
def test_microbench_entry_returns_jax_keys(name, small_microbench):
    jout = jmb.BENCHMARKS[name]()
    (tout,) = tmb.run([name], device="cpu")
    assert tout["bench"] == name
    assert set(jout) <= set(tout) - {"bench"}, (jout, tout)
    rates = [v for k, v in tout.items()
             if isinstance(v, (int, float)) and not isinstance(v, bool)
             and k != "bytes_per_row"]
    assert rates and all(r > 0 for r in rates), tout


def test_microbench_cli(capsys, small_microbench):
    assert tmb.main(["--device", "cpu", "sql_parse", "dictionary"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["bench"] for r in lines] == ["sql_parse", "dictionary"]
    assert tmb.main(["--device", "cpu", "nonsense"]) == 2


def test_in_memory_build_segments_unchanged():
    """The existing callers' path: segments in memory, frames beside."""
    segs, frames = T.build_segments(0, num_segments=3, rows=3000, seed=2)
    assert [s.segment_name for s in segs] == ["ssb_0", "ssb_1", "ssb_2"]
    _equal_frames(J.generate_table(3, 3000, seed=2),
                  {k: np.concatenate([f[k] for f in frames])
                   for k in frames[0]})
    with pytest.raises(ValueError):
        T.build_segments(0, num_segments=3, rows=3000, partitioned=True)


def test_chip_smoke_phase_24_small():
    import chip_smoke

    out = chip_smoke.phase_partitioned(1, device="cpu", sf=0.002,
                                       microbench_rows=1 << 12)
    assert set(out["flights"]) == set(T.QUERIES)
    assert out["flights"]["Q1.1"]["segments_kept"] == 1
    assert out["flights"]["Q2.1"]["segments_kept"] == SEGMENTS
    assert [r["bench"] for r in out["microbench"]] == sorted(tmb.BENCHMARKS)
