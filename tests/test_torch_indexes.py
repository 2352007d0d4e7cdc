"""Segment indexes in the port against the JAX package's: one table built
by the JAX SegmentBuilder with an IndexingConfig of every kind, carried
across with segment_from_arrays and the port's same IndexingConfig.

Equal to the JAX segment's: the inverted postings (doc-count offsets and
each dictId's docIds, a multi-value row that holds a value twice listed
twice), the range permutation and its sorted values, ``is_sorted`` of every
column, the bloom filters' bits, and the FST, text and JSON readers'
answers (the patterns of tests/test_fst_index.py, tests/test_text_index.py
and tests/test_json_range_index.py). The planner's lookup tables and the
host engine's masks through the indexes equal those of the index-less
segment and of the JAX segment; the bloom branch of the pruner prunes the
segments the JAX pruner prunes (tests/test_pruner.py's cases).
"""

import json

import numpy as np
import pytest

from pinot_tpu.engine.host_eval import eval_filter as j_eval_filter
from pinot_tpu.engine.pruner import prune_segments as j_prune
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema
from pinot_tpu.spi.table import IndexingConfig as JIndexing
from pinot_tpu_torch.engine.host_eval import eval_filter as t_eval_filter
from pinot_tpu_torch.engine.plan import plan_segment as t_plan
from pinot_tpu_torch.engine.pruner import prune_segments as t_prune
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.segment import columns_of, segment_from_arrays
from pinot_tpu_torch.segment.fstindex import literal_prefix
from pinot_tpu_torch.spi import IndexingConfig

N = 3000
WORDS = ["quick", "brown", "fox", "realtime", "analytics", "query",
         "engine", "streaming", "ingestion", "tpu"]
CFG = dict(inverted_index_columns=["k", "s", "tags"],
           range_index_columns=["r"],
           bloom_filter_columns=["k", "s", "r", "f"],
           fst_index_columns=["url"], text_index_columns=["body"],
           json_index_columns=["payload"], no_dictionary_columns=["r", "f"])


def _frame(seed: int, n: int):
    rng = np.random.default_rng(seed)
    payload = []
    for i in range(n):
        doc = {"user": {"tier": ["gold", "silver", "bronze"][
                   int(rng.integers(0, 3))]},
               "tags": [f"t{int(x)}"
                        for x in rng.integers(0, 8, rng.integers(0, 3))]}
        if i % 5 == 0:
            doc["promo"] = True
        payload.append(json.dumps(doc))
    tags = [[f"g{int(x)}" for x in rng.integers(0, 6, rng.integers(1, 4))]
            for _ in range(n)]
    tags[0] = ["g1", "g1"]      # a row that holds a value twice
    return {
        "k": rng.integers(0, 400, n).astype(np.int64),
        "srt": np.sort(rng.integers(0, 50, n)).astype(np.int64),
        "s": np.array([f"s{int(x):03d}" for x in rng.integers(0, 120, n)]),
        "url": [f"/api/v{rng.integers(1, 4)}/users/{i % 100}" if i % 3
                else f"/static/img/{i % 50}.png" for i in range(n)],
        "body": [" ".join(rng.choice(WORDS, int(rng.integers(2, 6))))
                 for _ in range(n)],
        "payload": payload,
        "tags": tags,
        "r": rng.integers(0, 100_000, n).astype(np.int64),
        "f": np.round(rng.normal(5, 2, n), 1).astype(np.float32),
    }


def _schema():
    S, L, I = DataType.STRING, DataType.LONG, DataType.INT
    return Schema("ix", [
        FieldSpec("k", I), FieldSpec("srt", I), FieldSpec("s", S),
        FieldSpec("url", S), FieldSpec("body", S), FieldSpec("payload", S),
        FieldSpec("tags", S, single_value=False),
        FieldSpec("r", L, FieldType.METRIC),
        FieldSpec("f", DataType.FLOAT, FieldType.METRIC)])


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_indexes")
    SegmentBuilder(_schema(), "ix_0", indexing_config=JIndexing(**CFG)).build(
        _frame(5, N), str(out))
    jseg = load_segment(str(out / "ix_0"))
    cols = columns_of(jseg)
    tseg = segment_from_arrays("ix_0", jseg.num_docs, cols, table_name="ix",
                               indexing=IndexingConfig(**CFG))
    plain = segment_from_arrays("ix_0", jseg.num_docs, cols, table_name="ix")
    return jseg, tseg, plain


def test_metadata_flags_and_is_sorted(segs):
    jseg, tseg, plain = segs
    for col, jc in jseg.metadata.columns.items():
        tc = tseg.metadata.column(col)
        for flag in ("is_sorted", "has_inverted_index", "has_range_index",
                     "has_bloom_filter", "has_fst_index", "has_text_index",
                     "has_json_index"):
            assert getattr(tc, flag) == getattr(jc, flag), (col, flag)
        assert plain.metadata.column(col).is_sorted == jc.is_sorted, col
        assert not (plain.metadata.column(col).has_inverted_index
                    or plain.metadata.column(col).has_bloom_filter)
    assert tseg.metadata.column("srt").is_sorted


@pytest.mark.parametrize("col", ["k", "s", "tags"])
def test_postings_equal(segs, col):
    jseg, tseg, _ = segs
    jds, tds = jseg.data_source(col), tseg.data_source(col)
    offsets, docs = tds.inverted_index
    np.testing.assert_array_equal(offsets, jds.inverted_index[0])
    assert docs.dtype == np.int32 and docs.shape[0] == offsets[-1]
    for i in range(jseg.metadata.column(col).cardinality):
        np.testing.assert_array_equal(tds.doc_ids_for_dict_id(i),
                                      jds.doc_ids_for_dict_id(i), (col, i))
    if col == "tags":
        g1 = tds.dictionary.index_of("g1")
        assert tds.doc_ids_for_dict_id(g1)[:2].tolist() == [0, 0]


def test_range_index_equal(segs):
    jseg, tseg, _ = segs
    jds, tds = jseg.data_source("r"), tseg.data_source("r")
    np.testing.assert_array_equal(tds.range_order, jds.range_order)
    np.testing.assert_array_equal(tds.range_sorted_values,
                                  jds.range_sorted_values)
    assert tseg.data_source("k").range_order is None


@pytest.mark.parametrize("col", ["k", "s", "r", "f"])
def test_bloom_bits_equal(segs, col):
    jseg, tseg, _ = segs
    jb, tb = jseg.data_source(col).bloom_filter, \
        tseg.data_source(col).bloom_filter
    assert tb.num_hashes == jb.num_hashes
    np.testing.assert_array_equal(tb.bits, jb.bits)
    np.testing.assert_array_equal(tb.to_array(), jb.to_array())


FST_PATTERNS = ["^/static/", "users/7$", "^/api/v2/users/1", "^/api/v[12]",
                "^/api/v1/users/9.", "^/nothing", ".*png", "^abc|/static",
                r"^/static/img/1\d\.png"]


@pytest.mark.parametrize("pattern", FST_PATTERNS)
def test_fst_reader_equal(segs, pattern):
    jseg, tseg, plain = segs
    got = tseg.data_source("url").fst_index.matching_ids(pattern)
    want = jseg.data_source("url").fst_index.matching_ids(pattern)
    np.testing.assert_array_equal(got, want)
    _same_masks(segs, f"REGEXP_LIKE(url, '{pattern}')")


def test_literal_prefix_equal():
    from pinot_tpu.segment.fstindex import literal_prefix as j_prefix

    for p in ("^abc.*", "^abc", "abc", "^a[bc]d", "^ab?c", "^", r"^a\.b",
              r"^a\d+", "^(ab|cd)", "^abc|xyz"):
        assert literal_prefix(p) == j_prefix(p), p


TEXT_QUERIES = ["quick", "quick fox", "quick AND fox", '"realtime analytics"',
                "ana*", "ingest*", "(quick OR streaming) AND analytics",
                "tpu AND quer*", "absentword"]


@pytest.mark.parametrize("q", TEXT_QUERIES)
def test_text_reader_equal(segs, q):
    jseg, tseg, _ = segs
    got = tseg.data_source("body").text_index.matching_ids(q)
    want = jseg.data_source("body").text_index.matching_ids(q)
    np.testing.assert_array_equal(got, want)
    _same_masks(segs, "TEXT_MATCH(body, '{}')".format(q.replace("'", "''")))


JSON_FILTERS = ["\"$.user.tier\"='gold'", "\"$.tags[*]\"='t3'",
                "\"$.user.tier\"='gold' AND \"$.tags[*]\"='t1'",
                "\"$.promo\" IS NOT NULL", "\"$.promo\" IS NULL",
                "\"$.user.tier\"!='gold'",
                "\"$.user.tier\"='gold' OR \"$.user.tier\"='silver'"]


@pytest.mark.parametrize("flt", JSON_FILTERS)
def test_json_reader_equal(segs, flt):
    jseg, tseg, _ = segs
    got = tseg.data_source("payload").json_index.match(flt)
    want = jseg.data_source("payload").json_index.match(flt)
    np.testing.assert_array_equal(got[:N], np.asarray(want)[:N])
    _same_masks(segs, "JSON_MATCH(payload, '{}')".format(
        flt.replace("'", "''")))


def _same_masks(segs, where):
    """The host mask through the indexes equals the index-less segment's
    and the JAX indexed segment's; the planner's lookup table (and its
    params) through the indexes equals the index-less one."""
    jseg, tseg, plain = segs
    sql = f"SELECT count(*) FROM ix WHERE {where}"
    got = t_eval_filter(tseg, t_compile(sql).filter)
    np.testing.assert_array_equal(got, t_eval_filter(plain,
                                                     t_compile(sql).filter))
    np.testing.assert_array_equal(got, j_eval_filter(jseg,
                                                     j_compile(sql).filter))
    if "JSON_MATCH" in where:
        return      # the planner reads no JSON index (JAX plan.py:975)
    a, b = t_plan(t_compile(sql), tseg), t_plan(t_compile(sql), plain)
    assert a.spec == b.spec
    for pa, pb in zip(a.params, b.params):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("where", [
    "r BETWEEN 1000 AND 2000", "r > 99000", "r < 5", "r >= 50000",
    "k = 7", "k IN (1, 2, 399)", "s = 's010'", "s IN ('s001', 's119')",
    "tags = 'g1'", "k BETWEEN 10 AND 12"])
def test_host_masks_through_postings_and_ranges(segs, where):
    _same_masks(segs, where)


@pytest.fixture(scope="module")
def bloom_segs(tmp_path_factory):
    """tests/test_pruner.py's shape: 4 segments whose region values are
    disjoint (and inside each other's min/max), a bloom filter on region,
    and a FLOAT column with a bloom filter."""
    out = tmp_path_factory.mktemp("torch_bloom")
    schema = Schema("pr", [FieldSpec("region", DataType.STRING),
                           FieldSpec("f", DataType.FLOAT),
                           FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    cfg = dict(bloom_filter_columns=["region", "f"])
    jsegs = []
    for i in range(4):
        n = 500
        region = [f"r{i}{'abc'[j % 3]}" for j in range(n)]
        # every segment's min/max spans the others' values: only the bloom
        # filter can prune
        region[0], region[1] = "r0a", "r9z"
        frame = {"region": region, "f": [0.1 * (i + 1)] * n,
                 "v": list(range(n))}
        SegmentBuilder(schema, f"pr_{i}", indexing_config=JIndexing(
            **cfg)).build(frame, str(out))
        jsegs.append(load_segment(str(out / f"pr_{i}")))
    tsegs = [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                 table_name="pr",
                                 indexing=IndexingConfig(**cfg))
             for j in jsegs]
    return jsegs, tsegs


@pytest.mark.parametrize("where", [
    "region = 'r2b'", "region IN ('r1a', 'r3c')", "region = 'absent'",
    "region = 'r0a'", "f = 0.2", "f = 0.30000001", "f IN (0.1, 0.4)",
    "region = 'r2b' OR region = 'r3a'", "NOT region = 'r2b'"])
def test_bloom_pruner_prunes_as_jax(bloom_segs, where):
    jsegs, tsegs = bloom_segs
    sql = f"SELECT count(*) FROM pr WHERE {where}"
    got = [s.segment_name for s in t_prune(t_compile(sql), tsegs)]
    want = [s.segment_name for s in j_prune(j_compile(sql), jsegs)]
    assert got == want, where
    if where == "region = 'r2b'":
        assert got == ["pr_2"]
