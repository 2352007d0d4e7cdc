"""The port's plans equal the JAX package's: plan_segment spec and params,
extract_plan trees/aggs/static params, and decline reason codes, on the
same segments carried across with segment_from_arrays."""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine.pallas_kernels import extract_plan as j_extract  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine.fused_scan import extract_plan as t_extract  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402
from pinot_tpu_torch.tools.ssb import DECLINED_QUERIES  # noqa: E402

# tests/test_pallas.py's QUERIES and WIDE_QUERIES, over its pl_sales shape
PL_QUERIES = [
    "SELECT region, count(*) FROM pl_sales GROUP BY region ORDER BY region",
    "SELECT region, sum(qty), count(*) FROM pl_sales "
    "WHERE year BETWEEN 2005 AND 2015 GROUP BY region ORDER BY region",
    "SELECT region, sum(price), avg(price) FROM pl_sales "
    "WHERE region != 'west' GROUP BY region ORDER BY region",
    "SELECT city, sum(qty), avg(qty) FROM pl_sales WHERE year = 2010 "
    "GROUP BY city ORDER BY city LIMIT 200",
    "SELECT region, city, sum(price), count(*) FROM pl_sales "
    "WHERE year >= 2012 AND region = 'east' "
    "GROUP BY region, city ORDER BY region, city LIMIT 200",
    "SELECT year, sum(qty), sum(price) FROM pl_sales "
    "GROUP BY year ORDER BY year LIMIT 30",
    "SELECT count(*), sum(qty) FROM pl_sales WHERE region = 'east'",
    "SELECT sum(price), avg(qty) FROM pl_sales "
    "WHERE year BETWEEN 2005 AND 2015",
    "SELECT min(price), max(price), minmaxrange(qty) FROM pl_sales "
    "WHERE region != 'west'",
    "SELECT region, min(qty), max(price) FROM pl_sales "
    "GROUP BY region ORDER BY region",
    "SELECT region, sum(qty) FROM pl_sales "
    "WHERE year = 2010 OR region = 'east' GROUP BY region ORDER BY region",
    "SELECT count(*) FROM pl_sales "
    "WHERE (region = 'east' OR region = 'west') AND year >= 2012",
]

# plans only the general rung serves: the declined SSB queries, gexpr keys,
# DISTINCTCOUNTHLL (its register tables are params)
GENERAL_QUERIES = dict(DECLINED_QUERIES, **{
    "gexpr": "SELECT d_year * 100 + lo_discount, lo_quantity - lo_discount, "
             "sum(lo_revenue) FROM ssb_lineorder WHERE lo_quantity < 10 "
             "GROUP BY d_year * 100 + lo_discount, lo_quantity - lo_discount "
             "LIMIT 100000",
    "gexpr hll": "SELECT 3 * d_year - 1, distinctcounthll(c_city), "
                 "distinctcounthll(lo_quantity) FROM ssb_lineorder "
                 "GROUP BY 3 * d_year - 1 LIMIT 100000",
    "hll lut": "SELECT distinctcounthll(s_city), count(*) FROM ssb_lineorder "
               "WHERE p_mfgr IN ('MFGR#1', 'MFGR#4') AND d_year != 1995",
})

GRAFT_SQL = ("SELECT region, sum(qty), count(*), avg(price) FROM sales "
             "WHERE year BETWEEN 2017 AND 2022 AND kind != 'c' "
             "GROUP BY region ORDER BY region")


def carry(jseg, table):
    return segment_from_arrays(jseg.segment_name, jseg.num_docs,
                               columns_of(jseg), table_name=table)


def build_pl_sales(out):
    """The tests/test_pallas.py fixture's segments (2 tiles, padded tail)."""
    n = 2 * 4096 - 700
    rng = np.random.default_rng(11)
    cities = np.array([f"c{i:03d}" for i in range(137)])
    frame = {
        "region": np.array(["east", "west", "north", "south"])[
            rng.integers(0, 4, n)],
        "city": cities[rng.integers(0, len(cities), n)],
        "year": rng.integers(2000, 2024, n).astype(np.int64),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "price": np.round(rng.normal(80.0, 30.0, n), 2),
    }
    schema = Schema("pl_sales", [
        FieldSpec("region", DataType.STRING), FieldSpec("city", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC)])
    segs = []
    for i, sl in enumerate([slice(0, n // 2), slice(n // 2, n)]):
        SegmentBuilder(schema, f"pl_sales_{i}").build(
            {c: v[sl] for c, v in frame.items()}, str(out))
        segs.append(load_segment(str(out / f"pl_sales_{i}")))
    return segs


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    import __graft_entry__

    ssb_segs = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_plan_ssb")), num_segments=2,
        rows=18_000, star_tree=False, workers=1)
    pl_segs = build_pl_sales(tmp_path_factory.mktemp("torch_plan_pl"))
    graft = __graft_entry__._build_segments(
        1, 2048, str(tmp_path_factory.mktemp("torch_plan_graft")))
    out = {}
    for qid, sql in j_ssb.QUERIES.items():
        out[f"ssb {qid}"] = (sql + " LIMIT 100000", ssb_segs, "ssb_lineorder")
    for gid, sql in GENERAL_QUERIES.items():
        out[f"ssb {gid}"] = (sql, ssb_segs, "ssb_lineorder")
    for i, sql in enumerate(PL_QUERIES):
        out[f"pl_sales {i}"] = (sql, pl_segs, "pl_sales")
    out["graft"] = (GRAFT_SQL, graft, "sales")
    return out


CASE_IDS = ([f"ssb {q}" for q in j_ssb.QUERIES]
            + [f"ssb {g}" for g in GENERAL_QUERIES]
            + [f"pl_sales {i}" for i in range(len(PL_QUERIES))] + ["graft"])


def _params_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", CASE_IDS)
def test_plan_and_extract_equal(cases, case):
    sql, jsegs, table = cases[case]
    for jseg in jsegs:
        tseg = carry(jseg, table)
        jp = j_plan(j_compile(sql), jseg)
        tp = t_plan(t_compile(sql), tseg)
        assert tp.spec == jp.spec
        _params_equal(tp.params, jp.params)
        assert tp.group_cards == jp.group_cards
        assert tp.group_bases == jp.group_bases
        for unchecked in (False, True):
            jr, tr = [], []
            ja = j_extract(jp, jseg, on_decline=jr.append,
                           unchecked_groups=unchecked)
            ta = t_extract(tp, tseg, on_decline=tr.append,
                           unchecked_groups=unchecked)
            assert tr == jr
            assert (ta is None) == (ja is None)
            if ja is None:
                continue
            for field in ("packed_names", "value_names", "value_is_int",
                          "filter_tree", "n_slots", "group_idx",
                          "group_strides", "group_key_offset",
                          "num_groups_padded", "aggs", "value_limbs"):
                assert getattr(ta, field) == getattr(ja, field), field
            np.testing.assert_array_equal(ta.static_params, ja.static_params)


DECLINES = [
    ("SELECT count(DISTINCT c_city) FROM ssb_lineorder", {}),
    ("SELECT max(lo_extendedprice * lo_discount) FROM ssb_lineorder", {}),
    ("SELECT sum(lo_extendedprice * lo_revenue) FROM ssb_lineorder", {}),
    ("SELECT c_city, s_city, sum(lo_revenue) FROM ssb_lineorder "
     "GROUP BY c_city, s_city LIMIT 100000", {}),
    ("SELECT sum(lo_revenue) FROM ssb_lineorder WHERE c_city IN ({every2})",
     {}),
    ("SELECT sum(lo_revenue) FROM ssb_lineorder WHERE c_city IN ({every7})",
     {"lut_run_cap": 4}),
]


@pytest.mark.parametrize("sql,kw", DECLINES,
                         ids=[d[0][:50] for d in DECLINES])
def test_decline_reason_codes_equal(cases, sql, kw):
    _, jsegs, _ = cases["ssb Q1.1"]
    jseg = jsegs[0]
    tseg = carry(jseg, "ssb_lineorder")
    cities = tseg.data_source("c_city").dictionary.values.tolist()
    sql = sql.format(every2=", ".join(f"'{c}'" for c in cities[::2]),
                     every7=", ".join(f"'{c}'" for c in cities[::7][:24]))
    jr, tr = [], []
    ja = j_extract(j_plan(j_compile(sql), jseg), jseg, on_decline=jr.append,
                   **kw)
    ta = t_extract(t_plan(t_compile(sql), tseg), tseg, on_decline=tr.append,
                   **kw)
    assert ja is None and ta is None
    assert jr and tr == jr
