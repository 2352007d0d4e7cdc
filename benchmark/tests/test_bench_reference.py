"""The reference: on hand-worked frames, and against the port's own SSB
oracle (a test may import the port; the reference may not)."""

import numpy as np
import torch

from benchmark.harness import spec, traffic as traffic_mod
from benchmark.harness.frame import Column, Frame
from benchmark.reference import hll
from benchmark.reference.evaluate import answer, kept_segments

from bench_tiny import ROOT, TINY


def _hand_frame() -> Frame:
    cols = {"k": Column("STRING", "DIMENSION", universe=["a", "b", "c"]),
            "v": Column("INT", "METRIC"),
            "t": Column("STRING", "DIMENSION", universe=["x", "y", "z"],
                        multi_value=True)}
    data = {"k": torch.tensor([0, 1, 1, 2, 0, 1]),
            "v": torch.tensor([5, 7, 1, 4, 3, 10]),
            "t": (torch.tensor([[0, 1], [2, 0], [1, 0], [0, 2], [1, 1],
                                [2, 0]]),
                  torch.tensor([2, 1, 1, 2, 1, 1]))}
    return Frame("t", cols, data, [(0, 3), (3, 6)])


def test_hand_worked_group_by():
    f = _hand_frame()
    q = {"select": [{"col": "k"}, {"agg": "count"},
                    {"agg": "sum", "arg": "v"}, {"agg": "min", "arg": "v"},
                    {"agg": "avg", "arg": "v"}],
         "where": [["v", ">=", 3]], "group_by": ["k"], "limit": 100}
    assert answer(f, q) == [["a", 2, 8, 3, 4.0], ["b", 2, 17, 7, 8.5],
                            ["c", 1, 4, 4, 4.0]]


def test_hand_worked_multi_value_and_order():
    f = _hand_frame()
    # rows holding y: 0, 2, 4; rows without x or z: 2, 4
    q = {"select": [{"agg": "count"}], "where": [["t", "=", "y"]]}
    assert answer(f, q) == [[3]]
    q = {"select": [{"agg": "count"}], "where": [["t", "not_in", ["x", "z"]]]}
    assert answer(f, q) == [[2]]
    q = {"select": [{"col": "k"}, {"agg": "sum", "arg": "v"}],
         "group_by": ["k"], "order_by": [[1, "desc"]], "limit": 2}
    assert answer(f, q) == [["b", 18], ["a", 8]]
    q = {"select": [{"agg": "count"}],
         "where": [{"or": [["v", "in", [1, 4]], ["k", "=", "a"]]}]}
    assert answer(f, q) == [[4]]
    # the float32 control rounds a sum a float32 cannot hold
    big = Frame("t", {"v": Column("INT", "METRIC")},
                {"v": torch.tensor([16_777_217, 2])}, [(0, 2)])
    q = {"select": [{"agg": "sum", "arg": "v"}]}
    assert answer(big, q) == [[16_777_219]]
    assert answer(big, q, precision="float32") != [[16_777_219]]


def test_kept_segments_min_max():
    f = _hand_frame()
    assert kept_segments(f, {"select": [], "where": [["v", ">", 7]]}) == [1]
    assert kept_segments(f, {"select": [], "where": [["k", "=", "c"]]}) == [1]
    assert kept_segments(f, {"select": [],
                             "where": [["k", "!=", "a"]]}) == [0, 1]


def test_hll_copy_matches_port():
    from pinot_tpu_torch.utils.hll import HyperLogLog, dictionary_register_luts

    vals = [f"MFGR#{i}" for i in range(300)]
    reg, rank = hll.register_luts(vals)
    preg, prank = dictionary_register_luts(vals)
    assert np.array_equal(reg, preg) and np.array_equal(rank, prank)
    regs = np.zeros(256, dtype=np.uint8)
    np.maximum.at(regs, reg, rank.astype(np.uint8))
    assert hll.cardinality(regs) == HyperLogLog(8, regs).cardinality()
    from pinot_tpu_torch.utils.hll import hash_values

    ints = list(range(-5, 40))
    assert [hll.hash_value(v) for v in ints] == \
        [int(h) for h in hash_values(np.asarray(ints))]
    assert [hll.hash_value(v) for v in vals] == \
        [int(h) for h in hash_values(vals)]


def _ssb_frame():
    cell = spec.load_cell(ROOT, "ssb-flights-c1")
    cfg = {**cell.config, **TINY["ssb-flights-c1"]["config"], "segments": 8}
    return spec.generator(ROOT, "ssb").generate(cfg, 5, "cpu")


def _numpy_frame(f: Frame):
    return {k: v.numpy().astype(np.int64) for k, v in f.data.items()}


def test_flights_match_port_oracle():
    from pinot_tpu_torch.tools import ssb

    f = _ssb_frame()
    # the universes of the columns the port tool knows are its own, so its
    # oracle reads the codes
    for col in ssb.UNIVERSE:
        assert list(ssb.UNIVERSE[col]) == f.columns[col].universe
    tr = spec.load_cell(ROOT, "ssb-flights-c1").traffic
    frame_np = _numpy_frame(f)
    # each flight at its published literals: fill the params by hand (the
    # tool's Q3.4 reads d_yearmonthnum and its Q4.3 leaves out c_region)
    literals = {
        "Q1.1": {"year": 1993, "d": 1, "d2": 3, "q": 25},
        "Q1.2": {"ym": 199401, "d": 4, "d2": 6, "q": 26, "q2": 35},
        "Q1.3": {"week": 6, "year": 1994, "d": 5, "d2": 7, "q": 26,
                 "q2": 35},
        "Q2.1": {"m": 1, "c": 2, "cat": "MFGR#12", "r": "AMERICA"},
        "Q2.2": {"lo": "MFGR#2221", "hi": "MFGR#2228", "r": "ASIA"},
        "Q2.3": {"brand": "MFGR#2239", "r": "EUROPE"},
        "Q3.1": {"r": "ASIA", "y": 1992, "y2": 1997},
        "Q3.2": {"n": "UNITED STATES", "y": 1992, "y2": 1997},
        "Q3.3": {"c1": "UNITED KI1", "c2": "UNITED KI5", "y": 1992,
                 "y2": 1997},
        "Q4.1": {"r": "AMERICA", "f1": "MFGR#1", "f2": "MFGR#2"},
        "Q4.2": {"r": "AMERICA", "f1": "MFGR#1", "f2": "MFGR#2", "y": 1997,
                 "y2": 1998},
    }
    by_id = {t["id"]: t for t in tr["templates"]}
    for qid, lit in literals.items():
        body = {k: by_id[qid][k] for k in ("select", "where", "group_by",
                                           "order_by", "limit")
                if k in by_id[qid]}
        q = traffic_mod._fill(body, lit)
        got = answer(f, q)
        want = ssb.numpy_answer(frame_np, qid)
        if isinstance(want, int):
            assert got == [[want]], qid
            continue
        pos = [q["select"].index({"col": g}) for g in q["group_by"]]
        assert {tuple(r[i] for i in pos): r[-1] for r in got} == want, qid


# the port tool's queries the fused scan declines, as structured queries:
# the reference's hash group-by, min / max, DISTINCTCOUNT and HLL
DECLINED = {
    "G2": {"select": [{"col": "c_city"}, {"col": "s_city"},
                      {"agg": "sum", "arg": "lo_revenue"}],
           "where": [["c_region", "=", "ASIA"], ["s_region", "=", "ASIA"],
                     ["d_year", "=", 1997]],
           "group_by": ["c_city", "s_city"]},
    "G3": {"select": [{"col": "d_year"},
                      {"agg": "min",
                       "arg": ["mul", "lo_extendedprice", "lo_discount"]},
                      {"agg": "max",
                       "arg": ["mul", "lo_extendedprice", "lo_discount"]}],
           "where": [["lo_quantity", ">=", 1]], "group_by": ["d_year"]},
    "G4": {"select": [{"agg": "distinctcount", "arg": "p_brand1"}],
           "where": [["s_region", "=", "AMERICA"], ["d_year", "=", 1993]]},
    "G5": {"select": [{"col": "d_year"},
                      {"agg": "distinctcounthll", "arg": "p_brand1"}],
           "where": [["s_region", "=", "EUROPE"]], "group_by": ["d_year"]},
}


def test_declined_match_port_oracle():
    from pinot_tpu_torch.tools import ssb

    f = _ssb_frame()
    frames = [{k: v[a:b] for k, v in _numpy_frame(f).items()}
              for a, b in f.segments]
    for gid, q in DECLINED.items():
        got = answer(f, q)
        want = ssb.declined_answer(frames, gid)
        nk = len(q.get("group_by", []))
        if gid == "G3":
            assert {(r[0],): (r[1], r[2]) for r in got} == want
        else:
            assert {tuple(r[:nk]): r[nk] for r in got} == want, gid
