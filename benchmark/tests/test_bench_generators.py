"""The generator: the same seed gives the same table, another seed another,
and the SSB table follows dbgen's formulas at full width."""

import datetime as dt

import torch

from benchmark.generators.ssb import NATIONS
from benchmark.harness import spec

from bench_tiny import ROOT, SEED, TINY

CELL = "ssb-flights-c1"


def _frame(seed: int):
    cfg = {**spec.load_cell(ROOT, CELL).config, **TINY[CELL]["config"]}
    return spec.generator(ROOT, cfg["generator"]).generate(cfg, seed, "cpu")


def _strings(f, col, rows):
    u = f.columns[col].universe
    return [u[i] for i in f.data[col][rows].tolist()]


def test_generator_repeats_per_seed():
    a, b, c = _frame(SEED), _frame(SEED), _frame(SEED + 1)
    assert a.data.keys() == b.data.keys()
    assert all(torch.equal(a.data[k], b.data[k]) for k in a.data)
    assert a.segments == b.segments
    assert not all(torch.equal(a.data[k], c.data[k]) for k in a.data)


def test_ssb_full_width():
    f = _frame(7)
    assert len(f.columns) == 54
    prefixes = [c.split("_")[0] for c in f.columns]
    assert [prefixes.count(p) for p in ("lo", "c", "s", "p", "d")] == \
        [17, 7, 6, 8, 16]
    # every order has lines 1..n, and a fact row per line: 4 on average
    cfg = TINY[CELL]["config"]
    assert 3.8 < f.num_rows / cfg["orders"] < 4.2
    assert int(f.data["lo_linenumber"].min()) == 1
    assert int(f.data["lo_linenumber"].max()) == 7


def test_ssb_dbgen_formulas():
    f = _frame(7)
    d = {k: v.long() for k, v in f.data.items()}
    for col, lo, hi in (("lo_quantity", 1, 50), ("lo_discount", 0, 10),
                        ("lo_tax", 0, 8), ("p_size", 1, 50),
                        ("d_weeknuminyear", 1, 53),
                        ("lo_orderdate", 19920101, 19980802)):
        assert lo <= int(d[col].min()) and int(d[col].max()) <= hi, col
    p = d["lo_partkey"]
    price = 90000 + (p // 10) % 20001 + 100 * (p % 1000)
    assert torch.equal(d["lo_extendedprice"], price * d["lo_quantity"])
    assert torch.equal(d["lo_supplycost"], 6 * price // 10)
    assert torch.equal(d["lo_revenue"], d["lo_extendedprice"]
                       * (100 - d["lo_discount"]) // 100)
    # an order's total price: its lines' revenue with tax, on every line
    key = d["lo_orderkey"]
    line_total = d["lo_revenue"] * (100 + d["lo_tax"]) // 100
    _, inv = torch.unique(key, return_inverse=True)
    total = torch.zeros(int(inv.max()) + 1, dtype=torch.long).index_add_(
        0, inv, line_total)
    assert torch.equal(d["lo_ordtotalprice"], total[inv])
    assert int((d["lo_custkey"] % 3 == 0).sum()) == 0
    gap = [(b - a).days for a, b in zip(
        *[[dt.date(v // 10000, v // 100 % 100, v % 100)
           for v in d[c][:500].tolist()]
          for c in ("lo_orderdate", "lo_commitdate")])]
    assert 30 <= min(gap) and max(gap) <= 90
    # the date attributes are the order date's
    assert torch.equal(d["d_year"], d["lo_orderdate"] // 10000)
    assert torch.equal(d["d_yearmonthnum"], d["lo_orderdate"] // 100)
    assert torch.equal(d["d_daynuminmonth"], d["lo_orderdate"] % 100)
    assert torch.equal(d["d_weeknuminyear"],
                       (d["d_daynuminyear"] - 1) // 7 + 1)
    years = d["d_year"][:50].tolist()
    assert _strings(f, "d_yearmonth", slice(0, 50)) == [
        m[:3] + str(y) for m, y in zip(_strings(f, "d_month", slice(0, 50)),
                                       years)]
    # contiguous months: each segment's precede the next one's
    for (a, b), (c, e) in zip(f.segments, f.segments[1:]):
        assert int(d["d_yearmonthnum"][a:b].max()) < int(
            d["d_yearmonthnum"][c:e].min())
    # a city's nation, a nation's region, a phone's country code, a
    # customer's attributes the same on each of its rows
    rows = slice(0, 300)
    for side, key_col in (("c", "lo_custkey"), ("s", "lo_suppkey")):
        city = _strings(f, f"{side}_city", rows)
        nation = _strings(f, f"{side}_nation", rows)
        assert all(c[:9] == n[:9].ljust(9) for c, n in zip(city, nation))
        keys = d[key_col][rows].tolist()
        code = [n for n, _ in NATIONS]
        assert all(ph.startswith(f"{code.index(n) + 10:02d}-") for ph, n in
                   zip(_strings(f, f"{side}_phone", rows), nation))
        names = _strings(f, f"{side}_name", rows)
        assert all(n.endswith(f"#{k:09d}") for n, k in zip(names, keys))
        addr = {}
        for k, a in zip(keys, _strings(f, f"{side}_address", rows)):
            assert addr.setdefault(k, a) == a and 10 <= len(a) <= 40
    brand = _strings(f, "p_brand1", rows)
    cat = _strings(f, "p_category", rows)
    mfgr = _strings(f, "p_mfgr", rows)
    assert all(b[:7] == c and c[:6] == m
               for b, c, m in zip(brand, cat, mfgr))
