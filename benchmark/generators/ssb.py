"""The Star Schema Benchmark's ``lineorder`` flattened at full width.

SSB rev. 3 (O'Neil, O'Neil, Chen, 2009): ``lineorder`` joined with its
four dimensions on their keys, every attribute of each kept once: the 17
columns of ``lineorder``, 7 of ``customer``, 6 of ``supplier``, 8 of
``part`` and 16 of ``date`` (``c_custkey``, ``s_suppkey``, ``p_partkey``
and ``d_datekey`` are ``lo_custkey``, ``lo_suppkey``, ``lo_partkey`` and
``lo_orderdate``), 54 columns.

The values follow ssb-dbgen, which keeps TPC-H's dbgen formulas:

- orders: an order date uniform over 1992-01-01 .. 1998-08-02 (the date
  range less 151 days), a customer uniform over the keys not divisible by
  3, 1-7 lines, a priority of five; TPC-H's sparse order keys;
- lines: part and supplier uniform, quantity 1-50, discount 0-10, tax 0-8,
  commit date 30-90 days after the order, a ship mode of seven; the
  part's retail price ``90000 + (p / 10) % 20001 + 100 (p % 1000)``,
  extended price = quantity x price, revenue = extended price x (100 -
  discount) / 100, supply cost = 6 x price / 10, the order's total price
  the sum over its lines of revenue x (100 + tax) / 100 (integer division
  throughout);
- customer and supplier: ``Customer#`` / ``Supplier#`` and the key in 9
  digits, an address of 10-40 characters of TPC-H's alphabet, a nation
  uniform (its region TPC-H's), a city the nation's first 9 letters and a
  digit, a phone ``<nation + 10>-ddd-ddd-dddd``; the customer's market
  segment one of five;
- part: a name of two distinct colour words, a manufacturer ``MFGR#m``, a
  category ``MFGR#mc``, a brand ``MFGR#mcbb`` (m, c in 1-5, bb in 01-40), a
  colour, a type of TPC-H's 150, a size 1-50, a container of its 40;
- date: the calendar's own attributes of the order date.

Where the specification gives only a column's type and size, the config's
``assumed`` says what was taken. Segments hold contiguous months of the
order date, the months split evenly; rows keep their order of generation
within a segment.

Every draw is made on the device from the seed. String columns are codes
into the sorted universe of their values.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness.frame import Column, Frame, device_generator

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# TPC-H's nation table: (name, region index), by nation key
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder puff "
    "purple red rose rosy royal saddle salmon sandy seashell sienna sky "
    "slate smoke snow spring steel tan thistle tomato turquoise violet "
    "wheat white yellow").split()
TYPES = [f"{a} {b} {c}"
         for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
ALPHABET = np.frombuffer(
    b"0123456789abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ,",
    dtype=np.uint8)
FIRST_DAY = dt.date(1992, 1, 1)
CALENDAR_DAYS = 2557            # 1992-01-01 .. 1998-12-31
ORDER_DAYS = CALENDAR_DAYS - 151
SEASONS = {1: "Winter", 2: "Winter", 3: "Spring", 4: "Spring", 5: "Summer",
           6: "Summer", 7: "Summer", 8: "Summer", 9: "Fall", 10: "Fall",
           11: "Christmas", 12: "Christmas"}
HOLIDAYS = {(1, 1), (2, 20), (4, 20), (5, 14), (7, 4), (9, 1), (11, 24),
            (12, 24), (12, 25), (12, 31)}

INT_DIMENSIONS = [
    "lo_orderkey", "lo_linenumber", "lo_custkey", "lo_partkey", "lo_suppkey",
    "lo_orderdate", "lo_quantity", "lo_discount", "lo_tax", "lo_commitdate",
    "p_size", "d_year", "d_yearmonthnum", "d_daynuminweek",
    "d_daynuminmonth", "d_daynuminyear", "d_monthnuminyear",
    "d_weeknuminyear", "d_lastdayinweekfl", "d_lastdayinmonthfl",
    "d_holidayfl", "d_weekdayfl"]
INT_METRICS = ["lo_extendedprice", "lo_ordtotalprice", "lo_revenue",
               "lo_supplycost"]


def _encode(values: List[str], device) -> Tuple[List[str], torch.Tensor]:
    """(the sorted universe of ``values``, each value's code in it)."""
    uniq, inv = np.unique(np.asarray(values), return_inverse=True)
    return uniq.tolist(), torch.from_numpy(
        inv.astype(np.int32).reshape(-1)).to(device)


def _calendar(device) -> Dict[str, object]:
    """Each date attribute by day since 1992-01-01: an int tensor, or
    (universe, codes) for a string attribute."""
    days = [FIRST_DAY + dt.timedelta(i) for i in range(CALENDAR_DAYS)]
    ints = {
        "datekey": [d.year * 10000 + d.month * 100 + d.day for d in days],
        "d_year": [d.year for d in days],
        "d_yearmonthnum": [d.year * 100 + d.month for d in days],
        "d_daynuminweek": [d.isoweekday() % 7 + 1 for d in days],
        "d_daynuminmonth": [d.day for d in days],
        "d_daynuminyear": [d.timetuple().tm_yday for d in days],
        "d_monthnuminyear": [d.month for d in days],
        "d_weeknuminyear": [(d.timetuple().tm_yday - 1) // 7 + 1
                            for d in days],
        "d_lastdayinweekfl": [int(d.isoweekday() == 6) for d in days],
        "d_lastdayinmonthfl": [int((d + dt.timedelta(1)).day == 1)
                               for d in days],
        "d_holidayfl": [int((d.month, d.day) in HOLIDAYS) for d in days],
        "d_weekdayfl": [int(d.isoweekday() <= 5) for d in days],
        "month": [(d.year - FIRST_DAY.year) * 12 + d.month - 1 for d in days],
    }
    strings = {
        "d_date": [f"{d:%B} {d.day}, {d.year}" for d in days],
        "d_dayofweek": [f"{d:%A}" for d in days],
        "d_month": [f"{d:%B}" for d in days],
        "d_yearmonth": [f"{d:%b}{d.year}" for d in days],
        "d_sellingseason": [SEASONS[d.month] for d in days],
    }
    out: Dict[str, object] = {
        k: torch.tensor(v, dtype=torch.int32, device=device)
        for k, v in ints.items()}
    out.update({k: _encode(v, device) for k, v in strings.items()})
    return out


def _addresses(n: int, gen, device) -> List[str]:
    """TPC-H's v-strings of average length 25: 10-40 characters."""
    lens = torch.randint(10, 41, (n,), generator=gen, device=device).cpu()
    chars = torch.randint(0, len(ALPHABET), (n, 40), generator=gen,
                          device=device, dtype=torch.int64).cpu().numpy()
    text = ALPHABET[chars]
    return [row[:k].tobytes().decode() for row, k in
            zip(text, lens.tolist())]


def _phones(nation: torch.Tensor, gen, device) -> List[str]:
    n = nation.numel()
    a = torch.randint(100, 1000, (n,), generator=gen, device=device)
    b = torch.randint(100, 1000, (n,), generator=gen, device=device)
    c = torch.randint(1000, 10000, (n,), generator=gen, device=device)
    return [f"{k + 10:02d}-{x:03d}-{y:03d}-{z:04d}" for k, x, y, z in
            zip(nation.tolist(), a.tolist(), b.tolist(), c.tolist())]


def _place(prefix: str, count: int, gen, device) -> Dict[str, object]:
    """A customer's or supplier's attributes by key (row 0 unused): an int
    tensor, or (universe, codes) for a string attribute."""
    nation = torch.randint(0, 25, (count,), generator=gen, device=device)
    digit = torch.randint(0, 10, (count,), generator=gen, device=device)
    nations = [n for n, _ in NATIONS]
    region_of = torch.tensor([r for _, r in NATIONS], device=device)
    out = {}
    for name, values, codes in (
            ("region", REGIONS, region_of[nation]),
            ("nation", nations, nation),
            ("city", [f"{n[:9]:<9}{d}" for n in nations for d in range(10)],
             nation * 10 + digit)):
        universe, code = _encode(values, device)
        out[f"{prefix}_{name}"] = (universe, code[codes])
    word = "Customer" if prefix == "c" else "Supplier"
    out[f"{prefix}_name"] = _encode(
        [f"{word}#{k:09d}" for k in range(1, count + 1)], device)
    out[f"{prefix}_address"] = _encode(_addresses(count, gen, device),
                                       device)
    out[f"{prefix}_phone"] = _encode(_phones(nation, gen, device), device)
    if prefix == "c":
        universe, code = _encode(SEGMENTS, device)
        pick = torch.randint(0, len(SEGMENTS), (count,), generator=gen,
                             device=device)
        out["c_mktsegment"] = (universe, code[pick])
    return out


def _part(count: int, gen, device) -> Dict[str, object]:
    def pick(values: List[str], idx: torch.Tensor):
        universe, code = _encode(values, device)
        return universe, code[idx]

    def uniform(lo: int, hi: int) -> torch.Tensor:   # inclusive
        return torch.randint(lo, hi + 1, (count,), generator=gen,
                             device=device)

    ncol = len(COLORS)
    first = uniform(0, ncol - 1)
    second = (first + uniform(1, ncol - 1)) % ncol
    # manufacturer m, category (m, c), brand (m, c, b), counted from 0
    m, c, b = uniform(0, 4), uniform(0, 4), uniform(0, 39)
    return {
        "p_name": pick([f"{x} {y}" for x in COLORS for y in COLORS],
                       first * ncol + second),
        "p_mfgr": pick([f"MFGR#{i}" for i in range(1, 6)], m),
        "p_category": pick([f"MFGR#{i}{j}" for i in range(1, 6)
                            for j in range(1, 6)], m * 5 + c),
        "p_brand1": pick([f"MFGR#{i}{j}{k:02d}" for i in range(1, 6)
                          for j in range(1, 6) for k in range(1, 41)],
                         (m * 5 + c) * 40 + b),
        "p_color": pick(COLORS, uniform(0, ncol - 1)),
        "p_type": pick(TYPES, uniform(0, len(TYPES) - 1)),
        "p_size": uniform(1, 50).to(torch.int32),
        "p_container": pick(CONTAINERS, uniform(0, len(CONTAINERS) - 1)),
    }


def columns(universes: Dict[str, List[str]]) -> Dict[str, Column]:
    out = {c: Column("INT", "DIMENSION") for c in INT_DIMENSIONS}
    out.update({c: Column("INT", "METRIC") for c in INT_METRICS})
    out.update({c: Column("STRING", "DIMENSION", universe=u)
                for c, u in universes.items()})
    return out


def generate(config: dict, seed: int, device) -> Frame:
    """The flat table of ``config["orders"]`` orders over its customers,
    suppliers and parts, in ``config["segments"]`` segments of contiguous
    months, from ``seed``."""
    norders = int(config["orders"])
    ncust, nsupp = int(config["customers"]), int(config["suppliers"])
    nparts, nseg = int(config["parts"]), int(config["segments"])
    gen = device_generator(seed, device)

    def uniform(lo: int, hi: int, n: int) -> torch.Tensor:   # inclusive
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=device)

    # orders
    odate = uniform(0, ORDER_DAYS - 1, norders)
    live = uniform(0, ncust - ncust // 3 - 1, norders)
    ocust = live + live // 2 + 1          # the keys not divisible by 3
    oprio = uniform(0, len(PRIORITIES) - 1, norders)
    nlines = uniform(1, 7, norders)
    i = torch.arange(1, norders + 1, device=device)
    okey = ((i >> 3) << 5) | (i & 7)      # TPC-H's sparse keys
    order = torch.repeat_interleave(
        torch.arange(norders, device=device), nlines)
    rows = order.numel()
    first_line = torch.cumsum(nlines, 0) - nlines

    # lines
    part = uniform(1, nparts, rows)
    supp = uniform(1, nsupp, rows)
    quantity = uniform(1, 50, rows)
    discount = uniform(0, 10, rows)
    tax = uniform(0, 8, rows)
    commit = odate[order] + uniform(30, 90, rows)
    shipmode = uniform(0, len(SHIPMODES) - 1, rows)
    price = 90000 + (part // 10) % 20001 + 100 * (part % 1000)
    extended = price * quantity
    revenue = extended * (100 - discount) // 100
    total = torch.zeros(norders, dtype=torch.int64, device=device).index_add_(
        0, order, revenue * (100 + tax) // 100)
    day = odate[order]

    cal = _calendar(device)
    data: Dict[str, torch.Tensor] = {
        "lo_orderkey": okey[order],
        "lo_linenumber": torch.arange(rows, device=device)
        - first_line[order] + 1,
        "lo_custkey": ocust[order],
        "lo_partkey": part,
        "lo_suppkey": supp,
        "lo_orderdate": cal["datekey"][day],
        "lo_quantity": quantity,
        "lo_extendedprice": extended,
        "lo_ordtotalprice": total[order],
        "lo_discount": discount,
        "lo_revenue": revenue,
        "lo_supplycost": 6 * price // 10,
        "lo_tax": tax,
        "lo_commitdate": cal["datekey"][commit],
    }
    universes: Dict[str, List[str]] = {}

    def put(name: str, enc, idx: torch.Tensor) -> None:
        universe, code = enc
        universes[name] = universe
        data[name] = code[idx]

    for name, values, idx in (
            ("lo_orderpriority", PRIORITIES, oprio[order]),
            ("lo_shippriority", ["0"], torch.zeros_like(order)),
            ("lo_shipmode", SHIPMODES, shipmode)):
        put(name, _encode(values, device), idx)
    for prefix, count, key in (("c", ncust, data["lo_custkey"]),
                               ("s", nsupp, supp)):
        for name, enc in _place(prefix, count, gen, device).items():
            put(name, enc, key - 1)
    for name, attr in _part(nparts, gen, device).items():
        if isinstance(attr, tuple):
            put(name, attr, part - 1)
        else:
            data[name] = attr[part - 1]
    for name, attr in cal.items():
        if not name.startswith("d_"):
            continue
        if isinstance(attr, tuple):
            put(name, attr, day)
        else:
            data[name] = attr[day]

    # segments: contiguous months of the order date, rows in their order
    months = int(cal["month"][ORDER_DAYS - 1]) + 1
    seg = cal["month"][day].long() * nseg // months
    perm = torch.sort(seg, stable=True).indices
    data = {k: v[perm].to(torch.int32) for k, v in data.items()}
    ends = torch.cumsum(torch.bincount(seg, minlength=nseg), 0).tolist()
    segments = [(a, b) for a, b in zip([0] + ends[:-1], ends) if b > a]
    return Frame(config["table"], columns(universes), data, segments)
