"""SSB baseline: the 13 flights vectorised by hand over numpy alone.

Counterpart of ``pinot_tpu/tools/ssb_baseline.py``, with its semantics and
its rows, but no pandas (the machine with the card has none): each flight
is boolean masks over dictionary-encoded columns, a composite group key,
and exact int64 sums folded with ``np.add.reduceat`` over the sorted keys.
It is an implementation independent of the engine: the same work a CPU
columnar engine does, and the oracle the on-disk SSB checks against.

``make_frame(cols)`` takes JAX-style columns (strings as string arrays) or
the port's generator frames (strings as codes into ``ssb.UNIVERSE``);
``run_query(frame, qid)`` returns rows shaped like the engine's result
table (group keys, then the sum as a float), ordered as the flight's
ORDER BY orders them; ``rows_match`` compares two row lists order-blind.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.tools.ssb import UNIVERSE

# a column of the frame: (sorted dictionary, int codes into it)
Column = Tuple[np.ndarray, np.ndarray]


def make_frame(cols: Dict[str, np.ndarray]) -> Dict[str, Column]:
    """Columns -> {name: (sorted dictionary, codes)}: strings dictionary-
    encoded (the port's coded frames keep their codes), ints as they are
    with a dictionary of none."""
    out: Dict[str, Column] = {}
    for name, v in cols.items():
        v = np.asarray(v)
        if v.dtype.kind in "UO":
            dictionary, codes = np.unique(v, return_inverse=True)
            out[name] = (dictionary, codes.reshape(-1).astype(np.int32))
        elif name in UNIVERSE:
            out[name] = (UNIVERSE[name], v.astype(np.int32))
        else:
            out[name] = (None, v.astype(np.int64))
    return out


def _ints(frame: Dict[str, Column], name: str) -> np.ndarray:
    return frame[name][1]


def _eq(frame: Dict[str, Column], name: str, value: str) -> np.ndarray:
    dictionary, codes = frame[name]
    hit = np.nonzero(dictionary == value)[0]
    if not len(hit):
        return np.zeros(len(codes), dtype=bool)
    return codes == hit[0]


def _isin(frame: Dict[str, Column], name: str,
          values: Sequence[str]) -> np.ndarray:
    dictionary, codes = frame[name]
    return np.isin(dictionary, list(values))[codes]


def _between(frame: Dict[str, Column], name: str, lo: str,
             hi: str) -> np.ndarray:
    dictionary, codes = frame[name]
    return ((dictionary >= lo) & (dictionary <= hi))[codes]


def _key_value(frame: Dict[str, Column], name: str, code: int):
    dictionary = frame[name][0]
    return int(code) if dictionary is None else str(dictionary[code])


def _grouped(frame: Dict[str, Column], mask: np.ndarray, keys: List[str],
             values: np.ndarray, order_desc_value: bool) -> List[Tuple]:
    """Filtered group-by sum -> rows [*keys, sum]: ordered by the keys, or
    by (the last key ascending, the sum descending) for the Q3 flights,
    ties in key order."""
    idx = np.nonzero(mask)[0]
    if not len(idx):
        return []
    codes = [frame[k][1][idx].astype(np.int64) for k in keys]
    # one composite key: dictionary codes (or ints) in key order, mixed
    # radix over each column's span
    comp = np.zeros(len(idx), dtype=np.int64)
    lows = []
    for c in codes:
        lo, span = int(c.min()), int(c.max() - c.min()) + 1
        comp = comp * span + (c - lo)
        lows.append((lo, span))
    order = np.argsort(comp, kind="stable")
    sc = comp[order]
    starts = np.nonzero(np.r_[True, sc[1:] != sc[:-1]])[0]
    sums = np.add.reduceat(values[idx][order].astype(np.int64), starts)
    ukeys = sc[starts]
    cols = []
    for lo, span in reversed(lows):
        cols.append(ukeys % span + lo)
        ukeys = ukeys // span
    cols.reverse()
    if order_desc_value:
        last = cols[-1]
        ix = np.lexsort((-sums, last))
        cols = [c[ix] for c in cols]
        sums = sums[ix]
    return [tuple(_key_value(frame, k, c[i]) for k, c in zip(keys, cols))
            + (float(sums[i]),) for i in range(len(sums))]


def run_query(frame: Dict[str, Column], qid: str) -> List[Tuple]:
    """One SSB flight over a ``make_frame`` frame."""
    year = _ints(frame, "d_year")
    disc = _ints(frame, "lo_discount")
    qty = _ints(frame, "lo_quantity")
    if qid.startswith("Q1"):
        if qid == "Q1.1":
            m = (year == 1993) & (disc >= 1) & (disc <= 3) & (qty < 25)
        elif qid == "Q1.2":
            m = ((_ints(frame, "d_yearmonthnum") == 199401) & (disc >= 4)
                 & (disc <= 6) & (qty >= 26) & (qty <= 35))
        elif qid == "Q1.3":
            m = ((_ints(frame, "d_weeknuminyear") == 6) & (year == 1994)
                 & (disc >= 5) & (disc <= 7) & (qty >= 26) & (qty <= 35))
        else:
            raise ValueError(f"unknown SSB query {qid!r}")
        v = (_ints(frame, "lo_extendedprice")[m] * disc[m]).sum()
        return [(float(v),)]

    rev = _ints(frame, "lo_revenue")
    if qid == "Q2.1":
        m = _eq(frame, "p_category", "MFGR#12") \
            & _eq(frame, "s_region", "AMERICA")
        return _grouped(frame, m, ["d_year", "p_brand1"], rev, False)
    if qid == "Q2.2":
        m = _between(frame, "p_brand1", "MFGR#2221", "MFGR#2228") \
            & _eq(frame, "s_region", "ASIA")
        return _grouped(frame, m, ["d_year", "p_brand1"], rev, False)
    if qid == "Q2.3":
        m = _eq(frame, "p_brand1", "MFGR#2239") \
            & _eq(frame, "s_region", "EUROPE")
        return _grouped(frame, m, ["d_year", "p_brand1"], rev, False)

    years_92_97 = (year >= 1992) & (year <= 1997)
    if qid == "Q3.1":
        m = _eq(frame, "c_region", "ASIA") & _eq(frame, "s_region", "ASIA") \
            & years_92_97
        return _grouped(frame, m, ["c_nation", "s_nation", "d_year"], rev,
                        True)
    if qid == "Q3.2":
        m = _eq(frame, "c_nation", "UNITED STATES") \
            & _eq(frame, "s_nation", "UNITED STATES") & years_92_97
        return _grouped(frame, m, ["c_city", "s_city", "d_year"], rev, True)
    if qid in ("Q3.3", "Q3.4"):
        cities = ["UNITED KI1", "UNITED KI5"]
        m = _isin(frame, "c_city", cities) & _isin(frame, "s_city", cities)
        if qid == "Q3.3":
            m &= years_92_97
        else:
            m &= _ints(frame, "d_yearmonthnum") == 199712
        return _grouped(frame, m, ["c_city", "s_city", "d_year"], rev, True)

    profit = rev - _ints(frame, "lo_supplycost")
    america = _eq(frame, "c_region", "AMERICA") \
        & _eq(frame, "s_region", "AMERICA")
    mfgr12 = _isin(frame, "p_mfgr", ["MFGR#1", "MFGR#2"])
    late = (year == 1997) | (year == 1998)
    if qid == "Q4.1":
        return _grouped(frame, america & mfgr12, ["d_year", "c_nation"],
                        profit, False)
    if qid == "Q4.2":
        return _grouped(frame, america & mfgr12 & late,
                        ["d_year", "s_nation", "p_category"], profit, False)
    if qid == "Q4.3":
        m = _eq(frame, "s_nation", "UNITED STATES") & late \
            & _eq(frame, "p_category", "MFGR#14")
        return _grouped(frame, m, ["d_year", "s_city", "p_brand1"], profit,
                        False)
    raise ValueError(f"unknown SSB query {qid!r}")


def rows_match(engine_rows, baseline_rows, rel: float = 1e-9) -> bool:
    """Order-insensitive parity (ORDER BY ties can legally differ)."""
    if len(engine_rows) != len(baseline_rows):
        return False

    def key(row):
        return tuple(str(x) for x in row[:-1])

    a = {key(r): r[-1] for r in engine_rows}
    b = {key(r): r[-1] for r in baseline_rows}
    if set(a) != set(b):
        return False
    for k, v in a.items():
        w = b[k]
        if abs(float(v) - float(w)) > rel * max(1.0, abs(float(w))):
            return False
    return True
