"""The comparison that decides ``correct``.

A query's rows are held to the reference's rows of the same SQL. The rows
must be the same set (for an ORDER BY, also in the same order of its sort
keys), every string and every integer-valued cell equal exactly (a count,
an integer sum, a minimum or maximum, a distinct count, an HLL estimate),
and a cell the reference gives as a fraction (an average) is read as its
relative error.

Per run three numbers are compared, each with the limit the traffic file
sets (``limits``): ``failed_queries`` (raised or refused), ``wrong_queries``
(rows not equal) and, where the traffic has a fractional aggregate,
``max_rel_err`` (the widest relative error of such a cell).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from benchmark.reference.evaluate import sort_key


def _order_keys(q: dict, rows: Sequence[Sequence]) -> List[Tuple]:
    idx = [i for i, _ in q.get("order_by", [])]
    return [sort_key([r[i] for i in idx]) for r in rows]


def compare(q: dict, got: Sequence[Sequence], want: Sequence[Sequence]
            ) -> Tuple[bool, float]:
    """(rows equal, widest relative error of a fractional cell)."""
    if len(got) != len(want):
        return False, 0.0
    if q.get("order_by") and _order_keys(q, got) != _order_keys(q, want):
        return False, 0.0
    g = sorted((list(r) for r in got), key=sort_key)
    w = sorted((list(r) for r in want), key=sort_key)
    worst = 0.0
    for rg, rw in zip(g, w):
        if len(rg) != len(rw):
            return False, worst
        for a, b in zip(rg, rw):
            if isinstance(b, str) or isinstance(a, str):
                if a != b:
                    return False, worst
            elif isinstance(b, float) and not b.is_integer():
                if a is None:
                    return False, worst
                worst = max(worst, abs(float(a) - b) / abs(b))
            elif a is None or b is None:
                if a is not b:
                    return False, worst
            elif a != b:
                return False, worst
    return True, worst


def fractional(q: dict) -> bool:
    return any(i.get("agg") == "avg" for i in q["select"])


def verdict(limits: Dict[str, float], failed: int, wrong: int,
            max_rel_err: float, any_fractional: bool
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}}) of a run."""
    checks = {"failed_queries": {"value": failed,
                                 "limit": limits["failed_queries"]},
              "wrong_queries": {"value": wrong,
                                "limit": limits["wrong_queries"]}}
    if "max_rel_err" in limits and any_fractional:
        checks["max_rel_err"] = {"value": max_rel_err,
                                 "limit": limits["max_rel_err"]}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
