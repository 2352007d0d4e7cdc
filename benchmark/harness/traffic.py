"""The one traffic generator: a traffic file's templates -> SQL variants.

A traffic file (``traffic/<name>.json``) names its clients, the number of
literal variants a template gets, the limits of the comparison that decides
``correct``, and its templates. A template is a query in structured form
(``select``, ``where``, ``group_by``, ``order_by``, ``limit``) whose
literals are ``"$name"`` references to its ``params``. Each param draws from
a domain:

- ``{"int": [lo, hi]}``: an integer in ``lo..hi``;
- ``{"choice": [v, ...]}``: one of the values;
- ``{"add": ["p", k]}``: param ``p`` plus ``k``;
- ``{"item": ["p", i]}``: element ``i`` of param ``p``, whose values are
  lists (a nation with its region);
- ``{"format": "..."}``: ``str.format`` over the params drawn before it.

The first two may carry ``"not": ["p", ...]``: the value differs from
those params' in the same variant. Without ``not``, a param's values over
a template's variants cover its domain evenly (each value ``variants /
size`` times, give or take one). The variants are drawn from a stream of
their own, the same for every seed: every seed asks for the same queries,
and the seed orders them and draws the table.

Each client deals its queries from a deck of every template's every
variant, shuffled from its own stream of the seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_AGG_SQL = {"count": "COUNT", "sum": "SUM", "min": "MIN", "max": "MAX",
            "avg": "AVG", "distinctcount": "DISTINCTCOUNT",
            "distinctcounthll": "DISTINCTCOUNTHLL"}
_ARITH_SQL = {"mul": "*", "sub": "-", "add": "+"}
_OP_SQL = {"=": "=", "!=": "!=", "<": "<", "<=": "<=", ">": ">", ">=": ">=",
           "in": "IN", "not_in": "NOT IN"}


# the stream the variants are drawn from, apart from every seed's
VARIANT_STREAM = 1


@dataclass
class Variant:
    template: str
    index: int
    sql: str
    query: dict   # the structured query, literals filled in


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy stream of ``seed`` (any whole number) and ``stream``."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


# -- SQL ----------------------------------------------------------------------

def literal(v) -> str:
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return str(int(v))


def expr_sql(expr) -> str:
    if isinstance(expr, str):
        return expr
    return f"{expr_sql(expr[1])} {_ARITH_SQL[expr[0]]} {expr_sql(expr[2])}"


def item_sql(item: dict) -> str:
    if "col" in item:
        return item["col"]
    if item["agg"] == "count":
        return "COUNT(*)"
    return f"{_AGG_SQL[item['agg']]}({expr_sql(item['arg'])})"


def condition_sql(cond) -> str:
    if isinstance(cond, dict):
        return "(" + " OR ".join(condition_sql(c) for c in cond["or"]) + ")"
    col, op, arg = cond
    if op == "between":
        return f"{col} BETWEEN {literal(arg[0])} AND {literal(arg[1])}"
    if op in ("in", "not_in"):
        return (f"{col} {_OP_SQL[op]} ("
                + ", ".join(literal(a) for a in arg) + ")")
    return f"{col} {_OP_SQL[op]} {literal(arg)}"


def render(q: dict, table: str) -> str:
    sql = "SELECT " + ", ".join(item_sql(i) for i in q["select"])
    sql += f" FROM {table}"
    if q.get("where"):
        sql += " WHERE " + " AND ".join(condition_sql(c) for c in q["where"])
    if q.get("group_by"):
        sql += " GROUP BY " + ", ".join(q["group_by"])
    if q.get("order_by"):
        sql += " ORDER BY " + ", ".join(
            f"{item_sql(q['select'][i])} {d.upper()}"
            for i, d in q["order_by"])
    if q.get("limit") is not None:
        sql += f" LIMIT {int(q['limit'])}"
    return sql


# -- params -------------------------------------------------------------------

def _domain(spec: dict) -> List:
    if "int" in spec:
        lo, hi = spec["int"]
        return list(range(int(lo), int(hi) + 1))
    if "choice" in spec:
        return list(spec["choice"])
    raise ValueError(f"param {spec} has no finite domain")


def _fill(obj, values: Dict):
    if isinstance(obj, str) and obj.startswith("$"):
        return values[obj[1:]]
    if isinstance(obj, list):
        return [_fill(o, values) for o in obj]
    if isinstance(obj, dict):
        return {k: _fill(v, values) for k, v in obj.items()}
    return obj


def draw_variants(traffic: dict, table: str) -> Dict[str, List[Variant]]:
    """Each template's variants over ``table``; the same for every seed."""
    n = int(traffic["variants"])
    out: Dict[str, List[Variant]] = {}
    for ti, tpl in enumerate(traffic["templates"]):
        rng = rng_for(VARIANT_STREAM, ti)
        params = tpl.get("params", {})
        rows: List[Dict] = [{} for _ in range(n)]
        for name, spec in params.items():
            if "add" in spec:
                base, k = spec["add"]
                for r in rows:
                    r[name] = r[base] + k
                continue
            if "item" in spec:
                base, i = spec["item"]
                for r in rows:
                    r[name] = r[base][int(i)]
                continue
            if "format" in spec:
                for r in rows:
                    r[name] = spec["format"].format(**r)
                continue
            dom = _domain(spec)
            if spec.get("not"):
                for r in rows:
                    free = [v for v in dom
                            if all(v != r[o] for o in spec["not"])]
                    r[name] = free[int(rng.integers(len(free)))]
                continue
            order = rng.permutation(len(dom))
            picks = [dom[int(order[i % len(dom)])] for i in range(n)]
            rng.shuffle(picks)
            for r, v in zip(rows, picks):
                r[name] = v
        body = {k: tpl[k] for k in ("select", "where", "group_by",
                                    "order_by", "limit") if k in tpl}
        out[tpl["id"]] = []
        for i, r in enumerate(rows):
            q = _fill(body, r)
            out[tpl["id"]].append(Variant(tpl["id"], i,
                                          render(q, table), q))
    return out


class ClientStream:
    """One client's queries: (template id, variant index), dealt from a
    deck of every template's every variant, shuffled by the client's own
    stream of the seed and dealt again when it runs out. Each template is
    equally likely, and every seed asks for the same mix of queries, in
    another order."""

    def __init__(self, traffic: dict, seed: int, client: int):
        n = int(traffic["variants"])
        self._deck = [(t["id"], i) for t in traffic["templates"]
                      for i in range(n)]
        self._rng = rng_for(seed, 2, client)
        self._order: List[int] = []

    def next(self) -> Tuple[str, int]:
        if not self._order:
            self._order = self._rng.permutation(len(self._deck)).tolist()
        return self._deck[self._order.pop()]
