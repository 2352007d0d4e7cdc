"""The plain reference: a bound query's answer over a frame, in PyTorch.

A query here is the structured form the traffic files hold (see
``benchmark/README.md``), with its literals filled in: ``where`` (a list of
conditions, all of which hold), ``group_by``, ``select``, ``order_by`` and
``limit``. ``answer`` evaluates it over every row of the frame with plain
tensor operations: masks, a unique over the group keys, scatter sums and
minima. Integer arithmetic is int64 and exact, an average an exact sum over
a count in float64, a distinct count exact, and DISTINCTCOUNTHLL the
estimate of exact registers (``reference/hll.py``).

``precision="float32"`` is the control: the same evaluation with every
value, sum, minimum and average carried in float32, the precision below
the one the configurations state.

``kept_segments`` is the reference's own min/max test: a segment is kept
unless one condition of the ``where`` list lies wholly outside its
column's range there.

Nothing here imports the program under test.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness.frame import Frame
from benchmark.reference import hll

_ARITH = {"mul": torch.mul, "sub": torch.sub, "add": torch.add}


def expr_columns(expr) -> List[str]:
    if isinstance(expr, str):
        return [expr]
    return [c for e in expr[1:] for c in expr_columns(e)]


def condition_columns(cond) -> List[str]:
    if isinstance(cond, dict):
        return [c for sub in cond["or"] for c in condition_columns(sub)]
    return [cond[0]]


def query_columns(q: dict) -> List[str]:
    """Every column the query reads: filters, group keys, aggregates."""
    cols: List[str] = []
    for cond in q.get("where", []):
        cols += condition_columns(cond)
    cols += q.get("group_by", [])
    for item in q["select"]:
        if "col" in item:
            cols.append(item["col"])
        elif "arg" in item:
            cols += expr_columns(item["arg"])
    return list(dict.fromkeys(cols))


# -- filters ------------------------------------------------------------------

def _code_test(universe: List[str], op: str, arg):
    """A string predicate as a test on codes (the universe is sorted)."""
    def at(s):
        i = bisect.bisect_left(universe, s)
        return i if i < len(universe) and universe[i] == s else -1

    if op == "=":
        return "=", at(arg)
    if op == "!=":
        return "!=", at(arg)
    if op == "in":
        return "in", [at(s) for s in arg]
    if op == "not_in":
        return "not_in", [at(s) for s in arg]
    if op == "between":
        return "range", (bisect.bisect_left(universe, arg[0]),
                         bisect.bisect_right(universe, arg[1]) - 1)
    if op == "<":
        return "range", (None, bisect.bisect_left(universe, arg) - 1)
    if op == "<=":
        return "range", (None, bisect.bisect_right(universe, arg) - 1)
    if op == ">":
        return "range", (bisect.bisect_right(universe, arg), None)
    if op == ">=":
        return "range", (bisect.bisect_left(universe, arg), None)
    raise ValueError(f"unknown operator {op!r}")


def _int_test(op: str, arg):
    if op in ("=", "!=", "in", "not_in"):
        return op, arg
    if op == "between":
        return "range", (arg[0], arg[1])
    if op == "<":
        return "range", (None, arg - 1)
    if op == "<=":
        return "range", (None, arg)
    if op == ">":
        return "range", (arg + 1, None)
    if op == ">=":
        return "range", (arg, None)
    raise ValueError(f"unknown operator {op!r}")


def _test(frame: Frame, col: str, op: str, arg):
    c = frame.columns[col]
    return _code_test(c.universe, op, arg) if c.universe is not None \
        else _int_test(op, arg)


def _positive(v: torch.Tensor, kind: str, arg) -> torch.Tensor:
    """The test with a negation folded out (``!=`` -> ``=``)."""
    if kind in ("=", "!="):
        return v == arg
    if kind in ("in", "not_in"):
        return torch.isin(v, torch.tensor(list(arg), dtype=v.dtype,
                                          device=v.device))
    lo, hi = arg
    m = torch.ones_like(v, dtype=torch.bool)
    if lo is not None:
        m &= v >= lo
    if hi is not None:
        m &= v <= hi
    return m


def condition_mask(frame: Frame, cond) -> torch.Tensor:
    if isinstance(cond, dict):
        out = None
        for sub in cond["or"]:
            m = condition_mask(frame, sub)
            out = m if out is None else out | m
        return out
    col, op, arg = cond
    kind, targ = _test(frame, col, op, arg)
    negated = kind in ("!=", "not_in")
    data = frame.data[col]
    if frame.columns[col].multi_value:
        # an entry past a row's count is no value; "!=" and NOT IN hold
        # where no value of the row matches
        codes, counts = data
        entry = (torch.arange(codes.shape[1], device=codes.device)[None, :]
                 < counts[:, None])
        hit = (_positive(codes.long(), kind, targ) & entry).any(dim=1)
    else:
        hit = _positive(data.long(), kind, targ)
    return ~hit if negated else hit


def row_mask(frame: Frame, where: Sequence) -> torch.Tensor:
    m = torch.ones(frame.num_rows, dtype=torch.bool,
                   device=_device(frame))
    for cond in where:
        m &= condition_mask(frame, cond)
    return m


def _device(frame: Frame):
    v = next(iter(frame.data.values()))
    return (v[0] if isinstance(v, tuple) else v).device


# -- aggregation --------------------------------------------------------------

def _values(frame: Frame, expr, mask: torch.Tensor, dtype) -> torch.Tensor:
    if isinstance(expr, str):
        return frame.data[expr][mask].to(dtype)
    fn = _ARITH[expr[0]]
    return fn(_values(frame, expr[1], mask, dtype),
              _values(frame, expr[2], mask, dtype))


def _groups(frame: Frame, cols: List[str], mask: torch.Tensor
            ) -> Tuple[torch.Tensor, List[torch.Tensor], int]:
    """(group index a matched row, each key column's value a group, the
    number of groups)."""
    if not cols:
        n = int(mask.sum())
        return (torch.zeros(n, dtype=torch.long, device=mask.device), [],
                1)
    keys = [frame.data[c][mask].long() for c in cols]
    los = [int(k.min()) if k.numel() else 0 for k in keys]
    spans = [int(k.max()) - lo + 1 if k.numel() else 1
             for k, lo in zip(keys, los)]
    if float(np.prod(np.array(spans, dtype=np.float64))) >= 2.0 ** 62:
        raise ValueError(f"group key space of {cols} past int64")
    code = torch.zeros_like(keys[0])
    for k, lo, span in zip(keys, los, spans):
        code = code * span + (k - lo)
    uniq, inv = torch.unique(code, return_inverse=True)
    digits = []
    rest = uniq
    for lo, span in zip(reversed(los), reversed(spans)):
        digits.append(rest % span + lo)
        rest = rest // span
    return inv, digits[::-1], int(uniq.numel())


def _hll_luts(frame: Frame, col: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(register, rank) per code of a string column's universe."""
    universe = frame.columns[col].universe
    if universe is None:
        raise ValueError(f"DISTINCTCOUNTHLL of {col}: a string column only")
    reg, rank = hll.register_luts(universe)
    dev = _device(frame)
    return torch.from_numpy(reg).to(dev), torch.from_numpy(rank).to(dev)


def _aggregate(frame: Frame, item: dict, mask: torch.Tensor,
               inv: torch.Tensor, ngroups: int, exact: bool) -> List:
    agg = item["agg"]
    dev = mask.device
    fdt = torch.float32
    if agg == "count":
        if exact:
            return torch.bincount(inv, minlength=ngroups).tolist()
        ones = torch.ones(inv.numel(), dtype=fdt, device=dev)
        return torch.zeros(ngroups, dtype=fdt, device=dev) \
            .index_add_(0, inv, ones).tolist()
    if agg in ("distinctcount", "distinctcounthll"):
        col = item["arg"]
        c = frame.columns[col]
        if c.multi_value:
            raise ValueError("distinct counts of a multi-value column")
        v = frame.data[col][mask].long()
        if agg == "distinctcount":
            lo = int(v.min()) if v.numel() else 0
            span = (int(v.max()) - lo + 1) if v.numel() else 1
            pairs = torch.unique(inv * span + (v - lo))
            return torch.bincount(pairs // span, minlength=ngroups).tolist()
        reg, rank = _hll_luts(frame, col)
        regs = torch.zeros(ngroups * (1 << hll.LOG2M), dtype=torch.long,
                           device=dev)
        regs.scatter_reduce_(0, inv * (1 << hll.LOG2M) + reg[v], rank[v],
                             reduce="amax")
        regs = regs.view(ngroups, -1).to(torch.uint8).cpu().numpy()
        return [hll.cardinality(r) for r in regs]
    vals = _values(frame, item["arg"], mask,
                   torch.int64 if exact else fdt)
    if agg in ("sum", "avg"):
        s = torch.zeros(ngroups, dtype=vals.dtype, device=dev) \
            .index_add_(0, inv, vals)
        if agg == "sum":
            return s.tolist()
        if exact:
            cnt = torch.bincount(inv, minlength=ngroups).tolist()
            return [a / b if b else None for a, b in zip(s.tolist(), cnt)]
        cnt = torch.zeros(ngroups, dtype=fdt, device=dev).index_add_(
            0, inv, torch.ones_like(vals))
        return (s / cnt).tolist()
    if agg in ("min", "max"):
        init = torch.zeros(ngroups, dtype=vals.dtype, device=dev)
        init.scatter_reduce_(0, inv, vals,
                             reduce="amin" if agg == "min" else "amax",
                             include_self=False)
        return init.tolist()
    raise ValueError(f"unknown aggregate {agg!r}")


def _cell(frame: Frame, col: str, v: int):
    u = frame.columns[col].universe
    return u[v] if u is not None else int(v)


def sort_key(row: Sequence) -> Tuple:
    """A total order over result rows of strings and numbers."""
    return tuple((0, c, 0.0) if isinstance(c, str)
                 else (1, "", float("nan") if c is None else float(c))
                 for c in row)


def order_rows(q: dict, rows: List[List]) -> List[List]:
    """Rows in the query's ORDER BY (ties broken by the whole row), cut to
    its LIMIT; with no ORDER BY, in ``sort_key`` order."""
    rows = sorted(rows, key=sort_key)
    for idx, direction in reversed(q.get("order_by", [])):
        rows.sort(key=lambda r, i=idx: sort_key([r[i]]),
                  reverse=direction == "desc")
    limit = q.get("limit")
    return rows[:limit] if limit is not None else rows


def answer(frame: Frame, q: dict, precision: str = "exact") -> List[List]:
    """The query's result rows."""
    exact = precision == "exact"
    mask = row_mask(frame, q.get("where", []))
    group_by = q.get("group_by", [])
    inv, keys, ngroups = _groups(frame, group_by, mask)
    if group_by and not inv.numel():
        return []
    cols: Dict[int, List] = {}
    for i, item in enumerate(q["select"]):
        if "col" in item:
            k = keys[group_by.index(item["col"])].tolist()
            cols[i] = [_cell(frame, item["col"], v) for v in k]
        else:
            cols[i] = _aggregate(frame, item, mask, inv, ngroups, exact)
    rows = [[cols[i][g] for i in range(len(q["select"]))]
            for g in range(ngroups)]
    return order_rows(q, rows)


# -- pruning ----------------------------------------------------------------

def segment_ranges(frame: Frame) -> List[Dict[str, Tuple[int, int]]]:
    """Per segment, each column's (min, max): codes for a string column,
    over the values present (a multi-value row's entries)."""
    out = []
    for a, b in frame.segments:
        st = {}
        for col, c in frame.columns.items():
            d = frame.data[col]
            if c.multi_value:
                codes, counts = d
                codes, counts = codes[a:b], counts[a:b]
                entry = (torch.arange(codes.shape[1],
                                      device=codes.device)[None, :]
                         < counts[:, None])
                v = codes[entry]
            else:
                v = d[a:b]
            st[col] = (int(v.min()), int(v.max())) if v.numel() else None
        out.append(st)
    return out


def _may_match(frame: Frame, ranges: Dict, cond) -> bool:
    if isinstance(cond, dict):
        return True
    col, op, arg = cond
    r = ranges.get(col)
    if r is None:
        return False
    lo, hi = r
    kind, targ = _test(frame, col, op, arg)
    if kind == "=":
        return lo <= targ <= hi
    if kind == "in":
        return any(lo <= t <= hi for t in targ)
    if kind == "range":
        a, b = targ
        return (a is None or a <= hi) and (b is None or lo <= b)
    return True   # != and NOT IN never prune


def kept_segments(frame: Frame, q: dict,
                  ranges: Optional[List[Dict]] = None) -> List[int]:
    ranges = ranges if ranges is not None else segment_ranges(frame)
    return [i for i, r in enumerate(ranges)
            if all(_may_match(frame, r, c) for c in q.get("where", []))]
