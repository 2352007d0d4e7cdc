"""Gapfill: fill missing time buckets of a grouped result at the broker.

Counterpart of ``pinot_tpu/broker/gapfill.py`` (the reference's
GapfillProcessor): the broker strips the ``gapfill(...)`` wrapper before
the scatter (servers run the plain time-bucket group-by), then the reduce
inserts a row for every absent bucket of every dimension combination.

Surface (simplified from the reference's 7-argument TIMESERIESON form, which
leans on Java DateTimeFormat specs):

    SELECT gapfill(bucketExpr, start, end, step[, 'FILL_PREVIOUS_VALUE']),
           dims..., agg(...) FROM t
    GROUP BY gapfill(...), dims...

- buckets are the numeric range ``[start, end)`` stepping ``step`` (the
  caller buckets time however it likes);
- FILL_DEFAULT_VALUE (default): absent buckets carry 0 for aggregation
  columns; FILL_PREVIOUS_VALUE: they carry the previous present bucket's
  values (the reference's carry-forward fill).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from pinot_tpu_torch.engine.errors import QueryError
from pinot_tpu_torch.engine.results import ResultTable, _Reversible
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import Expr, Function, Literal, OrderByExpr

_MODES = ("FILL_DEFAULT_VALUE", "FILL_PREVIOUS_VALUE")


@dataclass
class GapfillSpec:
    select_pos: int          # gapfill expression's position in the select list
    start: int
    end: int
    step: int
    fill_mode: str
    limit: int               # the QUERY's limit/offset, applied AFTER filling
    offset: int


# reduce-side row cap while gapfill is active: the reducer must hand gapfill
# every live group in the window (a reduce-side ORDER BY/LIMIT trim would
# make trimmed-but-present buckets indistinguishable from absent ones and
# fabricate zero rows over real data); the broker's num_groups_limit still
# bounds memory upstream
_REDUCE_LIMIT = 10_000_000


def _parse(fn: Function) -> Tuple[Expr, int, int, int, str]:
    if len(fn.args) not in (4, 5):
        raise QueryError(
            "gapfill(bucketExpr, start, end, step[, 'FILL_...']) expected")
    nums = []
    for a in fn.args[1:4]:
        if not (isinstance(a, Literal) and isinstance(a.value, (int, float))
                and not isinstance(a.value, bool)):
            raise QueryError("gapfill start/end/step must be numeric literals")
        nums.append(int(a.value))
    start, end, step = nums
    if step <= 0 or end < start:
        raise QueryError("gapfill needs step > 0 and end >= start")
    mode = "FILL_DEFAULT_VALUE"
    if len(fn.args) == 5:
        m = fn.args[4]
        if not (isinstance(m, Literal) and isinstance(m.value, str)) \
                or m.value.upper() not in _MODES:
            raise QueryError(f"gapfill fill mode must be one of {_MODES}")
        mode = m.value.upper()
    return fn.args[0], start, end, step, mode


def extract_gapfill(ctx: QueryContext
                    ) -> Tuple[QueryContext, Optional[GapfillSpec]]:
    """Strip gapfill(...) from the context; servers run the inner bucket
    expression. Returns the rewritten context + the fill spec (or None)."""
    gf = None
    for e in ctx.group_by:
        if isinstance(e, Function) and e.name == "gapfill":
            gf = e
            break
    if gf is None:
        # gapfill outside GROUP BY is the reference's error too
        if any(isinstance(e, Function) and e.name == "gapfill"
               for e in ctx.select_expressions):
            raise QueryError("gapfill(...) must be a GROUP BY expression")
        return ctx, None

    inner, start, end, step, mode = _parse(gf)

    def rw(e: Expr) -> Expr:
        return inner if e == gf else e

    select = [rw(e) for e in ctx.select_expressions]
    try:
        select_pos = ctx.select_expressions.index(gf)
    except ValueError:
        raise QueryError("gapfill(...) must also appear in the select list")
    new_ctx = replace(
        ctx,
        select_expressions=select,
        group_by=[rw(e) for e in ctx.group_by],
        order_by=[OrderByExpr(rw(o.expr), o.ascending)
                  for o in ctx.order_by],
        # LIMIT/OFFSET move to the post-fill trim (see _REDUCE_LIMIT note)
        limit=_REDUCE_LIMIT,
        offset=0,
    )
    return new_ctx, GapfillSpec(select_pos=select_pos, start=start, end=end,
                                step=step, fill_mode=mode,
                                limit=ctx.limit, offset=ctx.offset)


def apply_gapfill(ctx: QueryContext, table: ResultTable,
                  spec: GapfillSpec) -> ResultTable:
    """Insert rows for absent buckets per dimension combination. ``ctx`` is
    the REWRITTEN context (post extract). Aggregation columns are the select
    positions that are not group expressions; fabricated rows fill them with
    0 (default mode) or the previous bucket's values (carry-forward). The
    reduce ran UNTRIMMED (extract_gapfill lifts the limit) so every present
    bucket is visible here; the query's ORDER BY re-applies over the FILLED
    rows and the original LIMIT/OFFSET trim last."""
    group_keys = {str(e) for e in ctx.group_by}
    dim_pos = [i for i, e in enumerate(ctx.select_expressions)
               if str(e) in group_keys and i != spec.select_pos]
    agg_pos = [i for i in range(len(ctx.select_expressions))
               if i not in dim_pos and i != spec.select_pos]

    series: dict = {}
    order: List[Tuple] = []
    for row in table.rows:
        key = tuple(row[i] for i in dim_pos)
        if key not in series:
            series[key] = {}
            order.append(key)
        try:
            t = int(row[spec.select_pos])
        except (TypeError, ValueError):
            raise QueryError(
                f"gapfill bucket value {row[spec.select_pos]!r} not numeric")
        if not (spec.start <= t < spec.end):
            continue  # outside the fill window: window semantics drop it
        if (t - spec.start) % spec.step:
            # a misaligned bucket would be SILENTLY shadowed by a fabricated
            # zero row — refuse loudly instead (the bucket expression must
            # produce start + k*step values)
            raise QueryError(
                f"gapfill bucket {t} is not aligned to "
                f"start={spec.start} step={spec.step}")
        series[key][t] = row

    out = []
    for key in order:
        have = series[key]
        prev = None
        for t in range(spec.start, spec.end, spec.step):
            row = have.get(t)
            if row is None:
                row = [None] * len(ctx.select_expressions)
                row[spec.select_pos] = t
                for p, v in zip(dim_pos, key):
                    row[p] = v
                for p in agg_pos:
                    if spec.fill_mode == "FILL_PREVIOUS_VALUE" \
                            and prev is not None:
                        row[p] = prev[p]
                    else:
                        row[p] = 0
            else:
                row = list(row)
            prev = row
            out.append(row)

    if ctx.order_by:
        # re-apply the query's ORDER BY over the FILLED rows (fabricated
        # rows participate; a LIMIT-ed top-N over the series stays correct)
        pos_of = {str(e): i for i, e in enumerate(ctx.select_expressions)}
        idx_dir = [(pos_of[str(ob.expr)], ob.ascending)
                   for ob in ctx.order_by if str(ob.expr) in pos_of]

        def sort_key(row):
            return tuple(_Reversible(row[i], asc) for i, asc in idx_dir)

        out.sort(key=sort_key)
    return ResultTable(table.schema,
                       out[spec.offset:spec.offset + spec.limit])
