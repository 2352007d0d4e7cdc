"""Differential fuzz of the port against the JAX package (modelled on
tests/test_fuzz.py): seeded random aggregation and group-by queries over
tests/test_torch_columns.py's stats table (dictionary, raw, multi-value
and nullable columns), with nested AND / OR / NOT filters, LIKE / NOT LIKE
/ REGEXP_LIKE / TEXT_MATCH, the epoch time transforms as values and group
keys, the host-only aggregation families, HAVING, ORDER BY an aggregate,
LIMIT ... OFFSET and OPTION; and seeded random selections (unordered, or
ordered by columns and expressions) and DISTINCT queries.

Each query runs through the JAX host engine and its jnp rung
(``use_pallas=False``) and through the port with the fused scan on, off
and over the batch. Where the JAX planner sends a segment to its host
engine, the port's host engine serves it with the same reason code
recorded per segment (``plan:`` decisions equal); selection and DISTINCT
record JAX's ``selection:`` and ``plan:`` decisions. Where the fused scan
declines a batch, the port's batch path raises with the fused scan's code
(the jnp combine is not ported). Otherwise rows agree: counts, integer
sums, min/max, keys and selected values exact, float aggregates within
rel 1e-5, abs 1e-6. A query ordered by a float aggregate is compared as a
set of groups: ties in such an order may break differently (the planned
float difference in ROADMAP).
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine.errors import QueryError as JQueryError  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu_torch.engine.errors import QueryError  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_torch_columns import build_stats  # noqa: E402

N_QUERIES = 120
SEED = 2026

# aggregation -> whether its cell is exact (False: a float sum or average)
AGGS = {
    "count(*)": True, "sum(runs)": True, "min(runs)": True,
    "max(score)": True, "avg(score)": False, "minmaxrange(year)": True,
    "sum(salary)": True, "avg(ratio)": False, "min(big)": True,
    "max(bonus)": True, "distinctcount(team)": True,
    "distinctcounthll(league)": True, "countmv(nums)": True,
    "summv(nums)": True, "sum(runs * 2)": True, "sum(salary / 3)": False,
    "sum(runs % 4)": True, "sum(toEpochSeconds(salary))": True,
    "sum(fromEpochMinutes(runs))": True,
    "max(dateTrunc('SECOND', salary))": True,
    "sum(timeConvert(runs, 'HOURS', 'MINUTES'))": True,
    "min(toEpochDays(big))": True, "sum(score)": False,
    # served by the host engine (the JAX planner refuses them)
    "mode(runs)": True, "percentile90(score)": True,
    "percentiletdigest50(runs)": False, "distinctcount(salary)": True,
    "distinctcountmv(tags)": True, "sumprecision(runs)": True,
    "lastwithtime(runs, salary, 'LONG')": True, "avgmv(nums)": False,
}
# the last three: group-by on an MV column, on a raw float column, and a
# key spanning 2^24 values, which JAX serves on its host engine
GROUP_KEYS = ["team", "league", "year", "nick", "runs", "year - 1990",
              "toEpochSeconds(salary)", "toEpochHours(runs * 3600000)",
              "toEpochDays(salary * 1000)", "tags", "ratio",
              "toEpochMinutes(big)"]


def _predicate(rng):
    team = ["ATL", "BOS", "CHC", "NYA", "SFO", "LAD", "HOU"]
    k = int(rng.integers(0, 20))
    t = team[int(rng.integers(0, 7))]
    return [
        f"team = '{t}'", f"team != '{t}'",
        f"team IN ('{t}', 'NYA')", f"team NOT IN ('{t}', 'LAD')",
        f"team LIKE '{t[0]}%'", f"team NOT LIKE '%{t[1]}%'",
        f"REGEXP_LIKE(team, '^[A-{t[0]}]')",
        f"year BETWEEN {1990 + k} AND {2000 + k}",
        f"runs > {7 * k}", f"score <= {40 + k}",
        f"salary BETWEEN {k * 200_000} AND {k * 200_000 + 1_500_000}",
        f"ratio < {k / 20}", f"tags = 't{k % 5}'", "tags IN ('t0', 't3')",
        f"tags LIKE 't{k % 5}%'", "NOT tags LIKE 't_'",
        f"REGEXP_LIKE(tags, '[{k % 5}4]')", f"nums = {k}",
        "nick IS NULL", "bonus IS NOT NULL", f"year LIKE '19{k % 10}_'",
        f"TEXT_MATCH(team, '{t.lower()}')",
    ][int(rng.integers(0, 22))]


def _filter(rng, depth=0):
    r = rng.random()
    if depth >= 2 or r < 0.45:
        return _predicate(rng)
    if r < 0.55:
        return f"NOT ({_filter(rng, depth + 1)})"
    op = " AND " if r < 0.8 else " OR "
    n = int(rng.integers(2, 4))
    return "(" + op.join(_filter(rng, depth + 1) for _ in range(n)) + ")"


def _query(rng):
    """-> (sql, exact flags of its select columns, ordered by a float)."""
    aggs = list(rng.choice(list(AGGS), size=int(rng.integers(1, 4)),
                           replace=False))
    keys = []
    if rng.random() < 0.65:
        keys = list(rng.choice(GROUP_KEYS, size=int(rng.integers(1, 3)),
                               replace=False))
    sql = "SELECT " + ", ".join(keys + aggs) + " FROM stats"
    if rng.random() < 0.85:
        sql += " WHERE " + _filter(rng)
    float_order = False
    if keys:
        sql += " GROUP BY " + ", ".join(keys)
        if rng.random() < 0.3:
            sql += f" HAVING {aggs[0]} > {int(rng.integers(0, 50))}"
        if rng.random() < 0.5:
            float_order = not AGGS[aggs[0]]
            order = f"{aggs[0]} DESC, " + ", ".join(keys)
        else:
            order = ", ".join(keys)
        sql += f" ORDER BY {order}"
        if float_order:
            sql += " LIMIT 100000"
        else:
            sql += f" LIMIT {int(rng.choice([1, 5, 100000]))}"
            if rng.random() < 0.3:
                sql += f" OFFSET {int(rng.integers(1, 4))}"
    if rng.random() < 0.2:
        sql += " OPTION(timeoutMs=30000)"
    exact = [True] * len(keys) + [AGGS[a] for a in aggs]
    return sql, exact, float_order


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    return build_stats(tmp_path_factory.mktemp("torch_fuzz"))


@pytest.fixture(scope="module")
def executors():
    return {"jnp": JExecutor(use_device=True, use_pallas=False),
            "host": JExecutor(use_device=False),
            "port_on": ServerQueryExecutor(device="cpu"),
            "port_off": ServerQueryExecutor(device="cpu",
                                            use_fused_scan=False),
            "port_batch": ShardedQueryExecutor(device="cpu")}


def _cell_equal(g, w, exact):
    if isinstance(w, float) and isinstance(g, (int, float)) and not exact:
        return g == pytest.approx(w, rel=1e-5, abs=1e-6)
    return g == w


def _rows_equal(got, want, exact, as_set):
    if len(got) != len(want):
        return False
    if as_set:
        nk = exact.index(False) if False in exact else len(exact)
        got = sorted(got, key=lambda r: repr(r[:nk]))
        want = sorted(want, key=lambda r: repr(r[:nk]))
    return all(_cell_equal(g, w, ex) for gr, wr in zip(got, want)
               for g, w, ex in zip(gr, wr, exact))


def _plan_codes(stats):
    return {k.rsplit(":", 1)[1] for k in stats.decisions
            if k.startswith("plan:")}


def _host_keys(stats):
    """The host engine's and the device top-k's decisions with counts."""
    return {k: v for k, v in stats.decisions.items()
            if k.startswith(("plan:", "selection:"))}


@pytest.mark.parametrize("qi", range(N_QUERIES))
def test_fuzz_query(table, executors, qi):
    jsegs, tsegs = table
    sql, exact, float_order = _query(np.random.default_rng(SEED + qi))
    try:
        want, jstats = executors["jnp"].execute(j_compile(sql), jsegs)
    except JQueryError:
        for path in ("port_on", "port_off", "port_batch"):
            with pytest.raises(QueryError):
                executors[path].execute(t_compile(sql), tsegs)
        return
    host, _ = executors["host"].execute(j_compile(sql), jsegs)
    host_codes = _plan_codes(jstats)
    declines = set()
    for path in ("port_on", "port_off", "port_batch"):
        got, stats = executors[path].execute(t_compile(sql), tsegs)
        assert _plan_codes(stats) == host_codes, (path, sql, stats.decisions)
        if path != "port_batch":
            assert _host_keys(stats) == _host_keys(jstats), (path, sql)
        if path == "port_on":
            declines = {k.rsplit(":", 1)[1] for k in stats.decisions
                        if k.startswith("pallas:")}
        else:
            # where the fused scan declines the batch, it declines the
            # segments alike on the per-segment path, and the jnp combine
            # serves
            combine = {k.rsplit(":", 1)[1] for k in stats.decisions
                       if k.startswith("pallas:pallas_combine")}
            assert path == "port_off" or combine <= declines, \
                (sql, combine, declines)
        assert got.schema.column_names == want.schema.column_names, sql
        assert _rows_equal(got.rows, want.rows, exact, float_order), \
            (path, sql, got.rows[:5], want.rows[:5])
        # the host engine sums floats in f64 over the raw values and keys
        # expressions as floats: values within the float gate
        assert _rows_equal(got.rows, host.rows,
                           [False] * len(exact), float_order), \
            ("host", path, sql)
        assert stats.num_segments_pruned == jstats.num_segments_pruned, sql


N_SELECTIONS = 40
SELECT_COLS = ["team", "league", "year", "tags", "nums", "runs", "score",
               "salary", "nick", "bonus", "ratio", "big", "runs + 1",
               "upper(team)"]
# order keys: dictionary, raw INT/LONG/DOUBLE, nullable and expression keys
# (the device top-k takes the first six where the filter allows)
ORDER_KEYS = ["year", "runs", "score", "team", "ratio", "league", "salary",
              "big", "bonus", "runs * 2"]
DISTINCT_COLS = ["team", "league", "year", "nick", "ratio"]


def _selection_query(rng):
    where = f" WHERE {_filter(rng)}" if rng.random() < 0.7 else ""
    limit = int(rng.integers(1, 40))
    offset = (f" OFFSET {int(rng.integers(1, 6))}" if rng.random() < 0.3
              else "")
    r = rng.random()
    if r < 0.3:
        cols = rng.choice(DISTINCT_COLS, size=int(rng.integers(1, 3)),
                          replace=False)
        order = ""
        if rng.random() < 0.5:
            order = " ORDER BY " + ", ".join(
                f"{c} {'DESC' if rng.random() < 0.5 else 'ASC'}"
                for c in cols)
        return (f"SELECT DISTINCT {', '.join(cols)} FROM stats{where}"
                f"{order} LIMIT {limit * 10}{offset}")
    cols = list(rng.choice(SELECT_COLS, size=int(rng.integers(1, 4)),
                           replace=False))
    order = ""
    if r < 0.75:
        keys = rng.choice(ORDER_KEYS, size=int(rng.integers(1, 3)),
                          replace=False)
        order = " ORDER BY " + ", ".join(
            f"{k} {'DESC' if rng.random() < 0.5 else 'ASC'}" for k in keys)
    return (f"SELECT {', '.join(cols)} FROM stats{where}{order} "
            f"LIMIT {limit}{offset}")


@pytest.mark.parametrize("qi", range(N_SELECTIONS))
def test_fuzz_selection(table, executors, qi):
    """Selection and DISTINCT: the rows of the JAX executor (its device
    top-k or its host engine) exactly, ties in doc order included, with
    the same ``selection:`` / ``plan:`` decisions."""
    jsegs, tsegs = table
    sql = _selection_query(np.random.default_rng(SEED + 1000 + qi))
    try:
        want, jstats = executors["jnp"].execute(j_compile(sql), jsegs)
    except JQueryError:
        for path in ("port_on", "port_off", "port_batch"):
            with pytest.raises(QueryError):
                executors[path].execute(t_compile(sql), tsegs)
        return
    host, _ = executors["host"].execute(j_compile(sql), jsegs)
    assert host.rows == want.rows, sql
    for path in ("port_on", "port_off", "port_batch"):
        got, stats = executors[path].execute(t_compile(sql), tsegs)
        assert got.schema.column_names == want.schema.column_names, sql
        assert got.schema.column_types == want.schema.column_types, sql
        assert got.rows == want.rows, (path, sql, got.rows[:3],
                                       want.rows[:3])
        assert _host_keys(stats) == _host_keys(jstats), (path, sql)
        assert stats.num_docs_scanned == jstats.num_docs_scanned, (path, sql)
