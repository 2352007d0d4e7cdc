"""scan_host_ms (ms): over the queries that hold a ``ShardedCombine`` span,
the median of the benchmark's wall time for the query less that span's:
the executor's host work around the launch (compile, plan, bind, decode,
merge and reduce)."""

from benchmark.harness.observe import percentile, walk_spans


def read(obs):
    host = []
    for q in obs.queries:
        if q.error is not None:
            continue
        combine = [s["ms"] for s in walk_spans(q.spans)
                   if s.get("name") == "ShardedCombine"]
        if combine:
            host.append(q.ms - sum(combine))
    return percentile(host, 50)
