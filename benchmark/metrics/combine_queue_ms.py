"""combine_queue_ms (ms): the median ``queueMs`` of the port's
``ShardedCombine`` spans, the launcher's queue wait of a batch launch."""

from benchmark.harness.observe import percentile, walk_spans


def read(obs):
    waits = [s["queueMs"] for q in obs.queries for s in walk_spans(q.spans)
             if s.get("name") == "ShardedCombine" and "queueMs" in s]
    return percentile(waits, 50)
