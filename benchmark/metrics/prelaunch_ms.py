"""prelaunch_ms (ms): over the queries that hold a ``ShardedCombine`` span,
the median of the time from the ``ServerQuery`` root's start to the
combine's start on the program's clock (``t0Ns``): admission, pruning,
the lease and binding."""

from benchmark.harness.observe import percentile
from benchmark.harness.spans import named, roots


def read(obs):
    pre = []
    for _q, root in roots(obs):
        combine = named(root, "ShardedCombine")
        if combine and "t0Ns" in combine[0]:
            pre.append((combine[0]["t0Ns"] - root["t0Ns"]) / 1e6)
    return percentile(pre, 50)
