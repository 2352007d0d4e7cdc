"""result_host_ms (ms): over the queries that hold a ``ShardedCombine``
span, the median of the ``ServerQuery`` root's end less the last
combine's end on the program's clock (``t0Ns`` + ``ms``): decode,
reduce and release."""

from benchmark.harness.observe import percentile
from benchmark.harness.spans import end_ns, named, roots


def read(obs):
    post = []
    for _q, root in roots(obs):
        combine = named(root, "ShardedCombine")
        if combine and "t0Ns" in combine[-1]:
            post.append((end_ns(root) - end_ns(combine[-1])) / 1e6)
    return percentile(post, 50)
