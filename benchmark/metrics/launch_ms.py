"""launch_ms (ms): the median of the ``Launch`` spans' ``ms``: the
launcher's dispatcher from taking the group that served a query to
completing its futures (the kernel call and its copy to the host)."""

from benchmark.harness.observe import percentile
from benchmark.harness.spans import named, roots


def read(obs):
    return percentile([s["ms"] for _q, root in roots(obs)
                       for s in named(root, "Launch")], 50)
