"""idle_unnamed_share (%): inside the ``ServerQuery`` roots of the
profiled sub-window, the share of their time that no span below a root
and no device work covers: the executor's host work between its named
steps. Spans are laid on the trace with ``Profiler.host_us``
(``harness/spans.py``); the client and the SQL's compile, outside the
roots, do not count."""

from benchmark.harness.spans import unnamed_idle_us


def read(obs):
    got = unnamed_idle_us(obs)
    if got is None:
        return None
    unnamed, root = got
    return 100.0 * unnamed / root
