"""gc_share (%): the collector's pauses inside the window's queries (the
``ServerQuery`` roots' ``gcMs``) over the roots' wall time."""

from benchmark.harness.spans import roots


def read(obs):
    gc_ms = total_ms = 0.0
    for _q, root in roots(obs):
        gc_ms += root.get("gcMs", 0.0)
        total_ms += root["ms"]
    if total_ms <= 0:
        return None
    return 100.0 * gc_ms / total_ms
