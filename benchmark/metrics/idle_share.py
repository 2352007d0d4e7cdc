"""idle_share (%): the share of the profiled sub-window in which no kernel
and no copy ran on the device (1 - the union of their intervals)."""


def read(obs):
    p = obs.profile
    if p is None or p.window_us <= 0 or not p.events:
        return None
    return 100.0 * (1.0 - p.busy_us() / p.window_us)
