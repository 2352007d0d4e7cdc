"""kernel_roofline (%): the bytes the queries that finished in the
profiled sub-window must read (``harness/bytecount.py``, from the data),
over the card's peak bandwidth, over the device's busy time there."""


def read(obs):
    p = obs.profile
    if p is None or not p.events:
        return None
    need = sum(q.bytes for q in obs.queries
               if q.in_trace and q.error is None and q.bytes)
    busy_s = p.busy_us() / 1e6
    if need <= 0 or busy_s <= 0 or obs.bandwidth <= 0:
        return None
    return 100.0 * need / obs.bandwidth / busy_s
