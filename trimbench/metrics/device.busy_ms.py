"""Device ms a call: the union of the profiler's kernel, copy and memset
items over the traced calls, per call."""

MOVES = "trim_throughput"


def read(r):
    p = r.profile
    if p is None or not r.calls or p.busy_s <= 0:
        return None
    return p.busy_s / r.calls * 1e3
