"""The share of the traced window in which no device item ran, in %."""

MOVES = "trim_throughput"


def read(r):
    p = r.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return (1 - p.busy_s / p.window_s) * 100
