"""A call's share of its bandwidth roofline, in %: the least bytes the
call's inputs need (``leastbytes.py``) at the card's HBM rate
(``peaks.json``), over the device's busy time a call (every kernel and
copy, the torch ops the fixpoint launches included)."""

MOVES = "trim_throughput"


def read(r):
    p = r.profile
    if (p is None or not r.calls or p.busy_s <= 0 or not r.least_bytes
            or not r.bytes_per_s):
        return None
    return r.least_bytes / r.bytes_per_s / (p.busy_s / r.calls) * 100
