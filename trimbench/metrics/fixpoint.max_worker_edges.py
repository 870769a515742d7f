"""Arcs traversed by the busiest of the 16 workers in one call (the
paper's metric: the largest of ``TrimResult.per_worker_edges``).  Only
calls with counters on have it."""

MOVES = "trim_throughput"


def read(r):
    pw = r.per_worker_edges
    return None if pw is None or len(pw) == 0 else int(max(pw))
