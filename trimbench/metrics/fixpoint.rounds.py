"""BSP rounds of one call (``TrimResult.rounds``; fixpoint:
``core/ac6.py``, ``core/ac4.py``, ``core/common.py``)."""

MOVES = "trim_throughput"


def read(r):
    return r.rounds
