"""Bytes the planned engine holds after warm-up (``engine.nbytes()``: the
graph, Gt and its row ids for AC-4, the worker map), in GiB."""

MOVES = "peak_mem_gib"


def read(r):
    return None if r.resident_bytes is None else r.resident_bytes / 2**30
