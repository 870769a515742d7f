"""The plain reference: the trim every method must reach and the
per-worker counters each counted method must report, worked out from the
graph alone with plain torch ops.  It imports nothing of the program and
takes nothing the program made.

**Trim.**  A vertex stays iff it reaches a cycle.  Peeling: drop every
live vertex with no live successor, until nothing drops (each round one
gather and one prefix sum over the arcs).

**Counters.**  The paper's per-worker traversed arcs, vertex v on worker
``(v // chunk) % workers``, in closed form from the final status:

* AC-6: a removed vertex examined its whole row (deg v); a kept vertex
  examined its row up to and including its first arc into the kept set.
  (Pointers never retreat and a target once dead stays dead, so the
  support a kept vertex ends on is its first kept target.)
* AC-4: the counting scan reads every row (deg v), and each removed
  vertex propagates over all its in-arcs (in-deg v).  AC-4* skips the
  scan.

**Controls** (``control``): the reference made to break one guarantee
the configurations state, which the comparison must catch: the
per-worker counters accumulated in int16, the integer type below the
int32 they are stated in, and the trim stopped one round before its
fixpoint.
"""
from __future__ import annotations

import torch


def _prefix(x, m: int):
    """(m + 1,) int32 exclusive-then-inclusive prefix sums of ``x``."""
    out = torch.zeros(m + 1, dtype=torch.int32, device=x.device)
    torch.cumsum(x, 0, dtype=torch.int32, out=out[1:])
    return out


def trim(indptr, indices, max_rounds: int | None = None):
    """``(live, rounds)``: the (n,) bool set of vertices that reach a cycle
    and the number of peeling rounds that removed something.  With
    ``max_rounds`` the peeling stops after that many such rounds."""
    n, m = indptr.numel() - 1, indices.numel()
    start, end = indptr[:-1].long(), indptr[1:].long()
    live = torch.ones(n, dtype=torch.bool, device=indptr.device)
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        c = _prefix(live[indices], m)
        keep = live & (c[end] > c[start])
        if torch.equal(keep, live):
            break
        live = keep
        rounds += 1
    return live, rounds


def worker_sums(per_vertex, workers: int, chunk: int):
    """(workers,) int64 sums of ``per_vertex`` over each worker's vertices:
    chunk c of ``chunk`` vertices belongs to worker c mod ``workers``."""
    n = per_vertex.numel()
    chunks = -(-n // chunk)
    rows = -(-chunks // workers)
    padded = torch.zeros(rows * workers * chunk, dtype=torch.int64,
                         device=per_vertex.device)
    padded[:n] = per_vertex
    return padded.view(rows, workers, chunk).sum(dim=(0, 2))


def first_kept(indptr, indices, live):
    """(n,) int64: each vertex's position, within its row, of its first
    arc into ``live`` (undefined where it has none)."""
    m = indices.numel()
    c = _prefix(live[indices], m)
    start = indptr[:-1].long()
    at = torch.searchsorted(c, c[start] + 1, side="left")
    return at.long() - 1 - start


def examined(method: str, indptr, indices, live):
    """(n,) int64 arcs each vertex's worker traversed for it."""
    deg = (indptr[1:] - indptr[:-1]).long()
    if method == "ac6":
        return torch.where(live, first_kept(indptr, indices, live) + 1, deg)
    if method in ("ac4", "ac4*"):
        n = deg.numel()
        deg_in = torch.bincount(indices.long(), minlength=n)
        out = torch.where(live, 0, deg_in)
        return out + deg if method == "ac4" else out
    raise ValueError(f"no reference counters for method {method!r}")


def counters(method: str, indptr, indices, live, workers: int, chunk: int):
    """(workers,) int64 per-worker traversed arcs of ``method``."""
    return worker_sums(examined(method, indptr, indices, live), workers,
                       chunk)


def judge(status, per_worker, live, ref_counters=None) -> dict:
    """The numbers compared for one answer (an (n,) int32 status and a
    (P,) per-worker count or None): ``status_mismatch``, the vertices
    whose status differs from the reference's, and, with
    ``ref_counters``, ``counter_gap``, the largest gap of one worker's
    count from the reference's (a missing or misshapen count reads one
    more than the largest reference count).  Each has the limit 0."""
    out = {"status_mismatch": int(
        (status.to(live.device) != live.to(torch.int32)).sum())}
    if ref_counters is not None:
        missing = int(ref_counters.abs().max()) + 1
        if per_worker is None or len(per_worker) != len(ref_counters):
            out["counter_gap"] = missing
        else:
            got = torch.as_tensor(per_worker, dtype=torch.int64,
                                  device=ref_counters.device)
            out["counter_gap"] = int((got - ref_counters).abs().max())
    return out


def worst(readings) -> dict:
    """Each number's largest value over ``readings`` (dicts of
    :func:`judge`)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def passes(reading: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in reading.items())


LIMITS = {"status_mismatch": 0, "counter_gap": 0}


def control(kind: str, method: str, indptr, indices, workers: int,
            chunk: int, counted: bool):
    """One (status, per_worker) answer of the control ``kind``:
    ``"int16_counters"`` (the reference's counters accumulated in int16,
    wrapping) or ``"early_stop"`` (the trim stopped one round before its
    fixpoint, its counters worked out from that status)."""
    live, rounds = trim(indptr, indices)
    if kind == "early_stop":
        live, _ = trim(indptr, indices, max_rounds=max(rounds - 1, 0))
    pw = (counters(method, indptr, indices, live, workers, chunk)
          if counted else None)
    if kind == "int16_counters" and pw is not None:
        pw = ((pw + (1 << 15)) % (1 << 16)) - (1 << 15)
    elif kind not in ("int16_counters", "early_stop"):
        raise ValueError(f"unknown control {kind!r}")
    return live.to(torch.int32), pw
