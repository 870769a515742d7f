"""AC-3-based graph trimming (paper Algorithm 4), BSP formulation —
PyTorch port of ``src/repro/core/ac3.py``.

Every peeling round re-checks every live vertex: does it still have a live
successor?  The ``edge_index`` jump (paper §8) resumes each scan at the
previously found support, so per-round work is (live vertices) + (pointer
advances).  Rounds = peeling steps α + 1 (the final round confirms the
fixpoint), work O(α(n+m)), space O(n).

The round loop is driven from the host: one sync per round (the
``change`` test, after the round's work and counters are enqueued) plus
the probe's syncs (one per micro-step, see ``common.py``).
"""
from __future__ import annotations

import torch

from .common import per_worker_add, resolve_probe, worker_counts
from .registry import KernelSpec, register_kernel


def ac3_kernel(indptr, indices, worker_ids, workers: int, active=None, *,
               probe: str = "dense", window: int = 16,
               counters: bool = True):
    """``active``: optional (n,) bool — trim the induced subgraph (vertices
    outside are treated as already DEAD).

    Returns ``(status, rounds, per_worker, max_qp)``: rounds and max_qp
    0-d int32, per_worker (workers,) int32; the counter slots are ``None``
    with ``counters=False``.
    """
    n = indptr.shape[0] - 1
    dev = indptr.device
    deg = indptr[1:] - indptr[:-1]
    probe_fn = resolve_probe(probe, window)
    status = (torch.ones((n,), dtype=torch.bool, device=dev) if active is None
              else active.clone())
    ptr = torch.zeros((n,), dtype=torch.int32, device=dev)
    pw = torch.zeros((workers,), dtype=torch.int32, device=dev)
    max_qp = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = 0
    change = True
    while change:
        found, pos, probes = probe_fn(status, indptr, indices, ptr,
                                      scanning=status)
        frontier = status & ~found
        ptr = torch.where(status, torch.where(found, pos, deg), ptr)
        if counters:
            pw = per_worker_add(pw, probes, worker_ids, workers)
            max_qp = torch.maximum(
                max_qp, worker_counts(frontier, worker_ids, workers).max())
        status = status & found
        change = bool(frontier.any())                # host sync: loop test
        rounds += 1
    return (status, torch.tensor(rounds, dtype=torch.int32, device=dev),
            pw if counters else None, max_qp if counters else None)


def _run_ac3(graph_arrays, transpose_arrays, worker_ids, workers, active, *,
             probe, window, counters, frontier=None):
    del transpose_arrays, frontier  # AC-3 re-checks every live vertex
    indptr, indices = graph_arrays
    return ac3_kernel(indptr, indices, worker_ids, workers, active=active,
                      probe=probe, window=window, counters=counters)


register_kernel(KernelSpec(
    name="ac3", run=_run_ac3, needs_transpose=False,
    supports_windowed=True, supports_frontier=False))
