"""AC-4-based graph trimming (paper Algorithms 5/6), BSP formulation —
PyTorch port of ``src/repro/core/ac4.py``.

Out-degree counters are initialized for every vertex; dead vertices
propagate through the transposed graph Gᵀ, decrementing their
predecessors' counters (the paper's FAA), and counters reaching zero kill
the vertex.  Work O(n+m), space O(n+m).  A round's decrement vector is
one scatter-add over the frontier's Gᵀ edges: either over all of Gᵀ
masked by the frontier (dense) or over only the frontier's Gᵀ rows,
compacted by ``frontier_compact`` and expanded by ``sparse_expand``
(the two Hopper kernels of this path).  Both give the same vector.

The round loop is driven from the host with one sync per round: the
frontier's member count and Gᵀ degree sum come back together and decide
both the loop test and the dense/sparse choice (a dense plan tests
``any()`` instead, unless it is instrumented).  The sparse decrement adds
only the expanded buffer's real edges, slots ``[0, edges)``: the host
knows ``edges``, and the padding slots would add nothing but serialised
atomics on vertex 0.
"""
from __future__ import annotations

from functools import partial

import torch

from ..kernels import ops as kops
from .common import FrontierPlan, per_worker_add, segment_sum, worker_counts
from .graph import row_ids
from .registry import KernelSpec, register_kernel


def ac4_kernel(indptr, indices, t_indptr, t_indices, t_rows, worker_ids,
               workers: int, count_init_scan: bool, active=None, *,
               counters: bool = True, frontier: FrontierPlan = FrontierPlan(),
               stats=None):
    """t_rows: (mT,) source vertex (the dead propagator w) of each Gᵀ edge.

    ``active``: optional (n,) bool — trim the induced subgraph.
    ``count_init_scan``: AC-4 charges the initial out-degree counting scan
    to the workers; AC-4* computes degrees from CSR index arithmetic and
    does not.  ``stats``: a :class:`~repro_torch.obs.RoundBuffers` over
    ``r_frontier``, ``r_edges``, ``r_decrements`` (and ``r_sparse`` with a
    non-dense plan) that each round records into, or ``None``; AC-4's
    degree scan is charged to slot 0.  Returns ``(status, rounds,
    per_worker, max_qp)``.
    """
    n = indptr.shape[0] - 1
    dev = indptr.device
    deg_out = indptr[1:] - indptr[:-1]
    deg_in = t_indptr[1:] - t_indptr[:-1]   # = in-degree in G

    masked = active is not None
    if not masked:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        # counters count only successors inside the induced subgraph
        src = row_ids(indptr, indices.shape[0])
        deg_out = segment_sum(active[src] & active[indices], src, n)

    frontier_ = active & (deg_out == 0)
    status = active & ~frontier_
    cnt = deg_out.to(torch.int32)
    pw = torch.zeros((workers,), dtype=torch.int32, device=dev)
    if counters and count_init_scan:  # AC4: counting |v.post| reads m edges
        pw = per_worker_add(pw, deg_out, worker_ids, workers)
    max_qp = (worker_counts(frontier_, worker_ids, workers).max() if counters
              else None)
    if stats is not None and count_init_scan:
        # the degree-counting scan is round-0 work: all m edges, or the
        # induced ones
        stats.record(0, r_edges=(deg_out.sum(dtype=torch.int32) if masked
                                 else indices.shape[0]))

    def dense_dec(f):
        # bulk FAA: each Gᵀ edge (w -> v) with w in the frontier decrements v
        return segment_sum(f[t_rows], t_indices, n)

    def sparse_dec(f, edges: int):
        # the same vector from only the frontier's Gᵀ rows: compact ->
        # expand Σ deg_in(frontier) = ``edges`` (<= ecap) edges into slots
        # [0, edges) -> scatter-add those
        ids, _ = kops.frontier_compact(f, frontier.cap)
        _, tgt, _, valid = kops.sparse_expand(t_indptr, t_indices, ids,
                                              frontier.ecap)
        return segment_sum(valid[:edges], tgt[:edges], n)

    sparse = frontier.mode != "dense"
    known = sparse or stats is not None
    rounds = 0
    while True:
        in_edges = torch.where(frontier_, deg_in, 0)
        if known:
            count, edges = torch.stack(
                [frontier_.sum(), in_edges.sum()]).tolist()  # host sync
            if count == 0:
                break
            use_sparse = (sparse and count <= frontier.cap
                          and edges <= frontier.ecap)
        else:
            if not bool(frontier_.any()):                    # host sync
                break
            use_sparse = False
        dec = (sparse_dec(frontier_, edges) if use_sparse
               else dense_dec(frontier_))
        if stats is not None:
            # round r processes the frontier that died in round r - 1;
            # decrements count only those landing on live vertices
            vals = dict(r_frontier=count, r_edges=edges,
                        r_decrements=(dec * status).sum(dtype=torch.int32))
            if sparse:
                vals["r_sparse"] = int(use_sparse)
            stats.record(rounds, **vals)
        cnt = cnt - dec
        newly = status & (cnt <= 0)
        status = status & ~newly
        rounds += 1
        if counters:
            # traversed edges: all in-edges of the frontier, attributed to
            # the worker that owns the propagating vertex
            pw = per_worker_add(pw, in_edges, worker_ids, workers)
            max_qp = torch.maximum(
                max_qp, worker_counts(newly, worker_ids, workers).max())
        frontier_ = newly
    return (status, torch.tensor(rounds, dtype=torch.int32, device=dev),
            pw if counters else None, max_qp)


def _run_ac4(graph_arrays, transpose_arrays, worker_ids, workers, active, *,
             probe, window, counters, count_init_scan,
             frontier=FrontierPlan(), stats=None):
    del probe, window  # AC-4 never probes (counter-based)
    indptr, indices = graph_arrays
    t_indptr, t_indices, t_rows = transpose_arrays
    return ac4_kernel(
        indptr, indices, t_indptr, t_indices, t_rows, worker_ids, workers,
        count_init_scan=count_init_scan, active=active, counters=counters,
        frontier=frontier, stats=stats)


register_kernel(KernelSpec(
    name="ac4", run=partial(_run_ac4, count_init_scan=True),
    needs_transpose=True, supports_windowed=False, sharded_method="ac4"))
register_kernel(KernelSpec(
    name="ac4*", run=partial(_run_ac4, count_init_scan=False),
    needs_transpose=True, supports_windowed=False, sharded_method="ac4"))
