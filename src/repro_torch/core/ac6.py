"""AC-6-based graph trimming (paper Algorithms 7/8) — the paper's novel
contribution — in BSP formulation; PyTorch port of
``src/repro/core/ac6.py``.

Each vertex v keeps ONE support: the adjacency position ``ptr[v]`` of a
live successor.  When the support dies, v scans strictly after its pointer
for a replacement; failure kills v and the death propagates.  Pointers
never retreat, so every adjacency entry is examined at most once — total
edge traversals ≤ m (paper Theorem 12).  The supporting sets are inverted
lazily each round with one gather::

    affected = live(v) & ¬status[support(v)]

With a non-dense :class:`~repro_torch.core.common.FrontierPlan` the state
is padded to 64-row chunks, and a round whose affected set spans at most
``cap // 64`` chunks probes only those chunks' rows
(``probe_first_live_ids``) and writes them back — bit-identical to the
dense round, counters included.

The round loop is driven from the host: one sync per round (the number
of affected chunks, which is both the loop test and the dense/sparse
choice; the plain ``affected.any()`` when dense) plus the probe's syncs.
``ptr`` and the carried support are updated in place.  An instrumented
run keeps each round's death count and probe sum on the card
(``r_sparse`` is the host's own choice).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import FrontierPlan, per_worker_add, probe_first_live_ids, \
    resolve_probe, segment_sum, worker_counts
from .registry import KernelSpec, register_kernel

CHUNK = 64  # chunked-frontier granularity


def ac6_kernel(indptr, indices, worker_ids, workers: int, active=None, *,
               probe: str = "dense", window: int = 16, counters: bool = True,
               frontier: FrontierPlan = FrontierPlan(), stats=None):
    """``active``: optional (n,) bool — trim the induced subgraph.

    ``probe``/``window`` select the scan (``common.resolve_probe``);
    ``counters=False`` skips the per-worker counters and returns ``None``
    in their slots.  ``stats``: a :class:`~repro_torch.obs.RoundBuffers`
    over ``r_frontier``, ``r_edges`` (and ``r_sparse`` with a non-dense
    plan) that each round records into, or ``None``; ``r_edges`` is the
    round's probe sum whether or not ``counters`` is on.  Returns
    ``(status, rounds, per_worker, max_qp)``.
    """
    n = indptr.shape[0] - 1
    m = indices.shape[0]
    dev = indptr.device
    last = max(m - 1, 0)
    deg = indptr[1:] - indptr[:-1]
    row_base = indptr[:-1]
    probe_fn = resolve_probe(probe, window)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)

    sparse = frontier.mode != "dense"
    if sparse:
        K = -(-n // CHUNK)
        Cc = max(1, min(frontier.cap // CHUNK, K))
        pad = K * CHUNK - n
        # pad rows are dead: deg 0, never active, never scanned
        deg = F.pad(deg, (0, pad))
        row_base = F.pad(row_base, (0, pad))
        active = F.pad(active, (0, pad))
        worker_ids = F.pad(worker_ids, (0, pad))
        indptr = torch.cat([indptr, indptr[-1:].expand(pad)])
        n_state = K * CHUNK
        deg2 = deg.view(K, CHUNK)
        rb2 = row_base.view(K, CHUNK)
        wk2 = worker_ids.view(K, CHUNK)
        queries = torch.arange(1, Cc + 1, dtype=torch.int64, device=dev)
    else:
        n_state = n
    has_deg = deg > 0
    zero_pw = torch.zeros((workers,), dtype=torch.int32, device=dev)

    status = active.clone()
    affected = active.clone()
    ptr = torch.full((n_state,), -1, dtype=torch.int32, device=dev)
    # round 1 processes every live row, so every support that is ever read
    # is written before it is read
    supp = torch.zeros((n_state,), dtype=torch.int32, device=dev)
    pw = zero_pw
    max_qp = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = 0

    def dense_round(aff):
        # scan strictly after the (dead) support; round 0 starts at 0
        found, pos, probes = probe_fn(status, indptr, indices, ptr + 1,
                                      scanning=aff)
        new_status = status & ~(aff & ~found)
        ptr[:] = torch.where(aff, torch.where(found, pos, deg), ptr)
        supp[:] = indices[(row_base + ptr).clamp_(0, last)]
        pw_delta = (per_worker_add(zero_pw, probes, worker_ids, workers)
                    if counters else zero_pw)
        return new_status, pw_delta, probes

    def sparse_round(aff, chmask, nch):
        # compact the chunk set (rank search over the (K,) chunk mask),
        # probe the selected Cc*CHUNK rows through gathered CSR
        # descriptors, write whole chunk rows back.  The nch selected
        # chunk ids come first in cids (ascending; sentinel K after).
        aff2 = aff.view(K, CHUNK)
        ccs = torch.cumsum(chmask.to(torch.int64), dim=0)
        cids = torch.searchsorted(ccs, queries, side="left")
        okc = cids < K
        rowc = cids.clamp(max=K - 1)
        scan2 = aff2[rowc] & okc[:, None]                  # (Cc, CHUNK)
        scan = scan2.reshape(-1)
        rb_rows = rb2[rowc]
        dg_rows = deg2[rowc]
        dg = torch.where(scan, dg_rows.reshape(-1), 0)
        ptr2 = ptr.view(K, CHUNK)
        ptr_rows = ptr2[rowc]
        start = torch.where(scan, ptr_rows.reshape(-1) + 1, 0)
        found, pos, probes = probe_first_live_ids(
            status, indices, rb_rows.reshape(-1), dg, start, scanning=scan)
        found2 = found.view(Cc, CHUNK)
        new_ptr_rows = torch.where(
            scan2, torch.where(found2, pos.view(Cc, CHUNK), dg_rows),
            ptr_rows)
        sel = cids[:nch]
        ptr2[sel] = new_ptr_rows[:nch]
        supp.view(K, CHUNK)[sel] = indices[
            (rb_rows[:nch] + new_ptr_rows[:nch]).clamp_(0, last)]
        st2 = status.view(K, CHUNK)
        new_status = st2.clone()
        new_status[sel] = (st2[rowc] & ~(scan2 & ~found2))[:nch]
        pw_delta = (segment_sum(probes, wk2[rowc].reshape(-1), workers)
                    if counters else zero_pw)
        return new_status.view(-1), pw_delta, probes

    while True:
        if sparse:
            chmask = affected.view(K, CHUNK).any(dim=1)
            nch = int(chmask.sum())           # host sync: loop test + path
            if nch == 0:
                break
            if nch <= Cc:
                new_status, pw_delta, probes = sparse_round(affected, chmask,
                                                            nch)
            else:
                new_status, pw_delta, probes = dense_round(affected)
        else:
            if not bool(affected.any()):      # host sync: loop test
                break
            new_status, pw_delta, probes = dense_round(affected)
        frontier_ = status & ~new_status      # newly dead this round
        if stats is not None:
            vals = dict(r_frontier=frontier_.sum(dtype=torch.int32),
                        r_edges=probes.sum(dtype=torch.int32))
            if sparse:
                vals["r_sparse"] = int(nch <= Cc)
            stats.record(rounds, **vals)
        # lazy supporting-set inversion: whose support died?
        affected = new_status & ~new_status[supp] & has_deg
        rounds += 1
        if counters:
            pw = pw + pw_delta
            max_qp = torch.maximum(
                max_qp, worker_counts(frontier_, worker_ids, workers).max())
        status = new_status
    return (status[:n], torch.tensor(rounds, dtype=torch.int32, device=dev),
            pw if counters else None, max_qp if counters else None)


def _run_ac6(graph_arrays, transpose_arrays, worker_ids, workers, active, *,
             probe, window, counters, frontier=FrontierPlan(), stats=None):
    del transpose_arrays
    indptr, indices = graph_arrays
    return ac6_kernel(indptr, indices, worker_ids, workers, active=active,
                      probe=probe, window=window, counters=counters,
                      frontier=frontier, stats=stats)


register_kernel(KernelSpec(
    name="ac6", run=_run_ac6, needs_transpose=False,
    supports_windowed=True, sharded_method="ac6"))
