"""Incremental trimming over edge-update batches — PyTorch port of
``src/repro/core/stream.py``.

Trimming *is* arc-consistency, so AC-4's support counters (paper §5) can
be persistent state: a long-lived service absorbs edge deletions and
insertions and re-trims in time proportional to the update batch, not the
graph.  :class:`StreamEngine` is the third engine family (``"stream"`` in
the kernel registry)::

    engine = plan_stream(graph, capacity=1024)
    res = engine.apply(deletions=(du, dv), insertions=(iu, iv))
    result = engine.retrim()            # current fixpoint, zero dispatch
    result = engine.retrim(full=True)   # from-scratch rebuild, 1 dispatch
    g_now  = engine.snapshot()          # materialized CSRGraph

Each ``apply`` is one counted dispatch:

1. the batch is resolved on the host against the :class:`~repro_torch.
   core.graph.DeltaCSR` overlay (tombstoned base edge ids, freed and
   claimed insert slots; multiset semantics), and the host drops the
   reference's sentinel entries before the batch goes to the device;
2. the structural updates are written into the device overlay in place;
3. the ``counter_scatter`` Hopper kernel adjusts the live out-degree
   counters of the touched sources and emits the newly-dead frontier;
4. AC-4's propagation (``core/ac4.py``'s body) runs over the overlay,
   seeded from that frontier: base arcs through Gᵀ with tombstones masked
   out, insert-buffer arcs added in.

**Insertions and revival.**  Deletions are monotone: continuing from the
previous fixpoint reaches the from-scratch fixpoint.  An inserted arc out
of a dead source can revive vertices, which counter maintenance cannot
express.  Such a batch (``dirty``; one host test, made only in batches
with insertions) restarts from the from-scratch initialization instead:
all vertices live, counters = live out-degree over the overlay, and the
counter kernel is not needed.  Either way ``retrim()`` equals a
from-scratch AC-4 run on :meth:`StreamEngine.snapshot`, bit for bit.

The fixpoint is driven from the host with one sync per round (the
frontier's member count and Gᵀ degree sum, which decide the loop test and
the dense or sparse decrement).  The per-round insert-buffer sum covers
only the consumed slots ``[0, n_ins)`` and the sparse decrement only the
frontier's expanded edges, both known on the host: slots past them would
add nothing but serialised atomics.

``instrument=True`` records each dispatch's per-round stats (frontier
size, live arcs traversed, decrements applied to live vertices, the
sparse-round flag; a from-scratch initialization's scan of every overlay
arc is charged to slot 0) without a host sync; ``retrim()`` reports
those of the dispatch that produced the current fixpoint.

**Faults and checkpoints** (DESIGN.md §14).  ``apply`` arms the
FaultPlane's ``"mid-update-batch"`` point once the batch is validated and
before anything commits, so a fault there is retried with the same
batch; past it the host mirrors move, and a fault in the dispatch is
recovered by restoring a checkpoint and re-applying.  ``state_dict``
saves the overlay and the AC-4 state, counters verbatim (a dead vertex's
counter depends on the path that killed it), in the reference's names.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..fault.plane import get_fault_plane
from ..kernels import ops as kops
from .common import FrontierPlan, frontier_plan, segment_sum
from .enginebase import EngineBase
from .graph import (CSRGraph, DeltaCSR, TrimResult, _stable_counting_order,
                    check_edge_ids, row_ids)
from .registry import KernelSpec, get_kernel, register_kernel

STREAM_BACKENDS = ("dense",)


# -- the stream kernel (family "stream") ---------------------------------------

def _run_stream_ac4(tarrs, overlay, state, updates, *, n_ins: int,
                    full: bool, frontier: FrontierPlan = FrontierPlan(),
                    stats=None):
    """One apply step: structural overlay updates, counter maintenance and
    the (incremental or from-scratch) AC-4 fixpoint.

    tarrs:   (t_indptr, t_indices, t_rows, perm) — base Gᵀ, the source
             of each Gᵀ edge, and the base edge id of each Gᵀ edge
             (``perm``), so the base tombstones gather into Gᵀ order.
    overlay: (tomb, ins_src, ins_dst, ins_alive) — the device overlay,
             **updated in place**.
    state:   (status bool (n,), counters int32 (n,)) — the persistent AC-4
             state (``None`` when ``full``).
    updates: (del_src, del_dst, tomb_ids, free_slots, add_src, add_dst,
             add_slots) int32 — the deletions' endpoints, the base edge
             ids they tombstone and the insert slots they free, the
             insertions' endpoints and claimed slots.  Every entry is in
             range: the host filtered out the reference's sentinels.
    n_ins:   consumed insert slots after the batch (the host-known
             high-water mark; the slots past it are never alive).
    full:    ignore the incremental state and rebuild the fixpoint from
             scratch over the overlay.
    stats:   a :class:`~repro_torch.obs.RoundBuffers` over ``r_frontier``,
             ``r_edges``, ``r_decrements`` (and ``r_sparse`` on a non-dense
             plan) that each round records into, or ``None``.  An
             instrumented run reads the frontier's count in its loop test
             on every plan.

    Returns ``((status, counters), rounds, dirty)`` with ``rounds`` an int
    and ``dirty`` a bool.
    """
    t_indptr, t_indices, t_rows, perm = tarrs
    tomb, ins_src, ins_dst, ins_alive = overlay
    del_src, del_dst, tomb_ids, free_slots, add_src, add_dst, add_slots = \
        updates
    n = t_indptr.shape[0] - 1

    # 1. structural updates: deletions first, then insertions
    tomb[tomb_ids] = True
    ins_alive[free_slots] = False
    ins_src[add_slots] = add_src
    ins_dst[add_slots] = add_dst
    ins_alive[add_slots] = True
    tomb_t = tomb[perm]                      # tombstones in Gᵀ edge order
    ins_own, ins_tgt = ins_src[:n_ins], ins_dst[:n_ins]
    ins_live = ins_alive[:n_ins]

    def scratch_init():
        # all vertices live, counters = live out-degree over the overlay
        deg0 = segment_sum(~tomb_t, t_indices, n)
        if n_ins:
            deg0 = deg0 + segment_sum(ins_live, ins_own, n)
        return deg0 != 0, deg0, deg0 == 0

    dirty = False
    if full:
        status, counters, front = scratch_init()
    else:
        status, counters = state
        if add_src.numel():
            # revival: an inserted arc out of a dead source
            dirty = not bool(status[add_src].all())          # host sync
        if dirty:
            status, counters, front = scratch_init()
        else:
            # 2. counter deltas against the pre-batch fixpoint: an arc
            # counts for its source iff both endpoints are live
            del_live = status[del_src] & status[del_dst]
            add_live = status[add_src] & status[add_dst]
            counters, front = kops.counter_scatter(
                counters, status, torch.cat([del_src, add_src]),
                torch.cat([-del_live.to(torch.int32),
                           add_live.to(torch.int32)]))
            status = status & ~front

    if stats is not None and (full or dirty):
        # the from-scratch initialization scans every overlay arc: the
        # base edges and the insert buffer's capacity, as the reference
        stats.record(0, r_edges=t_rows.shape[0] + ins_alive.shape[0])

    # 3. AC-4 propagation over the overlay: each Gᵀ arc whose dead
    # propagator is on the frontier decrements its predecessor
    sparse = frontier.mode != "dense"
    known = sparse or stats is not None
    t_deg = t_indptr[1:] - t_indptr[:-1]

    def base_dec_dense(f):
        return segment_sum(f[t_rows] & ~tomb_t, t_indices, n)

    def base_dec_sparse(f, tedges: int):
        # only the frontier's Gᵀ rows: its ``tedges`` (host-known, <= ecap)
        # edges fill slots [0, tedges) of the expanded buffer, all valid; a
        # tombstoned base arc is masked through its expanded edge position
        if tedges == 0:        # also an edgeless base: nothing to expand
            return torch.zeros((n,), dtype=torch.int32, device=f.device)
        ids, _ = kops.frontier_compact(f, frontier.cap)
        _, tgt, pos, _ = kops.sparse_expand(t_indptr, t_indices, ids,
                                            frontier.ecap)
        return segment_sum(~tomb_t[pos[:tedges]], tgt[:tedges], n)

    rounds = 0
    while True:
        if known:
            count, tedges = torch.stack(
                [front.sum(), torch.where(front, t_deg, 0).sum()]
            ).tolist()                                        # host sync
            if count == 0:
                break
            use_sparse = (sparse and count <= frontier.cap
                          and tedges <= frontier.ecap)
        else:
            if not bool(front.any()):                         # host sync
                break
            use_sparse = False
        dec = (base_dec_sparse(front, tedges) if use_sparse
               else base_dec_dense(front))
        if n_ins:
            dec = dec + segment_sum(front[ins_tgt] & ins_live, ins_own, n)
        if stats is not None:
            vals = dict(r_frontier=count, r_edges=dec.sum(dtype=torch.int32),
                        r_decrements=(dec * status).sum(dtype=torch.int32))
            if sparse:
                vals["r_sparse"] = int(use_sparse)
            stats.record(rounds, **vals)
        # every vertex's counter moves, the dead ones' too: the values are
        # path-dependent, as in the reference
        counters = counters - dec
        front = status & (counters <= 0)
        status = status & ~front
        rounds += 1
    return (status, counters), rounds, dirty


register_kernel(KernelSpec(name="ac4", run=_run_stream_ac4,
                           needs_transpose=True), family="stream")


# -- results -------------------------------------------------------------------

class StreamResult:
    """Outcome of one ``apply`` batch.

    status:  (n,) bool fixpoint liveness after the batch (device)
    rounds:  propagation rounds this batch ran (an int: the host drove
             them, so nothing is left to fetch)
    dirty:   the batch had a reviving insertion and restarted from the
             from-scratch initialization (still one dispatch)
    round_stats: the batch's per-round :class:`repro_torch.obs.RoundStats`
             when the engine is instrumented, else None
    """

    __slots__ = ("_status", "_rounds", "_dirty", "_round_stats")

    def __init__(self, status, rounds: int, dirty: bool, round_stats=None):
        self._status = status
        self._rounds = rounds
        self._dirty = dirty
        self._round_stats = round_stats

    @property
    def round_stats(self):
        return self._round_stats

    @property
    def status(self):
        return self._status

    @property
    def rounds(self) -> int:
        return self._rounds

    @property
    def dirty(self) -> bool:
        return self._dirty

    @property
    def n_trimmed(self) -> int:
        return int((~self._status).sum())

    def __repr__(self):
        return f"StreamResult(n={self._status.shape[0]})"


# -- the engine ----------------------------------------------------------------

def plan_stream(graph, method: str = "ac4", backend: str = "dense", *,
                capacity: int | None = None,
                load_factor: float | None = None,
                frontier: str = "auto",
                instrument: bool = False,
                max_rounds: int | None = None) -> "StreamEngine":
    """Build a :class:`StreamEngine` over ``graph`` (a :class:`CSRGraph`
    or a pre-built :class:`DeltaCSR`), on the graph's device.

    ``capacity`` (default 256) sizes the insert buffer (rounded up to a
    power of two; the engine compacts or doubles it when a batch would
    overflow).  ``load_factor`` (default 0.5) is the overlay fraction —
    (tombstones + consumed insert slots) / base edges — beyond which
    ``apply`` folds the overlay into a fresh base CSR.  A pre-built
    :class:`DeltaCSR` carries its own sizing, so passing either with one
    raises.

    ``frontier``: "auto" (default) picks the dense or compacted decrement
    each round, "dense"/"sparse" pin one; the results are identical.  The
    capacities are sized once from the base graph and survive compaction.
    ``instrument=True`` attaches per-round stats of ``max_rounds`` slots
    (default ``obs.round_capacity(n)``) to each ``apply`` result and to
    ``retrim()``; ``instrument=False`` ignores ``max_rounds``.
    """
    return StreamEngine(graph, method=method, backend=backend,
                        capacity=capacity, load_factor=load_factor,
                        frontier=frontier, instrument=instrument,
                        max_rounds=max_rounds)


class StreamEngine(EngineBase):
    """Incremental trimming over one mutating graph.  Build with
    :func:`plan_stream`."""

    family = "stream"

    def __init__(self, graph, *, method, backend, capacity, load_factor,
                 frontier="auto", instrument=False, max_rounds=None):
        self.spec = get_kernel(method, family="stream")
        if backend not in STREAM_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {STREAM_BACKENDS}")
        if isinstance(graph, DeltaCSR):
            if capacity is not None or load_factor is not None:
                raise ValueError(
                    "capacity/load_factor are fixed by the DeltaCSR you "
                    "passed; construct it with the sizing you want")
            delta = graph
        else:
            delta = DeltaCSR(graph,
                             capacity=256 if capacity is None else capacity,
                             load_factor=(0.5 if load_factor is None
                                          else load_factor))
        super().__init__(delta.base)
        self.delta = delta
        self.device = delta.device
        self.method = method
        self.backend = backend
        # sized once from the base graph; compaction changes the
        # representation, not the graph, so the plan stays valid
        self.fplan = frontier_plan(frontier, delta.n, delta.m_base)
        self._plan_stats(instrument, max_rounds, delta.n)
        self._last_stats = None
        self._tarrs = None
        self._state = None          # (status bool (n,), counters int32 (n,))
        self._rounds_total = 0
        self._compactions = 0
        if delta.n:
            self.retrim(full=True)  # establish the fixpoint at plan time
        else:
            self._state = (
                torch.zeros((0,), dtype=torch.bool, device=self.device),
                torch.zeros((0,), dtype=torch.int32, device=self.device))

    def plan_signature(self) -> str:
        sig = (f"stream[{self.method}/{self.backend}]"
               f"(n={self.delta.n},m={self.delta.m_base},"
               f"cap={self.delta.capacity})"
               f"+frontier[{self.fplan.mode}]")
        return sig + "+stats" if self.instrument else sig

    def _plan_kwargs(self):
        """The reference's plan kwargs without ``use_kernel``."""
        return {"method": self.method, "backend": self.backend,
                "capacity": self.delta.capacity,
                "load_factor": self.delta.load_factor,
                "frontier": self.fplan.mode, "instrument": self.instrument,
                "max_rounds": self.max_rounds if self.instrument else None}

    def nbytes_breakdown(self):
        # _tarrs[0:2] seed the base transpose cache (counted by the base);
        # the Gᵀ row ids and the base-edge permutation, the DeltaCSR
        # overlay (tombstones, insert buffers, host index) and the fixpoint
        # state are new bytes
        out = super().nbytes_breakdown()
        for k, v in self.delta.nbytes_breakdown().items():
            out[f"delta_{k}"] = v
        if self._tarrs is not None:
            out["transpose_perm"] = obs.array_nbytes(self._tarrs[2:])
        if self._state is not None:
            out["state"] = obs.array_nbytes(self._state)
        return out

    def _stat_names(self):
        names = ("r_frontier", "r_edges", "r_decrements")
        return names + (("r_sparse",) if self.fplan.mode != "dense" else ())

    def _step_stats(self, rounds, bufs):
        """RoundStats of the latest dispatch (zeros for an empty graph's,
        which ran nothing), also kept for ``retrim()``."""
        if not self.instrument:
            return None
        if bufs is None:
            z = np.zeros(self.max_rounds, np.int64)
            rs = obs.RoundStats(0, {}, max_rounds=self.max_rounds,
                                host={k: z for k in self._stat_names()[:3]})
        else:
            rs = self._wrap_stats(rounds, bufs.finish())
        self._last_stats = rs
        return rs

    # -- cached resources --------------------------------------------------
    def _transpose_arrays(self):
        """Base Gᵀ arrays, Gᵀ row ids and the Gᵀ-edge -> base-edge
        permutation, from the overlay's host mirrors by a counting sort;
        rebuilt only after compaction."""
        if self._tarrs is None:
            d = self.delta
            n, m = d.n, d.m_base
            perm = _stable_counting_order(d._dst_np, n)
            t_indptr = np.zeros(n + 1, dtype=np.int64)
            if m:
                np.cumsum(np.bincount(d._dst_np, minlength=n),
                          out=t_indptr[1:])

            def dev(a):
                return torch.from_numpy(a.astype(np.int32)).to(self.device)

            t_indptr, t_indices, perm = (dev(t_indptr), dev(d._src_np[perm]),
                                         dev(perm))
            self._tarrs = (t_indptr, t_indices, row_ids(t_indptr, m), perm)
            # seed the EngineBase cache so .transpose is consistent
            if self._transpose is None:
                self._transpose = CSRGraph(t_indptr, t_indices)
                self._transpose_builds += 1
        return self._tarrs

    # -- host-side batch plumbing ------------------------------------------
    @staticmethod
    def _pairs(edges):
        if edges is None:
            return (np.zeros(0, np.int64),) * 2
        src, dst = edges
        return (np.asarray(src, np.int64).reshape(-1),
                np.asarray(dst, np.int64).reshape(-1))

    def _updates(self, dsrc, ddst, eids, slots_del, isrc, idst, slots_ins):
        """The batch as seven int32 device tensors, in one host-to-device
        copy.  The reference's sentinels (edge id ``m_base`` for a deletion
        that frees an insert slot, slot ``capacity`` for one that
        tombstones a base edge) are dropped here, on the host."""
        d = self.delta
        parts = [np.asarray(p, np.int64) for p in (
            dsrc, ddst, eids[eids < d.m_base], slots_del[slots_del <
                                                         d.capacity],
            isrc, idst, slots_ins)]
        flat = torch.from_numpy(np.concatenate(parts).astype(np.int32))
        return torch.split(flat.to(self.device), [p.size for p in parts])

    def _step(self, full: bool, updates, stats=None):
        d = self.delta
        return self.spec.run(
            self._transpose_arrays(),
            (d.tomb, d.ins_src, d.ins_dst, d.ins_alive), self._state,
            updates, n_ins=d.n_ins, full=full, frontier=self.fplan,
            stats=stats)

    # -- execution ---------------------------------------------------------
    def apply(self, deletions=None, insertions=None) -> StreamResult:
        """Apply one edge-update batch and advance the fixpoint.

        ``deletions`` / ``insertions``: ``(src, dst)`` array pairs.
        Deleting an edge that is not present raises ``ValueError`` and
        leaves the batch unapplied.  One counted dispatch.
        """
        dsrc, ddst = self._pairs(deletions)
        isrc, idst = self._pairs(insertions)
        d = self.delta
        if d.n == 0:
            if dsrc.size or isrc.size:
                raise ValueError("cannot update an empty (n=0) graph")
            return StreamResult(self._state[0], 0, False,
                                self._step_stats(0, None))
        # validate the whole batch before anything commits: a bad
        # insertion must not leave the deletions half-applied
        isrc, idst = check_edge_ids(d.n, isrc, idst)
        # fault point "mid-update-batch": nothing (host mirror or device)
        # has committed, so a fault here is retry-safe with the same
        # batch; past it the host mirrors move before the dispatch
        fplane = get_fault_plane()
        if fplane.enabled:
            fplane.arm("mid-update-batch", family=self.family,
                       deletions=int(dsrc.size), insertions=int(isrc.size))
        if d.n_ins + isrc.size > d.capacity:
            self.compact()          # free the insert buffer first
            if isrc.size > d.capacity:
                d.grow(isrc.size)
        eids, slots_del = d.resolve_deletions(dsrc, ddst)
        slots_ins = d.stage_inserts(isrc, idst)
        bufs = self._buffers()
        state, rounds, dirty = self._dispatch(
            self._step, False,
            self._updates(dsrc, ddst, eids, slots_del, isrc, idst,
                          slots_ins), bufs)
        self._state = state
        self._rounds_total += rounds
        res = StreamResult(state[0], rounds, dirty,
                           self._step_stats(rounds, bufs))
        if d.needs_compact:
            self.compact()
        return res

    def retrim(self, full: bool = False) -> TrimResult:
        """The current trimming fixpoint as a :class:`TrimResult` (int32
        status), bit-identical to a from-scratch AC-4 ``run()`` on
        :meth:`snapshot`.

        ``full=False`` (default) returns the incrementally maintained
        fixpoint: zero dispatches.  ``full=True`` discards the state and
        rebuilds it from scratch over the overlay in one dispatch; it also
        restarts the ``rounds`` total, which ``apply`` accumulates.
        """
        if full and self.delta.n:
            z = np.zeros(0, np.int64)
            bufs = self._buffers()
            self._state, self._rounds_total, _ = self._dispatch(
                self._step, True, self._updates(z, z, z, z, z, z, z), bufs)
            self._step_stats(self._rounds_total, bufs)
        return TrimResult(status=self._state[0].to(torch.int32),
                          rounds=self._rounds_total,
                          round_stats=self._last_stats)

    # -- checkpoint/resume (DESIGN.md §14) ---------------------------------
    def state_dict(self):
        """The DeltaCSR overlay (base, tombstones, insert buffers) and the
        persistent AC-4 state; ``rounds_total`` as the reference's 0-d
        int32.  The base CSR is the graph, and the transpose caches are
        rebuilt from the restored host mirrors."""
        out = dict(self.delta.state_dict())
        out["status"] = self._state[0]
        out["counters"] = self._state[1]
        out["rounds_total"] = np.asarray(self._rounds_total, np.int32)
        return out

    def state_meta(self):
        meta = super().state_meta()
        meta["delta"] = self.delta.state_meta()
        meta["compactions"] = self._compactions
        return meta

    def load_state(self, tree, meta):
        """Overwrite the overlay and the fixpoint state with a
        checkpoint's exact arrays.  The AC-4 counters are restored
        verbatim, not recomputed, so a resumed engine is bit-identical to
        the uninterrupted one, counters included.  The transpose caches
        are functions of the base alone: kept when the saved base is the
        one this engine was planned over."""
        self._check_family(meta)
        base = self.delta.base
        self.delta.load_state(tree, meta["delta"])
        if self.delta.base is not base:
            self.graph = self.delta.base
            self._transpose = None
            self._invalidate_caches()

        def dev(name, dtype):
            return torch.from_numpy(np.array(tree[name], dtype)).to(
                self.device)

        self._state = (dev("status", bool), dev("counters", np.int32))
        self._rounds_total = int(np.asarray(tree["rounds_total"]))
        self._dispatches = int(meta.get("dispatches", 0))
        self._transpose_builds = int(meta.get("transpose_builds", 0))
        self._compactions = int(meta.get("compactions", 0))
        self._last_stats = None

    def _invalidate_caches(self):
        self._tarrs = None

    def snapshot(self) -> CSRGraph:
        """Materialize the current graph (base minus tombstones plus live
        inserts) as a standalone :class:`CSRGraph`; the overlay is kept."""
        return self.delta.materialize()

    def compact(self):
        """Fold the overlay into a fresh base CSR (O(n+m) counting sort)
        and drop the transpose caches.  The fixpoint state is untouched:
        compaction changes the representation, not the graph."""
        self.graph = self.delta.compact()
        self._transpose = None
        self._tarrs = None
        self._compactions += 1

    @property
    def compactions(self) -> int:
        return self._compactions

    @property
    def status(self):
        """The persistent (n,) bool liveness fixpoint, on the device."""
        return self._state[0]


__all__ = ["plan_stream", "StreamEngine", "StreamResult", "STREAM_BACKENDS"]
