"""Plan-once bucketed k-core peeling on the AC-4 counter substrate —
PyTorch port of ``src/repro/core/peel.py``.

AC-4 trimming keeps live out-degree counters and removes vertices whose
counter reaches zero: the ``k = 1`` instance of out-degree k-core
peeling.  :class:`PeelEngine` runs the same loop with a moving threshold
and computes the full out-degree *coreness* of every vertex; each
``k_core(k)`` mask is then one comparison, and the ``k = 1`` live mask is
bit-identical to :class:`~repro_torch.core.engine.TrimEngine` AC-4.

Each round

1. jumps the bucket level to ``max(k, min counter among alive)`` (it
   never retreats below a cascade),
2. extracts the bucket's frontier ``alive & (counters <= k)`` through the
   ``bucket_peel`` Hopper kernel, which reads ``k`` on the device,
3. assigns the frontier its coreness ``k`` and its peel round, and
   subtracts the decrements through Gᵀ: a segment sum over all Gᵀ edges
   (dense) or over only the frontier's Gᵀ rows, compacted by
   ``frontier_compact`` and expanded by ``sparse_expand`` (sparse).

The round loop is driven from the host with one sync per round: the
loop test, which with a non-dense frontier plan also brings back the
bucket's member count and Gᵀ degree sum that choose the dense or sparse
decrement.  The next bucket is extracted before that test (its level
stays on the device), so a finished run launches one extraction that it
does not use.  ``run_batch`` runs its rows one after another in one
counted dispatch, each with the plan's frontier.

Lifecycle (family ``"peel"`` in the kernel registry)::

    engine = plan_peel(graph)
    res    = engine.run()              # full coreness, one dispatch
    res    = engine.run(k=1)           # early exit: peel below the k-core
    res    = engine.run_batch(masks)   # B induced subgraphs, one dispatch
    res.coreness                       # (n,) int32 peel values (device)
    res.k_core(3)                      # (n,) bool mask, one comparison
    res.degeneracy_order()             # host peel-order permutation
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..kernels import ops as kops
from .common import FrontierPlan, frontier_plan, segment_sum
from .engine import _to
from .enginebase import EngineBase
from .graph import CSRGraph, resolve_device, row_ids
from .registry import KernelSpec, get_kernel, register_kernel

_INT32_MAX = torch.iinfo(torch.int32).max


# -- the kernel (family "peel") ------------------------------------------------

def peel_bucket_kernel(indptr, indices, t_indptr, t_indices, t_rows,
                       active, *, k_stop, frontier: FrontierPlan =
                       FrontierPlan(), src=None, stats=None):
    """Bucketed out-degree peeling to the coreness fixpoint.

    ``active``: (n,) bool — peel the induced subgraph (inactive vertices
    get coreness -1 and count toward no counter).  ``k_stop``: ``None``
    peels everything (full coreness); an int peels only buckets below
    ``k_stop``, so the survivors are exactly the ``k_stop``-core
    (``k_stop = 1`` is AC-4 trimming).  ``t_rows``: (mT,) source of each
    Gᵀ edge; ``src``: (m,) source of each G edge (built when not given).

    ``stats`` (a :class:`~repro_torch.obs.RoundBuffers` over
    ``r_frontier``, ``r_edges``, ``r_k`` and, on a non-dense plan,
    ``r_sparse``; or ``None``) records each round's bucket size, the Gᵀ
    edges its decrement traverses and the level ``k`` peeled (a per-slot
    value, meaningful within the round capacity); the counter
    initialization's edge scan is charged to slot 0.  An instrumented run
    brings the bucket's count and degree sum back in its loop test on
    every plan; ``k`` stays on the card.

    Returns ``(coreness, peel_round, rounds)``: (n,) int32 peel value
    (survivors of a bounded run get ``k_stop``; inactive vertices -1),
    (n,) int32 round at which each vertex peeled (-1 for survivors and
    inactive vertices), and the 0-d int32 round count.
    """
    n = indptr.shape[0] - 1
    dev = indptr.device
    if src is None:
        src = row_ids(indptr, indices.shape[0])
    # induced live out-degree: the AC-4 counter initialization
    counters = segment_sum(active[src] & active[indices], src, n)
    if stats is not None:
        stats.record(0, r_edges=counters.sum(dtype=torch.int32))
    sparse = frontier.mode != "dense"
    known = sparse or stats is not None
    t_deg = t_indptr[1:] - t_indptr[:-1]

    def dense_dec(front):
        return segment_sum(front[t_rows], t_indices, n)

    def sparse_dec(front, edges: int):
        # the same vector from only the bucket's Gᵀ rows.  The bucket's
        # ``edges`` (host-known, <= ecap) in-edges fill slots [0, edges);
        # the add covers only those, so the invalid slots (tgt = 0) cost
        # no atomics on vertex 0
        ids, _ = kops.frontier_compact(front, frontier.cap)
        _, tgt, _, valid = kops.sparse_expand(t_indptr, t_indices, ids,
                                              frontier.ecap)
        return segment_sum(valid[:edges], tgt[:edges], n)

    alive = active
    coreness = torch.full((n,), -1, dtype=torch.int32, device=dev)
    peel_round = torch.full((n,), -1, dtype=torch.int32, device=dev)
    k = torch.zeros((1,), dtype=torch.int32, device=dev)
    rounds = 0
    while True:
        # the next bucket: jump to the least live counter, never below k
        minc = torch.where(alive, counters, _INT32_MAX).amin()
        k_next = torch.maximum(k, minc)
        front = kops.bucket_peel(counters, alive, k_next)
        go = (alive.any() if k_stop is None
              else (alive & (counters < k_stop)).any())
        if known:
            go, count, edges = torch.stack(
                [go.to(torch.int64), front.sum(),
                 torch.where(front, t_deg, 0).sum()]).tolist()  # host sync
            use_sparse = (sparse and count <= frontier.cap
                          and edges <= frontier.ecap)
        else:
            go, use_sparse = bool(go), False                  # host sync
        if not go:
            break
        if stats is not None:
            # the decrement traverses every Gᵀ edge of the bucket: edges
            vals = dict(r_frontier=count, r_edges=edges, r_k=k_next)
            if sparse:
                vals["r_sparse"] = int(use_sparse)
            stats.record(rounds, **vals)
        dec = sparse_dec(front, edges) if use_sparse else dense_dec(front)
        counters = counters - dec
        coreness = torch.where(front, k_next, coreness)
        peel_round = torch.where(front, rounds, peel_round)
        alive = alive & ~front
        k = k_next
        rounds += 1
    if k_stop is not None:
        # survivors of a bounded run are exactly the k_stop-core
        coreness = torch.where(alive, k_stop, coreness)
    return (coreness, peel_round,
            torch.tensor(rounds, dtype=torch.int32, device=dev))


def _run_bucket(graph_arrays, transpose_arrays, active, *, k_stop,
                frontier=FrontierPlan(), stats=None):
    indptr, indices, src = graph_arrays
    t_indptr, t_indices, t_rows = transpose_arrays
    return peel_bucket_kernel(indptr, indices, t_indptr, t_indices, t_rows,
                              active, k_stop=k_stop, frontier=frontier,
                              src=src, stats=stats)


register_kernel(KernelSpec(name="bucket", run=_run_bucket,
                           needs_transpose=True), family="peel")


# -- results -------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PeelResult:
    """Output of a peeling run — device-resident, lazily materialized.

    coreness:   (n,) int32 for ``run`` / (B, n) for ``run_batch`` — the
                largest k with v in the k-core.  Inactive vertices hold
                -1; a bounded ``run(k=j)`` clamps survivors at ``j``.
    peel_round: (n,) / (B, n) int32 — round at which the vertex peeled;
                -1 for survivors of a bounded run and inactive vertices.
    rounds:     rounds executed (an int / a (B,) int32 array); moves to
                the host on first access.
    round_stats: per-round :class:`repro_torch.obs.RoundStats` (bucket
                size, Gᵀ edges traversed, level ``k``); None unless the
                plan had ``instrument=True``.
    """

    __slots__ = ("_coreness", "_peel_round", "_rounds", "_k_stop",
                 "_round_stats")

    def __init__(self, coreness, peel_round, rounds, k_stop=None,
                 round_stats=None):
        self._coreness = coreness
        self._peel_round = peel_round
        self._rounds = rounds
        self._k_stop = k_stop
        self._round_stats = round_stats

    @property
    def coreness(self):
        return self._coreness

    @property
    def round_stats(self):
        return self._round_stats

    @property
    def peel_round(self):
        return self._peel_round

    @property
    def rounds(self):
        r = self._rounds
        if isinstance(r, torch.Tensor):
            arr = r.cpu().numpy()
            self._rounds = int(arr) if arr.ndim == 0 else arr
        return self._rounds

    @property
    def k_stop(self):
        return self._k_stop

    # -- derived masks -----------------------------------------------------
    def k_core(self, k: int):
        """(n,) / (B, n) bool — the k-core (the maximal induced subgraph
        of min live out-degree >= k).  ``k_core(0)`` is the active set,
        ``k_core(1)`` the trimmed live mask.  A bounded run only answers
        ``k <= k_stop``."""
        if self._k_stop is not None and k > self._k_stop:
            raise ValueError(
                f"this result was peeled with k={self._k_stop}; cores "
                f"above it were not computed (asked for k={k})")
        return self._coreness >= k

    @property
    def status(self):
        """(n,) / (B, n) int32 LIVE/DEAD mask of the (``k_stop`` or
        1)-core — bit-identical to AC-4 trimming for ``k = 1``."""
        core = self.k_core(1 if self._k_stop is None else self._k_stop)
        return (core.to(torch.int32) if isinstance(core, torch.Tensor)
                else core.astype(np.int32))

    @property
    def max_core(self):
        """Largest coreness present (an int for ``run``, a (B,) int64
        array for ``run_batch``); 0 when nothing is active."""
        arr = _host(self._coreness)
        if arr.shape[-1] == 0:
            z = np.zeros(arr.shape[:-1], np.int64)
            return int(z) if z.ndim == 0 else z
        mx = np.maximum(arr, 0).max(axis=-1).astype(np.int64)
        return int(mx) if mx.ndim == 0 else mx

    def degeneracy_order(self) -> np.ndarray:
        """Peel-order permutation (host): peeled vertices sorted stably by
        peel round.  Every vertex has at most ``coreness(v)``
        out-neighbors peeled in its own round or later.  Survivors of a
        bounded run are omitted; single-graph results only."""
        rounds = _host(self._peel_round)
        if rounds.ndim != 1:
            raise ValueError("degeneracy_order is per-graph; index a "
                             "batched result row first")
        order = np.argsort(rounds, kind="stable")
        return order[rounds[order] >= 0]

    def materialize(self) -> "PeelResult":
        """Force every field to the host (numpy arrays, python ints)."""
        self._coreness = _host(self._coreness).astype(np.int32)
        self._peel_round = _host(self._peel_round).astype(np.int32)
        _ = self.rounds
        return self

    def __repr__(self):
        kind = "numpy" if isinstance(self._coreness, np.ndarray) else "device"
        return (f"PeelResult(shape={tuple(self._coreness.shape)}, {kind}, "
                f"k_stop={self._k_stop})")


# -- the engine ----------------------------------------------------------------

def plan_peel(graph: CSRGraph, method: str = "bucket", *,
              transpose: CSRGraph | None = None, frontier: str = "auto",
              instrument: bool = False, max_rounds: int | None = None,
              device="cuda") -> "PeelEngine":
    """Build a :class:`PeelEngine` for ``graph`` on ``device`` (the graph
    and a pre-seeded ``transpose`` move there; a missing CUDA device
    raises).

    ``transpose`` pre-seeds the Gᵀ cache (shared with a TrimEngine over
    the same graph).  ``frontier``: "auto" (default) picks the dense or
    compacted decrement each round, "dense"/"sparse" pin one; the results
    are identical.  ``instrument=True`` attaches per-round stats to every
    result; a full-coreness peel can take up to n rounds, so pass
    ``max_rounds`` to size the buffers (the tail of a longer run folds
    into the last slot).
    """
    return PeelEngine(graph, method=method, transpose=transpose,
                      frontier=frontier, instrument=instrument,
                      max_rounds=max_rounds, device=device)


class PeelEngine(EngineBase):
    """k-core peeling over one graph on one device.  Build with
    :func:`plan_peel`."""

    family = "peel"

    def __init__(self, graph, *, method, transpose, frontier="auto",
                 instrument=False, max_rounds=None, device="cuda"):
        self.spec = get_kernel(method, family="peel")  # raises on unknown
        dev = resolve_device(device)
        super().__init__(_to(graph, dev), transpose=_to(transpose, dev))
        self.device = dev
        self.method = method
        self.fplan = frontier_plan(frontier, graph.n, graph.m)
        self._plan_stats(instrument, max_rounds, graph.n)
        self._invalidate_caches()

    def plan_signature(self) -> str:
        """The reference's signature string for the same plan."""
        sig = (f"peel[{self.method}]"
               f"(n={self.graph.n},m={self.graph.m})"
               f"+frontier[{self.fplan.mode}]")
        return sig + "+stats" if self.instrument else sig

    def _plan_kwargs(self):
        """The reference's plan kwargs without ``use_kernel``."""
        return {"method": self.method, "frontier": self.fplan.mode,
                "instrument": self.instrument,
                "max_rounds": self.max_rounds if self.instrument else None}

    def _invalidate_caches(self):
        self._garrs = None
        self._tarrs = None

    def nbytes_breakdown(self):
        # _garrs[0:2] / _tarrs[0:2] alias the graph and the cached
        # transpose (counted by the base); the row ids are new bytes
        out = super().nbytes_breakdown()
        if self._garrs is not None:
            out["edge_src"] = obs.array_nbytes(self._garrs[2])
        if self._tarrs is not None:
            out["row_ids"] = obs.array_nbytes(self._tarrs[2])
        return out

    def _stat_names(self):
        names = ("r_frontier", "r_edges", "r_k")
        return names + (("r_sparse",) if self.fplan.mode != "dense" else ())

    # -- cached resources --------------------------------------------------
    def _graph_arrays(self):
        if self._garrs is None:
            g = self.graph
            self._garrs = (g.indptr, g.indices, row_ids(g.indptr, g.m))
        return self._garrs

    def _transpose_arrays(self):
        if self._tarrs is None:
            gt = self.transpose
            self._tarrs = (gt.indptr, gt.indices, row_ids(gt.indptr, gt.m))
        return self._tarrs

    @staticmethod
    def _check_k(k):
        if k is not None and (not isinstance(k, (int, np.integer))
                              or isinstance(k, (bool, np.bool_)) or k < 0):
            raise ValueError(f"k must be None (full coreness) or an int "
                             f">= 0, got {k!r}")
        return None if k is None else int(k)

    def _peel(self, active, k, stats=None):
        return self.spec.run(self._graph_arrays(), self._transpose_arrays(),
                             active, k_stop=k, frontier=self.fplan,
                             stats=stats)

    # -- execution ---------------------------------------------------------
    def run(self, k: int | None = None, active=None) -> PeelResult:
        """Peel (the ``active``-induced subgraph of) the planned graph.

        ``k=None`` computes the full coreness in one dispatch.  ``k=j``
        peels only buckets below ``j`` and stops once the j-core remains:
        ``run(k=1)`` does AC-4 trimming's work, and its ``status`` is
        bit-identical to TrimEngine AC-4.
        """
        k = self._check_k(k)
        n, m = self.graph.n, self.graph.m
        act = (torch.ones((n,), dtype=torch.bool, device=self.device)
               if active is None else self._as_mask(active, (n,),
                                                  "active mask"))
        if n == 0 or m == 0:
            return self._degenerate(act, k)
        bufs = self._buffers()
        core, rnd, rounds = self._dispatch(self._peel, act, k, bufs)
        return PeelResult(core, rnd, rounds, k_stop=k,
                          round_stats=self._wrap_stats(
                              rounds, bufs and bufs.finish()))

    def run_batch(self, active_masks, k: int | None = None) -> PeelResult:
        """Peel B induced subgraphs in one counted dispatch.

        ``active_masks``: (B, n) bool.  Returns one :class:`PeelResult`
        with stacked (B, n) ``coreness``/``peel_round`` and (B,) rounds,
        equal row-wise to sequential ``run()`` calls.
        """
        k = self._check_k(k)
        n, m = self.graph.n, self.graph.m
        if np.ndim(active_masks) != 2 or np.shape(active_masks)[1] != n:
            raise ValueError(f"active_masks must be (B, {n}) bool, got "
                             f"{tuple(np.shape(active_masks))}")
        masks = self._as_mask(active_masks, tuple(np.shape(active_masks)),
                            "active_masks")
        if n == 0 or m == 0:
            return self._degenerate(masks, k)
        b = masks.shape[0]
        bufs = [self._buffers() for _ in range(b)]

        def batch():
            rows = [self._peel(masks[i], k, bufs[i]) for i in range(b)]
            if not rows:
                z = torch.zeros((0, n), dtype=torch.int32,
                                device=self.device)
                return z, z.clone(), torch.zeros(
                    (0,), dtype=torch.int32, device=self.device)
            return tuple(torch.stack(col) for col in zip(*rows))

        core, rnd, rounds = self._dispatch(batch)
        return PeelResult(core, rnd, rounds, k_stop=k,
                          round_stats=self._wrap_stats(
                              rounds, self._finish_rows(bufs)))

    # -- degenerate paths (no dispatch, still device-resident) -------------
    def _degenerate(self, act, k):
        """n == 0 or m == 0: every active vertex has out-degree 0, so the
        whole graph is the zero bucket — coreness 0 in one round (no
        rounds for k == 0, where nothing peels).  Mirrors
        ``TrimEngine._degenerate``: no dispatch, the kernel path's dtypes
        and device."""
        i32 = dict(dtype=torch.int32, device=self.device)
        lead = act.shape[:-1]
        core = torch.where(act, 0, -1).to(torch.int32)
        if k == 0:
            rnd = torch.full(act.shape, -1, **i32)
            rounds = torch.zeros(lead, **i32)
            peeled = torch.zeros(lead + (1,), **i32)
        else:
            rnd = core.clone()
            rounds = torch.ones(lead, **i32)
            peeled = act.sum(dim=-1, dtype=torch.int32)[..., None]
        rs = None
        if self.instrument:
            frontier = torch.nn.functional.pad(peeled,
                                               (0, self.max_rounds - 1))
            zeros = torch.zeros_like(frontier)
            rs = obs.RoundStats(rounds, {"r_frontier": frontier,
                                         "r_edges": zeros, "r_k": zeros},
                                max_rounds=self.max_rounds)
        return PeelResult(core, rnd, rounds, k_stop=k, round_stats=rs)


# -- host oracle ---------------------------------------------------------------

def coreness_oracle(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Matula–Beck out-degree coreness (numpy/python) — the test oracle
    (copy of the reference's).

    Repeatedly removes one minimum-live-out-degree vertex; the running
    maximum of removal degrees is the removed vertex's coreness.  One
    vertex at a time and no buckets, so it is structurally different
    from the engine's bucketed cascade.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    preds: list[list[int]] = [[] for _ in range(n)]
    for v in range(n):
        for e in range(indptr[v], indptr[v + 1]):
            preds[int(indices[e])].append(v)
    alive = np.ones(n, bool)
    core = np.full(n, -1, np.int64)
    k = 0
    for _ in range(n):
        cand = np.nonzero(alive)[0]
        v = cand[np.argmin(deg[cand])]
        k = max(k, int(deg[v]))
        core[v] = k
        alive[v] = False
        for u in preds[v]:
            if alive[u]:
                deg[u] -= 1
    return core


__all__ = ["plan_peel", "PeelEngine", "PeelResult", "peel_bucket_kernel",
           "coreness_oracle"]
