"""Plan-once / run-many reachability engine — PyTorch port of
``src/repro/core/reach.py``.

The FW-BW SCC driver (``core/scc.py``) spends its non-trim time in BFS
reachability.  :class:`ReachEngine` runs that sweep on the device over
dense (n,) masks, one counted dispatch per query::

    engine = plan_reach(graph, backend="dense")
    res    = engine.run(seeds=pivot, active=mask)       # ReachResult
    res    = engine.run_batch(seed_masks, active_masks) # one dispatch

Two frontier-expansion methods, registered under family ``"reach"``:

    "push" (backend="dense")    — per-edge: an edge fires when its source
        is on the frontier, and True is written at every fired edge's
        target.  O(m) dense work per round, no transpose.
    "pull" (backend="windowed") — per-vertex over *in*-neighbors (Gᵀ): an
        (n, W) frontier-membership tile reduced by the ``frontier_expand``
        Hopper kernel (pending rows only), plus a whole-row OR over Gᵀ for
        the vertices whose in-degree exceeds the window and found nothing
        in it.  The static window tile is built once per engine.

Both reach the same fixpoint: the vertices reachable from ``seeds``
inside the ``active``-induced subgraph.

Each sweep is driven from the host, one sync per round: the loop test,
which with a non-dense frontier plan also brings back the frontier's
out-edge count and decides the dense/sparse body (the reference's
``lax.cond``).  The pull body's gated continuation costs one more sync
in the rounds where some pending vertex overflows the window (the
reference's ``lax.cond(any(rest))``).  ``run_batch`` runs its rows one
after another in one counted dispatch, each with the single-run body and
the plan's frontier; the reference vmaps them, falls back to the whole-row
OR and pins the dense frontier, which gives the same masks and rounds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .common import FrontierPlan, frontier_plan
from .engine import _to
from .enginebase import EngineBase
from .graph import CSRGraph, resolve_device, row_ids
from .registry import KernelSpec, get_kernel, register_kernel

REACH_BACKENDS = ("dense", "windowed")


def _mark(n: int, targets, ok):
    """(n,) bool with True at ``targets[ok]``: every write is True, so
    duplicate targets need no atomics.  Slots with ``ok`` False write to a
    sentinel slot n that is cut off (torch has no ``mode="drop"``)."""
    buf = torch.zeros((n + 1,), dtype=torch.bool, device=targets.device)
    buf[torch.where(ok, targets, n)] = True
    return buf[:n]


def _sweep(seeds, active, dense_new, sparse_new, out_deg,
           frontier: FrontierPlan):
    """The BSP loop shared by both methods.  ``dense_new(frontier,
    pending)`` and ``sparse_new(frontier, pending, edges)`` give the newly
    reached vertices; ``out_deg`` is the out-degree the sparse body
    expands (the rows of G), and ``edges`` the frontier's host-known sum
    of it.  Returns ``(visited, rounds)``; ``rounds`` counts expansions
    executed."""
    visited = seeds & active
    front = visited
    sparse = frontier.mode != "dense"
    rounds = 0
    while True:
        if sparse:
            count, edges = torch.stack(
                [front.sum(), torch.where(front, out_deg, 0).sum()]
            ).tolist()                                       # host sync
            if count == 0:
                break
            use_sparse = count <= frontier.cap and edges <= frontier.ecap
        else:
            if not bool(front.any()):                        # host sync
                break
            use_sparse = False
        pending = active & ~visited
        new = (sparse_new(front, pending, edges) if use_sparse
               else dense_new(front, pending))
        visited = visited | new
        front = new
        rounds += 1
    return visited, torch.tensor(rounds, dtype=torch.int32,
                                 device=seeds.device)


def _sparse_push(indptr, indices, frontier: FrontierPlan):
    """Compacted push body: expand only the frontier's CSR rows of G
    (``frontier_compact`` -> ``sparse_expand``) and mark their targets.
    The frontier's ``edges`` (<= ecap) out-edges fill slots [0, edges) of
    the expanded buffer; only those are marked."""
    n = indptr.shape[0] - 1

    def new(front, pending, edges: int):
        ids, _ = kops.frontier_compact(front, frontier.cap)
        _, tgt, _, valid = kops.sparse_expand(indptr, indices, ids,
                                              frontier.ecap)
        return pending & _mark(n, tgt[:edges], valid[:edges])
    return new


def reach_push_kernel(indptr, indices, edge_src, seeds, active, *,
                      frontier: FrontierPlan = FrontierPlan()):
    """Forward reachability by per-edge push (one dense O(m) pass per
    round).  ``edge_src``: (m,) int32 source of each edge.  Rounds whose
    frontier fits ``frontier.cap`` members and ``frontier.ecap`` out-edges
    expand only the frontier's rows; the masks are identical.  Returns
    ``(visited (n,) bool, rounds 0-d int32)``."""
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]

    def dense_new(front, pending):
        return pending & _mark(n, indices, front[edge_src])

    return _sweep(seeds, active, dense_new,
                  _sparse_push(indptr, indices, frontier), deg, frontier)


def window_tile(t_indptr, t_indices, window: int):
    """The static (n, W) pull tile over Gᵀ: ``win_sources`` (int32, the
    j-th in-neighbor of each vertex, clamped into range) and ``valid``
    (bool, j < in-degree)."""
    m = t_indices.shape[0]
    t_deg = t_indptr[1:] - t_indptr[:-1]
    offs = torch.arange(window, dtype=torch.int32, device=t_indptr.device)
    valid = offs[None, :] < t_deg[:, None]
    addr = (t_indptr[:-1, None] + offs[None, :]).clamp_(0, max(m - 1, 0))
    return t_indices[addr], valid


def reach_pull_kernel(t_indptr, t_indices, seeds, active, *, window: int,
                      overflow: bool = True, fwd=None,
                      frontier: FrontierPlan = FrontierPlan(), tile=None):
    """Forward reachability by pull over in-neighbors (Gᵀ).

    Dense round: gather the frontier membership of every vertex's first
    ``window`` in-neighbors into an (n, W) tile and reduce it with the
    ``frontier_expand`` kernel (pending rows only).  When ``overflow``
    (some in-degree exceeds the window; a static fact of the graph) and
    some pending vertex of in-degree > W found nothing in its window, a
    whole-row OR over Gᵀ (exclusive prefix sum of per-edge hits,
    differenced at the row boundaries) completes those vertices.

    Sparse round (non-dense ``frontier``): the frontier's *forward* CSR
    rows (``fwd`` = the G arrays) are expanded and their targets marked —
    "v has an in-neighbor on the frontier" and "a frontier out-edge lands
    on v" are the same predicate, so the masks are identical.

    ``tile``: the ``window_tile`` of Gᵀ, built here when not given (an
    engine builds it once).  Returns ``(visited, rounds)``.
    """
    t_deg = t_indptr[1:] - t_indptr[:-1]
    sparse = frontier.mode != "dense"
    if sparse and fwd is None:
        raise ValueError("sparse-frontier pull needs the forward CSR "
                         "arrays (fwd=(indptr, indices))")
    win_sources, valid = (window_tile(t_indptr, t_indices, window)
                          if tile is None else tile)
    wide = t_deg > window if overflow else None

    def row_hits(front):
        # int32 prefix sum: the counts are <= m < 2^31
        csum = torch.nn.functional.pad(
            torch.cumsum(front[t_indices], dim=0, dtype=torch.int32), (1, 0))
        return (csum[t_indptr[1:]] - csum[t_indptr[:-1]]) > 0

    def dense_new(front, pending):
        hit = kops.frontier_expand(front[win_sources], valid, pending)
        if not overflow:
            return hit            # no vertex overflows the window: exact
        rest = pending & ~hit & wide
        if not bool(rest.any()):                             # host sync
            return hit
        return hit | (rest & row_hits(front))

    if sparse:
        f_indptr, f_indices = fwd
        f_deg = f_indptr[1:] - f_indptr[:-1]
        sparse_new = _sparse_push(f_indptr, f_indices, frontier)
    else:
        f_deg, sparse_new = None, None
    return _sweep(seeds, active, dense_new, sparse_new, f_deg, frontier)


def _run_push(graph_arrays, transpose_arrays, seeds, active, *, window,
              overflow=False, frontier=FrontierPlan(), tile=None):
    del transpose_arrays, window, overflow, tile
    indptr, indices, edge_src = graph_arrays
    return reach_push_kernel(indptr, indices, edge_src, seeds, active,
                             frontier=frontier)


def _run_pull(graph_arrays, transpose_arrays, seeds, active, *, window,
              overflow=True, frontier=FrontierPlan(), tile=None):
    indptr, indices, _ = graph_arrays
    t_indptr, t_indices = transpose_arrays
    return reach_pull_kernel(t_indptr, t_indices, seeds, active,
                             window=window, overflow=overflow,
                             fwd=(indptr, indices), frontier=frontier,
                             tile=tile)


register_kernel(KernelSpec(name="push", run=_run_push,
                           needs_transpose=False), family="reach")
register_kernel(KernelSpec(name="pull", run=_run_pull,
                           needs_transpose=True, supports_windowed=True),
                family="reach")


# -- results -------------------------------------------------------------------

class ReachResult:
    """Output of a reachability run — device-resident, lazily materialized.

    mask:   (n,) bool for ``run`` / (B, n) bool for ``run_batch`` —
            vertices reachable from the seeds inside the active subgraph
            (seeds included).
    rounds: frontier expansions executed (an int, or a (B,) int32 array
            for a batch); moves to the host on first access.
    """

    __slots__ = ("_mask", "_rounds", "_n_reached")

    def __init__(self, mask, rounds):
        self._mask = mask
        self._rounds = rounds
        self._n_reached = None

    @property
    def mask(self):
        return self._mask

    @property
    def rounds(self):
        r = self._rounds
        if isinstance(r, torch.Tensor):
            arr = r.cpu().numpy()
            self._rounds = int(arr) if arr.ndim == 0 else arr
        return self._rounds

    @property
    def n_reached(self):
        """Vertices reached: an int for a single query, a (B,) int64
        array for a batch."""
        if self._n_reached is None:
            mask = self._mask
            counts = (mask.sum(dim=-1).cpu().numpy()
                      if isinstance(mask, torch.Tensor)
                      else mask.sum(axis=-1))
            self._n_reached = (int(counts) if np.ndim(counts) == 0
                               else np.asarray(counts, np.int64))
        return self._n_reached

    def materialize(self) -> "ReachResult":
        """Force every field to the host (numpy mask, python ints)."""
        if isinstance(self._mask, torch.Tensor):
            self._mask = self._mask.cpu().numpy()
        _ = self.rounds
        return self

    def __repr__(self):
        kind = "numpy" if isinstance(self._mask, np.ndarray) else "device"
        return f"ReachResult(shape={tuple(self._mask.shape)}, {kind})"


# -- the engine ----------------------------------------------------------------

def plan_reach(graph: CSRGraph, backend: str = "dense", *,
               window: int = 16, transpose: CSRGraph | None = None,
               frontier: str = "auto", instrument: bool = False,
               device="cuda") -> "ReachEngine":
    """Build a :class:`ReachEngine` for ``graph`` on ``device`` (the graph
    and a pre-seeded ``transpose`` move there; a missing CUDA device
    raises).

    ``backend``: "dense" (push) or "windowed" (pull through the
    ``frontier_expand`` kernel).  ``transpose`` pre-seeds the Gᵀ cache.
    ``frontier``: "auto" (default) picks the dense or compacted body each
    round, "dense"/"sparse" pin one; the masks are identical.
    ``instrument=True`` (per-round stats) is not ported yet and raises.
    """
    return ReachEngine(graph, backend=backend, window=window,
                       transpose=transpose, frontier=frontier,
                       instrument=instrument, device=device)


class ReachEngine(EngineBase):
    """Reachability over one graph on one device.  Build with
    :func:`plan_reach`."""

    family = "reach"

    def __init__(self, graph, *, backend, window, transpose,
                 frontier="auto", instrument=False, device="cuda"):
        if backend not in REACH_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{REACH_BACKENDS}")
        if instrument:
            raise NotImplementedError(
                "instrument=True (per-round stats) is not ported yet: "
                "ROADMAP A7")
        dev = resolve_device(device)
        super().__init__(_to(graph, dev), transpose=_to(transpose, dev))
        self.device = dev
        self.backend = backend
        self.method = "pull" if backend == "windowed" else "push"
        self.spec = get_kernel(self.method, family="reach")
        self.window = window
        self.fplan = frontier_plan(frontier, graph.n, graph.m)
        self._garrs = None
        self._tarrs = None
        self._overflow = None
        self._tile = None

    def plan_signature(self) -> str:
        """The reference's signature string for the same plan."""
        return (f"reach[{self.method}/{self.backend}]"
                f"(n={self.graph.n},m={self.graph.m})"
                f"+frontier[{self.fplan.mode}]")

    def _plan_kwargs(self):
        """The reference's plan kwargs without ``use_kernel``;
        ``instrument`` / ``max_rounds`` keep their defaults (ROADMAP
        A7)."""
        return {"backend": self.backend, "window": self.window,
                "frontier": self.fplan.mode, "instrument": False,
                "max_rounds": None}

    # -- cached arrays -----------------------------------------------------
    def _graph_arrays(self):
        if self._garrs is None:
            g = self.graph
            edge_src = (row_ids(g.indptr, g.m)
                        if self.method == "push" else None)
            self._garrs = (g.indptr, g.indices, edge_src)
        return self._garrs

    def _transpose_arrays(self):
        if not self.spec.needs_transpose:
            return None
        if self._tarrs is None:
            gt = self.transpose
            self._tarrs = (gt.indptr, gt.indices)
        return self._tarrs

    def _has_overflow(self) -> bool:
        """Static per-graph fact: does any in-degree exceed the window?
        Computed once (one sync) and cached."""
        if self.method != "pull":
            return False
        if self._overflow is None:
            indptr = self.transpose.indptr
            deg = indptr[1:] - indptr[:-1]
            self._overflow = bool(deg.numel()
                                  and int(deg.max()) > self.window)
        return self._overflow

    def _window_tile(self):
        """The (n, W) pull tile, built at most once per engine and kept
        on the device (268 MB of int32 at n = 2^22, W = 16)."""
        if self.method != "pull":
            return None
        if self._tile is None:
            t_indptr, t_indices = self._transpose_arrays()
            self._tile = window_tile(t_indptr, t_indices, self.window)
        return self._tile

    # -- mask plumbing -----------------------------------------------------
    def _seed_mask(self, seeds):
        n = self.graph.n
        if isinstance(seeds, (bool, np.bool_)):
            # bool is an int subclass: a stray True would silently read
            # as vertex 1
            raise ValueError("seeds must be a vertex id or an (n,) bool "
                             "mask, got a scalar bool")
        if isinstance(seeds, (int, np.integer)):
            if not 0 <= seeds < n:
                raise ValueError(f"seed vertex {seeds} out of range [0, {n})")
            mask = torch.zeros((n,), dtype=torch.bool, device=self.device)
            mask[int(seeds)] = True
            return mask
        if np.shape(seeds) != (n,):
            raise ValueError(f"seeds must be a vertex id or an ({n},) bool "
                             f"mask, got shape {tuple(np.shape(seeds))}")
        return self._as_mask(seeds, (n,), "seeds")

    def _active_mask(self, active, shape):
        if active is None:
            return torch.ones(shape, dtype=torch.bool, device=self.device)
        return self._as_mask(active, shape, "active mask")

    def _sweep(self, seeds, active):
        return self.spec.run(
            self._graph_arrays(), self._transpose_arrays(), seeds, active,
            window=self.window, overflow=self._has_overflow(),
            frontier=self.fplan, tile=self._window_tile())

    # -- execution ---------------------------------------------------------
    def run(self, seeds, active=None) -> ReachResult:
        """Vertices reachable from ``seeds`` within the ``active``-induced
        subgraph.  ``seeds``: a vertex id or an (n,) bool mask."""
        n, m = self.graph.n, self.graph.m
        seed_mask = self._seed_mask(seeds)
        act = self._active_mask(active, (n,))
        if n == 0 or m == 0:
            # no edges: nothing propagates beyond the seeds themselves
            return ReachResult(seed_mask & act, torch.zeros(
                (), dtype=torch.int32, device=self.device))
        reached, rounds = self._dispatch(self._sweep, seed_mask, act)
        return ReachResult(reached, rounds)

    def run_batch(self, seed_masks, active_masks=None) -> ReachResult:
        """B reachability queries in one counted dispatch.

        ``seed_masks``: (B, n) bool; ``active_masks``: (B, n) bool or
        ``None`` (whole graph).  Returns one :class:`ReachResult` with a
        stacked (B, n) ``mask`` and (B,) ``rounds``, equal row-wise to
        sequential ``run()`` calls.
        """
        n, m = self.graph.n, self.graph.m
        if np.ndim(seed_masks) != 2 or np.shape(seed_masks)[1] != n:
            raise ValueError(f"seed_masks must be (B, {n}) bool, got "
                             f"{tuple(np.shape(seed_masks))}")
        seeds = self._as_mask(seed_masks, tuple(np.shape(seed_masks)),
                              "seed_masks")
        b = seeds.shape[0]
        act = self._active_mask(active_masks, (b, n))
        if n == 0 or m == 0:
            return ReachResult(seeds & act, torch.zeros(
                (b,), dtype=torch.int32, device=self.device))

        def batch():
            rows = [self._sweep(seeds[i], act[i]) for i in range(b)]
            if not rows:
                return seeds.clone(), torch.zeros(
                    (0,), dtype=torch.int32, device=self.device)
            return (torch.stack([r[0] for r in rows]),
                    torch.stack([r[1] for r in rows]))

        reached, rounds = self._dispatch(batch)
        return ReachResult(reached, rounds)


__all__ = ["plan_reach", "ReachEngine", "ReachResult", "REACH_BACKENDS",
           "reach_push_kernel", "reach_pull_kernel", "window_tile"]
