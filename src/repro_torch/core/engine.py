"""Plan-once / run-many trimming engine — PyTorch port of
``src/repro/core/engine.py``.

``plan()`` resolves a method from the kernel registry, binds a backend and
a device, and returns a :class:`TrimEngine` that builds the transpose (for
AC-4/AC-4*) at most once and returns device-resident results
(:class:`TrimResult`) whose counters reach the host only when read.

Backends:

    "dense"    — lockstep per-step probing (``common.probe_first_live``)
    "windowed" — window-batched probing through the ``first_live_scan``
                 Hopper kernel (``common.probe_first_live_windowed``);
                 AC-4/AC-4* never probe and run as on "dense"
    "sharded"  — one rank of a ``torch.distributed`` group per device,
                 each trimming its row block (``core.distributed``): NCCL
                 for a CUDA device, gloo for the CPU; the graph stays on
                 the host and only the rank's block goes to the device

Example::

    engine = plan(graph, method="ac6", backend="dense", workers=16)
    result = engine.run(active=mask)
    results = engine.run_batch(stacked_masks)     # one counted dispatch

Each fixpoint is driven from the host round by round (see ``ac3.py``,
``ac4.py``, ``ac6.py`` and ``distributed.py`` for where each syncs); a
``run()`` still counts one dispatch, and a ``run_batch()`` one dispatch
for all its rows.

Configuration errors fail at ``plan()`` time, as the reference's do: a
(method, backend) pair that could not run the calls the caller may make
— e.g. sharded AC-4, whose masked runs would need a global edge pass —
raises at once.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import obs
from . import ac3 as _ac3  # noqa: F401  (imports register the kernels)
from . import ac4 as _ac4  # noqa: F401
from . import ac6 as _ac6  # noqa: F401
from . import distributed as dist
from .common import frontier_plan
from .enginebase import EngineBase
from .graph import CSRGraph, TrimResult, resolve_device, row_ids, worker_of
from .registry import available_methods, get_kernel

BACKENDS = ("dense", "windowed", "sharded")


def plan(graph: CSRGraph, method: str = "ac6", backend: str = "dense", *,
         workers: int = 1, chunk: int = 4096, window: int = 16,
         transpose: CSRGraph | None = None, group=None,
         packed: bool = False, unmasked: bool = False,
         frontier: str = "auto", instrument: bool = False,
         max_rounds: int | None = None, device="cuda") -> "TrimEngine":
    """Build a :class:`TrimEngine` for ``graph`` on ``device`` (the graph
    and a pre-seeded ``transpose`` are moved there if they lie elsewhere,
    or to the host for the sharded backend; a missing CUDA device
    raises).

    ``frontier`` selects the sparse-frontier substrate: ``"auto"`` (the
    default) lets each round choose between the dense body and a
    compacted one sized at plan time (``common.frontier_plan``);
    ``"dense"`` pins the dense rounds; ``"sparse"`` compacts every round.
    Results are bit-identical across the three.  AC-3 degrades ``"auto"``
    to dense and rejects ``"sparse"``.

    ``unmasked=True`` declares that ``run`` is never given an ``active``
    mask; sharded AC-4 and AC-4* require it.  ``group`` and ``packed``
    configure the sharded backend: the ``torch.distributed`` group
    (default: the default group, which the caller initialises —
    ``core.distributed.process_group`` or ``torchrun``; its backend must
    be NCCL for a CUDA device, gloo for the CPU) and, for AC-6, a packed
    bitmap in place of the bool status in the per-round all-gather.  The
    sharded backend degrades ``frontier="auto"`` to dense and rejects
    ``"sparse"``.  ``instrument=True`` (DESIGN.md §11) attaches a
    :class:`~repro_torch.obs.RoundStats` to every result
    (``result.round_stats``): per-round buffers of ``max_rounds`` slots
    (pow2-padded; default ``obs.round_capacity(n)``), the tail of a longer
    run folded into the last slot.  It adds no host sync.
    ``instrument=False`` ignores ``max_rounds`` and records nothing.
    A sharded run's stats are ``(P, R)``, one row a rank, and its
    ``per_worker_edges`` the (P,) ranks' traversed edges.
    """
    return TrimEngine(graph, method=method, backend=backend, workers=workers,
                      chunk=chunk, window=window, transpose=transpose,
                      group=group, packed=packed,
                      unmasked=unmasked, frontier=frontier,
                      instrument=instrument, max_rounds=max_rounds,
                      device=device)


def _to(graph: CSRGraph | None, dev: torch.device):
    return None if graph is None else graph.to(dev)


class TrimEngine(EngineBase):
    """Trimming over one graph on one device.  Build with :func:`plan`."""

    family = "trim"

    def __init__(self, graph, *, method, backend, workers, chunk, window,
                 transpose, group=None, packed=False, unmasked=False,
                 frontier="auto", instrument=False, max_rounds=None,
                 device="cuda"):
        self.spec = get_kernel(method)   # raises on unknown method
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if frontier == "sparse" and not self.spec.supports_frontier:
            raise ValueError(
                f"method {method!r} has no sparse-frontier formulation "
                "(it re-checks every live vertex each round); use "
                "frontier='auto'/'dense' or a counter/support method")
        if frontier == "sparse" and backend == "sharded":
            raise ValueError(
                "frontier='sparse' is single-device (compaction is a "
                "global scan); use the dense or windowed backend, or "
                "frontier='auto' which degrades to dense when sharded")
        if not self.spec.supports_frontier or backend == "sharded":
            frontier = "dense"  # silent degrade for "auto"
        if backend == "sharded" and self.spec.sharded_method is None:
            raise ValueError(f"method {method!r} has no sharded kernels")
        if backend == "sharded" and self.spec.sharded_method == "ac4" \
                and not unmasked:
            raise ValueError(
                f"method {method!r} with backend='sharded' cannot trim "
                "induced subgraphs (active masks): AC-4's counter "
                "initialization needs a global edge pass. Use "
                "method='ac3'/'ac6' with backend='sharded', pick the "
                "'dense'/'windowed' backend for AC-4, or pass "
                "unmasked=True to promise that run() is never called "
                "with an active mask")
        if packed and (backend != "sharded"
                       or self.spec.sharded_method != "ac6"):
            raise ValueError(
                "packed=True (uint32-bitmap status exchange) only applies "
                "to method='ac6' with backend='sharded'")
        dev = resolve_device(device)
        # a sharded rank moves only its block to the device: the graph
        # and Gᵀ stay on the host, where the block is cut from them
        home = torch.device("cpu") if backend == "sharded" else dev
        super().__init__(_to(graph, home), transpose=_to(transpose, home))
        self.device = dev
        self._home = home
        self.method = method
        self.backend = backend
        self.workers = workers
        self.chunk = chunk
        self.window = window
        self.group = group
        self.packed = packed
        self.unmasked = unmasked
        self.last_collectives = None
        self.fplan = frontier_plan(frontier, graph.n, graph.m)
        self._plan_stats(instrument, max_rounds, graph.n)
        self._invalidate_caches()

    def plan_signature(self) -> str:
        """The reference's signature string for the same plan."""
        sig = (f"trim[{self.method}/{self.backend}]"
               f"(n={self.graph.n},m={self.graph.m},w={self.workers})")
        if self.fplan.mode != "dense":
            sig += f"+frontier[{self.fplan.mode}]"
        return sig + "+stats" if self.instrument else sig

    def _plan_kwargs(self):
        """The reference's plan kwargs without ``use_kernel`` (the device
        is the port's only switch).  No world size is stored, as in the
        reference: a sharded plan restores on whatever default group the
        restoring process has."""
        if self.group is not None:
            raise ValueError(
                "sharded trim engines with an explicit process group are "
                "not checkpointable (groups do not serialize); checkpoint "
                "at the region level instead")
        return {"method": self.method, "backend": self.backend,
                "workers": self.workers, "chunk": self.chunk,
                "window": self.window, "packed": self.packed,
                "unmasked": self.unmasked, "frontier": self.fplan.mode,
                "instrument": self.instrument,
                "max_rounds": self.max_rounds if self.instrument else None}

    def _graph_from(self, tree, prefix):
        # a restored graph goes where __init__ keeps it
        return CSRGraph.from_numpy(tree[f"{prefix}_indptr"],
                                   tree[f"{prefix}_indices"], self._home)

    def _invalidate_caches(self):
        self._tarrs = None
        self._worker_ids = None
        self._shard = None

    def nbytes_breakdown(self):
        # _tarrs[0:2] alias the cached transpose (already accounted by the
        # base); the row ids, the worker map and a rank's block are new
        # bytes
        out = super().nbytes_breakdown()
        if self._tarrs is not None:
            out["row_ids"] = obs.array_nbytes(self._tarrs[2])
        if self._worker_ids is not None:
            out["worker_ids"] = obs.array_nbytes(self._worker_ids)
        if self._shard is not None:
            out["shard_operands"] = obs.array_nbytes(self._shard["operands"])
        return out

    # -- cached resources --------------------------------------------------
    def _transpose_arrays(self):
        if not self.spec.needs_transpose:
            return None
        if self._tarrs is None:
            gt = self.transpose
            self._tarrs = (gt.indptr, gt.indices, row_ids(gt.indptr, gt.m))
        return self._tarrs

    def _ids(self):
        if self._worker_ids is None:
            self._worker_ids = torch.as_tensor(
                worker_of(self.graph.n, self.workers, self.chunk)
            ).to(self.device)
        return self._worker_ids

    def _mask(self, active):
        if active is not None and self.unmasked:
            raise ValueError(
                "this engine was planned with unmasked=True (no active "
                "masks); plan() a maskable configuration instead")
        if active is None:
            return None
        if not isinstance(active, torch.Tensor):
            active = torch.as_tensor(np.asarray(active))
        return active.to(self.device, torch.bool)

    def _probe_kind(self):
        return ("windowed" if self.backend == "windowed"
                and self.spec.supports_windowed else "dense")

    def _stat_names(self):
        """The stat buffers this plan's fixpoint records: counter methods
        also track decrements; non-dense frontier plans record which
        rounds took the compacted body."""
        names = (("r_frontier", "r_edges", "r_decrements")
                 if self.method.startswith("ac4")
                 else ("r_frontier", "r_edges"))
        if self.fplan.mode != "dense":
            names = names + ("r_sparse",)
        return names

    def _fixpoint(self, active, counters, stats=None):
        return self.spec.run(
            (self.graph.indptr, self.graph.indices), self._transpose_arrays(),
            self._ids(), self.workers, active, probe=self._probe_kind(),
            window=self.window, counters=counters, frontier=self.fplan,
            stats=stats)

    # -- execution ---------------------------------------------------------
    def run(self, active=None, counters: bool = True) -> TrimResult:
        """Trim (the ``active``-induced subgraph of) the planned graph.

        ``counters=False`` skips the per-worker counter accumulation;
        ``edges_traversed`` / ``max_frontier`` / ``per_worker_edges`` are
        then ``None``.
        """
        n, m = self.graph.n, self.graph.m
        act = self._mask(active)
        if act is not None and tuple(act.shape) != (n,):
            raise ValueError(f"active mask must have shape ({n},), got "
                             f"{tuple(act.shape)}")
        if n == 0 or m == 0:
            return self._degenerate(act, counters)
        if self.backend == "sharded":
            return self._run_sharded(act, counters)
        if act is None:
            act = torch.ones((n,), dtype=torch.bool, device=self.device)
        bufs = self._buffers()
        status, rounds, pw, max_qp = self._dispatch(
            self._fixpoint, act, counters, bufs)
        rs = self._wrap_stats(rounds, bufs and bufs.finish(), per_worker=pw)
        return TrimResult(status=status.to(torch.int32), rounds=rounds,
                          max_frontier=max_qp, per_worker_edges=pw,
                          round_stats=rs)

    def run_batch_stacked(self, active_masks, counters: bool = True):
        """Trim B induced subgraphs in one counted dispatch, returning the
        stacked device arrays ``(status, per_worker_edges, rounds,
        max_frontier, round_stats)``: (B, n) int32, (B, P) int32, (B,)
        int32, (B,) int32 — the counter entries ``None`` with
        ``counters=False`` — and ``round_stats`` ``None`` unless the plan
        is instrumented, then one :class:`~repro_torch.obs.RoundStats` of
        (B, R) buffers (the reference returns the raw buffer dict).

        The B rows run one after another inside the dispatch, each with
        the plan's frontier (the reference vmaps them and pins the dense
        rounds; the results are identical either way, and so are the
        stats but for ``r_sparse``, which records the rounds these rows
        compacted).  The sharded backend raises, as the reference's does.
        """
        if self.backend == "sharded":
            raise NotImplementedError(
                "run_batch is a single-device batch; use the dense or "
                "windowed backend (shard the batch at the caller instead)")
        n, m = self.graph.n, self.graph.m
        masks = self._mask(active_masks)
        if masks.dim() != 2 or masks.shape[1] != n:
            raise ValueError(f"active_masks must be (B, {n}) bool, got "
                             f"{tuple(masks.shape)}")
        b = masks.shape[0]
        i32 = dict(dtype=torch.int32, device=self.device)
        if n == 0 or m == 0:
            # rows follow _degenerate's conventions: no dispatch, rounds =
            # 0 (empty) / 2 (edgeless: kill + confirm)
            pw = torch.zeros((b, self.workers), **i32) if counters else None
            rounds = torch.full((b,), 0 if n == 0 else 2, **i32)
            rs = (obs.RoundStats(rounds, self._degenerate_stats(masks),
                                 per_worker=pw, max_rounds=self.max_rounds)
                  if self.instrument else None)
            return (torch.zeros((b, n), **i32), pw, rounds,
                    masks.sum(dim=1, dtype=torch.int32) if counters else None,
                    rs)

        def stack(xs, shape):
            return torch.stack(xs) if xs else torch.zeros(shape, **i32)

        bufs = [self._buffers() for _ in range(b)]

        def batch():
            rows = [self._fixpoint(masks[i], counters, bufs[i])
                    for i in range(b)]
            status = stack([r[0].to(torch.int32) for r in rows], (0, n))
            rounds = stack([r[1] for r in rows], (0,))
            if not counters:
                return status, None, rounds, None
            return (status, stack([r[2] for r in rows], (0, self.workers)),
                    rounds, stack([r[3] for r in rows], (0,)))

        status, pw, rounds, max_qp = self._dispatch(batch)
        rs = self._wrap_stats(rounds, self._finish_rows(bufs), per_worker=pw)
        return status, pw, rounds, max_qp, rs

    def run_batch(self, active_masks, counters: bool = True):
        """Trim B induced subgraphs in one counted dispatch; a list of B
        device-resident :class:`TrimResult`, equal element-wise to
        sequential ``run()`` calls (counters included)."""
        status, pw, rounds, max_qp, rs = self.run_batch_stacked(
            active_masks, counters=counters)
        return [TrimResult(status=status[i], rounds=rounds[i],
                           max_frontier=None if max_qp is None else max_qp[i],
                           per_worker_edges=None if pw is None else pw[i],
                           round_stats=None if rs is None else rs.row(i))
                for i in range(status.shape[0])]

    # -- degenerate paths (no dispatch, still device-resident) -------------
    def _degenerate_stats(self, masks):
        """Round stats for the no-dispatch paths: every active vertex dies
        in the first processed round (slot 0), zero edges traversed.
        ``masks`` is (n,) or (B, n) bool; buffers come back (R,)/(B, R)."""
        deaths = masks.sum(dim=-1, dtype=torch.int32)[..., None]
        frontier = torch.nn.functional.pad(deaths, (0, self.max_rounds - 1))
        zeros = torch.zeros_like(frontier)
        return {name: (frontier if name == "r_frontier" else zeros)
                for name in self._stat_names()}

    def _degenerate(self, act, counters):
        """n == 0 or m == 0: the fixpoint is immediate, so no kernel runs;
        the result has the kernel path's dtypes and device."""
        n = self.graph.n
        i32 = dict(dtype=torch.int32, device=self.device)
        npw = (self._num_shards() if self.backend == "sharded"
               else self.workers)
        pw = torch.zeros((npw,), **i32) if counters else None

        def stats_for(mask, rounds):
            if not self.instrument:
                return None
            return obs.RoundStats(rounds, self._degenerate_stats(mask),
                                  per_worker=pw, max_rounds=self.max_rounds)

        if n == 0:
            rounds = torch.zeros((), **i32)
            return TrimResult(status=torch.zeros((0,), **i32),
                              rounds=rounds,
                              max_frontier=(torch.zeros((), **i32)
                                            if counters else None),
                              per_worker_edges=pw,
                              round_stats=stats_for(torch.zeros(
                                  (0,), dtype=torch.bool,
                                  device=self.device), rounds))
        # no edges: every (active) vertex is a sink and dies in round one;
        # rounds follows the AC-3 convention (α + 1): one killing round,
        # one confirming round
        if act is None:
            act = torch.ones((n,), dtype=torch.bool, device=self.device)
        rounds = torch.full((), 2, **i32)
        return TrimResult(status=torch.zeros((n,), **i32),
                          rounds=rounds,
                          max_frontier=(act.sum(dtype=torch.int32)
                                        if counters else None),
                          per_worker_edges=pw,
                          round_stats=stats_for(act, rounds))

    # -- sharded backend ---------------------------------------------------
    def _num_shards(self):
        if self._shard is not None:
            return self._shard["num"]
        return dist.ShardComm(self.group).size

    def _ensure_sharded(self):
        """This rank's block of the partition, its comm and the body kind,
        built once per engine: the rank cuts its own block only, from the
        host CSR (AC-4's from Gᵀ, the engine's cached transpose, also on
        the host), and moves that block alone to the device."""
        if self._shard is not None:
            return self._shard
        comm = dist.ShardComm(self.group, device=self.device)
        kind = self.spec.sharded_method
        if kind == "ac4":
            arrs, n_pad = dist.build_ac4_sharded(
                self.graph, comm.size, transpose=self.transpose,
                rank=comm.rank)
        else:
            lip, lix, n_pad = dist.rank_partition(self.graph, comm.size,
                                                  comm.rank)
            arrs = (lip, lix)
        self._shard = dict(
            comm=comm, num=comm.size, rank=comm.rank, n_pad=n_pad, kind=kind,
            operands=tuple(torch.from_numpy(a).to(self.device)
                           for a in arrs))
        return self._shard

    def _run_sharded(self, act, counters):
        sh = self._ensure_sharded()
        n, comm = self.graph.n, sh["comm"]
        args = sh["operands"]
        if sh["kind"] != "ac4":
            # plan() refuses masks for AC-4, so only AC-3/AC-6 take one
            nl = sh["n_pad"] // sh["num"]
            lo = min(sh["rank"] * nl, n)
            hi = min(lo + nl, n)
            block = torch.zeros((nl,), dtype=torch.bool, device=self.device)
            block[:hi - lo] = True if act is None else act[lo:hi]
            args = (*args, block)
        bufs = (obs.stats_init(self.max_rounds, dist.STAT_NAMES)
                if self.instrument else None)
        before = comm.counts()
        status, pw, rounds, max_qp, stats = self._dispatch(
            partial(dist.run_rank, packed=self.packed, stats=bufs),
            sh["kind"], comm, args)
        after = comm.counts()
        self.last_collectives = {
            op: (after[op][0] - before[op][0], after[op][1] - before[op][1])
            for op in dist.OPS}
        self._publish_collectives()
        rs = None
        if stats is not None:
            # the (P, R) per-rank round buffers: per-worker per-round
            # stats, the paper's work-skew quantity
            rs = obs.RoundStats(rounds, stats, per_worker=pw,
                                max_rounds=self.max_rounds)
            self._publish_round_stats(rs)
        return TrimResult(
            status=status[:n].to(torch.int32), rounds=rounds,
            max_frontier=max_qp if counters else None,
            per_worker_edges=pw if counters else None, round_stats=rs)

    def _publish_collectives(self) -> None:
        """Fold the last run's collective calls and bytes
        (``last_collectives``) into the MetricsPlane (enabled plane
        only)."""
        plane = obs.get_plane()
        if not plane.enabled:
            return
        calls = plane.counter(
            "repro_collective_calls",
            "collective calls of the sharded backend's runs, by op")
        nbytes = plane.counter(
            "repro_collective_bytes",
            "bytes of the sharded backend's collectives, by op (the "
            "gathered buffer of an all-gather, the input of a "
            "reduce-scatter, 4 for an any)")
        for op, (c, b) in self.last_collectives.items():
            calls.inc(c, family=self.family, op=op)
            nbytes.inc(b, family=self.family, op=op)


__all__ = ["plan", "TrimEngine", "BACKENDS", "available_methods"]
