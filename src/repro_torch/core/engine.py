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
    "sharded"  — not ported yet (ROADMAP A6): raises

Example::

    engine = plan(graph, method="ac6", backend="dense", workers=16)
    result = engine.run(active=mask)
    results = engine.run_batch(stacked_masks)     # one counted dispatch

Each fixpoint is driven from the host round by round (see ``ac3.py``,
``ac4.py``, ``ac6.py`` for where each syncs); a ``run()`` still counts
one dispatch, and a ``run_batch()`` one dispatch for all its rows.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ac3 as _ac3  # noqa: F401  (imports register the kernels)
from . import ac4 as _ac4  # noqa: F401
from . import ac6 as _ac6  # noqa: F401
from .common import frontier_plan
from .enginebase import EngineBase
from .graph import CSRGraph, TrimResult, resolve_device, row_ids, worker_of
from .registry import available_methods, get_kernel

BACKENDS = ("dense", "windowed", "sharded")


def plan(graph: CSRGraph, method: str = "ac6", backend: str = "dense", *,
         workers: int = 1, chunk: int = 4096, window: int = 16,
         transpose: CSRGraph | None = None, unmasked: bool = False,
         frontier: str = "auto", instrument: bool = False,
         device="cuda") -> "TrimEngine":
    """Build a :class:`TrimEngine` for ``graph`` on ``device`` (the graph
    and a pre-seeded ``transpose`` are moved there if they lie elsewhere;
    a missing CUDA device raises).

    ``frontier`` selects the sparse-frontier substrate: ``"auto"`` (the
    default) lets each round choose between the dense body and a
    compacted one sized at plan time (``common.frontier_plan``);
    ``"dense"`` pins the dense rounds; ``"sparse"`` compacts every round.
    Results are bit-identical across the three.  AC-3 degrades ``"auto"``
    to dense and rejects ``"sparse"``.

    ``unmasked=True`` declares that ``run`` is never given an ``active``
    mask.  ``instrument=True`` (per-round stats) and ``backend="sharded"``
    are not ported yet and raise :class:`NotImplementedError`.
    """
    return TrimEngine(graph, method=method, backend=backend, workers=workers,
                      chunk=chunk, window=window, transpose=transpose,
                      unmasked=unmasked, frontier=frontier,
                      instrument=instrument, device=device)


def _to(graph: CSRGraph | None, dev: torch.device):
    return None if graph is None else graph.to(dev)


class TrimEngine(EngineBase):
    """Trimming over one graph on one device.  Build with :func:`plan`."""

    family = "trim"

    def __init__(self, graph, *, method, backend, workers, chunk, window,
                 transpose, unmasked=False, frontier="auto",
                 instrument=False, device="cuda"):
        self.spec = get_kernel(method)   # raises on unknown method
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if backend == "sharded":
            raise NotImplementedError(
                "backend='sharded' (torch.distributed) is not ported yet: "
                "ROADMAP A6")
        if instrument:
            raise NotImplementedError(
                "instrument=True (per-round stats) is not ported yet: "
                "ROADMAP A7")
        if frontier == "sparse" and not self.spec.supports_frontier:
            raise ValueError(
                f"method {method!r} has no sparse-frontier formulation "
                "(it re-checks every live vertex each round); use "
                "frontier='auto'/'dense' or a counter/support method")
        if not self.spec.supports_frontier:
            frontier = "dense"  # silent degrade for "auto"
        dev = resolve_device(device)
        super().__init__(_to(graph, dev), transpose=_to(transpose, dev))
        self.device = dev
        self.method = method
        self.backend = backend
        self.workers = workers
        self.chunk = chunk
        self.window = window
        self.unmasked = unmasked
        self.fplan = frontier_plan(frontier, graph.n, graph.m)
        self._tarrs = None
        self._worker_ids = None

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

    def _fixpoint(self, active, counters):
        return self.spec.run(
            (self.graph.indptr, self.graph.indices), self._transpose_arrays(),
            self._ids(), self.workers, active, probe=self._probe_kind(),
            window=self.window, counters=counters, frontier=self.fplan)

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
        if act is None:
            act = torch.ones((n,), dtype=torch.bool, device=self.device)
        status, rounds, pw, max_qp = self._dispatch(
            self._fixpoint, act, counters)
        return TrimResult(status=status.to(torch.int32), rounds=rounds,
                          max_frontier=max_qp, per_worker_edges=pw)

    def run_batch_stacked(self, active_masks, counters: bool = True):
        """Trim B induced subgraphs in one counted dispatch, returning the
        stacked device arrays ``(status, per_worker_edges, rounds,
        max_frontier, round_stats)``: (B, n) int32, (B, P) int32, (B,)
        int32, (B,) int32 — the counter entries ``None`` with
        ``counters=False`` — and ``round_stats`` always ``None`` (per-round
        stats are ROADMAP A7).

        The B rows run one after another inside the dispatch, each with
        the plan's frontier (the reference vmaps them and pins the dense
        rounds; the results are identical either way).
        """
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
            return (torch.zeros((b, n), **i32),
                    torch.zeros((b, self.workers), **i32)
                    if counters else None,
                    torch.full((b,), 0 if n == 0 else 2, **i32),
                    masks.sum(dim=1, dtype=torch.int32) if counters else None,
                    None)

        def stack(xs, shape):
            return torch.stack(xs) if xs else torch.zeros(shape, **i32)

        def batch():
            rows = [self._fixpoint(masks[i], counters) for i in range(b)]
            status = stack([r[0].to(torch.int32) for r in rows], (0, n))
            rounds = stack([r[1] for r in rows], (0,))
            if not counters:
                return status, None, rounds, None
            return (status, stack([r[2] for r in rows], (0, self.workers)),
                    rounds, stack([r[3] for r in rows], (0,)))

        status, pw, rounds, max_qp = self._dispatch(batch)
        return status, pw, rounds, max_qp, None

    def run_batch(self, active_masks, counters: bool = True):
        """Trim B induced subgraphs in one counted dispatch; a list of B
        device-resident :class:`TrimResult`, equal element-wise to
        sequential ``run()`` calls (counters included)."""
        status, pw, rounds, max_qp, _ = self.run_batch_stacked(
            active_masks, counters=counters)
        return [TrimResult(status=status[i], rounds=rounds[i],
                           max_frontier=None if max_qp is None else max_qp[i],
                           per_worker_edges=None if pw is None else pw[i])
                for i in range(status.shape[0])]

    # -- degenerate paths (no dispatch, still device-resident) -------------
    def _degenerate(self, act, counters):
        """n == 0 or m == 0: the fixpoint is immediate, so no kernel runs;
        the result has the kernel path's dtypes and device."""
        n = self.graph.n
        i32 = dict(dtype=torch.int32, device=self.device)
        pw = torch.zeros((self.workers,), **i32) if counters else None
        if n == 0:
            return TrimResult(status=torch.zeros((0,), **i32),
                              rounds=torch.zeros((), **i32),
                              max_frontier=(torch.zeros((), **i32)
                                            if counters else None),
                              per_worker_edges=pw)
        # no edges: every (active) vertex is a sink and dies in round one;
        # rounds follows the AC-3 convention (α + 1): one killing round,
        # one confirming round
        if act is None:
            act = torch.ones((n,), dtype=torch.bool, device=self.device)
        return TrimResult(status=torch.zeros((n,), **i32),
                          rounds=torch.tensor(2, **i32),
                          max_frontier=(act.sum(dtype=torch.int32)
                                        if counters else None),
                          per_worker_edges=pw)


__all__ = ["plan", "TrimEngine", "BACKENDS", "available_methods"]
