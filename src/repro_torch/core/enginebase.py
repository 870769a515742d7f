"""Shared base for the port's engine families (PyTorch port of
``src/repro/core/enginebase.py``).

It owns what every engine needs: the graph, a transpose built at most
once (O(n+m) counting sort, pre-seedable) and the dispatch accounting.

* ``dispatches`` counts device dispatches: each ``run`` is 1 and each
  ``run_batch`` is 1 whatever the batch size; the degenerate n = 0 /
  m = 0 shortcuts are 0.  The SCC driver's per-generation contract
  (DESIGN.md §8) is asserted against this count, so a fixpoint driven
  from the host, round by round, still counts one dispatch.
* ``traces`` stays 0: PyTorch runs eagerly and compiles nothing per
  shape.  The property is kept so callers written against the reference
  read the same accounting.

Every dispatch is one ``obs`` span (``cat="engine"``: family, plan
signature, seq), a no-op context while the global recorder is disabled.
Its ``phase`` is ``"build+execute"`` when ``kernels/_build.py`` compiled
a kernel library during the dispatch (the port's counterpart of the
reference's ``"compile+execute"``) and ``"execute"`` otherwise.

While the process-global MetricsPlane is enabled each dispatch also
feeds it (``_feed_plane``; one ``enabled`` read when it is off):

=================================  =====================================
reference                          port
=================================  =====================================
``repro_dispatch_latency_seconds`` ``repro_dispatch_wall_seconds``
{family, phase=compile|execute}    {family, phase=build|execute}: the
(host dispatch latency; jax        dispatch's wall time, its device work
dispatch is asynchronous)          included (the fixpoint ends in a sync)
``repro_dispatches{family}``       the same
``repro_traces{family}``           ``repro_kernel_builds{family}``:
                                   libraries compiled during dispatches
``repro_plan_compiles{family,      ``repro_plan_builds{family, plan}``
plan}``, ``repro_retrace_storms``  and ``repro_rebuild_storms``
``repro_plan_cost_flops/_bytes``   ``repro_plan_kernel_flops/_bytes``:
(XLA cost model, compile           the hand-written kernels' bound
dispatches)                        formulas over a plan's first dispatch
``repro_engine_live_bytes``        the same (``nbytes_breakdown``)
=================================  =====================================

and ``_publish_round_stats`` folds an instrumented run's
:class:`~repro_torch.obs.RoundStats` into ``repro_fixpoint_rounds``,
``repro_fixpoint_work``, ``repro_busiest_worker_edges`` and
``repro_worker_imbalance``, as the reference does.

The FaultPlane (DESIGN.md §14, ``repro_torch.fault``) arms two points in
every dispatch, as the reference does: ``"pre-dispatch"`` before the
fixpoint runs and ``"post-dispatch"`` after it returned, before the
dispatch is counted, so a faulted dispatch that is retried leaves the
counters where a fault-free run leaves them.  The disabled plane costs
one attribute read a dispatch.

The checkpoint protocol is the reference's: ``state_dict`` (flat
``{name: array}``: the graph and a built transpose; subclasses add their
persistent state), ``state_meta`` (family, plan signature and kwargs,
``dispatches``, ``traces``, ``transpose_builds``) and ``load_state``,
which overwrites the engine with a checkpoint's exact arrays
(``fault.save_engine`` / ``fault.restore_engine``).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import obs
from ..fault.plane import get_fault_plane
from ..kernels import _build
from .graph import CSRGraph


class EngineBase:
    """Engine over one graph: transpose cache + dispatch accounting."""

    #: engine family name; subclasses override
    family = "engine"
    #: per-round stats (``_plan_stats``); off unless a plan asks
    instrument = False
    max_rounds = 0

    def __init__(self, graph: CSRGraph, *, transpose: CSRGraph | None = None):
        self.graph = graph
        self._transpose = transpose
        self._transpose_builds = 0
        self._dispatches = 0
        self._costed = False

    def plan_signature(self) -> str:
        """Stable short description of the plan's static configuration,
        used to label spans.  Subclasses refine it."""
        return f"{self.family}(n={self.graph.n},m={self.graph.m})"

    @property
    def transpose(self) -> CSRGraph:
        """Gᵀ, built at most once (O(n+m) counting sort) and cached."""
        if self._transpose is None:
            self._transpose = self.graph.transpose()
            self._transpose_builds += 1
        return self._transpose

    @property
    def transpose_builds(self) -> int:
        return self._transpose_builds

    @property
    def traces(self) -> int:
        """Always 0 under eager PyTorch (nothing is traced)."""
        return 0

    @property
    def dispatches(self) -> int:
        return self._dispatches

    def _as_mask(self, x, shape, what):
        """``x`` (numpy or torch) as a bool tensor on the engine's device,
        raising unless its shape is ``shape``."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        return x.to(self.device, torch.bool)

    # -- memory accounting (nbytes protocol, DESIGN.md §13) ----------------
    def nbytes_breakdown(self) -> Dict[str, int]:
        """Live-buffer bytes by component (``numel * element_size``, no
        device sync).  Subclasses extend with their plan caches; the base
        accounts the graph and the cached transpose."""
        out = {"graph": obs.array_nbytes(self.graph)}
        if self._transpose is not None:
            out["transpose"] = obs.array_nbytes(self._transpose)
        return out

    def nbytes(self) -> int:
        """Total live-buffer bytes held by this engine."""
        return sum(self.nbytes_breakdown().values())

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, fn, *args):
        """Run one fixpoint call and count it as one dispatch, however
        many rounds and host syncs it takes: one span, and with an
        enabled plane its metrics (the first dispatch also captures the
        kernel calls for the plan's cost).  With the recorder and the
        plane both off it reads their two flags and the FaultPlane's, and
        nothing else.  The FaultPlane's ``"post-dispatch"`` point is armed
        before the dispatch is counted."""
        fplane = get_fault_plane()
        faults = fplane.enabled
        if faults:
            fplane.arm("pre-dispatch", family=self.family,
                       seq=self._dispatches)
        plane = obs.get_plane()
        if not (plane.enabled or obs.get_recorder().enabled):
            out = fn(*args)
            if faults:
                fplane.arm("post-dispatch", family=self.family,
                           seq=self._dispatches)
            self._dispatches += 1
            return out
        builds = _build.BUILDS[0]
        t0 = time.perf_counter() if plane.enabled else 0.0
        with obs.span("dispatch", cat="engine", family=self.family,
                      plan=self.plan_signature(),
                      seq=self._dispatches) as sp:
            if plane.enabled and not self._costed:
                self._costed = True
                out, cost = obs.plan_cost_of(fn, *args)
            else:
                out, cost = fn(*args), None
            built = _build.BUILDS[0] - builds
            if sp is not None:
                sp.attrs["builds"] = built
                sp.attrs["phase"] = ("build+execute" if built
                                     else "execute")
            if plane.enabled:
                self._feed_plane(plane, built, time.perf_counter() - t0,
                                 cost, sp)
            if faults:
                fplane.arm("post-dispatch", family=self.family,
                           seq=self._dispatches)
        self._dispatches += 1
        return out

    def _feed_plane(self, plane, built, elapsed, cost, sp) -> None:
        """Publish one dispatch to the MetricsPlane (enabled plane only)."""
        plane.histogram(
            "repro_dispatch_wall_seconds",
            "engine dispatch wall time by family, its device work included "
            "(the port's fixpoints end in a host sync), split by whether a "
            "kernel library was built during it",
        ).observe(elapsed, family=self.family,
                  phase="build" if built else "execute")
        plane.counter(
            "repro_dispatches",
            "device dispatches issued per engine family",
        ).inc(family=self.family)
        plan = self.plan_signature()
        if built:
            plane.counter(
                "repro_kernel_builds",
                "kernel libraries compiled during an engine family's "
                "dispatches",
            ).inc(built, family=self.family)
            plane.note_build(self.family, plan)
        if cost:
            obs.record_plan_cost(plane, self.family, plan, cost)
            if sp is not None:
                sp.attrs["cost"] = cost
        obs.publish_engine_memory(plane, self)

    # -- per-round stats (DESIGN.md §11) -----------------------------------
    def _plan_stats(self, instrument: bool, max_rounds, n: int) -> None:
        """Record the plan's ``instrument`` flag and round capacity
        (``obs.round_capacity``; 0, and ``max_rounds`` ignored, when
        off)."""
        self.instrument = bool(instrument)
        self.max_rounds = (obs.round_capacity(n, max_rounds)
                           if self.instrument else 0)

    def _stat_names(self) -> tuple:
        """The stats this plan's fixpoint records; subclasses override."""
        return ("r_frontier", "r_edges")

    def _buffers(self):
        """Empty round buffers for one run (``None`` when off)."""
        return (obs.stats_init(self.max_rounds, self._stat_names())
                if self.instrument else None)

    def _finish_rows(self, bufs):
        """A batch's ``(B, R)`` buffers from its rows' (None when off)."""
        return (obs.finish_rows(bufs, self.max_rounds, self._stat_names(),
                                self.device) if self.instrument else None)

    def _wrap_stats(self, rounds, done, per_worker=None):
        """The :class:`~repro_torch.obs.RoundStats` of a finished run
        (``done``: ``RoundBuffers.finish()`` or ``obs.finish_rows``; None
        when off), published to the MetricsPlane."""
        if done is None:
            return None
        dev, host = done
        rs = obs.RoundStats(rounds, dev, per_worker=per_worker,
                            max_rounds=self.max_rounds, host=host)
        self._publish_round_stats(rs)
        return rs

    def _publish_round_stats(self, rs) -> None:
        """Fold one run's :class:`~repro_torch.obs.RoundStats` into the
        MetricsPlane (rounds, per-stat work totals, worker skew).  No-op
        when the plane is disabled or the plan was not instrumented; an
        enabled plane moves the stats buffers to the host."""
        plane = obs.get_plane()
        if rs is None or not plane.enabled:
            return
        plane.counter(
            "repro_fixpoint_rounds",
            "fixpoint rounds executed per engine family (summed over "
            "batches)",
        ).inc(int(np.sum(rs.rounds)), family=self.family)
        work = plane.counter(
            "repro_fixpoint_work",
            "per-round instrumented work totals by stat (edges = edges "
            "traversed, frontier = frontier sizes, decrements = counter "
            "decrements, r_sparse = rounds on the sparse path)")
        for name in rs.names:
            work.inc(float(np.sum(rs.total(name))),
                     family=self.family, stat=name)
        mwe = rs.max_worker_edges()
        if mwe is not None:
            plane.gauge(
                "repro_busiest_worker_edges",
                "edges traversed by the busiest worker in the last "
                "instrumented run (paper's per-worker load metric)",
            ).set(float(np.max(mwe)), family=self.family)
            plane.gauge(
                "repro_worker_imbalance",
                "max/mean per-worker traversed edges in the last "
                "instrumented run (1.0 = perfectly balanced)",
            ).set(float(np.max(rs.imbalance())), family=self.family)

    # -- checkpoint/resume protocol (DESIGN.md §14) ------------------------
    def state_dict(self) -> Dict[str, object]:
        """Checkpointable state as a flat ``{name: array}`` tree: the graph
        and, once built, the transpose; subclasses add their persistent
        state.  Everything else an engine holds is a function of these
        arrays and the plan kwargs of :meth:`state_meta`, so a restore is
        bit-identical."""
        out = {"graph_indptr": self.graph.indptr,
               "graph_indices": self.graph.indices}
        if self._transpose is not None:
            out["transpose_indptr"] = self._transpose.indptr
            out["transpose_indices"] = self._transpose.indices
        return out

    def state_meta(self) -> Dict[str, object]:
        """JSON side of :meth:`state_dict`: the engine family, the plan
        kwargs a fresh process re-plans from, and the accounting counters
        (``traces`` is the port's 0), restored so a resumed engine counts
        on from the checkpoint."""
        return {"family": self.family, "plan": self.plan_signature(),
                "dispatches": self._dispatches, "traces": self.traces,
                "transpose_builds": self._transpose_builds,
                "plan_kwargs": self._plan_kwargs()}

    def _plan_kwargs(self) -> Dict[str, object]:
        """The kwargs that rebuild this plan (subclasses override)."""
        return {}

    def _check_family(self, meta) -> None:
        if meta.get("family") != self.family:
            raise ValueError(f"checkpoint family {meta.get('family')!r} "
                             f"does not match engine family "
                             f"{self.family!r}")

    def _graph_from(self, tree, prefix: str) -> CSRGraph:
        return CSRGraph.from_numpy(tree[f"{prefix}_indptr"],
                                   tree[f"{prefix}_indices"], self.device)

    def load_state(self, tree, meta) -> None:
        """Overwrite this engine with a checkpoint's exact arrays (``tree``
        from :meth:`state_dict` or ``train.checkpoint.load_flat``, ``meta``
        from :meth:`state_meta`), on the engine's device.  The caches
        derived from the graph and the transpose are dropped and rebuilt
        from the restored arrays.  The reference's ``traces`` is not
        restored: the port traces nothing."""
        self._check_family(meta)
        self.graph = self._graph_from(tree, "graph")
        self._transpose = (self._graph_from(tree, "transpose")
                           if "transpose_indptr" in tree else None)
        self._dispatches = int(meta.get("dispatches", 0))
        self._transpose_builds = int(meta.get("transpose_builds", 0))
        self._invalidate_caches()

    def _invalidate_caches(self) -> None:
        """Drop the plan caches derived from the graph and the transpose
        (subclasses override); they are rebuilt deterministically."""


__all__ = ["EngineBase"]
