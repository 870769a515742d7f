"""Unified trimming API (PyTorch port of ``src/repro/core/trim.py``)::

    result = trim(graph, method="ac6", workers=16)

``method``: "ac3" | "ac4" | "ac4*" | "ac6".  All reach the same unique
fixpoint; they differ in work, space and the number of adjacency entries
traversed.  ``trim()`` is a thin shim over :func:`~.engine.plan` on the
graph's own device that materializes the result on the host; callers that
trim one graph more than once should hold a ``plan(...)`` engine.
"""
from __future__ import annotations

from .engine import plan
from .graph import CSRGraph, TrimResult
from .registry import available_methods

METHODS = available_methods()   # ("ac3", "ac4", "ac4*", "ac6")


def trim(graph: CSRGraph, method: str = "ac6", workers: int = 1,
         chunk: int = 4096, transpose: CSRGraph | None = None,
         active=None, backend: str = "dense",
         counters: bool = True) -> TrimResult:
    """``active``: optional (n,) bool mask — trim the induced subgraph."""
    engine = plan(graph, method=method, backend=backend, workers=workers,
                  chunk=chunk, transpose=transpose,
                  unmasked=active is None, device=graph.device)
    return engine.run(active=active, counters=counters).materialize()


def peeling_alpha(graph: CSRGraph) -> int:
    """α via the AC-3 round count (rounds = α + 1, final round confirms)."""
    return trim(graph, method="ac3", workers=1).rounds - 1
