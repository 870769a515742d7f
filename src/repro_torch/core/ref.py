"""Pure-numpy oracle: naive peeling to the trimmed-graph fixpoint (copy of
``src/repro/core/ref.py`` for the port).

Used by tests and ``chip_smoke.py`` to check soundness (eq. 1) and
completeness (eq. 2).  The "has a live successor" reduction is a
``np.bincount`` over the edges' sources instead of the reference's
``np.logical_or.at``, which is far too slow at tens of millions of edges;
the mask it computes is the same.
"""
from __future__ import annotations

import numpy as np


def _has_live_succ(indptr, indices, status) -> np.ndarray:
    n = len(indptr) - 1
    if not len(indices):
        return np.zeros(n, dtype=bool)
    src = np.repeat(np.arange(n), np.diff(indptr))
    live = np.bincount(src, weights=status[indices].astype(np.float64),
                       minlength=n)
    return live > 0


def trim_oracle(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Return the LIVE mask of the unique trimmed fixpoint (bool, (n,))."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    status = np.ones(len(indptr) - 1, dtype=bool)
    while True:
        new_status = status & _has_live_succ(indptr, indices, status)
        if (new_status == status).all():
            return status
        status = new_status


def peeling_alpha(indptr: np.ndarray, indices: np.ndarray) -> int:
    """Number of peeling steps α (paper Definition 2)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    status = np.ones(len(indptr) - 1, dtype=bool)
    alpha = 0
    while True:
        new_status = status & _has_live_succ(indptr, indices, status)
        if (new_status == status).all():
            return alpha
        alpha += 1
        status = new_status


def sound(indptr, indices, status) -> bool:
    """Paper eq. (1): every dead vertex has only dead successors."""
    indptr, indices, status = map(np.asarray, (indptr, indices, status))
    has_live_succ = _has_live_succ(indptr, indices, status.astype(bool))
    dead = ~status.astype(bool)
    return bool((~(dead & has_live_succ)).all())


def complete(indptr, indices, status) -> bool:
    """Paper eq. (2): every vertex with no live successor is dead."""
    indptr, indices, status = map(np.asarray, (indptr, indices, status))
    has_live_succ = _has_live_succ(indptr, indices, status.astype(bool))
    live = status.astype(bool)
    return bool((~(~has_live_succ & live)).all())
