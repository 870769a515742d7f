"""Literal sequential implementations of the paper's Algorithms 5 and 7,
plus AC-3 with the edge_index jump (paper §8) — queue/worklist based, in
pure Python/numpy (copy of ``src/repro/core/sequential.py`` for the
port).

Three roles:
  1. second oracle for the BSP kernels (same fixpoint, comparable
     traversed-edge counts);
  2. the ON-THE-FLY path: AC-3/AC-6 touch edges only through ``post(v, i)``
     (the POST function of an implicit graph, paper §1.3/§2.1) — AC-6's
     ≤ m bound is exactly the bound on POST evaluations;
  3. readable reference for the propagation structure (waiting set Q,
     supporting sets S).
"""
from __future__ import annotations

from collections import deque

import numpy as np


class ImplicitGraph:
    """G = (V, POST): edges are produced on demand and counted."""

    def __init__(self, n: int, post_fn):
        self.n = n
        self._post = post_fn
        self.post_evaluations = 0

    def degree(self, v: int) -> int:
        return len(self._post(v))

    def post(self, v: int, i: int) -> int:
        """i-th successor of v (one POST evaluation)."""
        self.post_evaluations += 1
        return self._post(v)[i]


class ExplicitAdapter(ImplicitGraph):
    def __init__(self, indptr, indices):
        self.indptr = np.asarray(indptr)
        self.indices = np.asarray(indices)
        self.n = len(self.indptr) - 1
        self.post_evaluations = 0

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def post(self, v: int, i: int) -> int:
        self.post_evaluations += 1
        return int(self.indices[self.indptr[v] + i])


def seq_ac6(g: ImplicitGraph):
    """Paper Algorithm 7, verbatim structure (DoPost, waiting set Q,
    supporting sets S as lists). On-the-fly: only g.post() touches edges."""
    n = g.n
    status = np.ones(n, dtype=bool)
    ptr = np.zeros(n, dtype=np.int64)       # edge_index: next position to try
    S: list[list[int]] = [[] for _ in range(n)]

    def do_post(v, Q):
        while ptr[v] < g.degree(v):
            w = g.post(v, int(ptr[v]))
            ptr[v] += 1                      # w is "removed from v.post"
            if status[w]:
                S[w].append(v)
                return
        status[v] = False
        Q.append(v)

    for v in range(n):
        if not status[v]:
            continue
        Q: deque[int] = deque()
        do_post(v, Q)
        while Q:
            w = Q.popleft()
            supporters, S[w] = S[w], []
            for vp in supporters:
                if status[vp]:
                    do_post(vp, Q)
    return status, g.post_evaluations


def seq_ac4(indptr, indices, t_indptr, t_indices):
    """Paper Algorithm 5, verbatim structure (counters + waiting set Q)."""
    indptr, indices = np.asarray(indptr), np.asarray(indices)
    t_indptr, t_indices = np.asarray(t_indptr), np.asarray(t_indices)
    n = len(indptr) - 1
    status = np.ones(n, dtype=bool)
    deg_out = np.diff(indptr).astype(np.int64)
    edges = int(len(indices))                # counter init scan (AC4 variant)
    Q: deque[int] = deque()

    def do_degree(v):
        if deg_out[v] == 0 and status[v]:
            status[v] = False
            Q.append(v)

    for v in range(n):
        do_degree(v)
    while Q:
        w = Q.popleft()
        for e in range(t_indptr[w], t_indptr[w + 1]):
            vp = int(t_indices[e])
            edges += 1
            deg_out[vp] -= 1
            do_degree(vp)
    return status, edges


def seq_ac3(g: ImplicitGraph):
    """Paper Algorithm 4 with the edge_index jump optimization (§8)."""
    n = g.n
    status = np.ones(n, dtype=bool)
    ptr = np.zeros(n, dtype=np.int64)        # position of last-found support
    change = True
    rounds = 0
    while change:
        change = False
        rounds += 1
        snapshot = status.copy()             # BSP-equivalent parallel round
        for v in range(n):
            if not snapshot[v]:
                continue
            found = False
            while ptr[v] < g.degree(v):
                w = g.post(v, int(ptr[v]))
                if snapshot[w]:
                    found = True
                    break                    # ptr stays on the live support
                ptr[v] += 1
            if not found:
                status[v] = False
                change = True
    return status, g.post_evaluations, rounds
