"""Fanout neighbour sampler for sampled GNN training (PyTorch port of
``src/repro/graphs/sampler.py``, the ``minibatch_lg`` shape).

GraphSAGE-style layered sampling: seed nodes -> fanout[0] neighbours ->
fanout[1] neighbours of those, and so on.  Each layer becomes a fixed-shape
padded :class:`SampledBlock`: a (n_dst, fanout) matrix of indices into the
layer's source node set, with a validity mask.  The sampling is numpy on
the host, draw for draw the reference's, so the blocks are identical.

``trim=True`` puts the paper's technique into the data path: the graph is
trimmed first (``core.trim``, on the graph's own device), and only the
surviving vertices (each has an outgoing edge into the survivors, the
arc-consistency condition) are sampled, so no random walk reaches a dead
end.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import CSRGraph
from ..core.trim import trim as _trim


@dataclasses.dataclass
class SampledBlock:
    """One message-passing layer of a sampled minibatch."""
    src_nodes: np.ndarray    # (n_src,) global node ids of layer inputs
    dst_nodes: np.ndarray    # (n_dst,) global node ids of layer outputs
    neighbors: np.ndarray    # (n_dst, fanout) indices into src_nodes
    mask: np.ndarray         # (n_dst, fanout) bool validity


class NeighborSampler:
    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...],
                 seed: int = 0, trim: bool = False,
                 trim_method: str = "ac6"):
        self.indptr, self.indices = graph.to_numpy()
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        self.n = graph.n
        self.allowed = np.ones(self.n, dtype=bool)
        self.trim_stats = None
        if trim:
            res = _trim(graph, method=trim_method)
            self.allowed = np.asarray(res.status).astype(bool)
            self.trim_stats = dict(trimmed=res.n_trimmed,
                                   edges_traversed=res.edges_traversed)

    def sample(self, seeds: np.ndarray) -> list[SampledBlock]:
        """Returns blocks ordered input-layer-first (apply in list order)."""
        blocks: list[SampledBlock] = []
        dst = np.asarray(seeds, dtype=np.int64)
        for fanout in self.fanouts:
            n_dst = len(dst)
            neigh = np.zeros((n_dst, fanout), dtype=np.int64)
            mask = np.zeros((n_dst, fanout), dtype=bool)
            for i, v in enumerate(dst):
                lo, hi = self.indptr[v], self.indptr[v + 1]
                cand = self.indices[lo:hi]
                cand = cand[self.allowed[cand]]
                if len(cand) == 0:
                    continue
                take = self.rng.choice(cand, size=fanout,
                                       replace=len(cand) < fanout)
                neigh[i] = take
                mask[i] = True
            src_nodes, inverse = np.unique(
                np.concatenate([dst, neigh.ravel()]), return_inverse=True)
            neigh_local = inverse[n_dst:].reshape(n_dst, fanout)
            blocks.append(SampledBlock(
                src_nodes=src_nodes, dst_nodes=dst,
                neighbors=neigh_local, mask=mask))
            dst = src_nodes
        return blocks[::-1]

    def batches(self, batch_nodes: int, num_batches: int):
        """Iterate seed batches over allowed nodes (training epochs)."""
        pool = np.nonzero(self.allowed)[0]
        for _ in range(num_batches):
            yield self.rng.choice(pool, size=batch_nodes,
                                  replace=len(pool) < batch_nodes)
