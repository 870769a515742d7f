"""Deterministic synthetic data pipelines (the port's own copy of
``src/repro/data/pipeline.py``, which is pure numpy; the batches are
bit-identical to the reference's).

Every stream is a pure function of (seed, step): restoring a checkpoint
restores the exact batch sequence with zero iterator state beyond the step
counter.  Batches are produced host-side as numpy; the trainer's
``put_batch`` moves them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """LM training batches: (tokens, targets) of shape (batch, seq)."""
    batch: int
    seq: int
    vocab: int
    seed: int = 0

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class RecsysStream:
    """Wide&Deep batches: dense feats, sparse multi-hot ids, click labels."""
    batch: int
    n_dense: int
    n_sparse: int
    vocab_sizes: tuple[int, ...]     # per sparse field
    ids_per_field: int = 1           # multi-hot bag size
    seed: int = 0

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        dense = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        ids = np.stack(
            [rng.integers(0, v, (self.batch, self.ids_per_field))
             for v in self.vocab_sizes], axis=1).astype(np.int32)
        labels = rng.integers(0, 2, (self.batch,)).astype(np.float32)
        return {"dense": dense, "sparse_ids": ids, "labels": labels}


@dataclasses.dataclass
class GraphBatchStream:
    """Batched small molecular graphs (molecule shape): fixed n_nodes/n_edges
    per graph, random 3D coordinates + species."""
    batch: int
    n_nodes: int
    n_edges: int
    n_species: int = 8
    seed: int = 0

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        pos = rng.normal(size=(self.batch, self.n_nodes, 3)).astype(np.float32) * 2.0
        species = rng.integers(0, self.n_species,
                               (self.batch, self.n_nodes)).astype(np.int32)
        src = rng.integers(0, self.n_nodes,
                           (self.batch, self.n_edges)).astype(np.int32)
        dst = rng.integers(0, self.n_nodes,
                           (self.batch, self.n_edges)).astype(np.int32)
        # learnable pairwise target: a smooth function of geometry
        d = np.linalg.norm(
            np.take_along_axis(pos, src[..., None], 1)
            - np.take_along_axis(pos, dst[..., None], 1), axis=-1)
        energy = np.exp(-d).sum(axis=1).astype(np.float32)
        return {"pos": pos, "species": species, "edge_src": src,
                "edge_dst": dst, "energy": energy}
