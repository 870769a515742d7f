"""Declarative architecture registry (port of ``src/repro/configs/base.py``).

Each language-model, GNN and recsys architecture contributes one module
defining an :class:`ArchSpec`: the exact published configuration, a
reduced configuration for CPU smoke tests, and its shape cells (name →
:class:`ShapeCell`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                      # train | prefill | decode | serve | retrieval
    meta: dict
    skip: str | None = None       # reason if the cell is not runnable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                   # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_reduced: Callable[[], Any]
    shapes: dict[str, ShapeCell]
    source: str = ""              # citation tag from the assignment


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec):
    REGISTRY[spec.id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


# ---- shared LM shape cells (seq_len × global_batch per the assignment)


def lm_shapes(full_attention: bool) -> dict[str, ShapeCell]:
    skip = ("pure full-attention arch: 524k decode is quadratic-infeasible; "
            "skipped per assignment rules (DESIGN.md §5)"
            if full_attention else None)
    return {
        "train_4k": ShapeCell("train_4k", "train",
                              dict(seq=4096, batch=256)),
        "prefill_32k": ShapeCell("prefill_32k", "prefill",
                                 dict(seq=32768, batch=32)),
        "decode_32k": ShapeCell("decode_32k", "decode",
                                dict(seq=32768, batch=128)),
        "long_500k": ShapeCell("long_500k", "decode",
                               dict(seq=524288, batch=1), skip=skip),
    }


def gnn_shapes() -> dict[str, ShapeCell]:
    return {
        "full_graph_sm": ShapeCell(
            "full_graph_sm", "train",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433, classes=7)),
        "minibatch_lg": ShapeCell(
            "minibatch_lg", "train",
            # reddit-scale sampled subgraph: 1024 seeds, fanout 15-10
            dict(n_nodes=1024 + 1024 * 15 + 1024 * 150,
                 n_edges=1024 * 15 + 1024 * 150, d_feat=602, classes=41,
                 universe_nodes=232_965, universe_edges=114_615_892,
                 fanout=(15, 10), batch_nodes=1024)),
        "ogb_products": ShapeCell(
            "ogb_products", "train",
            dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                 classes=47)),
        "molecule": ShapeCell(
            "molecule", "train",
            dict(n_nodes=30, n_edges=64, batch=128)),
    }


def recsys_shapes() -> dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell("train_batch", "train", dict(batch=65536)),
        "serve_p99": ShapeCell("serve_p99", "serve", dict(batch=512)),
        "serve_bulk": ShapeCell("serve_bulk", "serve", dict(batch=262144)),
        # 1M candidates, padded to 2^20 so the candidate matrix shards
        # evenly over all 256/512 devices
        "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                    dict(batch=1, n_candidates=1_048_576)),
    }
