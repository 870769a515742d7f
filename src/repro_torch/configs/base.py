"""Declarative architecture registry (port of ``src/repro/configs/base.py``).

Each language-model and GNN architecture contributes one module defining
an :class:`ArchSpec`: the exact published configuration, a reduced
configuration for CPU smoke tests, and its shape cells (name →
:class:`ShapeCell`).  The reference also registers a recsys architecture;
its model is not ported yet, and :func:`get` raises
:class:`NotImplementedError` naming ROADMAP A11 for its id.
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
    family: str                   # lm | gnn (recsys is not ported)
    make_config: Callable[[], Any]
    make_reduced: Callable[[], Any]
    shapes: dict[str, ShapeCell]
    source: str = ""              # citation tag from the assignment


REGISTRY: dict[str, ArchSpec] = {}

#: the reference's architectures whose models the port does not have yet
NOT_PORTED = {"wide-deep": "recsys"}


def register(spec: ArchSpec):
    REGISTRY[spec.id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is a {NOT_PORTED[arch_id]} architecture; its model "
            "is not ported to repro_torch yet (ROADMAP A11)")
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
