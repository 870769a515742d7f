"""GAP Benchmark Suite "urand" generator (Beamer, Asanovic, Patterson,
arXiv:1508.03619), on the device: ``degree`` x 2**scale arcs whose two
endpoints are uniform over the 2**scale vertices, built as GAP's builder
builds them: each row sorted by target, self-loops and duplicate arcs
removed.

The endpoints come from the configuration's ``structure_seed``, and the
rows are built on their labels; the run's ``--seed`` then permutes the
labels, each row keeping its order.  So every seed gives the same graph
under other labels: the same first arc of every row, the same rounds.
"""
from __future__ import annotations

import torch

from trimbench import csr


def make(cfg: dict, seed: int, device):
    """``(indptr, indices)`` int32 of the configuration on ``device``."""
    n = 1 << int(cfg["scale"])
    m = int(cfg["degree"]) * n
    gen = csr.generator(cfg["structure_seed"], device)
    src = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    src, dst = csr.squish(n, src, dst)
    src, dst = csr.relabel(src, dst, n, seed)
    return csr.from_edges(n, src, dst)
