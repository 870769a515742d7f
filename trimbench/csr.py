"""Edge lists to CSR on the device, and the seed's vertex relabelling,
in plain torch ops.  Shared by the generators; no code of the program.
"""
from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole
    number; taken modulo 2**64)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def relabel(src, dst, n: int, seed: int):
    """Both endpoints through one permutation of the n vertex labels drawn
    from ``seed``: the same graph under other names, so every seed asks
    the same work of the trim, in another order."""
    perm = torch.randperm(n, generator=generator(seed, src.device),
                          device=src.device, dtype=torch.int32)
    return perm[src.long()], perm[dst.long()]


def squish(n: int, src, dst):
    """The arcs sorted by (source, target), with self-loops and duplicate
    arcs removed (GAP's builder, ``SquishGraph``)."""
    key = torch.unique(src.long() * n + dst.long(), sorted=True)
    src, dst = key // n, key % n
    keep = src != dst
    return src[keep], dst[keep]


def from_edges(n: int, src, dst):
    """``(indptr, indices)``, both int32, of the arcs ``src -> dst``: rows
    grouped by a stable sort on the source, so each row keeps the arcs'
    order in the list."""
    order = torch.sort(src, stable=True).indices
    src, dst = src[order], dst[order]
    counts = torch.bincount(src.long(), minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr, dst.to(torch.int32)
