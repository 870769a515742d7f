"""The least bytes a trim call moves, counted from the graph and the
reference's answer, whatever implements the method.  Each byte that
these inputs need is counted once and nothing more: an array read whole
counts its size; a row read in part counts the 32-byte sectors it covers
(the card's least read), each sector once however many rows share it.

* AC-6: the row pointers, 4 (n + 1); the arcs examined (the whole row of
  each removed vertex; the row of each kept vertex up to its first kept
  target), by sector; the status of each distinct target among them, 1
  byte each; the status written, 1 byte a vertex.
* AC-4 and AC-4*: G's row pointers (the degrees), 4 (n + 1); Gᵀ's row
  pointers, 4 (n + 1); the in-rows of the removed vertices in Gᵀ, by
  sector; the counters, 4 n, and the status, n, once each.
"""
from __future__ import annotations

import torch

from trimbench import reference

SECTOR = 32
INDEX_BYTES = 4


def covered(starts, lengths, size: int):
    """(size,) bool: the elements of ``[0, size)`` inside some range
    ``[starts[i], starts[i] + lengths[i])``."""
    keep = lengths > 0
    s, e = starts[keep].long(), (starts[keep] + lengths[keep]).long()
    edge = (torch.bincount(s, minlength=size + 1)
            - torch.bincount(e, minlength=size + 1))
    return torch.cumsum(edge, 0)[:size] > 0


def sector_bytes(starts, lengths, size: int) -> int:
    """Bytes of the distinct 32-byte sectors that the ranges of 4-byte
    entries cover, in an array of ``size`` entries."""
    keep = lengths > 0
    first = starts[keep].long() * INDEX_BYTES // SECTOR
    last = ((starts[keep] + lengths[keep]).long() * INDEX_BYTES - 1) // SECTOR
    sectors = -(-size * INDEX_BYTES // SECTOR)
    return SECTOR * int(covered(first, last - first + 1, sectors).sum())


def ac6(indptr, indices, live) -> int:
    n, m = indptr.numel() - 1, indices.numel()
    deg = (indptr[1:] - indptr[:-1]).long()
    length = torch.where(
        live, reference.first_kept(indptr, indices, live) + 1, deg)
    start = indptr[:-1].long()
    read = covered(start, length, m)
    targets = torch.zeros(n, dtype=torch.bool, device=indices.device)
    targets[indices[read].long()] = True
    return (INDEX_BYTES * (n + 1) + sector_bytes(start, length, m)
            + int(targets.sum()) + n)


def ac4(indptr, indices, live) -> int:
    n, m = indptr.numel() - 1, indices.numel()
    deg_in = torch.bincount(indices.long(), minlength=n)
    t_start = torch.cumsum(deg_in, 0) - deg_in
    dead_in = torch.where(live, 0, deg_in)
    return (2 * INDEX_BYTES * (n + 1) + sector_bytes(t_start, dead_in, m)
            + INDEX_BYTES * n + n)


METHODS = {"ac6": ac6, "ac4": ac4, "ac4*": ac4}


def least_bytes(method: str, indptr, indices, live) -> int | None:
    """The least bytes of one call of ``method``, or None for a method
    with no count here."""
    fn = METHODS.get(method)
    return None if fn is None else fn(indptr, indices, live)
