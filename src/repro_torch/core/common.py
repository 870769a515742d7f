"""Shared machinery for the BSP (bulk-synchronous) trimming algorithms —
PyTorch port of ``src/repro/core/common.py``.

The paper's algorithms advance per-vertex *scan pointers* (``edge_index``,
paper §8) so an adjacency list is never re-scanned from its start.  Here
all unresolved vertices advance in lockstep micro-steps; each micro-step
is one gather ("probe") per scanning vertex.  AC-3 re-probes every live
vertex each round from its pointer; AC-6 probes only vertices whose one
support died, and its pointers only move forward (≤ m probes in all).

The reference runs each probe loop inside a ``lax.while_loop``.  Here the
loop is driven from the host: **each micro-step ends in one host sync**
(the ``active.any()`` loop test); the step's work is enqueued on the
device before it.  Counters (probes per vertex) are exact and
deterministic, as in the reference.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..kernels import ops as kops

FRONTIER_MODES = ("auto", "dense", "sparse")


def _pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


class FrontierPlan(NamedTuple):
    """Sparse-frontier configuration, resolved once at plan time.

    mode: "dense"  — every round runs the dense O(n)/O(m) body.
          "auto"   — rounds whose frontier fits ``cap`` members and
                     ``ecap`` expanded edges take the compacted path
                     (decided on the host from one synced count per
                     round); the rest stay dense.  Bit-identical.
          "sparse" — capacities cover the whole graph, so every round
                     compacts (the parity-test configuration).
    cap:  member capacity of the compacted id buffer (pow2).
    ecap: capacity of the expanded edge buffer (pow2).
    """

    mode: str = "dense"
    cap: int = 0
    ecap: int = 0


def frontier_plan(mode: str, n: int, m: int) -> FrontierPlan:
    """Resolve a ``frontier=`` argument into a :class:`FrontierPlan`:
    "auto" sizes the member capacity at ~n/64 (clamped to [128, n]) and the
    edge capacity at ~m/8 (clamped to [128, m]), both pow2-padded.
    Degenerate graphs (no vertices or no edges) plan dense."""
    if mode not in FRONTIER_MODES:
        raise ValueError(f"unknown frontier mode {mode!r}; expected one of "
                         f"{FRONTIER_MODES}")
    if mode == "dense" or n == 0 or m == 0:
        return FrontierPlan("dense", 0, 0)
    if mode == "sparse":
        return FrontierPlan("sparse", _pow2(n), _pow2(m))
    cap = _pow2(min(max(n // 64, 128), n))
    ecap = _pow2(min(max(m // 8, 128), m))
    return FrontierPlan("auto", cap, ecap)


def _probe_loop(status, indices, row_base, deg, start, scanning):
    """Lockstep probing over rows described by (row_base, deg): advance
    each scanning row's pointer until it hits a live target or its list
    ends.  Returns (found, pos, probes) — see :func:`probe_first_live`."""
    last = max(indices.shape[0] - 1, 0)
    start = torch.minimum(start, deg)
    ptr = torch.where(scanning, start, deg)
    active = scanning & (ptr < deg)
    found = torch.zeros_like(scanning)
    while bool(active.any()):                       # host sync: loop test
        in_range = ptr < deg
        target = indices[(row_base + ptr).clamp_(0, last)]
        hit = active & in_range & status[target]
        found |= hit
        ptr = torch.where(active & in_range & ~hit, ptr + 1, ptr)
        active = active & ~hit & (ptr < deg)
    # entries examined: start..ptr inclusive when found, start..deg-1 when
    # exhausted  ->  (ptr - start) + found
    probes = torch.where(scanning, ptr - start + found.to(torch.int32), 0)
    return found, ptr, probes


def probe_first_live(status, indptr, indices, start, scanning):
    """Advance scan pointers until a live target is found or the list ends.

    status:   (n,) bool liveness snapshot (probes read only the snapshot).
    indptr:   (n+1,) int32; indices: (m,) int32.
    start:    (n,) int32 relative position to probe first.
    scanning: (n,) bool — which vertices participate.

    Returns found (n,) bool, pos (n,) int32 relative position of the live
    target (undefined where not found), probes (n,) int32 adjacency
    entries examined (0 for non-scanning vertices).
    """
    deg = indptr[1:] - indptr[:-1]
    return _probe_loop(status, indices, indptr[:-1], deg, start, scanning)


def probe_first_live_ids(status, indices, row_base, deg, start, scanning):
    """Compacted-row variant of :func:`probe_first_live`: probe the C rows
    a frontier compaction selected through gathered CSR descriptors
    (``row_base``, ``deg``: (C,) int32; deg 0 on unused slots).  Same
    found/pos/probes contract, so a sparse round built on it is
    bit-identical to the dense round, counters included."""
    return _probe_loop(status, indices, row_base, deg, start, scanning)


def probe_first_live_windowed(status, indptr, indices, start, scanning,
                              window: int = 16):
    """Window-batched probe: gather each scanning vertex's next ``window``
    adjacency entries into an (n, W) liveness tile, reduce it with the
    ``first_live_scan`` kernel, and fall back to per-step probing only for
    vertices whose live target lies beyond the window.  Identical results
    to :func:`probe_first_live`, counters included.

    The liveness gather stays outside the kernel, as in the reference
    (``src/repro/core/common.py:204-209``).
    """
    m = indices.shape[0]
    deg = indptr[1:] - indptr[:-1]
    start = torch.minimum(start, deg)

    offs = torch.arange(window, dtype=torch.int32, device=deg.device)
    pos = start[:, None] + offs[None, :]                      # (n, W)
    valid = pos < deg[:, None]
    addr = (indptr[:-1, None] + pos).clamp_(0, max(m - 1, 0))
    flags = status[indices[addr]]                             # (n, W)

    first, found_w = kops.first_live_scan(flags, valid, scanning)
    pos_w = start + first
    # exhausted within the window <=> no live found AND window covers deg
    resolved = found_w | ((start + window) >= deg)
    examined_w = torch.where(
        scanning,
        torch.where(found_w, first + 1,
                    torch.clamp(deg - start, min=0).clamp_(max=window)),
        0)

    # rare continuation: live target beyond the window
    rest = scanning & ~resolved
    found_r, pos_r, probes_r = probe_first_live(
        status, indptr, indices, start + window, rest)

    found = torch.where(rest, found_r, found_w & scanning)
    pos_out = torch.where(rest, pos_r, pos_w)
    probes = torch.where(rest, examined_w + probes_r, examined_w)
    return found, pos_out, probes


def resolve_probe(kind: str = "dense", window: int = 16):
    """Map an engine backend's probe kind to a probe function:
    "dense" -> :func:`probe_first_live`, "windowed" ->
    :func:`probe_first_live_windowed` (the ``first_live_scan`` kernel).
    Both give identical results, counters included."""
    if kind == "dense":
        return probe_first_live
    if kind == "windowed":
        return partial(probe_first_live_windowed, window=window)
    raise ValueError(f"unknown probe kind {kind!r}; "
                     "expected 'dense' or 'windowed'")


def segment_sum(values, seg_ids, num_segments: int):
    """(num_segments,) int32 sums of ``values`` (bool or int) grouped by
    ``seg_ids`` (every id in range).  Integer adds, so the result is exact
    whatever order the device adds in."""
    out = torch.zeros((num_segments,), dtype=torch.int32,
                      device=values.device)
    return out.index_add_(0, seg_ids, values.to(torch.int32))


def per_worker_add(acc, values, worker_ids, workers: int):
    """acc[p] += sum of values over vertices owned by worker p."""
    return acc + segment_sum(values, worker_ids, workers)


def worker_counts(mask, worker_ids, workers: int):
    return segment_sum(mask, worker_ids, workers)
