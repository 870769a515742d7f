"""Public kernel wrappers: the tensor's device decides the path.

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels/ref.py``).  A tensor on a CUDA device launches the hand-written
Hopper kernel, or raises: there is no fallback from a failed build or
launch to the plain version.  Each kernel wrapper counts its launches in
:data:`LAUNCHES` (a plain int per kernel); the plain path never counts.

Mirrors ``src/repro/kernels/ops.py`` for the kernels of the trimming,
reachability, peel and stream engines' paths, of the LM prefill and of the
GNN layers' aggregation, and the static checks' copy kernel.  The
reference's ``use_kernel`` switch is not carried over: the device is the
only switch.
"""
from __future__ import annotations

import math

from . import ref
from ._build import LAUNCHES, reset_launches
from . import bucket_peel as _bpl
from . import counter_scatter as _cs
from . import first_live_scan as _fls
from . import flash_attention as _fa
from . import frontier_compact as _fc
from . import frontier_expand as _fex
from . import mutant_copy as _mc
from . import segment_sum as _ss

__all__ = ["LAUNCHES", "reset_launches", "first_live_scan",
           "prefix_positions", "frontier_compact", "sparse_expand",
           "frontier_expand", "bucket_peel", "counter_scatter",
           "flash_attention", "segment_sum", "mutant_copy"]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def first_live_scan(flags, valid, active):
    """(n, W) bool ×2 + (n,) bool -> (first (n,) int32, found (n,) bool)."""
    if _on_cpu(flags):
        return ref.first_live_ref(flags, valid, active)
    return _fls.first_live_scan(flags, valid, active)


def prefix_positions(x):
    """(n,) int32/bool -> (exclusive prefix (n,) int32, total 0-d int32)."""
    if _on_cpu(x):
        return ref.prefix_positions_ref(x)
    return _fc.prefix_positions(x)


def frontier_compact(mask, capacity: int):
    """(n,) bool -> (ids (capacity,) int32 with sentinel n, count 0-d)."""
    if _on_cpu(mask):
        return ref.frontier_compact_ref(mask, capacity)
    return _fc.frontier_compact(mask, capacity)


def sparse_expand(indptr, indices, ids, ecap: int):
    """CSR rows of compacted ``ids`` -> (src, tgt, pos, valid), (ecap,)."""
    if _on_cpu(indptr):
        return ref.sparse_expand_ref(indptr, indices, ids, ecap)
    return _fc.sparse_expand(indptr, indices, ids, ecap)


def frontier_expand(flags, valid, pending):
    """(n, W) bool ×2 + (n,) bool -> hit (n,) bool."""
    if _on_cpu(flags):
        return ref.frontier_expand_ref(flags, valid, pending)
    return _fex.frontier_expand(flags, valid, pending)


def bucket_peel(counters, alive, k):
    """(n,) int32 + (n,) bool + 1-element int32 ``k`` -> (n,) bool."""
    if _on_cpu(counters):
        return ref.bucket_peel_ref(counters, alive, k)
    return _bpl.bucket_peel(counters, alive, k)


def counter_scatter(counters, status, upd_src, upd_delta):
    """(n,) int32 + (n,) bool + (B,) int32 x 2 -> (new (n,) int32,
    dead (n,) bool)."""
    if _on_cpu(counters):
        return ref.counter_scatter_ref(counters, status, upd_src, upd_delta)
    return _cs.counter_scatter(counters, status, upd_src, upd_delta)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in
    q.dtype: causal GQA attention, queries aligned to the end of the keys.
    On a CUDA tensor an unsupported head dim or dtype raises."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
    return _fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def segment_sum(values, seg_ids, num_segments: int):
    """values (m, *rest) float32 or bfloat16, seg_ids (m,) int32/int64 ->
    (num_segments, *rest) float32 sums, out-of-range ids dropped.  The
    trailing dims are flattened to one (a view where the layout allows)
    and restored afterwards."""
    if _on_cpu(values):
        return ref.segment_sum_ref(values, seg_ids, num_segments)
    rest = tuple(values.shape[1:])
    flat = values.reshape(values.shape[0], math.prod(rest))
    return _ss.segment_sum(flat, seg_ids, num_segments).view(
        (num_segments,) + rest)


def mutant_copy(x, carry=None, *, block: int = 256):
    """(n,) int32 (+ a 1-element int32 carry) -> (n,) int32 ``x +
    carry``: the static checks' copy kernel."""
    if _on_cpu(x):
        return ref.mutant_copy_ref(x, carry)
    return _mc.mutant_copy(x, carry, block=block)
