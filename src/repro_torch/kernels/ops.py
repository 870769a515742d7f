"""Public kernel wrappers: the tensor's device decides the path.

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels/ref.py``).  A tensor on a CUDA device launches the hand-written
Hopper kernel, or raises: there is no fallback from a failed build or
launch to the plain version.  Each kernel wrapper counts its launches in
:data:`LAUNCHES` (a plain int per kernel; ``flash_attention_bwd`` counts
the torch-op backward on the card); the plain path never counts.
Every call, on either path, is also noted to the observability layer
(``obs.note_kernel``: an instant span, ``repro_kernel_calls``, and the
plan cost capture), which costs an attribute read or two when it is off.

Mirrors ``src/repro/kernels/ops.py`` for the kernels of the trimming,
reachability, peel and stream engines' paths, of the LM prefill and
training and of the GNN layers' aggregation, and the static checks' copy
kernel.  The
reference's ``use_kernel`` switch is not carried over: the device is the
only switch.
"""
from __future__ import annotations

import math

import torch

from ..obs.recorder import note_kernel
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
           "first_live_probe",
           "prefix_positions", "frontier_compact", "sparse_expand",
           "frontier_expand", "bucket_peel", "counter_scatter",
           "flash_attention", "segment_index", "segment_sum", "mutant_copy"]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def _noted(name: str, cpu: bool, args, out):
    note_kernel(name, "plain" if cpu else "cuda", args, out)
    return out


def first_live_scan(flags, valid, active):
    """(n, W) bool ×2 + (n,) bool -> (first (n,) int32, found (n,) bool)."""
    cpu = _on_cpu(flags)
    out = (ref.first_live_ref(flags, valid, active) if cpu
           else _fls.first_live_scan(flags, valid, active))
    return _noted("first_live_scan", cpu, (flags, valid, active), out)


def first_live_probe(status, indptr, indices, start, scanning,
                     window: int = 16):
    """(n,) bool status, CSR (indptr, indices), (n,) int32 start and (n,)
    bool scanning -> (first (n,) int32, found (n,) bool) of each scanning
    row's window: the windowed probe with its liveness gather."""
    args = (status, indptr, indices, start, scanning, window)
    cpu = _on_cpu(status)
    out = (ref.first_live_probe_ref(*args) if cpu
           else _fls.first_live_probe(*args))
    return _noted("first_live_probe", cpu, args, out)


def prefix_positions(x):
    """(n,) int32/bool -> (exclusive prefix (n,) int32, total 0-d int32)."""
    cpu = _on_cpu(x)
    out = ref.prefix_positions_ref(x) if cpu else _fc.prefix_positions(x)
    return _noted("prefix_positions", cpu, (x,), out)


def frontier_compact(mask, capacity: int):
    """(n,) bool -> (ids (capacity,) int32 with sentinel n, count 0-d)."""
    cpu = _on_cpu(mask)
    out = (ref.frontier_compact_ref(mask, capacity) if cpu
           else _fc.frontier_compact(mask, capacity))
    return _noted("frontier_compact", cpu, (mask, capacity), out)


def sparse_expand(indptr, indices, ids, ecap: int):
    """CSR rows of compacted ``ids`` -> (src, tgt, pos, valid), (ecap,)."""
    args = (indptr, indices, ids, ecap)
    cpu = _on_cpu(indptr)
    out = ref.sparse_expand_ref(*args) if cpu else _fc.sparse_expand(*args)
    return _noted("sparse_expand", cpu, args, out)


def frontier_expand(flags, valid, pending):
    """(n, W) bool ×2 + (n,) bool -> hit (n,) bool."""
    cpu = _on_cpu(flags)
    out = (ref.frontier_expand_ref(flags, valid, pending) if cpu
           else _fex.frontier_expand(flags, valid, pending))
    return _noted("frontier_expand", cpu, (flags, valid, pending), out)


def bucket_peel(counters, alive, k):
    """(n,) int32 + (n,) bool + 1-element int32 ``k`` -> (n,) bool."""
    cpu = _on_cpu(counters)
    out = (ref.bucket_peel_ref(counters, alive, k) if cpu
           else _bpl.bucket_peel(counters, alive, k))
    return _noted("bucket_peel", cpu, (counters, alive, k), out)


def counter_scatter(counters, status, upd_src, upd_delta):
    """(n,) int32 + (n,) bool + (B,) int32 x 2 -> (new (n,) int32,
    dead (n,) bool)."""
    args = (counters, status, upd_src, upd_delta)
    cpu = _on_cpu(counters)
    out = (ref.counter_scatter_ref(*args) if cpu
           else _cs.counter_scatter(*args))
    return _noted("counter_scatter", cpu, args, out)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in
    q.dtype: causal GQA attention, queries aligned to the end of the keys.
    On a CUDA tensor an unsupported head dim or dtype raises.  With grad
    enabled and an input that requires it, the call goes through
    ``flash_attention.FlashAttentionFn`` (the same forward, and the
    gradient of ``flash_attention_bwd``)."""
    cpu = _on_cpu(q)
    fwd = ref.flash_attention_ref if cpu else _fa.flash_attention
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _fa.FlashAttentionFn.apply(q, k, v, causal, sm_scale, fwd)
    else:
        out = fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    return _noted("flash_attention", cpu, (q, k, v, causal, sm_scale), out)


def segment_index(seg_ids, num_segments: int):
    """(m,) int32/int64 ids -> ``segment_sum.SegmentIndex`` (``order``,
    the rows with in-range ids stably sorted by id; ``offsets``, each
    segment's start): built once per graph and passed to every
    :func:`segment_sum` over the same ids.  Plain PyTorch on every device,
    no host sync."""
    return _ss.segment_index(seg_ids, num_segments)


def segment_sum(values, seg_ids, num_segments: int, index=None):
    """values (m, *rest) float32 or bfloat16, seg_ids (m,) int32/int64 ->
    (num_segments, *rest) float32 sums, out-of-range ids dropped.  The
    trailing dims are flattened to one (a view where the layout allows)
    and restored afterwards.  ``index``: :func:`segment_index` of
    ``seg_ids``, built here where it is None; the plain version on the CPU
    does not need it."""
    cpu = _on_cpu(values)
    if cpu:
        out = ref.segment_sum_ref(values, seg_ids, num_segments)
    else:
        rest = tuple(values.shape[1:])
        flat = values.reshape(values.shape[0], math.prod(rest))
        out = _ss.segment_sum(flat, seg_ids, num_segments, index).view(
            (num_segments,) + rest)
    return _noted("segment_sum", cpu, (values, seg_ids, num_segments), out)


def mutant_copy(x, carry=None, *, block: int = 256):
    """(n,) int32 (+ a 1-element int32 carry) -> (n,) int32 ``x +
    carry``: the static checks' copy kernel."""
    cpu = _on_cpu(x)
    out = (ref.mutant_copy_ref(x, carry) if cpu
           else _mc.mutant_copy(x, carry, block=block))
    return _noted("mutant_copy", cpu, (x, carry), out)
