"""Segment sum on Hopper: GNN message aggregation.

The CUDA kernel is ``csrc/segment_sum.cu`` ``segment_rows``, one launch a
call: it reduces the rows of each segment in a sorted order, in
registers, and writes every output row once with plain stores (no memset,
no atomic into the output).  A segment whose rows are split between
workers is finished in the same launch: a worker adds the partial sums
of the workers before it in its CTA, and of the CTAs before it through
the single-pass kernels' look-back scratch
(:func:`frontier_compact.lookback_scratch`), in a fixed order, so two
calls on the same inputs give the same bits.  The order comes from a
:class:`SegmentIndex` (:func:`segment_index`): built once per graph in
plain PyTorch and passed to every aggregation over the same ids.  It
computes what ``src/repro/kernels/segment_reduce.py``
``segment_sum_pallas`` computes: float32 sums of (m, d) f32 or bf16 rows,
with out-of-range ids (negatives too) dropped.  The sums run in another
order than the plain version's (``ref.segment_sum_ref``), so the two agree
to rounding, not bit for bit.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to the plain version and flattens
trailing dimensions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .frontier_compact import lookback_scratch

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_build.declare("segment_sum", {
    "segment_sum_launch": [_VP] * 6 + [ctypes.c_uint] + [_I64] * 5
    + [ctypes.c_int] * 4 + [_VP]})
THREADS = 256           # segment_rows
#: threads resident on one streaming multiprocessor that the merge-path
#: split aims to fill with workers, and the merge-path items (rows plus
#: segment ends) a worker takes at least.  Of the settings swept at the
#: shapes that one molecule training step of the four GNNs launches,
#: weighted by their launches (``tools/kernel_ab.py --sweep``; PERF.md §6),
#: 16 items at 2,048 threads took the least device time without slowing
#: MeshGraphNet's minibatch_lg shape, where the split gives 41 items
SM_THREADS = 2048
MIN_ITEMS = 16
#: the SM count a launch recorded on meta tensors assumes (``_build``)
META_SMS = _build.META_SMS
sm_count = _build.sm_count


class SegmentIndex(NamedTuple):
    """The rows of an id vector grouped by segment: ``order`` (m,) int32,
    the rows with ids in ``[0, num_segments)`` stably sorted by id, then
    the dropped rows; ``offsets`` (num_segments + 1,) int32, segment s owns
    ``order[offsets[s]:offsets[s + 1]]``."""

    order: torch.Tensor
    offsets: torch.Tensor


def segment_index(seg_ids, num_segments: int) -> SegmentIndex:
    """The :class:`SegmentIndex` of ``seg_ids`` ((m,) int32 or int64, on
    any device), in plain PyTorch and without a host sync: a stable sort of
    the ids (out-of-range ones sorted last as ``num_segments``) and a
    search of each segment's first position."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    keys = torch.where(ok, seg_ids, num_segments).to(torch.int32)
    keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=keys.device)
    offsets = torch.searchsorted(keys, bounds, out_int32=True)
    return SegmentIndex(order.to(torch.int32), offsets)


def lanes_for(d: int) -> int:
    """Threads of one worker at row width ``d``: the power of two that
    covers ``d`` in groups of 4 columns, at most a warp."""
    return min(32, 1 << max(0, (-(-d // 4) - 1).bit_length()))


def split(m: int, n: int, d: int, sms: int) -> tuple:
    """The merge-path split of ``m`` rows and ``n`` segments at width
    ``d`` on a card of ``sms`` multiprocessors: (lanes a worker, column
    chunks, items a worker, workers).  The path holds at most ``m + n``
    items (dropped rows are left out on the card), cut so the workers of
    every chunk about fill the card once."""
    lanes = lanes_for(d)
    chunks = -(-d // (4 * lanes))
    resident = max(1, sms * SM_THREADS // (lanes * chunks))
    items = max(MIN_ITEMS, -(-(m + n) // resident))
    return lanes, chunks, items, -(-(m + n) // items)


def segment_sum(values, seg_ids, num_segments: int,
                index: SegmentIndex | None = None):
    """values: (m, d) float32 or bfloat16 with unit column stride (a column
    slice is taken as it is; other layouts are copied); seg_ids: (m,) int32
    or int64; both on one CUDA device.  Returns ``(num_segments, d)``
    float32 sums; rows whose id lies outside ``[0, num_segments)`` add
    nothing.  ``index``: :func:`segment_index` of ``seg_ids`` where the
    caller holds one; else it is built here."""
    if values.dim() != 2 or seg_ids.dim() != 1 \
            or seg_ids.shape[0] != values.shape[0]:
        raise ValueError(f"segment_sum: values (m, d) and seg_ids (m,), got "
                         f"{tuple(values.shape)} and {tuple(seg_ids.shape)}")
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum: values must be float32 or bfloat16, "
                        f"got {values.dtype}")
    if seg_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_sum: seg_ids must be int32 or int64, got "
                        f"{seg_ids.dtype}")
    m, d = values.shape
    if values.stride(1) != 1 or values.stride(0) < d:
        values = values.contiguous()
    seg_ids = seg_ids.contiguous()
    _build.require_cuda("segment_sum", seg_ids)
    if values.device != seg_ids.device:
        raise ValueError("segment_sum: values and seg_ids lie on different "
                         f"devices ({values.device}, {seg_ids.device})")
    if num_segments == 0 or d == 0 or m == 0:
        return torch.zeros((num_segments, d), dtype=torch.float32,
                           device=values.device)
    if index is None:
        index = segment_index(seg_ids, num_segments)
    order, offsets = index
    if order.shape != (m,) or offsets.shape != (num_segments + 1,) \
            or order.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError(f"segment_sum: the index does not fit {m} rows and "
                         f"{num_segments} segments")
    _build.require_cuda("segment_sum", order, offsets)
    dev = values.device
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    lanes, chunks, items, workers = split(m, num_segments, d, sm_count(dev))
    grid = (_build.blocks(workers, THREADS // lanes), chunks, 1)
    tickets = grid[0] * grid[1]
    carry = torch.empty((tickets, 4 * lanes), dtype=torch.float32,
                        device=dev)
    stream = _build.stream_of(values)
    scratch, epoch = lookback_scratch(dev, stream, tickets)
    row_stride = values.stride(0) if m > 1 else d
    align = 16 if values.dtype == torch.float32 else 8
    vec_in = int(values.data_ptr() % align == 0 and row_stride % 4 == 0)
    vec_out = int(out.data_ptr() % 16 == 0 and d % 4 == 0)
    _build.launch(
        _build.Launch("segment_sum", "segment_rows", grid, (THREADS, 1, 1),
                      0, {"out": out, "carry": carry}, scratch=True),
        "segment_sum_launch", _build.c_ptr(values), _build.c_ptr(order),
        _build.c_ptr(offsets), _build.c_ptr(out), _build.c_ptr(carry),
        _build.c_ptr(scratch), epoch, num_segments, d, row_stride, items,
        workers, lanes.bit_length() - 1, int(values.dtype == torch.bfloat16),
        vec_in, vec_out, stream)
    _build.LAUNCHES["segment_sum"] += 1
    return out
