"""Segment sum on Hopper: GNN message aggregation.

The CUDA kernel is ``csrc/segment_sum.cu`` ``scatter_rows``: a memset of
the output, then one thread per (row, group of 4 columns) that loads the row's values and
adds them into ``out[ids[row]]`` with float atomics.  It computes what
``src/repro/kernels/segment_reduce.py`` ``segment_sum_pallas`` computes:
float32 sums of (m, d) f32 or bf16 rows, with out-of-range ids (negatives
too) dropped.  The atomics sum in an order that changes from run to run,
so the result equals the plain version (``ref.segment_sum_ref``) to
rounding, not bit for bit.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to the plain version and flattens
trailing dimensions.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_build.declare("segment_sum", {
    "scatter_rows_launch": [_VP] * 3 + [_I64] * 4 + [ctypes.c_int] * 4
    + [_VP]})
THREADS = 256           # a thread per (row, group of 4 columns)


def segment_sum(values, seg_ids, num_segments: int):
    """values: (m, d) float32 or bfloat16 with unit column stride (a column
    slice is taken as it is; other layouts are copied); seg_ids: (m,) int32
    or int64; both on one CUDA device.  Returns ``(num_segments, d)``
    float32 sums; rows whose id lies outside ``[0, num_segments)`` add
    nothing."""
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
    # the entry point zeroes out, then scatters
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=values.device)
    row_stride = values.stride(0) if m > 1 else d
    align = 16 if values.dtype == torch.float32 else 8
    vec_in = int(values.data_ptr() % align == 0 and row_stride % 4 == 0)
    vec_out = int(out.data_ptr() % 16 == 0 and d % 4 == 0)
    spec = _build.Launch("segment_sum", "scatter_rows",
                         (_build.blocks(m * -(-d // 4), THREADS), 1, 1),
                         (THREADS, 1, 1), 0, {"out": out})
    _build.launch(spec, "scatter_rows_launch", _build.c_ptr(values),
                  _build.c_ptr(seg_ids), _build.c_ptr(out), m, d, row_stride,
                  num_segments, int(values.dtype == torch.bfloat16),
                  int(seg_ids.dtype == torch.int64), vec_in, vec_out,
                  _build.stream_of(values))
    _build.LAUNCHES["segment_sum"] += 1
    return out
