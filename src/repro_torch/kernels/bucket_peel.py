"""Bucket extraction on Hopper: one round's frontier of the k-core peel.

The CUDA kernel is ``csrc/bucket_peel.cu`` (four vertices per thread with
16-byte counter loads; quads with no alive vertex never load their
counters).  It computes what ``src/repro/kernels/bucket_peel.py``
computes.  The bucket level ``k`` is a 1-element int32 tensor on the
device, read by the kernel through its pointer, so the peel's round loop
advances it without a host sync.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to ``ref.bucket_peel_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_build.declare("bucket_peel", {
    "bucket_peel_vec4_launch": [_VP] * 4 + [ctypes.c_int64, _VP],
    "bucket_peel_scalar_launch": [_VP] * 4 + [ctypes.c_int64, _VP]})
THREADS = 256


def bucket_peel(counters, alive, k):
    """counters: (n,) int32; alive: (n,) bool; k: 1-element int32 tensor,
    all on one CUDA device.  Returns frontier (n,) bool = ``alive &
    (counters <= k)``.  Non-contiguous inputs are copied to contiguous
    ones first."""
    if not isinstance(k, torch.Tensor):
        raise TypeError("bucket_peel: k must be a 1-element int32 tensor on "
                        "the device, not a host value")
    counters, alive, k = (t.contiguous() for t in (counters, alive, k))
    _build.require_cuda("bucket_peel", counters, alive, k)
    if counters.dtype != torch.int32 or alive.dtype != torch.bool \
            or k.dtype != torch.int32:
        raise TypeError("bucket_peel: counters and k must be int32, alive "
                        "bool")
    n = counters.shape[0]
    if counters.dim() != 1 or alive.shape != (n,) or k.numel() != 1:
        raise ValueError(f"bucket_peel: shapes {tuple(counters.shape)}, "
                         f"{tuple(alive.shape)}, {tuple(k.shape)} do not "
                         "match")
    out = torch.empty((n,), dtype=torch.bool, device=counters.device)
    if n == 0:
        return out
    ptrs = [_build.c_ptr(t) for t in (counters, alive, k, out)]
    if (counters.data_ptr() % 16 == 0 and alive.data_ptr() % 4 == 0
            and out.data_ptr() % 4 == 0):
        # a thread per quad, plus one for the n % 4 tail when there is one
        spec = _build.Launch(
            "bucket_peel", "bucket_peel_vec4",
            (_build.blocks(n // 4 + (n % 4 != 0), THREADS), 1, 1),
            (THREADS, 1, 1), 0, {"out": out})
        _build.launch(spec, "bucket_peel_vec4_launch", *ptrs, n,
                      _build.stream_of(counters))
    else:
        spec = _build.Launch("bucket_peel", "bucket_peel_scalar",
                             (_build.blocks(n, THREADS), 1, 1),
                             (THREADS, 1, 1), 0, {"out": out})
        _build.launch(spec, "bucket_peel_scalar_launch", *ptrs, n,
                      _build.stream_of(counters))
    _build.LAUNCHES["bucket_peel"] += 1
    return out
