"""Frontier expansion on Hopper: one pull round of the windowed reach
sweep.

The CUDA kernel is ``csrc/frontier_expand.cu`` (one thread per row, W/16
16-byte loads per tile row when W is a multiple of 16, rows that are not
pending return before touching their tiles).  It keeps the Pallas
kernel's contract (``src/repro/kernels/frontier_expand.py``): the
frontier-membership gather that builds ``flags`` stays outside the
kernel, in ``core/reach.py``.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to ``ref.frontier_expand_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_build.declare("frontier_expand", {
    "frontier_expand_vec16_launch": [_VP] * 4 + [ctypes.c_int64,
                                                 ctypes.c_int, _VP],
    "frontier_expand_any_launch": [_VP] * 4 + [ctypes.c_int64, ctypes.c_int,
                                               _VP]})
THREADS = 256           # one thread per row


def frontier_expand(flags, valid, pending):
    """flags, valid: (n, W) bool; pending: (n,) bool, all on one CUDA
    device.  Returns hit (n,) bool — see ``ref.frontier_expand_ref``.
    Non-contiguous inputs are copied to contiguous ones first."""
    flags, valid, pending = (t.contiguous() for t in (flags, valid, pending))
    _build.require_cuda("frontier_expand", flags, valid, pending)
    if flags.dtype != torch.bool or valid.dtype != torch.bool \
            or pending.dtype != torch.bool:
        raise TypeError("frontier_expand: flags, valid and pending must be "
                        "bool")
    n, window = flags.shape
    if valid.shape != (n, window) or pending.shape != (n,):
        raise ValueError(f"frontier_expand: shapes {tuple(flags.shape)}, "
                         f"{tuple(valid.shape)}, {tuple(pending.shape)} do "
                         "not match")
    hit = torch.empty((n,), dtype=torch.bool, device=flags.device)
    if n == 0:
        return hit
    ptrs = [_build.c_ptr(t) for t in (flags, valid, pending, hit)]
    vec16 = (window > 0 and window % 16 == 0 and flags.data_ptr() % 16 == 0
             and valid.data_ptr() % 16 == 0)
    kernel = "frontier_expand_vec16" if vec16 else "frontier_expand_any"
    spec = _build.Launch("frontier_expand", kernel,
                         (_build.blocks(n, THREADS), 1, 1), (THREADS, 1, 1),
                         0, {"hit": hit})
    _build.launch(spec, kernel + "_launch", *ptrs, n,
                  window // 16 if vec16 else window, _build.stream_of(flags))
    _build.LAUNCHES["frontier_expand"] += 1
    return hit
