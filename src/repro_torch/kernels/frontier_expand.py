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
_READY = []


def _lib():
    lib = _build.load("frontier_expand")
    if not _READY:
        lib.frontier_expand_launch.restype = ctypes.c_int
        lib.frontier_expand_launch.argtypes = [
            _VP, _VP, _VP, _VP, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            _VP]
        _READY.append(True)
    return lib


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
    lib = _lib()
    vec16 = int(window > 0 and window % 16 == 0
                and flags.data_ptr() % 16 == 0 and valid.data_ptr() % 16 == 0)
    _build.check(lib, "frontier_expand", lib.frontier_expand_launch(
        _build.c_ptr(flags), _build.c_ptr(valid), _build.c_ptr(pending),
        _build.c_ptr(hit), n, window, vec16, _build.stream_of(flags)))
    _build.LAUNCHES["frontier_expand"] += 1
    return hit
