"""First-live-neighbor scan on Hopper: the windowed AC-3/AC-6 probe.

The CUDA kernel is ``csrc/first_live_scan.cu`` (one thread per row, one
16-byte load per tile row at W = 16, inactive rows return before touching
their tiles).  It keeps the Pallas kernel's contract
(``src/repro/kernels/first_live_scan.py``): the liveness gather that builds
``flags`` stays outside the kernel, in ``core/common.py``.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to ``ref.first_live_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_build.declare("first_live_scan", {
    "first_live_w16_launch": [_VP] * 5 + [ctypes.c_int64, _VP],
    "first_live_any_launch": [_VP] * 5 + [ctypes.c_int64, ctypes.c_int,
                                          _VP]})
THREADS = 256           # one thread per row


def first_live_scan(flags, valid, active):
    """flags, valid: (n, W) bool; active: (n,) bool, all on one CUDA
    device.  Returns (first (n,) int32, found (n,) bool) — see
    ``ref.first_live_ref``."""
    _build.require_cuda("first_live_scan", flags, valid, active)
    if flags.dtype != torch.bool or valid.dtype != torch.bool \
            or active.dtype != torch.bool:
        raise TypeError("first_live_scan: flags, valid and active must be "
                        "bool")
    n, window = flags.shape
    if valid.shape != (n, window) or active.shape != (n,):
        raise ValueError(f"first_live_scan: shapes {tuple(flags.shape)}, "
                         f"{tuple(valid.shape)}, {tuple(active.shape)} do "
                         "not match")
    first = torch.empty((n,), dtype=torch.int32, device=flags.device)
    found = torch.empty((n,), dtype=torch.bool, device=flags.device)
    if n == 0:
        return first, found
    ptrs = [_build.c_ptr(t) for t in (flags, valid, active, first, found)]
    vec16 = (window == 16 and flags.data_ptr() % 16 == 0
             and valid.data_ptr() % 16 == 0)
    spec = _build.Launch(
        "first_live_scan", "first_live_w16" if vec16 else "first_live_any",
        (_build.blocks(n, THREADS), 1, 1), (THREADS, 1, 1), 0,
        {"first": first, "found": found})
    if vec16:
        _build.launch(spec, "first_live_w16_launch", *ptrs, n,
                      _build.stream_of(flags))
    else:
        _build.launch(spec, "first_live_any_launch", *ptrs, n, window,
                      _build.stream_of(flags))
    _build.LAUNCHES["first_live_scan"] += 1
    return first, found
