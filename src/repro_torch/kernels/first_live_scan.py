"""First-live-neighbor scan on Hopper: the windowed AC-3/AC-6 probe.

The CUDA kernels are in ``csrc/first_live_scan.cu``.  ``first_live_scan``
keeps the Pallas kernel's contract (``src/repro/kernels/first_live_scan.py``:
one thread per row, one 16-byte load per tile row at W = 16, inactive rows
return before touching their tiles), with the liveness tiles built by the
caller.  ``first_live_probe`` is the probe the engines run: it reads the
graph, the liveness snapshot and the scan pointers itself (a thread per
row), so the (n, W) tiles are never built.

These wrappers take CUDA tensors only: they launch the kernel or raise.
``kernels.ops`` routes CPU tensors to ``ref.first_live_ref`` and
``ref.first_live_probe_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_build.declare("first_live_scan", {
    "first_live_w16_launch": [_VP] * 5 + [ctypes.c_int64, _VP],
    "first_live_any_launch": [_VP] * 5 + [ctypes.c_int64, ctypes.c_int,
                                          _VP],
    "first_live_probe_launch": [_VP] * 7 + [ctypes.c_int64] * 2
                               + [ctypes.c_int, _VP]})
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


def first_live_probe(status, indptr, indices, start, scanning,
                     window: int = 16):
    """status: (n,) bool; indptr: (n+1,) int32; indices: (m,) int32;
    start: (n,) int32; scanning: (n,) bool, all on one CUDA device.
    Returns (first (n,) int32, found (n,) bool) of the window of ``window``
    positions from ``min(start, deg)`` — see ``ref.first_live_probe_ref``.
    One launch, a thread a row."""
    _build.require_cuda("first_live_probe", status, indptr, indices, start,
                        scanning)
    if status.dtype != torch.bool or scanning.dtype != torch.bool \
            or indptr.dtype != torch.int32 or indices.dtype != torch.int32 \
            or start.dtype != torch.int32:
        raise TypeError("first_live_probe: status and scanning must be "
                        "bool, indptr, indices and start int32")
    n = indptr.shape[0] - 1
    if status.shape != (n,) or start.shape != (n,) \
            or scanning.shape != (n,) or indices.dim() != 1 or window < 1:
        raise ValueError(f"first_live_probe: shapes {tuple(status.shape)}, "
                         f"{tuple(indptr.shape)}, {tuple(indices.shape)}, "
                         f"{tuple(start.shape)}, {tuple(scanning.shape)} or "
                         f"window {window} do not match")
    dev = status.device
    first = torch.empty((n,), dtype=torch.int32, device=dev)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    if n <= 0:
        return first, found
    spec = _build.Launch(
        "first_live_scan", "first_live_probe",
        (_build.blocks(n, THREADS), 1, 1), (THREADS, 1, 1), 0,
        {"first": first, "found": found})
    _build.launch(spec, "first_live_probe_launch",
                  *(_build.c_ptr(t) for t in (status, indptr, indices, start,
                                              scanning, first, found)),
                  n, indices.shape[0], window, _build.stream_of(status))
    _build.LAUNCHES["first_live_probe"] += 1
    return first, found
