"""Counter maintenance on Hopper: one update batch of the stream engine.

The CUDA kernel is ``csrc/counter_scatter.cu``: a copy of the counters,
one int32 ``atomicAdd`` per in-range update with a non-zero delta, then a
death pass with four vertices a thread.  It computes what
``src/repro/kernels/counter_scatter.py`` computes; int32 atomics are
exact, so the result equals the plain version bit for bit.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to ``ref.counter_scatter_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_READY = []


def _lib():
    lib = _build.load("counter_scatter")
    if not _READY:
        lib.counter_scatter_launch.restype = ctypes.c_int
        lib.counter_scatter_launch.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, _VP]
        _READY.append(True)
    return lib


def counter_scatter(counters, status, upd_src, upd_delta):
    """counters: (n,) int32; status: (n,) bool; upd_src, upd_delta: (B,)
    int32, all on one CUDA device.  Returns ``(new, dead)``: (n,) int32
    and (n,) bool — see ``ref.counter_scatter_ref``.  The inputs are not
    modified; non-contiguous ones are copied to contiguous ones first."""
    counters, status, upd_src, upd_delta = (
        t.contiguous() for t in (counters, status, upd_src, upd_delta))
    _build.require_cuda("counter_scatter", counters, status, upd_src,
                        upd_delta)
    if counters.dtype != torch.int32 or status.dtype != torch.bool \
            or upd_src.dtype != torch.int32 or upd_delta.dtype != torch.int32:
        raise TypeError("counter_scatter: counters, upd_src and upd_delta "
                        "must be int32, status bool")
    n, b = counters.shape[0], upd_src.shape[0]
    if counters.dim() != 1 or status.shape != (n,) or upd_src.dim() != 1 \
            or upd_delta.shape != (b,):
        raise ValueError(f"counter_scatter: shapes {tuple(counters.shape)}, "
                         f"{tuple(status.shape)}, {tuple(upd_src.shape)}, "
                         f"{tuple(upd_delta.shape)} do not match")
    out = torch.empty_like(counters)
    dead = torch.empty((n,), dtype=torch.bool, device=counters.device)
    if n == 0:
        return out, dead
    lib = _lib()
    vec4 = int(out.data_ptr() % 16 == 0 and status.data_ptr() % 4 == 0
               and dead.data_ptr() % 4 == 0)
    _build.check(lib, "counter_scatter", lib.counter_scatter_launch(
        _build.c_ptr(counters), _build.c_ptr(status), _build.c_ptr(upd_src),
        _build.c_ptr(upd_delta), _build.c_ptr(out), _build.c_ptr(dead), n, b,
        vec4, _build.stream_of(counters)))
    _build.LAUNCHES["counter_scatter"] += 1
    return out, dead
