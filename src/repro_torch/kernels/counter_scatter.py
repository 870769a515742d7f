"""Counter maintenance on Hopper: one update batch of the stream engine.

The CUDA kernels are ``csrc/counter_scatter.cu``: a copy of the counters,
one int32 ``atomicAdd`` per in-range update with a non-zero delta
(``scatter_updates``), then a death pass with four vertices a thread
(``deaths_vec4``).  It computes what
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
_I64 = ctypes.c_int64
_build.declare("counter_scatter", {
    "scatter_updates_launch": [_VP] * 4 + [_I64, _I64, _VP],
    "deaths_vec4_launch": [_VP] * 3 + [_I64, _VP],
    "deaths_scalar_launch": [_VP] * 3 + [_I64, _VP]})
THREADS = 256


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
    dead = torch.empty((n,), dtype=torch.bool, device=counters.device)
    if n == 0:
        return torch.empty_like(counters), dead
    stream = _build.stream_of(counters)
    if b:
        # the entry point copies the counters into out, then adds
        out = torch.empty_like(counters)
        _build.launch(
            _build.Launch("counter_scatter", "scatter_updates",
                          (_build.blocks(b, THREADS), 1, 1), (THREADS, 1, 1),
                          0, {"out": out}),
            "scatter_updates_launch", _build.c_ptr(counters),
            _build.c_ptr(upd_src), _build.c_ptr(upd_delta),
            _build.c_ptr(out), n, b, stream)
    else:
        out = counters.clone()
    ptrs = [_build.c_ptr(t) for t in (out, status, dead)]
    if (out.data_ptr() % 16 == 0 and status.data_ptr() % 4 == 0
            and dead.data_ptr() % 4 == 0):
        # a thread per quad, plus one for the n % 4 tail when there is one
        spec = _build.Launch(
            "counter_scatter", "deaths_vec4",
            (_build.blocks(n // 4 + (n % 4 != 0), THREADS), 1, 1),
            (THREADS, 1, 1), 0, {"dead": dead})
        _build.launch(spec, "deaths_vec4_launch", *ptrs, n, stream)
    else:
        spec = _build.Launch("counter_scatter", "deaths_scalar",
                             (_build.blocks(n, THREADS), 1, 1),
                             (THREADS, 1, 1), 0, {"dead": dead})
        _build.launch(spec, "deaths_scalar_launch", *ptrs, n, stream)
    _build.LAUNCHES["counter_scatter"] += 1
    return out, dead
