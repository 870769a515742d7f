"""Frontier compaction on Hopper: ``prefix_positions``,
``frontier_compact`` and ``sparse_expand``.

The CUDA kernels are ``csrc/frontier_compact.cu``: a reduce-then-scan
exclusive prefix sum (the TPU's sequential grid with an SMEM carry has no
counterpart on a GPU, whose blocks run in no order), a one-pass fill of
the compacted id buffer, and a slot-parallel CSR expansion.  They compute
what ``src/repro/kernels/frontier_compact.py`` computes; every total stays
on the device, so no wrapper syncs with the host.

These wrappers take CUDA tensors only: they launch or raise.
``kernels.ops`` routes CPU tensors to the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_READY = []


def _lib():
    lib = _build.load("frontier_compact")
    if not _READY:
        sigs = {
            "prefix_positions_launch": [_VP, ctypes.c_int, _VP, _VP, _VP,
                                        _I64, _VP],
            "prefix_positions_tile": [],
            "frontier_compact_launch": [_VP, _VP, _VP, _VP, _I64, _I64, _VP],
            "sparse_expand_rows_launch": [_VP, _VP, _VP, _VP, _I64, _I64,
                                          _VP],
            "sparse_expand_slots_launch": [_VP] * 9 + [_I64, _I64, _I64,
                                                       _VP],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _READY.append(lib.prefix_positions_tile())
    return lib


def prefix_positions(x):
    """(n,) int32 or bool on a CUDA device -> (positions (n,) int32,
    total 0-d int32): ``positions[i] = sum(x[:i])``, ``total = sum(x)``."""
    _build.require_cuda("prefix_positions", x)
    if x.dtype not in (torch.int32, torch.bool) or x.dim() != 1:
        raise TypeError(f"prefix_positions: expected a 1-d int32 or bool "
                        f"tensor, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    total = torch.zeros((), dtype=torch.int32, device=x.device)
    if n == 0:
        return out, total
    lib = _lib()
    tiles = -(-n // _READY[0])
    scratch = torch.empty((tiles,), dtype=torch.int32, device=x.device)
    _build.check(lib, "prefix_positions", lib.prefix_positions_launch(
        _build.c_ptr(x), int(x.dtype == torch.bool), _build.c_ptr(out),
        _build.c_ptr(total), _build.c_ptr(scratch), n, _build.stream_of(x)))
    _build.LAUNCHES["prefix_positions"] += 1
    return out, total


def frontier_compact(mask, capacity: int):
    """(n,) bool on a CUDA device -> (ids (capacity,) int32, count 0-d
    int32) — see ``ref.frontier_compact_ref``."""
    _build.require_cuda("frontier_compact", mask)
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError("frontier_compact: expected a 1-d bool mask")
    n = mask.shape[0]
    if n == 0:
        return (torch.zeros((capacity,), dtype=torch.int32,
                            device=mask.device),
                torch.zeros((), dtype=torch.int32, device=mask.device))
    pos, count = prefix_positions(mask)
    ids = torch.empty((capacity,), dtype=torch.int32, device=mask.device)
    lib = _lib()
    _build.check(lib, "frontier_compact", lib.frontier_compact_launch(
        _build.c_ptr(mask), _build.c_ptr(pos), _build.c_ptr(count),
        _build.c_ptr(ids), n, capacity, _build.stream_of(mask)))
    _build.LAUNCHES["frontier_compact"] += 1
    return ids, count


def sparse_expand(indptr, indices, ids, ecap: int):
    """CSR rows of the compacted ``ids`` (int32, sentinel n) expanded into
    a static (ecap,) buffer ``(src, tgt, pos, valid)`` on the CUDA device —
    see ``ref.sparse_expand_ref``."""
    _build.require_cuda("sparse_expand", indptr, indices, ids)
    for t in (indptr, indices, ids):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError("sparse_expand: indptr, indices and ids must be "
                            "1-d int32")
    n = indptr.shape[0] - 1
    m = indices.shape[0]
    C = ids.shape[0]
    dev = indptr.device
    if n <= 0 or m == 0 or C == 0 or ecap == 0:
        z = torch.zeros((ecap,), dtype=torch.int32, device=dev)
        return (z, z.clone(), z.clone(),
                torch.zeros((ecap,), dtype=torch.bool, device=dev))
    src, tgt, pos = (torch.empty((ecap,), dtype=torch.int32, device=dev)
                     for _ in range(3))
    valid = torch.empty((ecap,), dtype=torch.bool, device=dev)
    lib = _lib()
    stream = _build.stream_of(indptr)
    row_base = torch.empty((C,), dtype=torch.int32, device=dev)
    deg = torch.empty((C,), dtype=torch.int32, device=dev)
    _build.check(lib, "sparse_expand", lib.sparse_expand_rows_launch(
        _build.c_ptr(indptr), _build.c_ptr(ids), _build.c_ptr(row_base),
        _build.c_ptr(deg), C, n, stream))
    excl, total = prefix_positions(deg)
    _build.check(lib, "sparse_expand", lib.sparse_expand_slots_launch(
        _build.c_ptr(ids), _build.c_ptr(row_base), _build.c_ptr(excl),
        _build.c_ptr(total), _build.c_ptr(indices), _build.c_ptr(src),
        _build.c_ptr(tgt), _build.c_ptr(pos), _build.c_ptr(valid), C, ecap,
        m, stream))
    _build.LAUNCHES["sparse_expand"] += 1
    return src, tgt, pos, valid
