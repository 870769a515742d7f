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
_build.declare("frontier_compact", {
    "prefix_positions_launch": [_VP, ctypes.c_int, _I64, _I64, _VP, _VP,
                                _VP, _VP],
    "compact_fill_launch": [_VP] * 4 + [_I64, _I64, _VP],
    "expand_rows_launch": [_VP] * 4 + [_I64, _I64, _VP],
    "expand_slots_launch": [_VP] * 9 + [_I64, _I64, _I64, _VP]})
SCAN_THREADS = 256      # a block scans one tile of _build.SCAN_TILE
SUM_THREADS = 1024      # the one block that scans the tile sums
THREADS = 256           # compact_fill, expand_rows, expand_slots


def prefix_positions(x):
    """(n,) int32 or bool on a CUDA device -> (positions (n,) int32,
    total 0-d int32): ``positions[i] = sum(x[:i])``, ``total = sum(x)``."""
    _build.require_cuda("prefix_positions", x)
    if x.dtype not in (torch.int32, torch.bool) or x.dim() != 1:
        raise TypeError(f"prefix_positions: expected a 1-d int32 or bool "
                        f"tensor, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out, torch.zeros((), dtype=torch.int32, device=x.device)
    total = torch.empty((), dtype=torch.int32, device=x.device)
    tiles = _build.blocks(n, _build.SCAN_TILE)
    # the tile sums, then the tiles' exclusive offsets (scanned in place)
    sums = torch.empty((tiles,), dtype=torch.int32, device=x.device)
    grid, block = (tiles, 1, 1), (SCAN_THREADS, 1, 1)
    _build.launch(
        (_build.Launch("frontier_compact", "tile_reduce", grid, block, 0,
                       {"sums": sums}),
         _build.Launch("frontier_compact", "scan_tile_sums", (1, 1, 1),
                       (SUM_THREADS, 1, 1), 0,
                       {"sums": sums, "total": total}),
         _build.Launch("frontier_compact", "tile_scan", grid, block, 0,
                       {"out": out})),
        "prefix_positions_launch", _build.c_ptr(x),
        int(x.dtype == torch.bool), n, tiles, _build.c_ptr(sums),
        _build.c_ptr(total), _build.c_ptr(out), _build.stream_of(x))
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
    # a thread per slot of max(n, capacity): members write their slot,
    # slots past the count the sentinel
    spec = _build.Launch("frontier_compact", "compact_fill",
                         (_build.blocks(max(n, capacity), THREADS), 1, 1),
                         (THREADS, 1, 1), 0, {"ids": ids})
    _build.launch(spec, "compact_fill_launch", _build.c_ptr(mask),
                  _build.c_ptr(pos), _build.c_ptr(count), _build.c_ptr(ids),
                  n, capacity, _build.stream_of(mask))
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
    stream = _build.stream_of(indptr)
    row_base = torch.empty((C,), dtype=torch.int32, device=dev)
    deg = torch.empty((C,), dtype=torch.int32, device=dev)
    _build.launch(_build.Launch("frontier_compact", "expand_rows",
                                (_build.blocks(C, THREADS), 1, 1),
                                (THREADS, 1, 1), 0,
                                {"row_base": row_base, "deg": deg}),
                  "expand_rows_launch", _build.c_ptr(indptr),
                  _build.c_ptr(ids), _build.c_ptr(row_base),
                  _build.c_ptr(deg), C, n, stream)
    excl, total = prefix_positions(deg)
    _build.launch(_build.Launch("frontier_compact", "expand_slots",
                                (_build.blocks(ecap, THREADS), 1, 1),
                                (THREADS, 1, 1), 0,
                                {"src": src, "tgt": tgt, "pos": pos,
                                 "valid": valid}),
                  "expand_slots_launch", _build.c_ptr(ids),
                  _build.c_ptr(row_base), _build.c_ptr(excl),
                  _build.c_ptr(total), _build.c_ptr(indices),
                  _build.c_ptr(src), _build.c_ptr(tgt), _build.c_ptr(pos),
                  _build.c_ptr(valid), C, ecap, m, stream)
    _build.LAUNCHES["sparse_expand"] += 1
    return src, tgt, pos, valid
