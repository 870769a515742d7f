"""Frontier compaction on Hopper: ``prefix_positions``,
``frontier_compact`` and ``sparse_expand``.

The CUDA kernels are ``csrc/frontier_compact.cu``: a single-pass
exclusive prefix sum (``scan_lookback``) and a single-pass compaction
(``compact_lookback``), each one launch and one read of its input with
decoupled look-back (the GPU form of the TPU's sequential grid with an
SMEM carry), and a one-launch CSR expansion (``expand_lookback``: row
CTAs scan the degrees by the same look-back, slot CTAs after them find
their owners in shared memory).  The three share one scratch buffer per
(device, stream).  They compute what
``src/repro/kernels/frontier_compact.py`` computes; every total stays on
the device, so no wrapper syncs with the host.

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
    "scan_lookback_launch": [_VP, ctypes.c_int, ctypes.c_int, _I64, _I64,
                             _VP, ctypes.c_uint, _VP, _VP, _VP],
    "compact_lookback_launch": [_VP, ctypes.c_int, _I64, _I64, _I64, _VP,
                                ctypes.c_uint, _VP, _VP, _VP],
    "expand_lookback_launch": [_VP] * 3 + [_I64] * 5 + [_VP, ctypes.c_uint]
                              + [_VP] * 6})
SCAN_THREADS = 256      # scan_lookback: a CTA per tile of _build.SCAN_TILE
THREADS = 256           # compact_lookback, expand_lookback
#: expand_lookback's slot CTAs a multiprocessor (they take the slot tiles
#: from a counter)
EXPAND_SLOT_CTAS_PER_SM = 4
#: sentinel slots per fill CTA of compact_lookback: a capacity of up to
#: FILL_SLOTS is filled by the last tile's CTA, a larger one by
#: ceil(capacity / FILL_SLOTS) - 1 CTAs after the tiles
FILL_SLOTS = 4096
#: the single-pass kernels' status words carry a 30-bit epoch
EPOCHS = 1 << 30
#: (device, stream) -> (scratch buffer, epoch of the last call)
_SCRATCH: dict = {}


def prefix_positions(x):
    """(n,) int32 or bool on a CUDA device -> (positions (n,) int32,
    total 0-d int32): ``positions[i] = sum(x[:i])``, ``total = sum(x)``.
    One launch of scan_lookback."""
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
    stream = _build.stream_of(x)
    scratch, epoch = lookback_scratch(x.device, stream, tiles)
    mask = x.dtype == torch.bool
    # a quad of int32 is one 16-byte load, of mask bytes one 4-byte load
    aligned = x.data_ptr() % (4 if mask else 16) == 0
    spec = _build.Launch("frontier_compact", "scan_lookback", (tiles, 1, 1),
                         (SCAN_THREADS, 1, 1), 0,
                         {"out": out, "total": total}, scratch=True)
    _build.launch(spec, "scan_lookback_launch", _build.c_ptr(x), int(mask),
                  int(aligned), n, tiles, _build.c_ptr(scratch), epoch,
                  _build.c_ptr(out), _build.c_ptr(total), stream)
    _build.LAUNCHES["prefix_positions"] += 1
    return out, total


def lookback_scratch(device, stream, tiles: int):
    """The single-pass kernels' scratch on ``device`` for launches on
    ``stream`` and the epoch of this call: one int64 buffer of the ticket
    word and a status word per tile (ticket), kept from call to call and
    never cleared between them (the ticket clears itself and the status
    words carry the epoch).  ``scan_lookback``, ``compact_lookback``,
    ``expand_lookback`` and ``segment_sum``'s ``segment_rows`` share it:
    launches on one stream run in order.  It is zeroed only when it is
    made, grown, or when the epoch wraps.  A CUDA graph that captures any of them replays one
    epoch, so it must clear the buffer inside the graph first."""
    key = (str(device), stream.value)
    buf, epoch = _SCRATCH.get(key, (None, 0))
    epoch += 1
    if buf is None or buf.shape[0] < 1 + tiles or epoch == EPOCHS:
        size = 1 + max(tiles, 0 if buf is None else buf.shape[0] - 1)
        buf = torch.zeros((size,), dtype=torch.int64, device=device)
        epoch = 1
    _SCRATCH[key] = (buf, epoch)
    return buf, epoch


def frontier_compact(mask, capacity: int):
    """(n,) bool on a CUDA device -> (ids (capacity,) int32, count 0-d
    int32) — see ``ref.frontier_compact_ref``.  One launch of
    compact_lookback."""
    _build.require_cuda("frontier_compact", mask)
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError("frontier_compact: expected a 1-d bool mask")
    n = mask.shape[0]
    if n == 0:
        return (torch.zeros((capacity,), dtype=torch.int32,
                            device=mask.device),
                torch.zeros((), dtype=torch.int32, device=mask.device))
    ids = torch.empty((capacity,), dtype=torch.int32, device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    tiles = _build.blocks(n, _build.COMPACT_TILE)
    stream = _build.stream_of(mask)
    scratch, epoch = lookback_scratch(mask.device, stream, tiles)
    # a CTA per tile, then the fill CTAs of the sentinel slots
    fill = max(_build.blocks(capacity, FILL_SLOTS) - 1, 0)
    spec = _build.Launch("frontier_compact", "compact_lookback",
                         (tiles + fill, 1, 1), (THREADS, 1, 1), 0,
                         {"ids": ids, "count": count}, scratch=True)
    _build.launch(spec, "compact_lookback_launch", _build.c_ptr(mask),
                  int(mask.data_ptr() % 16 == 0), n, capacity, tiles,
                  _build.c_ptr(scratch), epoch, _build.c_ptr(ids),
                  _build.c_ptr(count), stream)
    _build.LAUNCHES["frontier_compact"] += 1
    return ids, count


def sparse_expand(indptr, indices, ids, ecap: int):
    """CSR rows of the compacted ``ids`` (int32, sentinel n) expanded into
    a static (ecap,) buffer ``(src, tgt, pos, valid)`` on the CUDA device —
    see ``ref.sparse_expand_ref``.  One launch of expand_lookback: a CTA
    per ``_build.EXPAND_ROW_TILE`` ids, then slot CTAs that take the slot
    tiles of ``_build.EXPAND_SLOT_TILE`` from a counter."""
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
    rows = torch.empty((C, 2), dtype=torch.int32, device=dev)
    row_tiles = _build.blocks(C, _build.EXPAND_ROW_TILE)
    stream = _build.stream_of(indptr)
    scratch, epoch = lookback_scratch(dev, stream,
                                      _build.EXPAND_STATUS_AT - 1
                                      + 2 * row_tiles)
    slot_ctas = min(_build.blocks(ecap, _build.EXPAND_SLOT_TILE),
                    EXPAND_SLOT_CTAS_PER_SM * _build.sm_count(dev))
    spec = _build.Launch(
        "frontier_compact", "expand_lookback", (row_tiles + slot_ctas, 1, 1),
        (THREADS, 1, 1), 0,
        {"src": src, "tgt": tgt, "pos": pos, "valid": valid, "rows": rows},
        scratch=True)
    _build.launch(spec, "expand_lookback_launch", _build.c_ptr(indptr),
                  _build.c_ptr(indices), _build.c_ptr(ids), n, m, C, ecap,
                  row_tiles, _build.c_ptr(scratch), epoch, _build.c_ptr(rows),
                  _build.c_ptr(src), _build.c_ptr(tgt), _build.c_ptr(pos),
                  _build.c_ptr(valid), stream)
    _build.LAUNCHES["sparse_expand"] += 1
    return src, tgt, pos, valid
