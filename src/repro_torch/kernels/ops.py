"""Public kernel wrappers: the tensor's device decides the path.

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels/ref.py``).  A tensor on a CUDA device launches the hand-written
Hopper kernel, or raises: there is no fallback from a failed build or
launch to the plain version.  Each kernel wrapper counts its launches in
:data:`LAUNCHES` (a plain int per kernel); the plain path never counts.

Mirrors ``src/repro/kernels/ops.py`` for the kernels of the trimming
engine's path.  The reference's ``use_kernel`` switch is not carried
over: the device is the only switch.
"""
from __future__ import annotations

from . import ref
from ._build import LAUNCHES, reset_launches
from . import first_live_scan as _fls
from . import frontier_compact as _fc

__all__ = ["LAUNCHES", "reset_launches", "first_live_scan",
           "prefix_positions", "frontier_compact", "sparse_expand"]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def first_live_scan(flags, valid, active):
    """(n, W) bool ×2 + (n,) bool -> (first (n,) int32, found (n,) bool)."""
    if _on_cpu(flags):
        return ref.first_live_ref(flags, valid, active)
    return _fls.first_live_scan(flags, valid, active)


def prefix_positions(x):
    """(n,) int32/bool -> (exclusive prefix (n,) int32, total 0-d int32)."""
    if _on_cpu(x):
        return ref.prefix_positions_ref(x)
    return _fc.prefix_positions(x)


def frontier_compact(mask, capacity: int):
    """(n,) bool -> (ids (capacity,) int32 with sentinel n, count 0-d)."""
    if _on_cpu(mask):
        return ref.frontier_compact_ref(mask, capacity)
    return _fc.frontier_compact(mask, capacity)


def sparse_expand(indptr, indices, ids, ecap: int):
    """CSR rows of compacted ``ids`` -> (src, tgt, pos, valid), (ecap,)."""
    if _on_cpu(indptr):
        return ref.sparse_expand_ref(indptr, indices, ids, ecap)
    return _fc.sparse_expand(indptr, indices, ids, ecap)
