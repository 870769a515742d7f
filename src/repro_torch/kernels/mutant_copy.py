"""The mutation corpus's copy kernel on Hopper: the one geometry of the
static checks' corpus that runs.

The CUDA kernels are ``csrc/mutant_copy.cu``: a 1-D blocked int32 copy in
which a block of ``block`` threads owns ``PER_THREAD * block`` elements
and moves them with one Hopper bulk copy through shared memory
(``mutant_copy``), and the same with a one-word device input added to
every element, each thread moving ``VECS`` 16-byte vectors
(``mutant_copy_carry``).  An ``x`` or output that is not 16-byte aligned
takes the one-element-a-thread kernels (``mutant_copy_scalar``,
``mutant_copy_carry_scalar``).  They compute what
``src/repro/analysis/mutants.py`` ``_mutant_pallas`` computes at its
well-formed geometry; the corpus's broken twins
(``repro_torch.analysis.mutants``) keep the reference's one element a
thread, are only captured, and are never launched.

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to ``ref.mutant_copy_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_VP = ctypes.c_void_p
_build.declare("mutant_copy", {
    "mutant_copy_launch": [_VP, _VP, ctypes.c_int64, _VP],
    "mutant_copy_carry_launch": [_VP, _VP, _VP, ctypes.c_int64, _VP],
    "mutant_copy_scalar_launch": [_VP, _VP, ctypes.c_int64, _VP],
    "mutant_copy_carry_scalar_launch": [_VP, _VP, _VP, ctypes.c_int64,
                                        _VP]})
#: 16-byte vectors a thread of the aligned kernels (csrc VECS), and the
#: int32 elements that makes
VECS = 4
PER_THREAD = 4 * VECS


def mutant_copy(x, carry=None, *, block: int = 256):
    """x: (n,) int32 on a CUDA device; carry: None or a 1-element int32
    tensor on the same device.  Returns ``x + carry[0]`` ((n,) int32; a
    copy of x without a carry), ``block`` threads a block, a block
    owning ``PER_THREAD * block`` elements (``block`` where x is not
    16-byte aligned)."""
    tensors = (x,) if carry is None else (x, carry)
    _build.require_cuda("mutant_copy", *tensors)
    if any(t.dtype != torch.int32 for t in tensors) or x.dim() != 1 \
            or (carry is not None and carry.numel() != 1):
        raise TypeError("mutant_copy: x must be (n,) int32 and carry a "
                        "1-element int32 tensor")
    if not 1 <= block <= 1024:
        raise ValueError(f"mutant_copy: block must be in [1, 1024], got "
                         f"{block}")
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    kernel = "mutant_copy" if carry is None else "mutant_copy_carry"
    smem = 0
    if x.data_ptr() % 16 == 0:      # out is a fresh, aligned allocation
        # VECS vectors a thread, plus a slot for the n % 4 tail; the bulk
        # copy stages a block's range in shared memory
        slots = n // 4 + (n % 4 != 0)
        grid = _build.blocks(slots, VECS * block)
        smem = 16 * VECS * block if carry is None else 0
    else:
        kernel += "_scalar"
        grid = _build.blocks(n, block)
    spec = _build.Launch("mutant_copy", kernel, (grid, 1, 1), (block, 1, 1),
                         smem, {"out": out})
    ptrs = [_build.c_ptr(t) for t in (*tensors, out)]
    _build.launch(spec, kernel + "_launch", *ptrs, n, _build.stream_of(x))
    _build.LAUNCHES["mutant_copy"] += 1
    return out
