"""The mutation corpus's copy kernel on Hopper: the one geometry of the
static checks' corpus that runs.

The CUDA kernels are ``csrc/mutant_copy.cu``: a 1-D blocked int32 copy,
one block of ``block`` threads per ``block`` elements (``mutant_copy``),
and the same with a one-word device input added to every element
(``mutant_copy_carry``).  They compute what
``src/repro/analysis/mutants.py`` ``_mutant_pallas`` computes at its
well-formed geometry; the corpus's broken twins
(``repro_torch.analysis.mutants``) take this launch record, mutate it,
and are never launched.

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
    "mutant_copy_carry_launch": [_VP, _VP, _VP, ctypes.c_int64, _VP]})


def mutant_copy(x, carry=None, *, block: int = 256):
    """x: (n,) int32 on a CUDA device; carry: None or a 1-element int32
    tensor on the same device.  Returns ``x + carry[0]`` ((n,) int32; a
    copy of x without a carry), one block of ``block`` threads per
    ``block`` elements."""
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
    spec = _build.Launch("mutant_copy", kernel,
                         (_build.blocks(n, block), 1, 1), (block, 1, 1), 0,
                         {"out": out})
    ptrs = [_build.c_ptr(t) for t in (*tensors, out)]
    _build.launch(spec, kernel + "_launch", *ptrs, n, _build.stream_of(x))
    _build.LAUNCHES["mutant_copy"] += 1
    return out
