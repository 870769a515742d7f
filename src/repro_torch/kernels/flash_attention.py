"""Causal GQA flash attention on Hopper: the LM prefill's attention.

The CUDA kernel is ``csrc/flash_attention.cu``: one 256-thread block per
(batch, q head, 64-row q tile), 64-key tiles staged through shared memory,
an online softmax with f32 running statistics, and causal skipping of the
reference's whole 128-key blocks.  It computes what
``src/repro/kernels/flash_attention.py`` computes, including its
fully-masked rows (0, or the mean of v over the computed blocks, when
Sq > Sk); the plain version is ``ref.flash_attention_ref``.  Sums run in
another order than the plain version's, so the two agree to f32 rounding
(bf16 outputs to one rounding of the output).

This wrapper takes CUDA tensors only: it launches the kernel or raises.
``kernels.ops`` routes CPU tensors to ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_blocks

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_READY = []
#: head widths and dtypes the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention")
    if not _READY:
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.POINTER(_I64), _I64, _I64, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, _VP]
        _READY.append(True)
    return lib


def _rows_contiguous(t):
    """The kernel reads dims 0-2 by strides but needs dim 3 contiguous."""
    return t if t.stride(3) == 1 else t.contiguous()


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0, all on one
    CUDA device in one dtype (float32 or bfloat16), D in
    :data:`HEAD_DIMS`.  Returns (B, Hq, Sq, D) in q's dtype, laid out like
    q (a transposed view in, a transposed view out); see
    ``ref.flash_attention_ref`` for the semantics.  Sq and Sk must be
    multiples of their blocks, ``min(128, S)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D "
                         "(B, H, S, D)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not match")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    bq, bk = flash_blocks(sq, sk)
    q, k, v = (_rows_contiguous(t) for t in (q, k, v))
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: the CUDA kernel takes "
                             f"tensors on one CUDA device, got {t.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)        # keeps q's layout when q is dense
    if out.numel() == 0:
        return out
    strides = (_I64 * 12)(*(t.stride(i) for t in (q, k, v, out)
                            for i in range(3)))
    lib = _lib()
    _build.check(lib, "flash_attention", lib.flash_attention_launch(
        _build.c_ptr(q), _build.c_ptr(k), _build.c_ptr(v), _build.c_ptr(out),
        b, hq, hkv, sq, sk, d, strides, bq, bk, int(bool(causal)),
        float(sm_scale), DTYPES[q.dtype], _build.stream_of(q)))
    _build.LAUNCHES["flash_attention"] += 1
    return out
