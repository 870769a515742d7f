"""Causal GQA flash attention on Hopper: the LM prefill's attention.

Two CUDA kernels in ``csrc/flash_attention.cu`` compute what
``src/repro/kernels/flash_attention.py`` computes, including its
fully-masked rows (0, or the mean of v over the computed blocks, when
Sq > Sk); the plain version is ``ref.flash_attention_ref``.  The wrapper
picks one from (dtype, D) alone (:func:`kernel_for`), with no fallback:

* ``flash_fwd_wgmma`` takes bfloat16 at D in :data:`WGMMA_HEAD_DIMS`
  (64, 128: every published LM config's ``d_head`` is 128).  One CTA of
  three warpgroups per (batch, q head, 128-row q tile): a TMA producer
  and two consumers that run Q K^T and P V on the tensor cores (wgmma),
  with p split into two bf16 halves so the f32 contract holds to ~2^-17
  of p.
* ``flash_fwd`` takes float32, and bfloat16 at D in {16, 32}: one
  256-thread block per (batch, q head, 64-row q tile), f32 products on
  the CUDA cores.

Sums run in another order than the plain version's, so the two agree to
f32 rounding (bf16 outputs to one rounding of the output).

This wrapper takes CUDA tensors only: it launches a kernel or raises.
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
# q, k, v, out; b, hq, hkv, sq, sk, d; strides; block_q, block_k, causal,
# sm_scale; flash_fwd adds its dtype code; the stream
_ARGS = [_VP] * 4 + [_I64] * 6 + [ctypes.POINTER(_I64), _I64, _I64,
                                  ctypes.c_int, ctypes.c_float]
_build.declare("flash_attention", {
    "flash_fwd_launch": _ARGS + [ctypes.c_int, _VP],
    "flash_wgmma_launch": _ARGS + [_VP]})
#: head widths and dtypes the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: flash_fwd's geometry: q rows and keys per tile, threads per block
TQ, TK, THREADS = 64, 64, 256
#: bfloat16 head widths that flash_fwd_wgmma takes
WGMMA_HEAD_DIMS = (64, 128)
#: flash_fwd_wgmma's geometry: q rows per CTA (= keys per kv tile),
#: threads (three warpgroups), K/V ring stages
WG_ROWS, WG_THREADS, WG_STAGES = 128, 384, 2


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block: the q tile and one k/v tile
    (rows padded to D + 1), the score tile (padded to TK + 1) and three
    per-row statistics, all f32."""
    return 4 * (TQ * (d + 1) + TK * (d + 1) + TQ * (TK + 1) + 3 * TQ)


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one flash_fwd_wgmma CTA: the Q tile and
    WG_STAGES K and V tiles (128 x D bf16 each), 64 bytes of barriers and
    1024 bytes to align the base for the 128-byte swizzle."""
    return (1 + 2 * WG_STAGES) * WG_ROWS * d * 2 + 64 + 1024


def kernel_for(dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "flash_fwd_wgmma"
    return "flash_fwd"


def tma_ready(t) -> bool:
    """TMA's rule for a bf16 input: a 16-byte aligned base, the last
    dimension contiguous and the other strides multiples of 16 bytes
    (dimensions of length 1 are never stepped)."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(t.stride(i) % 8 == 0 for i in range(3)
                    if t.shape[i] > 1))


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
    multiples of their blocks, ``min(128, S)``.

    bfloat16 at D in :data:`WGMMA_HEAD_DIMS` launches ``flash_fwd_wgmma``;
    an input that breaks TMA's rule (:func:`tma_ready`) is first copied
    to a fresh contiguous tensor.  Everything else launches ``flash_fwd``,
    which reads any strides with a contiguous last dimension (a tensor
    without one is copied)."""
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
    kernel = kernel_for(q.dtype, d)
    if kernel == "flash_fwd_wgmma":
        q, k, v = (t if tma_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:
        q, k, v = (_rows_contiguous(t) for t in (q, k, v))
    for t in (q, k, v):
        if t.device.type not in _build.ACCEPTED or t.device != q.device:
            raise ValueError(f"flash_attention: the CUDA kernel takes "
                             f"tensors on one CUDA device, got {t.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)        # keeps q's layout when q is dense
    if out.numel() == 0:
        return out
    strides = (_I64 * 12)(*(t.stride(i) for t in (q, k, v, out)
                            for i in range(3)))
    args = (_build.c_ptr(q), _build.c_ptr(k), _build.c_ptr(v),
            _build.c_ptr(out), b, hq, hkv, sq, sk, d, strides, bq, bk,
            int(bool(causal)), float(sm_scale))
    # one block per (batch, q head, q tile)
    if kernel == "flash_fwd_wgmma":
        spec = _build.Launch("flash_attention", kernel,
                             (_build.blocks(sq, WG_ROWS) * b * hq, 1, 1),
                             (WG_THREADS, 1, 1), wgmma_smem_bytes(d),
                             {"out": out})
        _build.launch(spec, "flash_wgmma_launch", *args, _build.stream_of(q))
    else:
        spec = _build.Launch("flash_attention", kernel,
                             (_build.blocks(sq, TQ) * b * hq, 1, 1),
                             (THREADS, 1, 1), smem_bytes(d), {"out": out})
        _build.launch(spec, "flash_fwd_launch", *args, DTYPES[q.dtype],
                      _build.stream_of(q))
    _build.LAUNCHES["flash_attention"] += 1
    return out
