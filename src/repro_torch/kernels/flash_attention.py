"""Causal GQA flash attention on Hopper: the LM prefill's attention.

Two CUDA kernels in ``csrc/flash_attention.cu`` compute what
``src/repro/kernels/flash_attention.py`` computes, including its
fully-masked rows (0, or the mean of v over the computed blocks, when
Sq > Sk); the plain version is ``ref.flash_attention_ref``.  Both run on
the tensor cores at every D in :data:`HEAD_DIMS`, and the wrapper picks
one from the dtype (:func:`kernel_for`), with no fallback:

* ``flash_fwd_wgmma`` takes bfloat16.  One CTA of three warpgroups per
  (batch, q head, 128-row q tile): a TMA producer and two consumers that
  run Q K^T and P V by wgmma, with p split into two bf16 halves so the
  f32 contract holds to ~2^-17 of p.  Every published LM config's
  ``d_head`` is 128; the reduced configs' 16 takes the same kernel with
  32-byte swizzled tiles.
* ``flash_fwd_tf32x3`` takes float32.  The same three warpgroups per
  (batch, q head, 128-row q tile) run Q K^T and P V by TF32 wgmma, each
  operand split into a TF32 head (x truncated) and the f32 remainder and
  each product taken as three TF32 products (3xTF32), which keeps it
  within ~2^-19 of the f32 product; the producer warpgroup splits K and
  V (transposed) into shared-memory tiles for the consumers.

Sums run in another order than the plain version's, so the two agree to
f32 rounding (bf16 outputs to one rounding of the output); neither kernel
uses atomics, so reruns give the same bits.

:func:`flash_attention` takes CUDA tensors only: it launches a kernel or
raises.  ``kernels.ops`` routes CPU tensors to ``ref.flash_attention_ref``.

Training differentiates through :class:`FlashAttentionFn`: its forward
is the forward ``kernels.ops`` resolved for the device (this module's
kernel on a CUDA tensor, the plain version on a CPU one), its backward
:func:`flash_attention_bwd`, the attention gradient in plain float32
torch ops on either device.  The TPU kernel has
no backward (no ``custom_vjp``; Pallas registers no transpose rule for
``pallas_call``), so the reference's training step differentiates the
attention XLA runs off the TPU, ``attention_ref_chunked`` with float32
scores: what :func:`flash_attention_bwd` computes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import NEG_INF, flash_blocks

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
# q, k, v, out; b, hq, hkv, sq, sk, d; strides; block_q, block_k, causal,
# sm_scale; the stream
_ARGS = [_VP] * 4 + [_I64] * 6 + [ctypes.POINTER(_I64), _I64, _I64,
                                  ctypes.c_int, ctypes.c_float, _VP]
_build.declare("flash_attention", {"flash_tf32x3_launch": _ARGS,
                                   "flash_wgmma_launch": _ARGS})
#: head widths both kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: the kernel each dtype launches, with its C entry point
KERNELS = {torch.float32: ("flash_fwd_tf32x3", "flash_tf32x3_launch"),
           torch.bfloat16: ("flash_fwd_wgmma", "flash_wgmma_launch")}
#: both kernels' geometry: q rows per CTA, threads (three warpgroups);
#: flash_fwd_wgmma's K/V ring stages (of WG_ROWS keys); flash_fwd_tf32x3's
#: keys per kv tile
WG_ROWS, WG_THREADS, WG_STAGES = 128, 384, 2
T3_KEYS = 64
#: the dynamic shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448
#: the backward's budget for one (B, Hq, rows, Sk) float32 temporary; about
#: four are alive at once
BWD_TILE_BYTES = 512 << 20


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one flash_fwd_wgmma CTA: the Q tile and
    WG_STAGES K and V tiles (128 x D bf16 each), 64 bytes of barriers and
    1024 bytes to align the base for the swizzle."""
    return (1 + 2 * WG_STAGES) * WG_ROWS * d * 2 + 64 + 1024


def tf32x3_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one flash_fwd_tf32x3 CTA: the Q tile (128
    x D f32), the K tile and its lo, the raw V tile and V^T's hi and lo
    (T3_KEYS x D each), 64 bytes of barriers and 1024 bytes to align the
    base for the swizzle."""
    return (WG_ROWS + 5 * T3_KEYS) * d * 4 + 64 + 1024


def kernel_for(dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches: every
    D in :data:`HEAD_DIMS` of both dtypes runs on the tensor cores."""
    if dtype not in KERNELS or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for {dtype} at D={d}")
    return KERNELS[dtype][0]


def smem_bytes(dtype, d: int) -> int:
    """The dynamic shared memory of one block of :func:`kernel_for`'s
    kernel."""
    if kernel_for(dtype, d) == "flash_fwd_wgmma":
        return wgmma_smem_bytes(d)
    return tf32x3_smem_bytes(d)


def tma_ready(t) -> bool:
    """TMA's rule, by which both kernels read their inputs: a 16-byte
    aligned base, the last dimension contiguous and the other strides
    multiples of 16 bytes (dimensions of length 1 are never stepped)."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(t.stride(i) * t.element_size() % 16 == 0
                    for i in range(3) if t.shape[i] > 1))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0, all on one
    CUDA device in one dtype (float32 or bfloat16), D in
    :data:`HEAD_DIMS`.  Returns (B, Hq, Sq, D) in q's dtype, laid out like
    q (a transposed view in, a transposed view out); see
    ``ref.flash_attention_ref`` for the semantics.  Sq and Sk must be
    multiples of their blocks, ``min(128, S)``.

    bfloat16 launches ``flash_fwd_wgmma``, float32 ``flash_fwd_tf32x3``.
    Both read any strides that keep :func:`tma_ready`'s rule; an input
    that breaks it is first copied to a fresh contiguous tensor."""
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
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    bq, bk = flash_blocks(sq, sk)
    q, k, v = (t if tma_ready(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
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
    kernel, entry = KERNELS[q.dtype]
    # one CTA per (batch, q head, q tile)
    spec = _build.Launch("flash_attention", kernel,
                         (_build.blocks(sq, WG_ROWS) * b * hq, 1, 1),
                         (WG_THREADS, 1, 1), smem_bytes(q.dtype, d),
                         {"out": out})
    _build.launch(spec, entry, _build.c_ptr(q), _build.c_ptr(k),
                  _build.c_ptr(v), _build.c_ptr(out), b, hq, hkv, sq, sk, d,
                  strides, bq, bk, int(bool(causal)), float(sm_scale),
                  _build.stream_of(q))
    _build.LAUNCHES["flash_attention"] += 1
    return out


def bwd_block_rows(b: int, hq: int, sq: int, sk: int) -> int:
    """Query rows per step of :func:`flash_attention_bwd`: as many as keep
    one (B, Hq, rows, Sk) float32 temporary within
    :data:`BWD_TILE_BYTES`."""
    return max(1, min(sq, BWD_TILE_BYTES // (4 * b * hq * max(sk, 1))))


def flash_attention_bwd(q, k, v, dout, *, causal: bool = True,
                        sm_scale: float | None = None):
    """The gradient of causal GQA attention: q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D), ``dout`` (B, Hq, Sq, D) -> (dq, dk, dv) in the
    inputs' dtypes.  Queries are aligned to the end of the keys, as in the
    forward; Sq > Sk is refused (such rows have no gradient contract).

    Plain torch ops in float32 on any device, as XLA differentiates the
    reference's ``attention_ref_chunked``: the scores and the softmax are
    recomputed, then dV = Pᵀ·dO, dS = P ∘ (dP − rowsum(dP ∘ P)) with
    dP = dO·Vᵀ, dQ = dS·K·scale and dK = dSᵀ·Q·scale, dK and dV summed
    over the q heads of each kv head.  Query rows go
    :func:`bwd_block_rows` at a time, each block against the keys its
    causal rows can see."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if sq > sk:
        raise ValueError(f"flash_attention_bwd: Sq={sq} > Sk={sk} has no "
                         "gradient contract")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_bwd: Hq={hq} is not a multiple "
                         f"of Hkv={hkv}")
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    rows = bwd_block_rows(b, hq, sq, sk)
    off = sk - sq
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)
    dof = dout.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        kend = min(sk, off + r1) if causal else sk
        qb, dob = qf[:, :, :, r0:r1], dof[:, :, :, r0:r1]
        kb, vb = kf[:, :, :kend], vf[:, :, :kend]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kb) * scale
        if causal:
            q_pos = off + torch.arange(r0, r1, device=dev)
            seen = q_pos[:, None] >= torch.arange(kend, device=dev)[None, :]
            s = torch.where(seen, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, :kend] += torch.einsum("bkgqc,bkgqd->bkcd", p, dob)
        ds = torch.einsum("bkgqd,bkcd->bkgqc", dob, vb)      # dP
        ds.sub_((ds * p).sum(-1, keepdim=True)).mul_(p)     # dS
        del p
        dq[:, :, :, r0:r1] = torch.einsum("bkgqc,bkcd->bkgqd", ds, kb) * scale
        dk[:, :, :kend] += torch.einsum("bkgqc,bkgqd->bkcd", ds, qb) * scale
        del ds
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


#: what :class:`FlashAttentionFn`'s backward calls in place of
#: :func:`flash_attention_bwd` while it is set: ``launch.lowering.meter``
#: sets a wrapper of it that replays a signature it has counted before on
#: meta tensors.  None otherwise.
BWD_HOOK = None


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: ``apply(q, k, v, causal, sm_scale,
    fwd)`` returns ``fwd(q, k, v, causal=..., sm_scale=...)``, the forward
    the caller resolved for the device (:func:`flash_attention` on the
    card); the backward is :func:`flash_attention_bwd`.  It saves q, k and
    v; a CUDA backward adds one to ``LAUNCHES["flash_attention_bwd"]``
    (torch ops, not a kernel of the port)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, fwd):
        if q.shape[2] > k.shape[2]:
            raise ValueError(f"flash_attention: Sq={q.shape[2]} > Sk="
                             f"{k.shape[2]} has no gradient contract")
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return fwd(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if q.device.type != "cpu":
            _build.LAUNCHES["flash_attention_bwd"] += 1
        bwd = flash_attention_bwd if BWD_HOOK is None else BWD_HOOK
        dq, dk, dv = bwd(q, k, v, dout, causal=ctx.causal,
                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None
