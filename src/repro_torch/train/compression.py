"""Gradient compression: int8 quantization with error feedback (PyTorch
port of ``src/repro/train/compression.py``).

Quantizing a gradient to int8 cuts a data-parallel reduction's traffic 4x
(against bf16) with little loss in quality when the quantization error is
fed back into the next step's gradient.  Usage is functional::

    comp_state = init_error_feedback(grads)
    grads_q, comp_state = compress_with_feedback(grads, comp_state)

Trees are nested dicts, lists and tuples of tensors.  For an explicit
data-parallel loop, :func:`compressed_psum` performs the quantize ->
all-reduce in int32 -> dequantize sequence over a ``torch.distributed``
group (one of a ``DeviceMesh``'s: ``mesh.get_group("data")``), bit for bit
the reference's along a mesh axis.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from ..core.distributed import _collective


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        out = [_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return fn(*trees)


def quantize(x: torch.Tensor):
    """Per-tensor symmetric int8.  Returns ``(q, scale)``."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(grads):
    return _map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compress_with_feedback(grads, err_state):
    """Quantize each leaf, carrying its quantization residual forward.
    Returns ``(new_grads, new_err_state)``."""
    corrected = _map(lambda g, e: g.to(torch.float32) + e, grads,
                     err_state)
    deq = _map(lambda c: dequantize(*quantize(c)), corrected)
    return (_map(lambda d, g: d.to(g.dtype), deq, grads),
            _map(lambda c, d: c - d, corrected, deq))

def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce (sum) of ``x`` over ``group`` (the
    default group when None), the reference's two phases with int8 on the
    wire:

      1. a shared scale: an all-reduce (MAX) of the local ``max |x|``;
      2. quantize to int8 on that scale; an ``all_to_all_single`` of the
         int8 chunks (rank d receives chunk d from every rank);
      3. the owned chunk summed exactly in int32, requantized to int8 on
         ``scale * size``;
      4. an all-gather of the requantized chunks, dequantized, sliced
         and reshaped.

    About 2n bytes on the wire against 4n for a bf16 ring all-reduce.
    The reference's rounding (half to even) and f32 arithmetic, so the
    result equals its bit for bit.  Returns f32 of ``x``'s shape."""
    size = tdist.get_world_size(group)
    shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    flat = F.pad(flat, (0, (-n) % size))
    # 1. shared scale so every shard's int8 grid matches
    amax = flat.abs().max()
    tdist.all_reduce(amax, op=tdist.ReduceOp.MAX, group=group)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    # 2. exchange: rank d receives chunk d from everyone
    recv = torch.empty_like(q)
    tdist.all_to_all_single(recv, q, group=group)
    # 3. local exact accumulation of the owned chunk
    part = recv.view(size, -1).to(torch.int32).sum(0)
    scale2 = scale * size
    q2 = torch.clamp(torch.round(part.to(torch.float32) * (scale / scale2)),
                     -127, 127).to(torch.int8)
    # 4. gather the reduced chunks back
    full = torch.empty(size * q2.numel(), dtype=torch.int8, device=q2.device)
    _collective("all_gather_single", "all_gather_into_tensor")(
        full, q2, group=group)
    out = full.to(torch.float32) * scale2
    return out[:n].reshape(shape)


__all__ = ["quantize", "dequantize", "init_error_feedback",
           "compress_with_feedback", "compressed_psum"]
