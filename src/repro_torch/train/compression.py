"""Gradient compression: int8 quantization with error feedback (PyTorch
port of ``src/repro/train/compression.py``, one device).

Quantizing a gradient to int8 cuts a data-parallel reduction's traffic 4x
(against bf16) with little loss in quality when the quantization error is
fed back into the next step's gradient.  Usage is functional::

    comp_state = init_error_feedback(grads)
    grads_q, comp_state = compress_with_feedback(grads, comp_state)

Trees are nested dicts, lists and tuples of tensors.  The reference's
``compressed_psum`` (the int8 all-reduce along a mesh axis) needs
collectives and waits for ROADMAP A6.
"""
from __future__ import annotations

import torch


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

__all__ = ["quantize", "dequantize", "init_error_feedback",
           "compress_with_feedback"]
