"""Weights carried between the JAX reference and the port.

The reference keeps an LM's parameters as a pytree with the layer weights
stacked on a leading L axis::

    {"embed": (V, d), "out_head": (d, V), "final_norm": (d,),
     "blocks": {"ln1": (L, d), "ln2": (L, d),
                "attn": {"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]},
                "ffn": {"w_gate", "w_up", "w_down"}}}

:func:`lm_from_numpy` takes that tree as numpy arrays (``jax.tree.map(
np.asarray, params)``) and returns the port's :class:`~.transformer.LM`;
:func:`lm_to_numpy` goes back.  Both keep the values and dtypes exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import LMConfig
from .transformer import LM

_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_FFN = ("w_gate", "w_up", "w_down")


def lm_from_numpy(cfg: LMConfig, tree: dict, *, device="cuda") -> LM:
    lm = LM(cfg, device=device, init=False)
    blocks = tree["blocks"]
    with torch.no_grad():
        def put(param, arr):
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"shape {arr.shape} does not match the "
                                 f"port's {tuple(param.shape)}")
            param.copy_(torch.tensor(arr))

        put(lm.embed, tree["embed"])
        put(lm.out_head, tree["out_head"])
        put(lm.final_norm, tree["final_norm"])
        for i, block in enumerate(lm.blocks):
            put(block.ln1, blocks["ln1"][i])
            put(block.ln2, blocks["ln2"][i])
            for name, p in block.attn.named_parameters():
                put(p, blocks["attn"][name][i])
            for name, p in block.ffn.named_parameters():
                put(p, blocks["ffn"][name][i])
    return lm


def lm_to_numpy(lm: LM) -> dict:
    def stack(get):
        return np.stack([get(b).detach().cpu().numpy() for b in lm.blocks])

    attn = {n: stack(lambda b, n=n: getattr(b.attn, n))
            for n in _ATTN if hasattr(lm.blocks[0].attn, n)}
    ffn = {n: stack(lambda b, n=n: getattr(b.ffn, n)) for n in _FFN}
    return {
        "embed": lm.embed.detach().cpu().numpy(),
        "out_head": lm.out_head.detach().cpu().numpy(),
        "final_norm": lm.final_norm.detach().cpu().numpy(),
        "blocks": {"attn": attn,
                   "ln1": stack(lambda b: b.ln1),
                   "ln2": stack(lambda b: b.ln2),
                   "ffn": ffn},
    }
