"""Weights carried between the JAX reference and the port.

**Language models.** The reference keeps an LM's parameters as a pytree with the layer weights
stacked on a leading L axis::

    {"embed": (V, d), "out_head": (d, V), "final_norm": (d,),
     "blocks": {"ln1": (L, d), "ln2": (L, d),
                "attn": {"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]},
                "ffn": {"w_gate", "w_up", "w_down"}}}

:func:`lm_from_numpy` takes that tree as numpy arrays (``jax.tree.map(
np.asarray, params)``) and returns the port's :class:`~.transformer.LM`;
:func:`lm_to_numpy` goes back.  Both keep the values and dtypes exactly.

**GNNs.** The reference keeps a GNN's parameters as nested dicts and lists
(an MLP is a list of ``{"w", "b"}``).  The port's GNN modules mirror that
tree attribute for attribute (a dict key is a child module or parameter,
a list index an entry of an ``nn.ModuleList``), so :func:`gnn_from_numpy`
walks the tree into a freshly built module and :func:`gnn_to_numpy` walks
the module back into the tree, both exactly.

**Wide & Deep.** The reference's tree is ``{"tables": {"t0", ...},
"wide_tables": {...}, "mlp": [{"w", "b"}, ...], "head", "wide_dense",
"bias", "query_proj"}``; the port's :class:`~.recsys.WideDeep` mirrors it
the same way (``tables`` and ``wide_tables`` are parameter dicts),
so :func:`widedeep_from_numpy` and :func:`widedeep_to_numpy` walk it like
the GNNs'.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import configs
from .gnn import MODELS
from .layers import LMConfig
from .recsys import WideDeep, WideDeepConfig
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


def _gnn_config(arch_or_cfg):
    if isinstance(arch_or_cfg, str):
        spec = configs.get(arch_or_cfg)
        if spec.family != "gnn":
            raise ValueError(f"{arch_or_cfg!r} is not a GNN architecture")
        return spec.make_config()
    return arch_or_cfg


def _walk_into(module, tree, path="") -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _walk_into(getattr(module, key), sub, f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{path}: {len(tree)} entries, the port has "
                             f"{len(module)}")
        for i, sub in enumerate(tree):
            _walk_into(module[i], sub, f"{path}/{i}")
    else:
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(module.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not match the "
                             f"port's {tuple(module.shape)}")
        module.copy_(torch.tensor(arr, dtype=module.dtype))


def gnn_from_numpy(arch_or_cfg, tree: dict, *, d_feat=None, device="cuda"):
    """The port's GNN module for ``arch_or_cfg`` (an arch id, whose published
    config is taken, or a config dataclass) with the weights of the
    reference's parameter tree (``jax.tree.map(np.asarray, params)``)."""
    cfg = _gnn_config(arch_or_cfg)
    return _load(MODELS[type(cfg)](cfg, d_feat=d_feat, device=device,
                                   init=False), cfg.name, tree)


def widedeep_from_numpy(cfg: WideDeepConfig, tree: dict, *,
                        device="cuda") -> WideDeep:
    """The port's :class:`~.recsys.WideDeep` for ``cfg`` with the weights of
    the reference's parameter tree (``jax.tree.map(np.asarray, params)``)."""
    return _load(WideDeep(cfg, device=device, init=False), cfg.name, tree)


def widedeep_to_numpy(model: WideDeep) -> dict:
    """The reference's parameter tree of a port :class:`~.recsys.WideDeep`,
    as numpy."""
    return gnn_to_numpy(model)


def _load(model, name: str, tree: dict):
    """``model`` with the values of ``tree``, which must name exactly its
    parameters."""
    have = gnn_to_numpy(model)
    if _keys(have) != _keys(tree):
        raise ValueError(f"{name}: parameter tree differs from the "
                         f"port's: {sorted(_keys(tree) ^ _keys(have))[:8]}")
    with torch.no_grad():
        _walk_into(model, tree)
    return model


def _keys(tree, path=""):
    if isinstance(tree, dict):
        return set().union(*(_keys(v, f"{path}/{k}") for k, v in
                             tree.items())) if tree else set()
    if isinstance(tree, (list, tuple)):
        return set().union(*(_keys(v, f"{path}/{i}") for i, v in
                             enumerate(tree))) if tree else set()
    return {path}


def gnn_to_numpy(module) -> dict | list:
    """The reference's parameter tree of a port GNN module, as numpy."""
    if isinstance(module, torch.nn.ModuleList):
        return [gnn_to_numpy(m) for m in module]
    tree = {name: p.detach().cpu().numpy()
            for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        tree[name] = gnn_to_numpy(child)
    return tree
