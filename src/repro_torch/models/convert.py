"""Weights carried between the JAX reference and the port.

**Language models.** The reference keeps an LM's parameters as a pytree with the layer weights
stacked on a leading L axis::

    {"embed": (V, d), "out_head": (d, V), "final_norm": (d,),
     "blocks": {"ln1": (L, d), "ln2": (L, d),
                "attn": {"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]},
                "ffn": {"w_gate", "w_up", "w_down"}}}

and a MoE LM has, in place of ``ffn``, ``"moe": {"router": (L, d, E),
"w_gate", "w_up": (L, E, d, f), "w_down": (L, E, f, d)[, "dense":
{"w_gate", "w_up", "w_down"}]}`` (the port's ``blocks.3.moe.dense.w_gate``
is the reference's ``blocks/moe/dense/w_gate``, layer 3).

:func:`lm_from_numpy` takes that tree as numpy arrays (``jax.tree.map(
np.asarray, params)``) and returns the port's :class:`~.transformer.LM`;
:func:`lm_to_numpy` goes back.  Both keep the values and dtypes exactly.
:func:`lm_to_numpy` also stacks any list that follows ``LM.parameters()``
(their gradients, AdamW's moments) into that tree and :func:`lm_list`
takes it apart again; :class:`LMLayout` does so for a trainer's whole
state, so an LM checkpoint is in the reference's layout.

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
from torch.distributed.tensor import DTensor

from .. import configs
from .gnn import MODELS
from .layers import LMConfig
from .recsys import WideDeep, WideDeepConfig
from .transformer import LM


def _ref_path(name: str):
    """A port parameter name -> (the reference's tree path, its layer or
    None): ``blocks.3.attn.wq`` -> (("blocks", "attn", "wq"), 3)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("blocks", *parts[2:]), int(parts[1])
    return tuple(parts), None


def lm_to_numpy(lm: LM, tensors=None) -> dict:
    """The reference's stacked tree of ``tensors`` (numpy, on the host):
    one entry per parameter of ``lm`` in ``lm.parameters()`` order (by
    default the parameters themselves; their gradients or AdamW moments
    just as well), each layer's stacked on a leading L axis.  DTensors
    (a sharded LM, ``sharding.shard_lm``) are gathered whole
    (``full_tensor()``, a collective every rank must join)."""
    names = [n for n, _ in lm.named_parameters()]
    tensors = lm.parameters() if tensors is None else tensors
    stacks: dict = {}
    for name, t in zip(names, tensors, strict=True):
        path, layer = _ref_path(name)
        if isinstance(t, DTensor):      # a sharded LM: gather its blocks
            t = t.full_tensor()
        arr = t.detach().cpu().numpy()
        if layer is None:
            stacks[path] = arr
        else:
            stacks.setdefault(path, []).append(arr)
    tree: dict = {}
    for path, arr in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arr) if isinstance(arr, list) else arr
    return tree


def lm_list(lm: LM, tree: dict) -> list:
    """:func:`lm_to_numpy` undone: the entries of ``tree`` (numpy arrays or
    tensors) per parameter of ``lm``, in ``lm.parameters()`` order, a
    layer's entry a slice of its stack."""
    out = []
    for name, p in lm.named_parameters():
        path, layer = _ref_path(name)
        node = tree
        for key in path:
            node = node[key]
        leaf = node if layer is None else node[layer]
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(leaf.shape)} does not "
                             f"match the port's {tuple(p.shape)}")
        out.append(leaf)
    return out


def lm_from_numpy(cfg: LMConfig, tree: dict, *, device="cuda") -> LM:
    lm = LM(cfg, device=device, init=False)
    with torch.no_grad():
        for p, arr in zip(lm.parameters(), lm_list(lm, tree)):
            p.copy_(torch.tensor(np.asarray(arr)))
    return lm


class LMLayout:
    """A trainer's LM state in the reference's checkpoint layout:
    ``{"params": stacked tree, "opt": AdamWState(count, mu=stacked tree,
    nu=stacked tree)}`` (``train.checkpoint`` names its leaves
    ``params/blocks/attn/wq``, ``opt/.mu/embed``, ``opt/.count``, as the
    reference's ``tree_flatten_with_path`` does)."""

    def __init__(self, lm: LM):
        self.lm = lm

    def tree(self, params, opt_state) -> dict:
        """The state as host arrays in the reference's layout."""
        return {"params": lm_to_numpy(self.lm, params),
                "opt": type(opt_state)(
                    count=opt_state.count.detach().cpu().numpy(),
                    mu=lm_to_numpy(self.lm, opt_state.mu),
                    nu=lm_to_numpy(self.lm, opt_state.nu))}

    def load(self, tree, params):
        """Copy a restored ``tree`` (tensors on the parameters' device)
        into ``params`` in place; returns the AdamW state, its moments
        slices of the restored stacks."""
        with torch.no_grad():
            for p, q in zip(params, lm_list(self.lm, tree["params"])):
                p.copy_(q)
        opt = tree["opt"]
        return type(opt)(count=opt.count, mu=lm_list(self.lm, opt.mu),
                         nu=lm_list(self.lm, opt.nu))


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
                        device="cuda", lookup: str = "auto", mesh=None,
                        model_axis: str = "model") -> WideDeep:
    """The port's :class:`~.recsys.WideDeep` for ``cfg`` with the weights of
    the reference's parameter tree (``jax.tree.map(np.asarray, params)``);
    given ``mesh``, placed on it by ``param_specs`` once loaded (each rank
    keeps its rows of the tables)."""
    model = _load(WideDeep(cfg, lookup, model_axis=model_axis,
                           device=device, init=False), cfg.name, tree)
    return model if mesh is None else model.shard(mesh)


def widedeep_to_numpy(model: WideDeep) -> dict:
    """The reference's parameter tree of a port :class:`~.recsys.WideDeep`,
    as numpy.  DTensor parameters (a sharded model) are gathered whole
    (``full_tensor()``, a collective every rank must join)."""
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


def _numpy(t) -> np.ndarray:
    """A tensor as numpy on the host; a DTensor gathered whole."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def gnn_to_numpy(module) -> dict | list:
    """The reference's parameter tree of a port GNN module, as numpy
    (DTensor parameters gathered whole)."""
    if isinstance(module, torch.nn.ModuleList):
        return [gnn_to_numpy(m) for m in module]
    tree = {name: _numpy(p)
            for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        tree[name] = gnn_to_numpy(child)
    return tree
