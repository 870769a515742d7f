"""(architecture x shape) -> a step to run on the meta device (PyTorch
port of ``src/repro/launch/cells.py``).

``build_cell`` returns what the dry-run needs: the step function, its
arguments as meta tensors (parameters, optimizer state, batch: the shapes
and dtypes of the reference's abstract arguments), and the MODEL_FLOPS
accounting of the roofline's useful-compute ratio.  The models are built
on ``device="meta"`` with ``init=False``: nothing is drawn and nothing is
allocated.  The steps are the ones the launchers run: an LM's
``make_train_step`` (AdamW, remat as the config sets it), ``prefill`` and
``decode_step``; a GNN's loss (a batch of molecules as one disjoint
union, ``molecule_union`` + ``molecule_loss``; the other cells through
``model.loss`` with the reference's pad to 512) with AdamW; wide-deep's
train step (AdamW, or ``HybridAdamW`` under ``perf_flags``'
``recsys_hybrid_opt``), ``forward`` and ``retrieval_scores``.  Serving
steps run under ``torch.no_grad``.

The batches arrive as the data pipelines give them (int32 ids), and an
LM step turns its ids into int64 on the device first, as
``launch.train``'s ``put`` does.  ``decode_step``'s position is a 0-d
int32 tensor on the host, the reference's scalar argument, which the
port reads on the host.

Every cell also builds on a ``DeviceMesh`` (``build_cell(...,
mesh=)``, ``launch.mesh.make_mesh``): the runnable twin of the
reference's sharded cell, with random weights (seed 0) and the step's
arguments placed as the reference's ``in_shardings``.  An LM (dense or
MoE) is placed by ``LM.param_specs`` (``models.sharding.shard_lm``):
AdamW's moments as the parameters, its count replicated, tokens and
targets on (dp, None); decode's cache by the reference's three cases
(``LM.decode_cache_spec``) and its token on (dp, None), or replicated at
batch 1.  Wide-deep's tables are row-sharded over "model" with the
collective lookup, the batch on dp, retrieval's candidates over dp and
"model" (:func:`_build_recsys`).  A GNN's parameters are replicated, the
molecule batch on dp, a large graph's arrays on ``gdp``
(:func:`_build_gnn`).  Without a mesh the cells stay unsharded on one
device, and the reference's donations are not carried over.

On a fake mesh (``launch.mesh.make_production_mesh``: 256 or 512 ranks,
this process rank 0) the cell is built on ``device``, not the mesh's
device type: on meta for the sharded dry-run (``dryrun --mesh
pod|multi|both``), each argument rank 0's meta block; on the card the
models are built and placed on meta first and only rank 0's blocks are
then allocated and drawn (``sharding.materialize``), so a 480B-parameter
model costs the card 1/512 of it.  Every batch and cache tensor is made
as rank 0's block alone (``sharding.local_zeros``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import configs
from ..configs.base import ShapeCell
from ..models.gnn import MODELS
from ..models.gnn.common import (all_reduced, edge_sharded, mesh_grads,
                                 mesh_groups, molecule_loss, molecule_union)
from ..models.recsys import WideDeep, make_recsys_train_step
from ..models.sharding import is_fake, local_zeros, materialize, place
from ..models.transformer import LM, init_param, make_train_step
from ..optim import AdamW, HybridAdamW
from . import perf_flags


@dataclasses.dataclass
class CellBuild:
    fn: Callable
    abstract_args: tuple
    model_flops: float
    notes: str = ""


def build_cell(arch_id: str, shape, n_layers: int | None = None, *,
               device="meta", mesh=None) -> CellBuild:
    """The step of ``arch_id`` at ``shape`` (a name of the arch's cells,
    or a :class:`ShapeCell` of one's own), at the published configuration.
    ``n_layers`` (LM only) cuts the depth; ``device``
    other than meta builds real tensors (random weights, zero batches),
    which the tests run to check the meta counts.  ``mesh`` (a
    ``DeviceMesh`` with a ``"model"`` axis and ``"data"`` or ``("pod",
    "data")``) builds the sharded step on the mesh's device type (module
    docstring); a fake one (``launch.mesh.make_production_mesh``) on
    ``device``, rank 0's blocks alone.  A skipped cell raises."""
    spec = configs.get(arch_id)
    cell = shape if isinstance(shape, ShapeCell) else spec.shapes[shape]
    if cell.skip:
        raise ValueError(f"cell {arch_id}×{cell.name} is skipped: "
                         f"{cell.skip}")
    cfg = spec.make_config()
    dev = torch.device(device)
    if spec.family == "lm":
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        return _build_lm(cfg, cell, dev, mesh)
    if spec.family == "gnn":
        return _build_gnn(spec, cfg, cell, dev, mesh)
    return _build_recsys(cfg, cell, dev, mesh)


def _device(dev, mesh) -> torch.device:
    """The device a cell's tensors go on: a real mesh's device type; with
    a fake mesh or none, ``dev`` (meta when None).  A fake mesh's blocks
    are meta (the dry-run) or the card's: any other device raises."""
    if mesh is not None and not is_fake(mesh):
        return torch.device(mesh.device_type)
    dev = torch.device("meta" if dev is None else dev)
    if mesh is not None and dev.type not in ("meta", "cuda"):
        raise ValueError(f"a fake mesh's blocks are meta or cuda tensors, "
                         f"not {dev}")
    return dev


def _model_kw(dev, mesh=None) -> dict:
    """A model's constructor arguments on ``dev``: on meta, or on any
    device with a fake ``mesh`` (placed on meta, then
    :func:`_materialize`), nothing is drawn; elsewhere seed-0 weights."""
    if dev.type == "meta" or (mesh is not None and is_fake(mesh)):
        return dict(device=torch.device("meta"), init=False)
    return dict(device=dev, generator=torch.Generator(device=dev)
                .manual_seed(0))


def _materialize(model, dev, init=None):
    """On a fake mesh, give ``model`` (built and placed on meta) rank 0's
    blocks on ``dev``, drawn from a seed-0 generator by ``init(name, p,
    block, generator)`` (default: normal over sqrt(fan-in)); a model on
    meta stays there."""
    if dev.type == "meta":
        return model
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(name, p, t):
        if init is not None:
            return init(name, p, t, g)
        t.normal_(generator=g)
        t.mul_(p.shape[-2] ** -0.5 if p.dim() > 1 else 1.0)
    return materialize(model, dev, draw)


NOTES = "one device, no mesh: no shardings, no collectives"


# ------------------------------------------------------------------- LM


def _build_lm(cfg, cell, dev, mesh=None) -> CellBuild:
    """The LM step of ``cell`` on ``dev``, or, given ``mesh``, on the
    mesh's device type with the reference's in_shardings applied (module
    docstring): the LM places its parameters (``param_specs``), AdamW's
    moments take their placements, the batch and the decode cache are
    placed by the LM's own helpers."""
    dev = _device(dev, mesh)
    if perf_flags.FLAGS.serve_bf16_params and cell.kind in ("prefill",
                                                            "decode"):
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    axes = None
    if mesh is not None:
        from ..models.transformer import MeshAxes
        from .mesh import data_axes
        axes = MeshAxes(dp=data_axes("pod" in mesh.mesh_dim_names),
                        tp="model")
    model = LM(cfg, axes=axes, mesh=mesh, **_model_kw(dev, mesh))
    if mesh is not None and is_fake(mesh):
        _materialize(model, dev, init_param)
    params = list(model.parameters())
    b, s = cell.meta["batch"], cell.meta["seq"]
    n_active = cfg.active_param_count()
    notes = NOTES if mesh is None else ""

    def ids(shape):
        """int32 ids, placed on the mesh as the reference's (dp, None)."""
        spec = None if mesh is None else (model._dp(b), None)
        return local_zeros(shape, torch.int32, spec, mesh, dev)

    if cell.kind == "train":
        opt = AdamW(lr=3e-4)
        step = make_train_step(model, opt)

        def train(params, opt_state, batch):
            return step(params, opt_state,
                        {k: v.long() for k, v in batch.items()})

        batch = {"tokens": ids((b, s)), "targets": ids((b, s))}
        return CellBuild(train, (params, opt.init(params), batch),
                         model_flops=6.0 * n_active * b * s, notes=notes)

    if cell.kind == "prefill":
        return CellBuild(lambda params, tokens: model.prefill(tokens),
                         (params, ids((b, s))),
                         model_flops=2.0 * n_active * b * s, notes=notes)

    # decode: one new token against a full cache of length s
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    cache = tuple(model._zeros_cache(shape) for _ in range(2))
    pos = torch.tensor(s - 1, dtype=torch.int32)
    return CellBuild(
        lambda params, cache, token, pos: model.decode_step(cache, token,
                                                            int(pos)),
        (params, cache, ids((b, 1)), pos),
        model_flops=2.0 * n_active * b, notes=notes)


# ------------------------------------------------------------------ GNN


def _gnn_flops(spec, cfg, cell) -> float:
    """Analytic useful-matmul FLOPs of one forward pass x 3 (forward and
    backward): the reference's formulas."""
    meta = cell.meta
    batch = meta.get("batch", 1)
    n = meta["n_nodes"] * batch
    m = meta["n_edges"] * batch
    if spec.id == "meshgraphnet":
        h = cfg.d_hidden
        per_edge = 2 * (3 * h * h + h * h)
        per_node = 2 * (2 * h * h + h * h)
        fwd = cfg.n_layers * (per_edge * m + per_node * n)
    elif spec.id == "schnet":
        h, r = cfg.d_hidden, cfg.n_rbf
        per_edge = 2 * (r * h + h * h)
        per_node = 2 * (3 * h * h)
        fwd = cfg.n_interactions * (per_edge * m + per_node * n)
    elif spec.id == "mace":
        C = cfg.channels
        dims = sum((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
                   for l1 in range(3) for l2 in range(3) for l3 in range(3)
                   if abs(l1 - l2) <= l3 <= l1 + l2)
        per_edge = 2 * dims * C + 2 * 9 * C * C     # CG + channel mix
        per_node = 2 * (2 * dims * C + 8 * 9 * C * C)
        fwd = cfg.n_layers * (per_edge * m + per_node * n)
    else:  # equiformer-v2
        C, lm = cfg.channels, cfg.l_max
        rot = 2 * sum((2 * l + 1) ** 2 for l in range(lm + 1)) * C * 2
        so2 = 2 * sum(((lm + 1 - mm) * C) ** 2 * (1 if mm == 0 else 4)
                      for mm in range(cfg.m_max + 1))
        per_edge = rot + so2
        per_node = 2 * (lm + 1) * C * C * 3
        fwd = cfg.n_layers * (per_edge * m + per_node * n)
    return 3.0 * fwd


def _pad512(x: int) -> int:
    """The reference's pad of a graph cell's node and edge counts."""
    return -(-x // 512) * 512


def _build_gnn(spec, cfg, cell, dev, mesh=None) -> CellBuild:
    """A GNN's AdamW step of ``cell`` on ``dev``, or, given ``mesh``, on
    the mesh's device type as the reference's sharded cell: the
    parameters (and AdamW's moments) replicated, every rank the whole
    model; the ``molecule`` batch on dp, each rank's graphs one
    :func:`molecule_union` whose squared errors count 1/B each (B the
    whole batch); a large graph's arrays, padded to multiples of 512, on
    ``gdp`` (``perf_flags.FLAGS.gnn_edge_dp``, or the data axes): each
    rank takes its block of the edges and gathers the node arrays
    (node space replicated), and the forward runs inside
    ``common.edge_sharded``.  The gradients are summed over the axes the
    work is split over (``common.mesh_grads``); the step's loss is the
    whole batch's, the same on every rank."""
    meta = cell.meta
    cfg = dataclasses.replace(cfg, out_dim=meta.get("classes", 1))
    dev = _device(dev, mesh)
    model = MODELS[type(cfg)](cfg, d_feat=meta.get("d_feat"),
                              **_model_kw(dev))
    opt = AdamW(lr=1e-3)
    params = list(model.parameters())
    f32, i32 = torch.float32, torch.int32
    axes, groups, scale = (), [], 1.0
    if mesh is not None:
        from .mesh import data_axes
        dp = data_axes("pod" in mesh.mesh_dim_names)
        axes = dp if cell.name == "molecule" else tuple(
            perf_flags.FLAGS.gnn_edge_dp or dp)
        groups = mesh_groups(mesh, axes)
        if cell.name != "molecule":     # the same loss on every rank
            scale = 1.0 / math.prod(
                mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)

    def zeros(shape, dtype):
        return local_zeros(shape, dtype, (axes,) + (None,) * (len(shape) - 1),
                           mesh, dev)

    if cell.name == "molecule":
        bsz, n, m = meta["batch"], meta["n_nodes"], meta["n_edges"]
        batch = {"species": zeros((bsz, n), i32),
                 "pos": zeros((bsz, n, 3), f32),
                 "edge_src": zeros((bsz, m), i32),
                 "edge_dst": zeros((bsz, m), i32),
                 "energy": zeros((bsz,), f32)}

        def loss_fn(batch):
            """The whole batch's loss, or on a mesh the rank's share of it
            (its graphs' squared errors over the whole batch's count)."""
            if mesh is None:
                return molecule_loss(model, molecule_union(batch, dev))
            local = {k: _local(v, mesh, axes) for k, v in batch.items()}
            share = local["energy"].shape[0] / batch["energy"].shape[0]
            return molecule_loss(model, molecule_union(local, dev)) * share
    else:
        n, m = _pad512(meta["n_nodes"]), _pad512(meta["n_edges"])
        batch = {"feats": zeros((n, meta["d_feat"]), f32),
                 "pos": zeros((n, 3), f32),
                 "edge_src": zeros((m,), i32),
                 "edge_dst": zeros((m,), i32),
                 "labels": zeros((n,), i32)}

        def loss_fn(batch):
            """The loss, on a mesh from the rank's block of the edges and
            every node (the same on every rank)."""
            if mesh is None:
                return model.loss(batch)
            local = {k: (_local(v, mesh, axes) if k.startswith("edge_")
                         else _whole(v)) for k, v in batch.items()}
            with edge_sharded(groups, axes):
                return model.loss(local)

    def train_step(params, opt_state, batch):
        loss = loss_fn(batch)
        grads = mesh_grads(loss, params, groups, scale)
        if cell.name == "molecule":     # the ranks' shares summed
            loss = all_reduced(loss.detach(), groups)
        opt_state = opt.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach()}

    return CellBuild(train_step, (params, opt.init(params), batch),
                     model_flops=_gnn_flops(spec, cfg, cell),
                     notes=NOTES if mesh is None else "")


def _local(t, mesh, axes):
    """This rank's block of a batch tensor placed on ``axes`` (a plain
    tensor, the same on every rank, is cut as ``local_block`` cuts it)."""
    return place(t, (tuple(axes),) + (None,) * (t.dim() - 1),
                 mesh).to_local()


def _whole(t):
    """A batch tensor whole on every rank (a DTensor gathered)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# --------------------------------------------------------------- recsys


def _recsys_fwd_flops(cfg, b: int) -> float:
    """The reference's MLP FLOPs of one forward pass over ``b`` rows."""
    mlp_params = sum(cfg.mlp[i] * cfg.mlp[i + 1]
                     for i in range(len(cfg.mlp) - 1))
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    mlp_params += d_in * cfg.mlp[0] + cfg.mlp[-1]
    return 2.0 * mlp_params * b


def _build_recsys(cfg, cell, dev, mesh=None) -> CellBuild:
    """Wide-deep's step of ``cell`` on ``dev``, or, given ``mesh``, on the
    mesh's device type: the tables row-sharded over ``"model"`` by
    ``param_specs`` with the collective lookup, the rest replicated,
    AdamW's moments placed as their parameters (HybridAdamW's 0-d table
    moments plain), and the batch placed as the reference's cell: dense
    features, ids and labels on dp; retrieval's query replicated and its
    candidates over dp and ``"model"``."""
    dev = _device(dev, mesh)
    model = WideDeep(cfg, "collective" if mesh is not None else "auto",
                     mesh, **_model_kw(dev, mesh))
    if mesh is not None and is_fake(mesh):
        _materialize(model, dev)
    params = model.params()
    b = cell.meta["batch"]
    fwd_flops = _recsys_fwd_flops(cfg, b)
    notes = NOTES if mesh is None else ""
    dp = model.dp if mesh is not None else None

    def zeros(shape, dtype, spec):
        return local_zeros(shape, dtype, spec, mesh, dev)

    rows = None if cell.kind == "retrieval" else dp
    batch = {"dense": zeros((b, cfg.n_dense), torch.float32, (rows, None)),
             "sparse_ids": zeros((b, cfg.n_sparse, cfg.ids_per_field),
                                 torch.int32, (rows, None, None))}
    if cell.kind == "train":
        opt = (HybridAdamW(adamw=AdamW(lr=1e-3))
               if perf_flags.FLAGS.recsys_hybrid_opt else AdamW(lr=1e-3))
        batch["labels"] = zeros((b,), torch.float32, (dp,))
        return CellBuild(make_recsys_train_step(model, opt),
                         (params, opt.init(params), batch),
                         model_flops=3.0 * fwd_flops, notes=notes)
    if cell.kind == "serve":
        return CellBuild(torch.no_grad()(lambda params, batch: model(batch)),
                         (params, batch), model_flops=fwd_flops, notes=notes)
    # retrieval: 1 query vs n_candidates
    nc = cell.meta["n_candidates"]
    cand_spec = (None if mesh is None else dp + ("model",), None)
    batch["candidates"] = zeros((nc, cfg.retrieval_dim), torch.float32,
                                cand_spec)
    return CellBuild(
        torch.no_grad()(
            lambda params, batch: model.retrieval_scores(batch)),
        (params, batch),
        model_flops=fwd_flops + 2.0 * nc * cfg.retrieval_dim, notes=notes)
