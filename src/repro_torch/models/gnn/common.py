"""Shared GNN machinery (PyTorch port of ``src/repro/models/gnn/common.py``).

Messages are gathered by edge index (``x[src]``, torch's own gather and
its backward) and reduced by destination with :func:`segment_sum`, whose
forward is the Hopper kernel (``kernels.ops.segment_sum``) on the card and
its plain version on the CPU, and whose backward is a plain gather, as the
reference leaves the transpose of ``jax.ops.segment_sum`` to XLA.  Each
forward groups its edges by destination once (:func:`segment_index`, a
sort) and hands that index to every aggregation.  All four
GNNs take the reference's batch schema, as torch tensors on one device:

  node input:  ``feats`` (n, d_feat) float  OR  ``species`` (n,) int
  geometry:    ``pos`` (n, 3) float
  topology:    ``edge_src``/``edge_dst`` (m,) int  (messages flow src->dst)
  supervision: ``labels`` (n,) int  or  ``energy``

The reference trains on a batch of B small graphs by ``jax.vmap`` over the
graphs.  The port batches them as one disjoint union instead
(:func:`molecule_union`): node ids of graph b are offset by b * n_nodes, so
each layer aggregates the whole batch with one kernel launch, and the
per-graph energy is the sum over each graph's nodes
(:func:`molecule_loss`).

Parameters mirror the reference's tree: an :class:`MLP` is a list of
:class:`Dense` layers with ``w`` (in, out) and ``b`` (out,), used as
``x @ w + b``, so ``models.convert`` maps the tree to the modules one to one.

On a mesh (``launch.cells`` ``_build_gnn(..., mesh)``) the parameters are
replicated: every rank holds the whole model as plain tensors.  A large
graph's edges are split over the mesh axes ``gdp`` and its node space is
replicated: inside :func:`edge_sharded` a rank's forward sees its block of
the edges and every node, each aggregation reduces the rank's edges into
a full-node partial result (the ``segment_sum`` kernel on the local block)
and sums it over the ranks (:class:`_AllReduce`; ``segment_max``, the
softmax's shift, takes the max), so every node-space tensor is the
unsharded one on every rank.  Gradients then come back as partial sums:
:func:`mesh_grads` seeds each rank with ``1 / |gdp|`` of the loss and sums
the parameters' gradients over ``gdp``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from ...kernels import ops


def all_reduced(x, groups):
    """A copy of ``x`` summed over each of the process groups ``groups``
    (over all of their ranks together); ``x`` itself is left as it is."""
    out = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        tdist.all_reduce(out, group=g)
    return out


class _AllReduce(torch.autograd.Function):
    """:func:`all_reduced` in the forward and in the backward: a rank's
    forward input is its partial sum, and every gradient on a mesh is a
    partial sum over the ranks too (see :func:`mesh_grads`)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduced(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return all_reduced(grad, ctx.groups), None


#: (process groups, mesh axes) of the active :func:`edge_sharded` block
_EDGE_SPLIT: contextvars.ContextVar = contextvars.ContextVar(
    "edge_split", default=((), ()))


@contextlib.contextmanager
def edge_sharded(groups, axes=()):
    """A block in which every aggregation sums its rank's partial result
    over ``groups`` (the process groups of the mesh axes ``axes`` the
    edges are split over; an empty list changes nothing).  The scope is
    a ``ContextVar``'s: the forward's aggregations read it, nothing else
    does."""
    token = _EDGE_SPLIT.set((tuple(groups), tuple(axes)))
    try:
        yield
    finally:
        _EDGE_SPLIT.reset(token)


def mesh_groups(mesh, axes) -> list:
    """The process groups of ``mesh``'s dimensions named in ``axes`` that
    hold more than one rank."""
    return [mesh.get_group(name) for name in axes if mesh.size(
        mesh.mesh_dim_names.index(name)) > 1]


def edge_axes() -> tuple:
    """The mesh axes of the active :func:`edge_sharded` block (() when
    none is active or it names none)."""
    return _EDGE_SPLIT.get()[1]


def mesh_grads(loss, params, groups, scale: float = 1.0) -> list:
    """``d loss / d params`` on a mesh, summed over ``groups``: each rank's
    backward is seeded with ``scale`` (``1 / |groups|`` where ``loss`` is
    the same on every rank of them, 1 where it is the rank's share of
    a sum), and the partial gradients are all-reduced, one call a
    parameter.  The ranks of ``groups`` end with the same gradients;
    without groups it is ``torch.autograd.grad``."""
    grads = list(torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                     params))
    for g in grads:
        for grp in groups:
            tdist.all_reduce(g, group=grp)
    return grads


class _SegmentSum(torch.autograd.Function):
    """Forward: the kernel (float32 sums, out-of-range ids dropped), over
    the caller's :func:`segment_index` where it passes one.  Backward:
    ``grad[ids]`` with zeros for dropped ids, in the values' dtype."""

    @staticmethod
    def forward(ctx, values, seg_ids, num_segments: int, index):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        ctx.dtype = values.dtype
        return ops.segment_sum(values, seg_ids, num_segments, index)

    @staticmethod
    def backward(ctx, grad):
        (seg_ids,) = ctx.saved_tensors
        ok = (seg_ids >= 0) & (seg_ids < ctx.num_segments)
        g = grad[torch.where(ok, seg_ids, 0)]
        g = g * ok.view((-1,) + (1,) * (g.dim() - 1))
        return g.to(ctx.dtype), None, None, None


#: the rows of ``seg_ids`` grouped by segment (``kernels.ops``): a forward
#: builds one from ``edge_dst`` and passes it to each aggregation
segment_index = ops.segment_index


def segment_sum(values, seg_ids, num_segments: int, index=None):
    """(m, *rest) values summed by ``seg_ids`` into (num_segments, *rest)
    float32; differentiable in ``values``.  ``index``: the
    :func:`segment_index` of ``seg_ids``, built per call where it is
    None.  Inside :func:`edge_sharded` the rank's sum is summed over the
    ranks."""
    out = _SegmentSum.apply(values, seg_ids, num_segments, index)
    groups = _EDGE_SPLIT.get()[0]
    if groups:
        out = _AllReduce.apply(out, groups)
    return out


def segment_mean(values, seg_ids, num_segments: int, index=None):
    s = segment_sum(values, seg_ids, num_segments, index)
    ones = torch.ones(seg_ids.shape + (1,) * (values.dim() - 1),
                      dtype=torch.float32, device=values.device)
    c = segment_sum(ones, seg_ids, num_segments, index)
    return s / torch.clamp(c, min=1.0)


def segment_max(values, seg_ids, num_segments: int):
    """Per-segment maximum, -inf for an empty segment; ids outside
    ``[0, num_segments)``, negatives too, are dropped (as
    ``jax.ops.segment_max``).  They go to one extra row that is cut off,
    so the scatter never sees an out-of-range index (a device-side assert
    on the card).  Inside :func:`edge_sharded`: the max over the ranks,
    without a gradient."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(ok, seg_ids, num_segments).to(torch.int64)
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]),
                     float("-inf"), dtype=values.dtype, device=values.device)
    idx = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out = out.scatter_reduce(0, idx, values, "amax",
                             include_self=False)[:num_segments]
    groups = _EDGE_SPLIT.get()[0]
    if groups:
        # the max over the ranks' edges; no gradient (the one use, the
        # softmax's shift, cancels it)
        out = out.detach().contiguous()
        for g in groups:
            tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=g)
    return out


def _take(x, ids):
    """``x[ids]`` under JAX's gather rule: a negative id wraps once, then
    every id is clamped into ``[0, len(x))``."""
    n = x.shape[0]
    return x[torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)]


def segment_softmax(logits, seg_ids, num_segments: int, index=None):
    """Softmax over edges grouped by destination (graph attention).  An
    edge whose id lies outside ``[0, num_segments)`` reads the clamped
    segment's max and sum, as the reference's gathers do.  ``index``: as
    :func:`segment_sum`'s."""
    mx = segment_max(logits, seg_ids, num_segments)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(logits - _take(mx, seg_ids))
    z = segment_sum(e, seg_ids, num_segments, index)
    return e / torch.clamp(_take(z, seg_ids), min=1e-9)


# ------------------------------------------------------------------ params


def normal(shape, scale: float, *, device, generator=None, init=True):
    """A float32 parameter drawn from N(0, 1) * scale (or left empty when
    ``init`` is False, for weights that are loaded next)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if init:
        t.normal_(generator=generator).mul_(scale)
    return nn.Parameter(t)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, device, generator=None,
                 init=True):
        super().__init__()
        self.w = normal((d_in, d_out), 1.0 / math.sqrt(d_in), device=device,
                        generator=generator, init=init)
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=torch.float32,
                                          device=device))

    def forward(self, x):
        return x @ self.w + self.b


class MLP(nn.ModuleList):
    """``mlp_init``/``mlp_apply`` of the reference: Dense layers of
    ``sizes``, ``act`` between them (and after the last with
    ``final_act``), an optional layer norm at the end."""

    def __init__(self, sizes, *, device, generator=None, init=True):
        super().__init__(
            Dense(sizes[i], sizes[i + 1], device=device, generator=generator,
                  init=init) for i in range(len(sizes) - 1))

    def forward(self, x, act=F.silu, final_act: bool = False,
                norm: bool = False):
        for i, lyr in enumerate(self):
            x = lyr(x)
            if i < len(self) - 1 or final_act:
                x = act(x)
        if norm:
            x = layer_norm(x)
        return x


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


class NodeInput(nn.Module):
    """``node_input_params``: ``in_proj`` (d_feat, hidden) for dense
    features, else ``species_embed`` (n_species, hidden)."""

    def __init__(self, hidden: int, d_feat: int | None, n_species: int = 32,
                 *, device, generator=None, init=True):
        super().__init__()
        if d_feat is not None:
            self.in_proj = normal((d_feat, hidden), 1.0 / math.sqrt(d_feat),
                                  device=device, generator=generator,
                                  init=init)
        else:
            self.species_embed = normal((n_species, hidden), 0.1,
                                        device=device, generator=generator,
                                        init=init)

    def forward(self, batch):
        """Project dense features or embed species into the hidden dim."""
        if "feats" in batch:
            return batch["feats"] @ self.in_proj
        return self.species_embed[batch["species"]]


def num_nodes(batch) -> int:
    return (batch["feats"].shape[0] if "feats" in batch
            else batch["species"].shape[0])


def graph_loss(out, batch):
    """Node classification (labels) or energy regression, by batch keys."""
    if "labels" in batch:
        logz = torch.logsumexp(out, dim=-1)
        tgt = torch.gather(out, -1, batch["labels"][..., None].to(
            torch.int64))[..., 0]
        return (logz - tgt).mean()
    return torch.square(out - batch["energy"]).mean()


def pooled_loss(model, batch):
    """``model.loss`` of the reference: node classification, or one graph's
    energy as the sum of its nodes' first output."""
    out = model(batch)
    if "energy" in batch:
        out = out[..., 0].sum(dim=-1)
    return graph_loss(out, batch)


# ----------------------------------------------------- batched molecules


def molecule_union(batch, device) -> dict:
    """A ``GraphBatchStream`` batch of B graphs ((B, n, ...) numpy arrays,
    or tensors) as one disjoint union on ``device``: (B*n,) species,
    (B*n, 3) float32 pos, (B*m,) int64 edge ids offset by b * n, and the
    (B,) float32 energies.  The arrays reach the device first and the
    offsets are added there, so a batch of meta tensors (the dry-run's)
    takes the same path."""
    t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    b, n = t["species"].shape
    off = torch.arange(b, dtype=torch.int64, device=device)[:, None] * n
    out = {
        "species": t["species"].reshape(b * n),
        "pos": t["pos"].to(torch.float32).reshape(b * n, 3),
        "edge_src": (t["edge_src"] + off).reshape(-1),
        "edge_dst": (t["edge_dst"] + off).reshape(-1),
    }
    if "energy" in t:
        out["energy"] = t["energy"].to(torch.float32)
    return out


def molecule_loss(model, union):
    """The reference's batched molecule loss (``vmap`` of one graph's pooled
    energy, then the mean squared error over the batch) on a
    :func:`molecule_union` batch: each graph's energy is the sum of its
    nodes' first output."""
    out = model({k: v for k, v in union.items() if k != "energy"})
    energies = out[:, 0].reshape(union["energy"].shape[0], -1).sum(dim=1)
    return torch.square(energies - union["energy"]).mean()
