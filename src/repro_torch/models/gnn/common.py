"""Shared GNN machinery (PyTorch port of ``src/repro/models/gnn/common.py``).

Messages are gathered by edge index (``x[src]``, torch's own gather and
its backward) and reduced by destination with :func:`segment_sum`, whose
forward is the Hopper kernel (``kernels.ops.segment_sum``) on the card and
its plain version on the CPU, and whose backward is a plain gather, as the
reference leaves the transpose of ``jax.ops.segment_sum`` to XLA.  All four
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
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...kernels import ops


class _SegmentSum(torch.autograd.Function):
    """Forward: the kernel (float32 sums, out-of-range ids dropped).
    Backward: ``grad[ids]`` with zeros for dropped ids, in the values'
    dtype."""

    @staticmethod
    def forward(ctx, values, seg_ids, num_segments: int):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        ctx.dtype = values.dtype
        return ops.segment_sum(values, seg_ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        (seg_ids,) = ctx.saved_tensors
        ok = (seg_ids >= 0) & (seg_ids < ctx.num_segments)
        g = grad[torch.where(ok, seg_ids, 0)]
        g = g * ok.view((-1,) + (1,) * (g.dim() - 1))
        return g.to(ctx.dtype), None, None


def segment_sum(values, seg_ids, num_segments: int):
    """(m, *rest) values summed by ``seg_ids`` into (num_segments, *rest)
    float32; differentiable in ``values``."""
    return _SegmentSum.apply(values, seg_ids, num_segments)


def segment_mean(values, seg_ids, num_segments: int):
    s = segment_sum(values, seg_ids, num_segments)
    ones = torch.ones(seg_ids.shape + (1,) * (values.dim() - 1),
                      dtype=torch.float32, device=values.device)
    c = segment_sum(ones, seg_ids, num_segments)
    return s / torch.clamp(c, min=1.0)


def segment_max(values, seg_ids, num_segments: int):
    """Per-segment maximum, -inf for an empty segment; ids outside
    ``[0, num_segments)``, negatives too, are dropped (as
    ``jax.ops.segment_max``).  They go to one extra row that is cut off,
    so the scatter never sees an out-of-range index (a device-side assert
    on the card)."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(ok, seg_ids, num_segments).to(torch.int64)
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]),
                     float("-inf"), dtype=values.dtype, device=values.device)
    idx = ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax",
                              include_self=False)[:num_segments]


def _take(x, ids):
    """``x[ids]`` under JAX's gather rule: a negative id wraps once, then
    every id is clamped into ``[0, len(x))``."""
    n = x.shape[0]
    return x[torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)]


def segment_softmax(logits, seg_ids, num_segments: int):
    """Softmax over edges grouped by destination (graph attention).  An
    edge whose id lies outside ``[0, num_segments)`` reads the clamped
    segment's max and sum, as the reference's gathers do."""
    mx = segment_max(logits, seg_ids, num_segments)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(logits - _take(mx, seg_ids))
    z = segment_sum(e, seg_ids, num_segments)
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
    """A ``GraphBatchStream`` batch of B graphs ((B, n, ...) numpy arrays)
    as one disjoint union on ``device``: (B*n,) species, (B*n, 3) pos,
    (B*m,) edge ids offset by b * n, and the (B,) energies."""
    species = np.asarray(batch["species"])
    b, n = species.shape
    off = (np.arange(b, dtype=np.int64) * n)[:, None]
    union = {
        "species": species.reshape(b * n),
        "pos": np.asarray(batch["pos"], np.float32).reshape(b * n, 3),
        "edge_src": (np.asarray(batch["edge_src"]) + off).reshape(-1),
        "edge_dst": (np.asarray(batch["edge_dst"]) + off).reshape(-1),
    }
    out = {k: torch.as_tensor(v, device=device) for k, v in union.items()}
    if "energy" in batch:
        out["energy"] = torch.as_tensor(np.asarray(batch["energy"],
                                                   np.float32), device=device)
    return out


def molecule_loss(model, union):
    """The reference's batched molecule loss (``vmap`` of one graph's pooled
    energy, then the mean squared error over the batch) on a
    :func:`molecule_union` batch: each graph's energy is the sum of its
    nodes' first output."""
    out = model({k: v for k, v in union.items() if k != "energy"})
    energies = out[:, 0].reshape(union["energy"].shape[0], -1).sum(dim=1)
    return torch.square(energies - union["energy"]).mean()
