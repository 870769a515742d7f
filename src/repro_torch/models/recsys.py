"""Wide & Deep [arXiv:1606.07792] (PyTorch port of
``src/repro/models/recsys.py``).

The EmbeddingBag (sum) of a field is a gather plus a sum over the bag
axis in plain PyTorch: ``F.embedding(ids, table).sum(1)``, as the
reference builds it from ``jnp.take`` + ``.sum`` outside any Pallas
kernel.  ``F.embedding``'s backward on the card sorts the ids and sums
each id's rows in a fixed order (``embedding_dense_backward``), where an
``index_select`` would take ``index_add_``'s atomics: on an H100 a rerun
gives the same bits (``chip_smoke.py`` phase 17 checks it at the
published width, ``tests/test_torch_gpu.py`` at a small one).

The parameters keep the reference's names and initial distributions:
``tables.t{f}`` (N(0, 1) * 0.01), ``wide_tables.t{f}`` (zeros),
``mlp[i].w`` (N(0, 1) / sqrt(fan-in)) and ``mlp[i].b`` (zeros), ``head``,
``wide_dense``, ``bias`` and ``query_proj``; :meth:`WideDeep.params` names
them as the reference's tree paths (``tables/t0``, ``mlp/0/w``), which
``optim.HybridAdamW`` matches.  Draws come from a ``torch.Generator`` on
the device, so weights equal the reference's only when carried over
(``models.convert.widedeep_from_numpy``).

On a ``DeviceMesh`` (``WideDeep(..., mesh=)``, or :meth:`WideDeep.shard`)
the parameters are DTensors placed by :meth:`WideDeep.param_specs`: every
table (``tables``, ``wide_tables``) row-sharded over the model axis, the
rest replicated; the other mesh axes are the data axes (dp).  A plain
batch tensor is placed as the reference's cells place it: the batch on
dp, retrieval's query replicated and its candidates over dp and the model
axis.  ``lookup="collective"`` is the reference's model-parallel lookup
(:meth:`WideDeep._bag_collective`): each rank looks up the ids its rows
hold, the others masked to 0, and the bag sums are summed over the model
axis, every field in one ``local_map``.  The reference's ``shard_map``
takes the ids replicated, so each dp rank embeds the whole batch; the
port keeps the batch on dp (the same values, a dp-th of the lookups;
ROADMAP C).  ``lookup`` is kept for the reference's signature: off a
mesh both lookups are ``F.embedding``, and ``"auto"`` on a mesh runs the
collective lookup too: the reference leaves its collectives to GSPMD,
and ``F.embedding`` on row-sharded DTensor tables (DTensor's own masked
lookup) fails from the second field on (its mask buffer is shared by the
cached sharding decision: "MaskBuffer has been materialized with
conflicting data"; ROADMAP C).
:meth:`WideDeep.retrieval_scores` on sharded candidates takes each
rank's top 100 and the global top 100 of those, ties to the lower index
as ``jax.lax.top_k``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import sharding


def default_vocab_sizes(n_sparse: int = 40) -> tuple[int, ...]:
    """Criteo-like skew: 4 huge, 8 large, rest small; all divisible by 16."""
    sizes = []
    for i in range(n_sparse):
        if i < 4:
            sizes.append(1 << 24)        # 16.8M rows
        elif i < 12:
            sizes.append(1 << 20)        # 1M rows
        elif i < 24:
            sizes.append(1 << 16)
        else:
            sizes.append(1 << 12)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    mlp: tuple[int, ...] = (1024, 512, 256)
    n_dense: int = 13
    ids_per_field: int = 2               # multi-hot bag size
    vocab_sizes: tuple[int, ...] = dataclasses.field(
        default_factory=default_vocab_sizes)
    retrieval_dim: int = 256

    def param_count(self) -> int:
        emb = sum(self.vocab_sizes) * (self.embed_dim + 1)
        d_in = self.n_sparse * self.embed_dim + self.n_dense
        mlp = 0
        prev = d_in
        for h in self.mlp:
            mlp += prev * h + h
            prev = h
        return emb + mlp + prev + self.n_dense + 2


def _param(shape, scale=None, *, device, generator, init):
    """A float32 parameter: N(0, 1) * ``scale``, or zeros without a scale
    (left empty when ``init`` is False, for weights loaded next)."""
    if scale is None:
        return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                        device=device))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if init:
        t.normal_(generator=generator).mul_(scale)
    return nn.Parameter(t)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, **kw):
        super().__init__()
        self.w = _param((d_in, d_out), 1.0 / math.sqrt(d_in), **kw)
        self.b = _param((d_out,), **kw)


class WideDeep(nn.Module):
    def __init__(self, cfg: WideDeepConfig, lookup: str = "auto",
                 mesh=None, model_axis: str = "model", *, device="cuda",
                 generator=None, init: bool = True):
        super().__init__()
        if lookup not in ("auto", "collective"):
            raise ValueError(f"lookup={lookup!r}: 'auto' or 'collective'")
        self.cfg = cfg
        self.lookup, self.model_axis = lookup, model_axis
        self.mesh = None
        kw = dict(device=device, generator=generator, init=init)
        self.tables = nn.ParameterDict()
        self.wide_tables = nn.ParameterDict()
        for f, v in enumerate(cfg.vocab_sizes):
            self.tables[f"t{f}"] = _param((v, cfg.embed_dim), 0.01, **kw)
            self.wide_tables[f"t{f}"] = _param((v, 1), **kw)
        prev = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
        self.mlp = nn.ModuleList()
        for h in cfg.mlp:
            self.mlp.append(_Dense(prev, h, **kw))
            prev = h
        self.head = _param((prev, 1), 1.0 / math.sqrt(prev), **kw)
        self.wide_dense = _param((cfg.n_dense, 1), **kw)
        self.bias = _param((1,), **kw)
        self.query_proj = _param((prev, cfg.retrieval_dim),
                                 1.0 / math.sqrt(prev), **kw)
        if mesh is not None:
            self.shard(mesh)

    @property
    def device(self) -> torch.device:
        return self.bias.device

    def params(self) -> dict:
        """The parameters by the reference's tree paths (``tables/t0``,
        ``mlp/0/w``), in the module's order."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    def param_specs(self, tp: str = "model") -> dict:
        """The reference's spec of each parameter, by its tree path
        (:meth:`params`' names): ``(tp, None)`` for every leaf whose path
        holds ``tables``, replicated otherwise."""
        return {name: ((tp, None) if "tables" in name
                       else (None,) * p.dim())
                for name, p in self.params().items()}

    def shard(self, mesh):
        """Place the parameters on ``mesh`` by :meth:`param_specs` of the
        model axis (each rank keeps its rows of every table; nothing is
        sent: every rank must hold the same weights); returns self."""
        sharding.check_device(self.device, mesh, "the model's parameters")
        if self.model_axis not in mesh.mesh_dim_names:
            raise ValueError(f"the mesh has no axis {self.model_axis!r}")
        specs = self.param_specs(self.model_axis)
        sharding.place_module(self, {n: specs[n.replace(".", "/")] for n, _
                                     in self.named_parameters()}, mesh)
        self.mesh = mesh
        return self

    @property
    def dp(self) -> tuple:
        """The data axes: the mesh's axes other than the model axis."""
        return tuple(n for n in self.mesh.mesh_dim_names
                     if n != self.model_axis)

    def _batch(self, batch, replicated: bool = False):
        """``batch``'s dense features, ids and labels placed: the batch on
        dp, or replicated (retrieval's query)."""
        if self.mesh is None:
            return batch
        dp = None if replicated else self.dp
        out = dict(batch)
        for key in ("dense", "sparse_ids", "labels"):
            if key in batch:
                t = batch[key]
                out[key] = sharding.place(t, (dp,) + (None,) * (t.dim() - 1),
                                          self.mesh)
        return out

    # ---------------------------------------------------------- embedding
    def _bags(self, tables, ids):
        """Every field's EmbeddingBag(sum) over ``tables`` (``t0`` ..):
        ids (B, F, K) -> (B, F * D), the fields side by side."""
        ts = [tables[f"t{f}"] for f in range(self.cfg.n_sparse)]
        if self.mesh is not None:
            return self._bag_collective(ts, ids)
        return torch.cat([F.embedding(ids[:, f], t).sum(dim=1)
                          for f, t in enumerate(ts)], dim=-1)

    def _bag_collective(self, tables, ids):
        """The reference's masked local lookup, every field in one
        ``local_map``: on each rank the ids its rows of a table (row-sharded
        over the model axis) hold are looked up, the others give 0, each
        bag is summed, and the sum over the model axis (a ``Partial``
        output, reduced) plays the EmbeddingBag's reduce across shards.
        The ids keep their own placement (the batch on dp), so a table's
        gradient is a partial sum over dp."""
        mesh = self.mesh
        tpl = list(tables[0].placements)
        ipl = list(ids.placements)
        spans = [sharding.shard_offset(mesh, tpl, 0, t.shape[0])
                 for t in tables]
        tp_dims = [i for i, q in enumerate(tpl) if isinstance(q, Shard)]
        opl = [Partial() if i in tp_dims else
               (Shard(0) if isinstance(q, Shard) and q.dim == 0 else
                Replicate()) for i, q in enumerate(ipl)]
        gpl = [q if i in tp_dims else
               (Partial() if isinstance(ipl[i], Shard) else q)
               for i, q in enumerate(tpl)]

        def body(*args):
            *tbls, ids_ = args
            out = []
            for f, (tbl, (start, rows)) in enumerate(zip(tbls, spans)):
                local = ids_[:, f] - start
                ok = (local >= 0) & (local < rows)
                emb = F.embedding(local.clamp(0, rows - 1), tbl)
                out.append(torch.where(ok[..., None], emb, 0.0).sum(dim=1))
            return torch.cat(out, dim=-1)

        n = len(tables)
        out = local_map(body, out_placements=opl,
                        in_placements=(tpl,) * n + (ipl,),
                        in_grad_placements=(gpl,) * n + (ipl,),
                        device_mesh=mesh)(*tables, ids)
        return out.redistribute(mesh, [Replicate() if q.is_partial() else q
                                       for q in opl])

    @staticmethod
    def _field_sum(w):
        """(B, F) -> (B,): the fields added one after another, in order
        (the reference's ``sum`` over the fields' wide bags); on a DTensor,
        on each rank's block."""
        if not isinstance(w, DTensor):
            return sum(w.unbind(-1))
        pl = list(w.placements)
        return local_map(lambda t: sum(t.unbind(-1)), out_placements=pl,
                         in_placements=(pl,), device_mesh=w.device_mesh)(w)

    def _deep(self, batch):
        h = torch.cat([self._bags(self.tables, batch["sparse_ids"]),
                       batch["dense"]], dim=-1)
        for lyr in self.mlp:
            h = torch.relu(h @ lyr.w + lyr.b)
        return h

    # ------------------------------------------------------------ forward
    def forward(self, batch):
        """batch: dense (B, n_dense), sparse_ids (B, F, K) -> logits (B,)
        (on a mesh a DTensor, the batch on dp)."""
        batch = self._batch(batch)
        deep_logit = (self._deep(batch) @ self.head)[:, 0]
        wide = self._bags(self.wide_tables, batch["sparse_ids"])
        wide_logit = (self._field_sum(wide)
                      + (batch["dense"] @ self.wide_dense)[:, 0])
        return deep_logit + wide_logit + self.bias[0]

    def user_tower(self, batch):
        """Deep-tower representation for retrieval (B, retrieval_dim)."""
        return self._deep(batch) @ self.query_proj

    def retrieval_scores(self, batch):
        """Score 1 query against a candidate matrix.

        batch: dense (1, n_dense), sparse_ids (1, F, K),
               candidates (N_cand, retrieval_dim) -> (top_val, top_idx).

        On a mesh the query is replicated and the candidates are placed
        over dp and the model axis (the reference's cell's specs): each
        rank scores its block, keeps its top 100 (a stable descending
        sort: ties to the lower index), and the global top 100 is taken
        from the gathered ones in rank order, which is index order: the
        values and indices of an exact top-100 with ``jax.lax.top_k``'s
        ties.  Plain tensors are returned, the same on every rank."""
        if self.mesh is None:
            q = self.user_tower(batch)[0]                     # (R,)
            scores = batch["candidates"] @ q                  # (N,)
            return torch.topk(scores, 100)
        q = self.user_tower(self._batch(batch, replicated=True))
        q = q.redistribute(self.mesh, [Replicate()] * self.mesh.ndim)
        cand = sharding.place(batch["candidates"],
                              (self.dp + (self.model_axis,), None), self.mesh)
        return _sharded_top100(cand, q)

    def loss(self, batch):
        """Binary cross-entropy on the logits, in the reference's stable
        form; on a mesh a plain 0-d tensor (the same on every rank)."""
        logits = self.forward(batch)
        y = batch["labels"]
        if self.mesh is not None:
            y = sharding.place(y, (self.dp,), self.mesh)
        out = torch.mean(torch.clamp(logits, min=0) - logits * y
                         + torch.log1p(torch.exp(-torch.abs(logits))))
        return out.full_tensor() if isinstance(out, DTensor) else out


def _sharded_top100(cand, q, k: int = 100):
    """The top ``k`` of ``cand @ q[0]`` over candidates row-sharded on
    the mesh (``cand`` a DTensor, ``q`` (1, R) replicated): see
    :meth:`WideDeep.retrieval_scores`."""
    mesh, cpl = cand.device_mesh, list(cand.placements)
    n = cand.shape[0]
    start, _ = sharding.shard_offset(mesh, cpl, 0, n)

    def local_top(c, ql):
        s = c @ ql[0]
        vals, idx = torch.sort(s, descending=True, stable=True)
        vals, idx = vals[:k], idx[:k] + start
        if vals.numel() < k:           # a block of fewer rows: pad
            pad = k - vals.numel()
            vals = torch.cat([vals, vals.new_full((pad,), float("-inf"))])
            idx = torch.cat([idx, idx.new_full((pad,), n)])
        return vals, idx

    vals, idx = local_map(local_top, out_placements=(cpl, cpl),
                          in_placements=(cpl, list(q.placements)),
                          device_mesh=mesh)(cand, q)
    vals, idx = vals.full_tensor(), idx.full_tensor()
    top, order = torch.sort(vals, descending=True, stable=True)
    return top[:k], idx[order[:k]]


def make_recsys_train_step(model: WideDeep, optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``
    over ``params = model.params()``: the loss and its gradient by
    autograd (zeros for ``query_proj``, which the loss does not use, as
    JAX's gradient gives), then one update of ``optimizer`` (``AdamW`` or
    ``HybridAdamW``) written into the parameters in place."""
    def train_step(params, opt_state, batch):
        loss = model.loss(batch)
        grads = loss_grads(loss, params)
        opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach()}
    return train_step


def loss_grads(loss, params: dict) -> list:
    """``d loss / d params`` in ``params``' order, zeros where the loss
    does not depend on a parameter."""
    tensors = list(params.values())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(tensors, grads)]
