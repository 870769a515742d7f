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

Not ported: the model-parallel lookup (``lookup="collective"``) and
``param_specs``, which shard the tables over a mesh (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


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
    def __init__(self, cfg: WideDeepConfig, lookup: str = "auto", *,
                 device="cuda", generator=None, init: bool = True):
        super().__init__()
        if lookup != "auto":
            raise NotImplementedError(
                f"lookup={lookup!r} shards the tables over a mesh; the "
                "sharded lookup is not ported yet (ROADMAP A6)")
        self.cfg = cfg
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

    @property
    def device(self) -> torch.device:
        return self.bias.device

    def params(self) -> dict:
        """The parameters by the reference's tree paths (``tables/t0``,
        ``mlp/0/w``), in the module's order."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    def param_specs(self, tp: str = "model"):
        raise NotImplementedError(
            "param_specs shards the tables over a mesh; sharding is not "
            "ported yet (ROADMAP A6)")

    # ---------------------------------------------------------- embedding
    @staticmethod
    def _bag(table, ids):
        """EmbeddingBag(sum): ids (B, K) -> (B, D)."""
        return F.embedding(ids, table).sum(dim=1)

    def _deep(self, batch):
        ids = batch["sparse_ids"]
        embs = [self._bag(self.tables[f"t{f}"], ids[:, f])
                for f in range(self.cfg.n_sparse)]
        h = torch.cat(embs + [batch["dense"]], dim=-1)
        for lyr in self.mlp:
            h = torch.relu(h @ lyr.w + lyr.b)
        return h

    # ------------------------------------------------------------ forward
    def forward(self, batch):
        """batch: dense (B, n_dense), sparse_ids (B, F, K) -> logits (B,)."""
        ids = batch["sparse_ids"]
        deep_logit = (self._deep(batch) @ self.head)[:, 0]
        wide = [self._bag(self.wide_tables[f"t{f}"], ids[:, f])
                for f in range(self.cfg.n_sparse)]
        wide_logit = (sum(wide)[:, 0]
                      + (batch["dense"] @ self.wide_dense)[:, 0])
        return deep_logit + wide_logit + self.bias[0]

    def user_tower(self, batch):
        """Deep-tower representation for retrieval (B, retrieval_dim)."""
        return self._deep(batch) @ self.query_proj

    def retrieval_scores(self, batch):
        """Score 1 query against a candidate matrix.

        batch: dense (1, n_dense), sparse_ids (1, F, K),
               candidates (N_cand, retrieval_dim) -> (top_val, top_idx)."""
        q = self.user_tower(batch)[0]                         # (R,)
        scores = batch["candidates"] @ q                      # (N,)
        return torch.topk(scores, 100)

    def loss(self, batch):
        """Binary cross-entropy on the logits, in the reference's stable
        form."""
        logits = self.forward(batch)
        y = batch["labels"]
        return torch.mean(torch.clamp(logits, min=0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))


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
