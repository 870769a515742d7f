"""Decoder-only LM (dense and MoE) with KV-cache serving and training
(PyTorch port of ``src/repro/models/transformer.py``).

:class:`LM` is an ``nn.Module``: the embedding, one :class:`Block` per
layer (``ln1``, :class:`Attention` with optional ``q_norm``/``k_norm``,
``ln2``, and :class:`SwiGLU` as ``ffn`` or, under ``cfg.moe``,
:class:`MoE` as ``moe``), ``final_norm`` and ``out_head``.  Weights are
stored as the reference stores them, (in, out) and used as ``x @ W``, in
``cfg.param_dtype`` (fp32 masters, cast to ``cfg.compute_dtype`` at use);
the reference stacks them on a leading L axis, the port keeps one module
per layer (``models.convert`` maps between the two).  Layers run in a
Python loop, in groups of ``cfg.layer_group`` with the reference's layer
types (llama4: 3 chunked-local layers + 1 global).

Training: :meth:`LM.loss` and :func:`make_train_step`, as the reference's.
With ``cfg.remat`` each layer group runs under ``torch.utils.checkpoint``
with a selective policy that keeps the weight matmuls' outputs and
recomputes the rest in the backward, attention included: the reference's
``dots_with_no_batch_dims_saveable`` (a MoE layer keeps its router and
dense-branch products and recomputes its batched expert products).
``forward``, ``prefill`` and ``decode_step`` run under ``torch.no_grad``.

Not ported: sharding (``MeshAxes``, ``param_specs``, ``cache_specs``;
ROADMAP A6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .layers import LMConfig, attention, moe_ffn, rms_norm, swiglu

__all__ = ["LM", "Block", "Attention", "SwiGLU", "MoE", "make_train_step"]


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _weights(module: nn.Module) -> dict:
    return dict(module.named_parameters(recurse=False))


def _keep_weight_matmuls(ctx, op, *args, **kwargs):
    """The remat policy: a weight matmul (``x @ W``, one ``aten.mm``: no
    batch dimension) is saved, everything else recomputed (the MoE's
    expert products are ``aten.bmm``, batched over the experts)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_contexts():
    return create_selective_checkpoint_contexts(_keep_weight_matmuls)


class Attention(nn.Module):
    def __init__(self, cfg: LMConfig, *, device):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        self.wq = _param(d, cfg.q_dim, dtype=pd, device=device)
        self.wk = _param(d, cfg.kv_dim, dtype=pd, device=device)
        self.wv = _param(d, cfg.kv_dim, dtype=pd, device=device)
        self.wo = _param(cfg.q_dim, d, dtype=pd, device=device)
        if cfg.qk_norm:
            self.q_norm = _param(cfg.d_head, dtype=pd, device=device)
            self.k_norm = _param(cfg.d_head, dtype=pd, device=device)


class SwiGLU(nn.Module):
    def __init__(self, cfg: LMConfig, *, device):
        super().__init__()
        d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.w_gate = _param(d, f, dtype=pd, device=device)
        self.w_up = _param(d, f, dtype=pd, device=device)
        self.w_down = _param(f, d, dtype=pd, device=device)


class MoE(nn.Module):
    """The MoE FFN's weights (``layers.moe_ffn``): ``router`` (d, E),
    ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d), and ``dense`` (a
    :class:`SwiGLU`) for a dense residual or shared expert."""

    def __init__(self, cfg: LMConfig, *, device):
        super().__init__()
        d, f, e, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.param_dtype
        self.router = _param(d, e, dtype=pd, device=device)
        self.w_gate = _param(e, d, f, dtype=pd, device=device)
        self.w_up = _param(e, d, f, dtype=pd, device=device)
        self.w_down = _param(e, f, d, dtype=pd, device=device)
        if cfg.moe_dense_residual or cfg.moe_shared_expert:
            self.dense = SwiGLU(cfg, device=device)

    def weights(self) -> dict:
        p = _weights(self)
        if hasattr(self, "dense"):
            p["dense"] = _weights(self.dense)
        return p


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param(cfg.d_model, dtype=cfg.param_dtype, device=device)
        self.ln2 = _param(cfg.d_model, dtype=cfg.param_dtype, device=device)
        self.attn = Attention(cfg, device=device)
        if cfg.moe:
            self.moe = MoE(cfg, device=device)
        else:
            self.ffn = SwiGLU(cfg, device=device)

    def forward(self, x, positions, chunked, kv_cache=None, cache_pos=None):
        """-> ``(x, aux, (k, v))``: ``aux`` the MoE's auxiliary loss, a
        0-d f32 zero for a dense layer."""
        cfg = self.cfg
        h, kv = attention(_weights(self.attn), cfg, rms_norm(x, self.ln1),
                          positions, chunked=chunked, kv_cache=kv_cache,
                          cache_pos=cache_pos)
        x = x + h
        if cfg.moe:
            ff, aux = moe_ffn(self.moe.weights(), cfg, rms_norm(x, self.ln2))
        else:
            ff = swiglu(_weights(self.ffn), rms_norm(x, self.ln2),
                        cfg.compute_dtype)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + ff, aux, kv


class LM(nn.Module):
    """``LM(cfg, device=..., generator=...)`` draws the reference's shapes
    and scales (normal weights scaled by 1/sqrt(fan-in), the embedding by
    0.02, norms at one) from ``generator`` — a ``torch.Generator`` on
    ``device``, seeded 0 when omitted.  ``init=False`` leaves the weights
    uninitialised (``models.convert.lm_from_numpy`` fills them)."""

    def __init__(self, cfg: LMConfig, *, device="cuda",
                 generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        if cfg.n_layers % cfg.layer_group:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"layer_group {cfg.layer_group}")
        self.cfg = cfg
        device = torch.device(device)
        pd = cfg.param_dtype
        self.embed = _param(cfg.vocab, cfg.d_model, dtype=pd, device=device)
        self.out_head = _param(cfg.d_model, cfg.vocab, dtype=pd,
                               device=device)
        self.final_norm = _param(cfg.d_model, dtype=pd, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        if init:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
                p.fill_(1.0)
                continue
            scale = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
            # drawn in place (``torch.randn``'s draw): a temporary the
            # size of one arctic expert weight (17.85 GB in f32) would
            # not fit beside the rest
            p.normal_(generator=generator)
            p.mul_(scale)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _layer_types(self):
        g = self.cfg.layer_group
        if g == 1:
            return (self.cfg.attention == "chunked",)
        # llama4 iRoPE grouping: local, local, local, global
        return tuple(i < g - 1 for i in range(g))

    def _embed(self, tokens):
        # F.embedding: a gather, whose backward on the card sorts the ids
        # and reduces each row's segment (no atomic: the same bits again)
        return F.embedding(tokens, self.embed).to(self.cfg.compute_dtype)

    def _head(self, x):
        x = rms_norm(x, self.final_norm)
        return (x @ self.out_head.to(self.cfg.compute_dtype)).float()

    def _group(self, x, positions, first: int, cache=None):
        """Layers ``first .. first + layer_group - 1`` -> ``(x, the sum of
        their aux losses)``; each one's (k, v) is written into ``cache``
        when given."""
        cfg = self.cfg
        types = self._layer_types()
        s = x.shape[1]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(first, first + cfg.layer_group):
            x, aux, (k, v) = self.blocks[i](
                x, positions, chunked=types[i % cfg.layer_group])
            aux_total = aux_total + aux
            if cache is not None:
                cache[0][i, :, :s] = k
                cache[1][i, :, :s] = v
        return x, aux_total

    def _run(self, tokens, cache=None):
        """tokens (B, S) -> ``(logits (B, S, V) f32, aux)`` through every
        layer group, ``aux`` the groups' summed MoE auxiliary loss, with
        gradients where grad is enabled (and remat when ``cfg.remat`` is
        set and no cache is filled)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=x.device).expand(b, s)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        auxes = []
        for first in range(0, cfg.n_layers, cfg.layer_group):
            if remat:
                x, aux = checkpoint(self._group, x, positions, first,
                                    use_reentrant=False,
                                    context_fn=_remat_contexts)
            else:
                x, aux = self._group(x, positions, first, cache)
            auxes.append(aux)
        return self._head(x), torch.stack(auxes).sum()

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, tokens, *, collect_cache: bool = False,
                cache_len: int | None = None):
        """tokens (B, S) int -> ``(logits (B, S, V) f32, aux, cache)``.

        ``aux`` is the reference's MoE auxiliary loss (0-d f32), summed
        over the layers; zero for a dense model.  With ``collect_cache`` the cache is ``(k, v)``, each
        (L, B, cache_len, Hkv, Dh) in the compute dtype with the first S
        positions filled and the rest zero (``cache_len`` defaults to S:
        the reference's cache, which ``serve`` pads to prompt + gen)."""
        cfg = self.cfg
        b, s = tokens.shape
        cache = None
        if collect_cache:
            shape = (cfg.n_layers, b, cache_len or s, cfg.n_kv_heads,
                     cfg.d_head)
            cache = tuple(torch.zeros(shape, dtype=cfg.compute_dtype,
                                      device=self.device)
                          for _ in range(2))
        logits, aux = self._run(tokens, cache)
        return logits, aux, cache

    # --------------------------------------------------------------- loss
    def loss(self, batch):
        """``batch``: ``tokens`` and ``targets``, (B, S) int64 on the
        model's device -> the reference's ``(nll + 0.01 * aux, {"nll",
        "aux"})``, differentiable where grad is enabled.  The target
        logit is gathered: the value of the reference's one-hot
        contraction, which it takes only to shard the vocab."""
        logits, aux = self._run(batch["tokens"])
        logz = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, batch["targets"][..., None]).squeeze(-1)
        nll = (logz - tgt).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def prefill(self, tokens, *, cache_len: int | None = None):
        """Returns (last-token logits (B, V), cache (k, v):
        (L, B, cache_len, Hkv, Dh)); see :meth:`forward`."""
        logits, _, cache = self.forward(tokens, collect_cache=True,
                                        cache_len=cache_len)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos):
        """token (B, 1) int; pos (int) — the position being written.

        Writes the new k/v into ``cache`` in place and returns
        ``(logits (B, V) f32, cache)``."""
        cfg = self.cfg
        b = token.shape[0]
        pos = int(pos)
        x = self._embed(token)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        types = self._layer_types()
        ks, vs = cache
        for i, block in enumerate(self.blocks):
            x, _, _ = block(x, positions,
                            chunked=types[i % cfg.layer_group],
                            kv_cache=(ks[i], vs[i]), cache_pos=pos)
        return self._head(x[:, 0]), cache


def make_train_step(model: LM, optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` as the reference's: the loss and its gradient (autograd,
    with respect to ``params``, the model's parameters in order), then
    one ``optimizer.step`` written into ``params`` in place; ``metrics``
    holds ``nll``, ``aux`` and ``loss``."""

    def train_step(params, opt_state, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, params)
        opt_state = optimizer.step(params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step
