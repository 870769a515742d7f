"""Decoder-only LM with KV-cache serving (PyTorch port of the dense part of
``src/repro/models/transformer.py``).

:class:`LM` is an ``nn.Module``: the embedding, one :class:`Block` per
layer (``ln1``, :class:`Attention` with optional ``q_norm``/``k_norm``,
``ln2``, :class:`SwiGLU`), ``final_norm`` and ``out_head``.  Weights are
stored as the reference stores them, (in, out) and used as ``x @ W``, in
``cfg.param_dtype`` (fp32 masters, cast to ``cfg.compute_dtype`` at use);
the reference stacks them on a leading L axis, the port keeps one module
per layer (``models.convert`` maps between the two).  Layers run in a
Python loop, in groups of ``cfg.layer_group`` with the reference's layer
types (llama4: 3 chunked-local layers + 1 global).

Not ported: the MoE FFN (an ``LMConfig`` with ``moe=True`` raises,
ROADMAP A11), sharding (``MeshAxes``, ``param_specs``, ``cache_specs``),
and training (``loss``, ``make_train_step``; ROADMAP A11).  ``remat`` has no
meaning without a gradient and is ignored.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import LMConfig, attention, rms_norm, swiglu

__all__ = ["LM", "Block", "Attention", "SwiGLU"]


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _weights(module: nn.Module) -> dict:
    return dict(module.named_parameters(recurse=False))


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


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param(cfg.d_model, dtype=cfg.param_dtype, device=device)
        self.ln2 = _param(cfg.d_model, dtype=cfg.param_dtype, device=device)
        self.attn = Attention(cfg, device=device)
        self.ffn = SwiGLU(cfg, device=device)

    def forward(self, x, positions, chunked, kv_cache=None, cache_pos=None):
        cfg = self.cfg
        h, kv = attention(_weights(self.attn), cfg, rms_norm(x, self.ln1),
                          positions, chunked=chunked, kv_cache=kv_cache,
                          cache_pos=cache_pos)
        x = x + h
        ff = swiglu(_weights(self.ffn), rms_norm(x, self.ln2),
                    cfg.compute_dtype)
        return x + ff, kv


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
        if cfg.moe:
            raise NotImplementedError(
                f"{cfg.name}: the MoE FFN is not ported to repro_torch yet "
                "(ROADMAP A11, MoE)")
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
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=p.device)
            p.copy_(w * scale)

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
        return self.embed[tokens].to(self.cfg.compute_dtype)

    def _head(self, x):
        x = rms_norm(x, self.final_norm)
        return (x @ self.out_head.to(self.cfg.compute_dtype)).float()

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, tokens, *, collect_cache: bool = False,
                cache_len: int | None = None):
        """tokens (B, S) int -> ``(logits (B, S, V) f32, aux, cache)``.

        ``aux`` is the reference's MoE auxiliary loss, a 0-d zero for a
        dense model.  With ``collect_cache`` the cache is ``(k, v)``, each
        (L, B, cache_len, Hkv, Dh) in the compute dtype with the first S
        positions filled and the rest zero (``cache_len`` defaults to S:
        the reference's cache, which ``serve`` pads to prompt + gen)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=x.device).expand(b, s)
        types = self._layer_types()
        cache = None
        if collect_cache:
            shape = (cfg.n_layers, b, cache_len or s, cfg.n_kv_heads,
                     cfg.d_head)
            cache = tuple(torch.zeros(shape, dtype=cfg.compute_dtype,
                                      device=x.device) for _ in range(2))
        for i, block in enumerate(self.blocks):
            x, (k, v) = block(x, positions,
                              chunked=types[i % cfg.layer_group])
            if collect_cache:
                cache[0][i, :, :s] = k
                cache[1][i, :, :s] = v
        logits = self._head(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux, cache

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
            x, _ = block(x, positions, chunked=types[i % cfg.layer_group],
                         kv_cache=(ks[i], vs[i]), cache_pos=pos)
        return self._head(x[:, 0]), cache
