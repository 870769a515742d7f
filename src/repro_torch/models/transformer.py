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

Sharding, as the reference's: :class:`MeshAxes` names the mesh axes,
:meth:`LM.param_specs` gives each parameter the reference's spec (FSDP x
TP x EP, the layer axis dropped: the port keeps a module per layer) and
:meth:`LM.cache_specs` the KV cache's.  ``models.sharding.shard_lm``
places the parameters as DTensors on a ``DeviceMesh``; the LM then pins
its activations where the reference does (the embedding's output on dp,
q/k/v on (dp, heads on tp), the logits on (dp, vocab on tp)) with
``redistribute``, and the attention runs on each rank's heads
(``layers.attention``; ceil(H / tp) of them, padded with zero heads
where tp does not divide H, as GSPMD pads); each layer's branch outputs
are all-reduced onto the residual stream's placement (:func:`_like`); a
MoE layer routes every token of the batch on every rank and runs each
expert's products on the ranks that hold it
(``layers._moe_ffn_sharded``).  The sharded loss reduces the
vocab-sharded logits over the shard (a max, a sum and the target logit
picked on the rank that holds it), never gathering the logits.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import sharding
from .layers import (LMConfig, attention, cache_write, moe_ffn, rms_norm,
                     swiglu)

__all__ = ["LM", "MeshAxes", "Block", "Attention", "SwiGLU", "MoE",
           "make_train_step"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical -> physical mesh axis names (the reference's)."""
    dp: tuple[str, ...] = ("data",)      # batch / fsdp axes ("pod","data")
    tp: str = "model"

    @property
    def fsdp(self):
        return self.dp


_NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def _ref_spec(path: str, nd: int, axes: MeshAxes) -> tuple:
    """The reference's ``param_specs`` rule for its stacked leaf ``path``
    (dotted, ``blocks.attn.wq``) of ``nd`` dimensions."""
    fsdp, tp = axes.fsdp, axes.tp
    if path.endswith(_NORMS):
        return (None,) * nd
    if path.endswith("embed"):
        return (tp, None)       # vocab-sharded, d replicated
    if path.endswith("out_head"):
        return (None, tp)
    if path.endswith("router"):
        return (None, fsdp, None)
    if ".moe." in path or path.endswith(("moe.w_gate", "moe.w_up",
                                         "moe.w_down")):
        if "dense" in path:     # (L, d, f) / (L, f, d) dense branch
            if path.endswith("w_down"):
                return (None, tp, fsdp)
            return (None, fsdp, tp)
        if path.endswith("w_down"):     # (L, E, F, D)
            return (None, tp, None, fsdp)
        return (None, tp, fsdp, None)   # (L, E, D, F)
    # dense attn / ffn mats (L, in, out)
    if path.endswith(("wo", "w_down")):
        return (None, tp, fsdp)
    return (None, fsdp, tp)


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


def _like(h, x):
    """A branch's output ``h`` placed as the residual stream ``x`` (a
    DTensor's partial sums over tp all-reduced), so the stream keeps the
    embedding's pin (the batch on dp) from layer to layer: DTensor left
    alone may reduce-scatter the sums onto the batch over tp, which
    splits unevenly where tp does not divide the rank's batch."""
    if isinstance(h, DTensor) and tuple(h.placements) != tuple(x.placements):
        return h.redistribute(x.device_mesh, x.placements)
    return h


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

    def forward(self, x, positions, chunked, kv_cache=None, cache_pos=None,
                axes=None):
        """-> ``(x, aux, (k, v))``: ``aux`` the MoE's auxiliary loss, a
        0-d f32 zero for a dense layer.  ``axes``: the LM's
        :class:`MeshAxes` when it is sharded."""
        cfg = self.cfg
        h, kv = attention(_weights(self.attn), cfg, rms_norm(x, self.ln1),
                          positions, chunked=chunked, kv_cache=kv_cache,
                          cache_pos=cache_pos, axes=axes)
        x = x + _like(h, x)
        if cfg.moe:
            ff, aux = moe_ffn(self.moe.weights(), cfg, rms_norm(x, self.ln2),
                              axes=axes)
        else:
            ff = swiglu(_weights(self.ffn), rms_norm(x, self.ln2),
                        cfg.compute_dtype)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + _like(ff, x), aux, kv


@torch.no_grad()
def init_param(name: str, p, t, generator: torch.Generator) -> None:
    """Draw parameter ``name`` (global shape ``p.shape``) into ``t`` in
    place, by the reference's rule: norms at one, the embedding normal
    times 0.02, every other weight normal over sqrt(fan-in).  ``t`` is
    ``p`` itself, or one rank's block of it (``sharding.materialize``)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _NORMS:
        t.fill_(1.0)
        return
    scale = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
    # drawn in place (``torch.randn``'s draw): a temporary the size of
    # one arctic expert weight (17.85 GB in f32) would not fit beside
    # the rest
    t.normal_(generator=generator)
    t.mul_(scale)


class LM(nn.Module):
    """``LM(cfg, device=..., generator=...)`` draws the reference's shapes
    and scales (normal weights scaled by 1/sqrt(fan-in), the embedding by
    0.02, norms at one) from ``generator`` — a ``torch.Generator`` on
    ``device``, seeded 0 when omitted.  ``init=False`` leaves the weights
    uninitialised (``models.convert.lm_from_numpy`` fills them).

    ``mesh`` (a ``DeviceMesh``) places the parameters by
    :meth:`param_specs` of ``axes`` (default :class:`MeshAxes`) once they
    are drawn (``sharding.shard_lm``), and turns on the activation pins."""

    def __init__(self, cfg: LMConfig, *, device="cuda",
                 generator: torch.Generator | None = None,
                 init: bool = True, axes: MeshAxes | None = None,
                 mesh=None):
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
        self.axes, self.mesh = None, None
        if init:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            self.init_weights(generator)
        if mesh is not None:
            sharding.shard_lm(self, mesh, axes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            init_param(name, p, p, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -------------------------------------------------------- sharding
    def param_specs(self, axes: MeshAxes = MeshAxes()) -> dict:
        """The reference's spec of each parameter, by the port's name
        (``blocks.3.attn.wq``): a layer's spec without the reference's
        leading (replicated) layer axis."""
        from .convert import _ref_path
        out = {}
        for name, p in self.named_parameters():
            path, layer = _ref_path(name)
            stacked = p.dim() + (layer is not None)
            spec = _ref_spec(".".join(path), stacked, axes)
            out[name] = spec if layer is None else spec[1:]
        return out

    def cache_specs(self, axes: MeshAxes = MeshAxes(),
                    shard_seq: bool = False):
        """(k, v) cache: (L, B, S, Hkv, Dh). Batch on dp normally; for
        batch=1 long-context decode, the sequence axis instead (context
        parallelism).  The reference's rule."""
        if shard_seq:
            s = (None, None, axes.dp, None, None)
        else:
            s = (None, axes.dp, None, None, None)
        return (s, s)

    def decode_cache_spec(self, b: int, axes: MeshAxes | None = None):
        """The cache spec the reference's decode cell places its
        (L, B, S, Hkv, Dh) cache by (``launch/cells.py``): batch 1 -> the
        sequence over dp and tp; chunked attention -> batch on dp, the
        head-feature dim on tp (a chunk's window stays local); otherwise
        batch on dp, the sequence on tp."""
        axes = axes or self.axes or MeshAxes()
        dp = tuple(axes.dp)
        if b == 1:
            return (None, None, dp + (axes.tp,), None, None)
        if self.cfg.attention == "chunked":
            return (None, dp, None, None, axes.tp)
        return (None, dp, axes.tp, None, None)

    def _pin(self, x, spec):
        return sharding.pin(x, spec, self.mesh)

    def _place(self, t, spec):
        """A host-side batch tensor (the same on every rank) placed by
        ``spec`` (each rank keeps its block); a DTensor as it is."""
        return sharding.place(t, spec, self.mesh)

    def _layer_types(self):
        g = self.cfg.layer_group
        if g == 1:
            return (self.cfg.attention == "chunked",)
        # llama4 iRoPE grouping: local, local, local, global
        return tuple(i < g - 1 for i in range(g))

    def _dp(self, b: int):
        """The batch's spec entry: dp, or None for a batch of one (which
        DTensor cannot fold into the sequence when it is sharded, and
        which GSPMD would pad)."""
        return self.axes.dp if b > 1 else None

    def _embed(self, tokens):
        # F.embedding: a gather, whose backward on the card sorts the ids
        # and reduces each row's segment (no atomic: the same bits again)
        if self.mesh is not None:
            bspec = self._dp(tokens.shape[0])
            tokens = self._place(tokens, (bspec, None))
        x = F.embedding(tokens, self.embed).to(self.cfg.compute_dtype)
        if self.mesh is not None:
            x = sharding.sum_partial_grads(self._pin(x, (bspec, None, None)))
        return x

    def _head(self, x):
        x = rms_norm(x, self.final_norm)
        logits = (x @ self.out_head.to(self.cfg.compute_dtype)).float()
        if self.mesh is not None:
            dp, tp = self._dp(logits.shape[0]), self.axes.tp
            logits = self._pin(logits, (dp,) + (None,) * (logits.dim() - 2)
                               + (tp,))
        return logits

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
                x, positions, chunked=types[i % cfg.layer_group],
                axes=self.axes)
            aux_total = aux_total + aux
            if cache is not None:
                for c, t in zip(cache, (k, v)):
                    if isinstance(c, DTensor):
                        cache_write(c[i], t, 0)
                    else:
                        c[i, :, :s] = t
        return x, aux_total

    def _run(self, tokens, cache=None):
        """tokens (B, S) -> ``(logits (B, S, V) f32, aux)`` through every
        layer group, ``aux`` the groups' summed MoE auxiliary loss, with
        gradients where grad is enabled (and remat when ``cfg.remat`` is
        set and no cache is filled)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = sharding.positions_like(x, s)
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
            cache = tuple(self._zeros_cache(shape) for _ in range(2))
        logits, aux = self._run(tokens, cache)
        return logits, aux, cache

    def _zeros_cache(self, shape):
        """A zero cache tensor; on a mesh, placed by
        :meth:`decode_cache_spec` (the decode cell's spec)."""
        dt = self.cfg.compute_dtype
        if self.mesh is None:
            return torch.zeros(shape, dtype=dt, device=self.device)
        return sharding.local_zeros(shape, dt,
                                    self.decode_cache_spec(shape[1]),
                                    self.mesh, self.device)

    # --------------------------------------------------------------- loss
    def loss(self, batch):
        """``batch``: ``tokens`` and ``targets``, (B, S) int64 on the
        model's device -> the reference's ``(nll + 0.01 * aux, {"nll",
        "aux"})``, differentiable where grad is enabled.  The target
        logit is gathered: the value of the reference's one-hot
        contraction, which it takes only to shard the vocab."""
        logits, aux = self._run(batch["tokens"])
        if self.mesh is not None:
            targets = self._place(batch["targets"],
                                  (self._dp(logits.shape[0]), None))
            nll = self._sharded_nll(logits, targets)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, batch["targets"][..., None]).squeeze(-1)
            nll = (logz - tgt).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def _sharded_nll(self, logits, targets):
        """The mean NLL of vocab-sharded logits without gathering them
        (the reference's one-hot contraction, which reduces over the
        shard): the log-sum-exp from a max and a sum over the shard, the
        target logit picked on the rank whose block holds it (Partial
        over tp).  Returns a plain 0-d tensor (``full_tensor``), so a
        gradient starts from one replicated seed.  Each reduction over the
        vocab is all-reduced onto the logits' batch placement (replicated
        over tp) explicitly: left to DTensor, the per-token terms were
        split over tp by batch rows, and their gradients then met the
        vocab-sharded logits' in a reshuffle of the whole (B, S, V)
        gradient (an all-to-all, or a gather of every rank's vocab:
        39.8 GB a rank for qwen3-1.7b's train_4k cell at (16, 16))."""
        mesh = self.mesh
        rows = [Replicate() if isinstance(q, Shard) and q.dim == 2 else q
                for q in logits.placements]
        m = logits.detach().amax(-1, keepdim=True).redistribute(mesh, rows)
        total = (logits - m).exp().sum(-1).redistribute(mesh, rows)
        logz = total.log() + m.squeeze(-1)
        tgt = self._target_logit(logits, targets).redistribute(mesh, rows)
        return (logz - tgt).mean().full_tensor()

    def _target_logit(self, logits, targets):
        mesh, vocab = self.mesh, logits.shape[-1]
        lp = list(logits.placements)
        tp = [Partial() if isinstance(p, Shard) and p.dim == 2 else p
              for p in lp]
        tgt_pl = list(targets.placements)

        def pick(lg, tg):
            start, n = sharding.shard_offset(mesh, lp, 2, vocab)
            if n == 0:      # an uneven split left this rank no vocab
                return lg.new_zeros(tg.shape)
            t = tg - start
            inside = (t >= 0) & (t < n)
            got = lg.gather(-1, t.clamp(0, n - 1)[..., None]).squeeze(-1)
            return torch.where(inside, got, torch.zeros_like(got))

        return local_map(pick, out_placements=tp,
                         in_placements=(lp, tgt_pl),
                         device_mesh=mesh)(logits, targets)

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
        positions = sharding.positions_like(x, 1, pos)
        types = self._layer_types()
        ks, vs = cache
        for i, block in enumerate(self.blocks):
            x, _, _ = block(x, positions,
                            chunked=types[i % cfg.layer_group],
                            kv_cache=(ks[i], vs[i]), cache_pos=pos,
                            axes=self.axes)
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
