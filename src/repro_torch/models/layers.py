"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full /
chunked-local / decode), the SwiGLU FFN and the capacity-based top-k MoE
FFN (PyTorch port of ``src/repro/models/layers.py``).

Plain functions on tensors; the weights come from ``transformer.LM``.
Compute runs in ``cfg.compute_dtype`` (bf16) over fp32 master weights cast
at use, with fp32 softmax and normalization statistics.  Where the
reference accumulates a bf16 product in f32
(``preferred_element_type=jnp.float32``) the port computes in f32; where
its output is bf16 (``x @ W.astype(dt)``) the port's is bf16 too.

The prefill's and training's causal attention goes through
``kernels.ops.flash_attention`` (the hand-written Hopper kernel on a CUDA
tensor, its plain version on a CPU one; with grad enabled its gradient is
``flash_attention.flash_attention_bwd``); decode attention is plain
einsum, as the reference leaves it to XLA.  The functions carry
gradients: nothing on the prefill and training path writes in place (only
decode writes its new k/v into the cache).  The MoE FFN (``moe_ffn``)
reaches no kernel of its own, as in the reference: plain torch ops for
the routing and dispatch, ``torch.bmm`` for the grouped expert products.
Sharded (``axes`` set, the tensors DTensors on a ``DeviceMesh``): the
prefill's and training's attention takes the reference's flat-head
layout (k and v repeated to the q heads, q/k/v pinned to batch on dp and
heads on tp) and runs ``_causal`` on each rank's local (B/dp, S,
ceil(H/tp), D) block at group 1 (``sharding.local_apply``); where tp does
not divide the heads the rank's block is padded with zero heads, as
GSPMD pads them, and a flat projection whose tp block would split a head
is gathered over tp before it is cut into heads (:func:`_whole_heads`).
Decode writes the new k/v and attends inside ``local_map`` on the
cache's own placement (:func:`cache_write`, :func:`_decode_attend`): a
sequence-sharded cache (the reference's decode specs shard the
sequence over tp, or over dp and tp at batch 1) combines the softmax
over the ranks, a feature-sharded one (chunked attention) sums the
scores over them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops as kops
from . import sharding


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # arctic: parallel dense FFN branch
    moe_shared_expert: bool = False    # llama4: always-on shared expert
    capacity_factor: float = 1.25
    # attention structure
    attention: str = "full"            # "full" | "chunked"
    chunk_size: int = 8192
    layer_group: int = 1               # llama4: 4 (3 chunked + 1 global)
    rope_theta: float = 1e6
    # numerics / memory
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True                 # training: recompute each layer
    # group but its weight matmuls in the backward (``transformer.LM``)
    scan_unroll: bool = False          # kept for parity; layers are a loop

    @property
    def q_dim(self):
        return self.n_heads * self.d_head

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.d_head

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS = 6·N·D accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe:
            ffn = self.n_experts * 3 * d * f
            ffn += d * self.n_experts                    # router
            if self.moe_dense_residual or self.moe_shared_expert:
                ffn += 3 * d * f
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d                  # two norms
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts + dense branches)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn = self.top_k * 3 * d * f + d * self.n_experts
        if self.moe_dense_residual or self.moe_shared_expert:
            ffn += 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


# ---------------------------------------------------------------- numerics


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm: the variance accumulates in f32 (the reference's f32
    einsum over the compute-dtype activation); the full-size multiplies
    stay in ``x.dtype``."""
    d = x.shape[-1]
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / d
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S).  f32 inside, cast back.
    On a mesh both are DTensors (``sharding.positions_like``)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if isinstance(positions, DTensor):
        mesh = positions.device_mesh
        freqs = DTensor.from_local(freqs, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    angles = positions[..., :, None, None].float() * freqs   # S,1,half
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention


def _whole_heads(x, dim: int, n_heads: int):
    """A DTensor ``x`` whose dimension ``dim`` holds ``n_heads`` heads (flat
    or not), gathered over every mesh dimension that splits it where that
    dimension's size does not divide ``n_heads``: DTensor can neither cut
    a flat block of half heads into heads nor flatten uneven head
    blocks.  Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(q, Shard) and q.dim == dim
          and n_heads % mesh.size(i) else q
          for i, q in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def _whole_features(out):
    """A DTensor attention output (B, S, H, D) with its head features
    gathered where they are split (a chunked decode's cache shards D over
    tp): flat, they would be a strided split of the heads' features,
    whose products DTensor plans for minutes on a 3-D mesh."""
    if not isinstance(out, DTensor):
        return out
    pl = [Replicate() if isinstance(q, Shard) and q.dim == 3 else q
          for q in out.placements]
    return (out if pl == list(out.placements)
            else out.redistribute(out.device_mesh, pl))


def _split_heads(x, n_heads, d_head):
    b, s, _ = x.shape
    return _whole_heads(x, 2, n_heads).reshape(b, s, n_heads, d_head)


def attention(p, cfg: LMConfig, x, positions, *, chunked: bool,
              kv_cache=None, cache_pos=None, axes=None):
    """GQA attention.  ``p``: the layer's weights (``wq``, ``wk``, ``wv``,
    ``wo``, and ``q_norm``/``k_norm`` under ``qk_norm``), stored (in, out).

    Prefill: ``kv_cache`` None -> causal over x itself; returns
    ``(out, (k, v))`` with k/v shaped (B, S, Hkv, Dh).
    Decode: ``kv_cache = (k, v)`` over S_cache positions, x is (B, 1, D),
    ``cache_pos`` the int position of the new token.  The new k/v are
    written into the cache tensors IN PLACE (the reference returns updated
    copies; the values are the same) and ``(out, (k, v))`` is returned.

    ``axes`` (``transformer.MeshAxes``, the tensors DTensors): the
    prefill's attention runs sharded over heads (module docstring); the
    returned (k, v) are the kv heads before the repeat, the values of the
    reference's un-repeat ``[:, :, ::g]``.  Decode pins no heads, as the
    reference: the cache's placement decides.
    """
    dt = cfg.compute_dtype
    b, s, _ = x.shape
    q = _split_heads(x @ p["wq"].to(dt), cfg.n_heads, cfg.d_head)
    k = _split_heads(x @ p["wk"].to(dt), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(x @ p["wv"].to(dt), cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        if axes is not None:
            out = _sharded_causal(q, k, v, cfg, axes, chunked)
        elif chunked and s > cfg.chunk_size:
            out = _chunked_causal(q, k, v, cfg)
        else:
            out = _causal(q, k, v)
        new_kv = (k, v)
    elif isinstance(kv_cache[0], DTensor):
        ck, cv = kv_cache
        out = _decode_sharded(q, k, v, ck, cv, int(cache_pos), cfg, chunked)
        new_kv = (ck, cv)
    else:
        ck, cv = kv_cache              # (B, S_c, Hkv, Dh)
        pos = int(cache_pos)
        ck[:, pos:pos + 1] = k.to(ck.dtype)
        cv[:, pos:pos + 1] = v.to(cv.dtype)
        s_c = ck.shape[1]
        if chunked:
            # local layers attend within the CURRENT chunk (chunk-aligned,
            # iRoPE semantics), not a sliding window
            span = min(cfg.chunk_size, s_c)
            start = min((pos // cfg.chunk_size) * cfg.chunk_size, s_c - span)
            valid = (start + torch.arange(span, device=ck.device)) <= pos
            out = _decode_attend(q, ck[:, start:start + span],
                                 cv[:, start:start + span], valid)
        else:
            valid = torch.arange(s_c, device=ck.device) <= pos
            out = _decode_attend(q, ck, cv, valid)
        new_kv = (ck, cv)

    out = _whole_heads(_whole_features(out), 2, cfg.n_heads)
    out = out.reshape(b, s, cfg.q_dim)
    return out @ p["wo"].to(dt), new_kv


def _causal(q, k, v):
    """(B, S, H, D) GQA causal attention through the flash kernel, which
    takes (B, H, S, D): the transposes are views, read by strides."""
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def _sharded_causal(q, k, v, cfg, axes, chunked: bool):
    """The reference's flat-head layout: k and v repeated to the q heads
    (``[h0, h0, h1, h1, ...]``, its ``jnp.repeat``), q/k/v pinned to
    batch on dp and heads on tp, and ``_causal`` (or ``_chunked_causal``)
    run on each rank's (B/dp, S, H/tp, D) block.  Where tp does not
    divide the H heads, the pin gives ``torch.chunk``'s blocks (ceil(H /
    tp) heads a rank, the last ranks fewer or none) and each rank pads
    its block with zero heads to ceil(H / tp) for the kernel, dropping
    them after: GSPMD's padding, so every rank runs the same kernel
    shape, and a zero head's output (zero values) never leaves it."""
    mesh = q.device_mesh
    b, s, hkv, d = k.shape
    g = cfg.n_heads // cfg.n_kv_heads
    if g > 1:
        k, v = (t[:, :, :, None].expand(b, s, hkv, g, d)
                .reshape(b, s, hkv * g, d) for t in (k, v))
    hspec = (axes.dp if b > 1 else None, None, axes.tp, None)
    q, k, v = (sharding.pin(t, hspec, mesh) for t in (q, k, v))
    pl = list(q.placements)
    tp = mesh.size(mesh.mesh_dim_names.index(axes.tp))
    width = -(-cfg.n_heads // tp)
    if chunked and s > cfg.chunk_size:
        def fn(q, k, v):
            return _chunked_causal(q, k, v, cfg)
    else:
        fn = _causal

    def attend(q, k, v):
        n = q.shape[2]
        if n < width:
            q, k, v = (F.pad(t, (0, 0, 0, width - n)) for t in (q, k, v))
        return fn(q, k, v)[:, :, :n]

    return sharding.local_apply(attend, (q, k, v), (pl, pl, pl), pl,
                                q.shape, mesh)


def _chunked_causal(q, k, v, cfg):
    """Local (chunked) causal attention: queries attend only within their
    own chunk (iRoPE-style local layers).  Sequences not divisible by the
    chunk are padded at the end (causality keeps real queries clean)."""
    b, s, h, d = q.shape
    c = cfg.chunk_size
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    sp = s + pad
    nc = sp // c

    def rs(t):
        return t.reshape(b * nc, c, t.shape[2], d)
    out = _causal(rs(q), rs(k), rs(v))
    return out.reshape(b, sp, h, d)[:, :s]


def _kv_placements(cache_pl) -> list:
    """New (B, n, Hkv, D) k/v beside a cache placed ``cache_pl``: the
    cache's placement, replicated where the cache shards the sequence."""
    return [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in cache_pl]


def _groups(mesh, cache_pl, dim: int) -> list:
    """The process groups of the mesh dimensions of more than one rank
    that shard ``dim`` (a one-rank dimension holds the whole of it)."""
    return [mesh.get_group(i) for i, p in enumerate(cache_pl)
            if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1]


def cache_write(cache, t, pos0: int) -> None:
    """Write ``t`` (B, n, Hkv, D) into ``cache`` (B, S_c, Hkv, D) at
    positions ``pos0 .. pos0 + n - 1``, in place, where both are DTensors
    on one mesh: ``t`` is placed beside the cache (:func:`_kv_placements`)
    and each rank writes the positions its block of the cache holds."""
    mesh, cpl = cache.device_mesh, list(cache.placements)
    t = t.to(cache.dtype).redistribute(mesh, _kv_placements(cpl))
    start, length = sharding.shard_offset(mesh, cpl, 1, cache.shape[1])
    n = t.shape[1]

    def write(c, x):
        lo, hi = max(pos0, start), min(pos0 + n, start + length)
        if lo < hi:
            c[:, lo - start:hi - start] = x[:, lo - pos0:hi - pos0]
        return c

    local_map(write, out_placements=cpl,
              in_placements=(cpl, list(t.placements)),
              device_mesh=mesh)(cache, t)


def _decode_sharded(q, k, v, ck, cv, pos: int, cfg, chunked: bool):
    """Decode attention on a DTensor cache, in the cache's layout: the
    new k/v written at ``pos`` (:func:`cache_write`), then
    :func:`_decode_attend` on each rank's block through ``local_map``;
    q is placed as the cache (batch, kv heads in whole groups, head
    features) and replicated where the cache shards the sequence, and the
    output keeps q's placement.  Over a mesh dimension of one rank
    nothing is combined: the ops are the unsharded decode's."""
    mesh, cpl = ck.device_mesh, list(ck.placements)
    cache_write(ck, k, pos)
    cache_write(cv, v, pos)
    for i, p in enumerate(cpl):
        if isinstance(p, Shard) and p.dim == 2 and cfg.n_kv_heads % \
                mesh.size(i):
            raise ValueError(f"a cache sharded over kv heads needs "
                             f"{mesh.mesh_dim_names[i]!r} "
                             f"({mesh.size(i)}) to divide n_kv_heads="
                             f"{cfg.n_kv_heads}")
    qpl = _kv_placements(cpl)
    q = q.redistribute(mesh, qpl)
    s_c = ck.shape[1]
    start, length = sharding.shard_offset(mesh, cpl, 1, s_c)
    seq_groups, feat_groups = _groups(mesh, cpl, 1), _groups(mesh, cpl, 3)
    if chunked:
        span = min(cfg.chunk_size, s_c)
        lo = min((pos // cfg.chunk_size) * cfg.chunk_size, s_c - span)
        hi = lo + span
    else:
        lo, hi = 0, s_c

    def attend(qb, kb, vb):
        if seq_groups:      # mask the window on this rank's positions
            idx = start + torch.arange(length, device=kb.device)
            valid = (idx >= lo) & (idx < hi) & (idx <= pos)
        else:               # the window is local: slice it
            kb, vb = kb[:, lo:hi], vb[:, lo:hi]
            valid = (lo + torch.arange(hi - lo, device=kb.device)) <= pos
        return _decode_attend(qb, kb, vb, valid, cfg.d_head, seq_groups,
                              feat_groups)

    return local_map(attend, out_placements=qpl,
                     in_placements=(qpl, cpl, cpl),
                     device_mesh=mesh)(q, ck, cv)


def _decode_attend(q, k, v, valid, d: int | None = None, seq_groups=(),
                   feat_groups=()):
    """q: (B, 1, Hq, D); k/v: (B, S, Hkv, D); valid: (S,) bool mask.

    The reference's einsums accumulate in f32 over the compute-dtype
    operands; here the operands are upcast to f32 first (bf16 products
    are exact in f32).  The probabilities are cast to ``v.dtype`` before
    the PV product, as in the reference.

    On one rank's block of a sharded cache (:func:`_decode_sharded`):
    the scores are summed over ``feat_groups`` (the head features
    sharded), the softmax's max and sum and the output over
    ``seq_groups`` (the sequence sharded); ``d`` is the whole head
    dimension (default: q's).  With both empty the ops are the unsharded
    decode's."""
    b, one, hq, dl = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, dl)
    s = torch.einsum("bkgd,bskd->bkgs", qf.float(), k.float())
    for grp in feat_groups:
        tdist.all_reduce(s, group=grp)
    s = s / math.sqrt(d or dl)
    s = torch.where(valid[None, None, None, :], s, -1e30)
    if seq_groups:
        m = s.amax(-1, keepdim=True)
        for grp in seq_groups:
            tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=grp)
        e = torch.exp(s - m)
        total = e.sum(-1, keepdim=True)
        for grp in seq_groups:
            tdist.all_reduce(total, group=grp)
        p = e / total
    else:
        p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    for grp in seq_groups:
        tdist.all_reduce(out, group=grp)
    return out.reshape(b, 1, hq, dl).to(q.dtype)


# -------------------------------------------------------------------- FFN


def swiglu(p, x, dt):
    gate = F.silu(x @ p["w_gate"].to(dt))
    up = x @ p["w_up"].to(dt)
    return (gate * up) @ p["w_down"].to(dt)


def moe_capacity(cfg: LMConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: the statistical capacity
    ``capacity_factor * t * top_k / n_experts``, floored so that a small
    (decode) batch stays dropless.  The floor is
    ``launch.perf_flags.FLAGS.moe_decode_capacity_floor``, 8 when it is
    None (the reference's rule)."""
    from ..launch.perf_flags import FLAGS
    floor = FLAGS.moe_decode_capacity_floor
    if floor is None:
        floor = 8
    k = cfg.top_k
    return max(int(cfg.capacity_factor * t * k / cfg.n_experts),
               min(t * k, floor), 1)


def moe_route(gates, k: int):
    """The top ``k`` gates of each row and their experts, largest first,
    the lower expert first on a tie (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise)."""
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    return top_w[:, :k], top_e[:, :k]


def moe_ffn(p, cfg: LMConfig, x, axes=None):
    """Capacity-based top-k MoE: x (B, S, D) -> ``(out (B, S, D), aux)``.

    ``p``: ``router`` (D, E), ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D), and ``dense`` (a SwiGLU's weights) for arctic's dense
    residual or llama4's shared expert.  The reference's rules: each
    token's top-k experts by softmax gate, weights renormalised; an
    expert's slots go to its assignments in (token, k) order (a stable
    sort of the expert ids), and an assignment past ``moe_capacity`` is
    dropped and adds exactly 0.  The (E, cap, D) buffer is a copy of
    the kept rows (one token a slot), built out of place, so autograd and
    remat see a pure function; the expert products are batched over E.
    ``aux`` is the Switch-style load-balancing loss, f32.

    ``axes`` (``transformer.MeshAxes``, x and the weights DTensors of a
    sharded LM): :func:`_moe_ffn_sharded`."""
    if axes is not None:
        return _moe_ffn_sharded(p, cfg, x, axes)
    dt = cfg.compute_dtype
    b, s, d = x.shape
    buf, keep, slot, w, aux = _moe_dispatch(x.reshape(b * s, d),
                                            p["router"].to(dt), cfg)
    out_buf = _moe_experts(buf, p["w_gate"], p["w_up"], p["w_down"], dt)
    out = _moe_combine(out_buf, keep, slot, w, cfg).view(b, s, d)
    if cfg.moe_dense_residual or cfg.moe_shared_expert:
        out = out + swiglu(p["dense"], x, dt)
    return out, aux


def _moe_dispatch(xf, router, cfg: LMConfig):
    """The routing of all ``T`` tokens ``xf`` (T, D): ``(buf (E, cap, D),
    keep (T*k,), slot (T*k,), w (T*k,) the kept gates in the compute
    dtype, aux)``; ``slot`` is a kept assignment's row of the flat
    (E * cap) buffer, ``e * cap`` for a dropped one."""
    dt = cfg.compute_dtype
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, t)
    logits = (xf @ router).float()                              # (T, E)
    gates = torch.softmax(logits, dim=-1)
    top_w, top_e = moe_route(gates, k)                          # (T, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_e.reshape(-1)                                  # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    # rank within the expert: index - first index of that expert
    first = torch.searchsorted(sorted_e, torch.arange(e, device=xf.device))
    pos_sorted = torch.arange(t * k, device=xf.device) - first[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    # a kept assignment's slot in the flat (E * cap) buffer; a dropped
    # one writes a spare last row, cut off
    slot = torch.where(keep, flat_e * cap + pos, e * cap)

    tok = xf.repeat_interleave(k, dim=0)                        # (T*k, D)
    buf = xf.new_zeros(e * cap + 1, d).index_put((slot,), tok)
    buf = buf[:e * cap].view(e, cap, d)
    w = torch.where(keep, top_w.reshape(-1), 0.0).to(dt)

    # load-balancing auxiliary loss (Switch-style)
    me = F.one_hot(top_e[:, 0], e).float().mean(0)
    ce = gates.mean(0)
    aux = e * (me * ce).sum()
    return buf, keep, slot, w, aux


def _moe_experts(buf, w_gate, w_up, w_down, dt):
    """The grouped expert products of ``buf`` (E, C, D): (E, C, D).  Each
    weight is cast to ``dt`` just before its product, so one cast copy
    is alive at a time (arctic's is 8.9 GB in bf16)."""
    gate_h = F.silu(torch.bmm(buf, w_gate.to(dt)))
    up_h = torch.bmm(buf, w_up.to(dt))
    return torch.bmm(gate_h * up_h, w_down.to(dt))


def _moe_combine(out_buf, keep, slot, w, cfg: LMConfig):
    """Each token's kept expert outputs weighted by their gates and summed
    over its k assignments: (T, D) in the compute dtype."""
    e, cap, d = out_buf.shape
    out_buf = out_buf.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           out_buf[torch.where(keep, slot, 0)], 0)
    # the reference's segment sum over tok_idx = repeat(arange(T), k)
    combined = (gathered * w[:, None]).view(-1, cfg.top_k, d).sum(1)
    return combined.to(cfg.compute_dtype)


def _moe_ffn_sharded(p, cfg: LMConfig, x, axes):
    """:func:`moe_ffn` of a sharded LM, its routing global over the
    batch as the reference's (the capacity counts all B * S tokens, the
    capacity ranks sort all T * k assignments), so every mesh routes as
    one device does.  Collectives a call makes, over the mesh's dp (the
    fsdp axes) and tp axes:

    1. x (batch on dp) and the router (D on fsdp) all-gathered to every
       rank; the routing and the (E, cap, D) buffer are computed whole on
       each (:func:`_moe_dispatch` in ``local_map``, replicated);
    2. each rank takes its block of the buffer, E on tp and the capacity
       slots on dp (no collective; the slots padded with zero rows to a
       multiple of dp, as GSPMD pads an uneven split), and all-gathers
       its experts' weights over the fsdp axes (E on tp stays:
       ``param_specs`` places the experts (E on tp, D on fsdp)), one
       weight at a time; the three grouped products
       (:func:`_moe_experts`'s) run on the rank's (E/tp, cap/dp, .)
       blocks (``sharding.local_apply``), so each expert's products run
       on the ranks that hold it, and the weights' gradients, partial
       sums over the slots, are reduce-scattered back over the fsdp
       axes;
    3. the expert outputs all-gathered, the k-ordered combine computed
       whole on each rank, and the result cut to x's placement.

    Over a mesh dimension of one rank nothing moves, and the ops are the
    unsharded ones on the same tensors.  The dense residual / shared
    expert is the dense FFN on x's placement; ``aux`` is a plain 0-d
    tensor (the same on every rank)."""
    dt = cfg.compute_dtype
    mesh = x.device_mesh
    b, s, d = x.shape
    rep = [Replicate()] * mesh.ndim
    xr = x.redistribute(mesh, rep)
    router = p["router"].to(dt).redistribute(mesh, rep)

    n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in axes.dp)

    def dispatch(xl, rl):
        """The routing; the buffer's capacity slots padded with zero rows
        to a multiple of dp (GSPMD's padding of an uneven split: a decode
        step's 8 slots over 32 ranks), cut off again in ``combine``."""
        buf, *rest = _moe_dispatch(xl.reshape(b * s, d), rl, cfg)
        pad = -buf.shape[1] % n_dp
        return (F.pad(buf, (0, 0, 0, pad)) if pad else buf, *rest)
    cap = moe_capacity(cfg, b * s)
    buf, keep, slot, w, aux = local_map(
        dispatch, out_placements=(rep,) * 5, in_placements=(rep, rep),
        device_mesh=mesh)(xr, router)

    bpl = sharding.placements((axes.tp, axes.dp, None), mesh)
    wpl = sharding.placements((axes.tp, None, None), mesh)
    wgrad = [Partial() if isinstance(q, Replicate) and mesh.size(i) > 1
             and mesh.mesh_dim_names[i] in axes.dp else q
             for i, q in enumerate(wpl)]

    def mm(a, w):       # one weight cast and gathered at a time
        shape = (a.shape[0], a.shape[1], w.shape[2])
        return sharding.local_apply(torch.bmm, (a, w.to(dt)), (bpl, wpl),
                                    bpl, shape, mesh, (bpl, wgrad))
    buf = buf.redistribute(mesh, bpl)
    gate_h = F.silu(mm(buf, p["w_gate"]))
    up_h = mm(buf, p["w_up"])
    out_buf = mm(gate_h * up_h, p["w_down"]).redistribute(mesh, rep)

    def combine(ob, kp, sl, wl):
        return _moe_combine(ob[:, :cap], kp, sl, wl, cfg).view(b, s, d)
    out = local_map(combine, out_placements=rep,
                    in_placements=(rep,) * 4, device_mesh=mesh)(
        out_buf, keep, slot, w)
    out = out.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in x.placements])
    if cfg.moe_dense_residual or cfg.moe_shared_expert:
        out = out + swiglu(p["dense"], x, dt)
    return out, aux.full_tensor()
