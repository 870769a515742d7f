"""EquiformerV2 [arXiv:2306.12059] (PyTorch port of
``src/repro/models/gnn/equiformer_v2.py``): equivariant graph attention with
eSCN SO(2) convolutions.  Published config: n_layers=12, d_hidden=128,
l_max=6, m_max=2, n_heads=8.

Each edge's features are rotated into the edge-aligned frame (Wigner-D
blocks from ``equivariant``), mixed by an SO(2) linear per azimuthal order
m <= m_max, modulated radially and rotated back.  Attention weights come
from the invariant part: per-edge scalars -> heads -> softmax over each
node's incoming edges -> a head-averaged gate on the aggregated messages.
Features are (n, (l_max+1)^2 = 49, C); each layer aggregates twice through
the ``segment_sum`` kernel: the softmax's normaliser (E, heads) and the
messages (E, 49, C).

Not carried over: the reference's optional edge-sharding pins
(``perf_flags.gnn_edge_dp``), which are mesh constraints and do nothing
without a mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..equivariant import (WignerConstants, bessel_basis, l_slices, num_sh,
                           wigner_d_align)
from .common import MLP, normal, num_nodes, pooled_loss, segment_softmax, \
    segment_sum


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    cutoff: float = 8.0
    n_species: int = 32
    out_dim: int = 1


def _m_indices(l_max: int, m_max: int):
    """For each m in 0..m_max, the positions of the (l, +m) and (l, -m)
    coefficients (l >= m) in the packed (l_max+1)^2 axis."""
    idx_pos, idx_neg = [], []
    for m in range(m_max + 1):
        ls = [l for l in range(l_max + 1) if l >= m]
        idx_pos.append([l * l + l + m for l in ls])
        idx_neg.append([l * l + l - m for l in ls])
    return idx_pos, idx_neg


class SO2Weights(nn.Module):
    """``w`` for m = 0; ``wr`` and ``wi`` (the complex pair) for m > 0."""

    def __init__(self, m: int, width: int, **kw):
        super().__init__()
        s = 1.0 / math.sqrt(width)
        if m == 0:
            self.w = normal((width, width), s, **kw)
        else:
            self.wr = normal((width, width), s, **kw)
            self.wi = normal((width, width), s, **kw)


class EquiformerV2Layer(nn.Module):
    def __init__(self, cfg: EquiformerV2Config, **kw):
        super().__init__()
        c, nl = cfg.channels, cfg.l_max + 1

        def nrm(*s):
            return normal(s, 1.0 / math.sqrt(s[-2]), **kw)

        self.so2 = nn.ModuleList(
            SO2Weights(m, (cfg.l_max + 1 - m) * c, **kw)
            for m in range(cfg.m_max + 1))
        self.radial = MLP([cfg.n_rbf, 32, c], **kw)
        self.attn_w = nrm(c, cfg.n_heads)
        self.out_lin = nrm(nl, c, c)
        self.ffn1 = nrm(nl, c, 2 * c)
        self.ffn2 = nrm(nl, 2 * c, c)
        self.gate = nrm(c, nl)
        self.ln_scale = nn.Parameter(torch.ones((nl, c), dtype=torch.float32,
                                                device=kw["device"]))


class EquiformerV2(nn.Module):
    def __init__(self, cfg: EquiformerV2Config, d_feat: int | None = None, *,
                 device="cuda", generator=None, init: bool = True):
        super().__init__()
        self.cfg = cfg
        self.d_feat = d_feat
        self.slices = l_slices(cfg.l_max)
        pos, neg = _m_indices(cfg.l_max, cfg.m_max)
        as_idx = lambda x: torch.as_tensor(x, dtype=torch.int64,
                                           device=device)
        self.idx_pos = [as_idx(p) for p in pos]
        self.idx_neg = [as_idx(q) for q in neg]
        # where the SO(2) outputs land: [m=0, +1, -1, +2, -2, ...]
        self.idx_out = as_idx(pos[0] + [i for m in range(1, cfg.m_max + 1)
                                        for i in pos[m] + neg[m]])
        self.wigner = WignerConstants(cfg.l_max, device)
        c = cfg.channels
        kw = dict(device=device, generator=generator, init=init)
        if d_feat is not None:
            self.in_proj = normal((d_feat, c), 1.0 / math.sqrt(d_feat), **kw)
        else:
            self.species_embed = normal((cfg.n_species, c), 0.1, **kw)
        self.layers = nn.ModuleList(EquiformerV2Layer(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.readout = MLP([c, c, cfg.out_dim], **kw)

    # --------------------------------------------------------- sub-blocks
    def _rotate(self, h_e, d_blocks, transpose: bool = False):
        """Apply per-l Wigner blocks to (E, 49, C) edge features."""
        outs = []
        for (a, b), d in zip(self.slices, d_blocks):
            outs.append((d.transpose(1, 2) if transpose else d)
                        @ h_e[:, a:b])
        return torch.cat(outs, dim=1)

    def _so2_conv(self, lp, z):
        """SO(2) linear in the edge frame; components with m > m_max are
        dropped.  z: (E, 49, C) rotated features -> (E, 49, C)."""
        e, c = z.shape[0], self.cfg.channels
        parts = [(z[:, self.idx_pos[0]].reshape(e, -1) @ lp.so2[0].w)
                 .reshape(e, -1, c)]
        for m in range(1, self.cfg.m_max + 1):
            xp = z[:, self.idx_pos[m]].reshape(e, -1)
            xm = z[:, self.idx_neg[m]].reshape(e, -1)
            wr, wi = lp.so2[m].wr, lp.so2[m].wi
            parts.append((xp @ wr - xm @ wi).reshape(e, -1, c))
            parts.append((xp @ wi + xm @ wr).reshape(e, -1, c))
        return z.new_zeros(z.shape).index_copy(1, self.idx_out,
                                               torch.cat(parts, dim=1))

    def _equiv_ln(self, h, scale):
        """Per-l RMS layer norm over (m, C), learnable per-(l, C) scale."""
        outs = []
        for l, (a, b) in enumerate(self.slices):
            blk = h[:, a:b]
            rms = torch.sqrt(torch.square(blk).mean(dim=(1, 2), keepdim=True)
                             + 1e-6)
            outs.append(blk / rms * scale[l][None, None, :])
        return torch.cat(outs, dim=1)

    # ------------------------------------------------------------ forward
    def forward(self, batch):
        cfg = self.cfg
        c = cfg.channels
        n = num_nodes(batch)
        src, dst = batch["edge_src"], batch["edge_dst"]
        rel = batch["pos"][src] - batch["pos"][dst]
        r = torch.linalg.vector_norm(rel, dim=-1)
        rad = bessel_basis(r, cfg.n_rbf, cfg.cutoff)

        # per-edge Wigner blocks (computed once, reused by all layers)
        d_fwd = [wigner_d_align(self.wigner, rel, l)
                 for l in range(cfg.l_max + 1)]
        d_bwd = [wigner_d_align(self.wigner, rel, l, inverse=True)
                 for l in range(cfg.l_max + 1)]

        if "feats" in batch:
            h0 = batch["feats"] @ self.in_proj
        else:
            h0 = self.species_embed[batch["species"]]
        h = torch.cat([h0[:, None, :], h0.new_zeros(
            (n, num_sh(cfg.l_max) - 1, c))], dim=1)
        edge_ok = (r > 1e-6)[:, None, None]

        for lp in self.layers:
            hn = self._equiv_ln(h, lp.ln_scale)
            # eSCN message: rotate -> SO(2) conv (radial-modulated) -> back
            z = self._rotate(hn[src], d_fwd)
            z = self._so2_conv(lp, z)
            z = z * lp.radial(rad)[:, None, :]
            msg = self._rotate(z, d_bwd)
            # zero-length edges (self-loops / padding) have no frame: mask
            msg = msg * edge_ok
            # attention from the invariant part
            logits = msg[:, 0, :] @ lp.attn_w                 # (E, heads)
            attn = segment_softmax(logits, dst, n)            # (E, heads)
            attn = attn.mean(dim=-1)                          # head-avg gate
            agg = segment_sum(msg * attn[:, None, None], dst, n)
            # per-l output linear
            outs = [agg[:, a:b] @ lp.out_lin[l]
                    for l, (a, b) in enumerate(self.slices)]
            h = h + torch.cat(outs, dim=1)
            # gated equivariant FFN
            hn = self._equiv_ln(h, lp.ln_scale)
            gate = torch.sigmoid(hn[:, 0, :] @ lp.gate)       # (n, nl)
            ff = []
            for l, (a, b) in enumerate(self.slices):
                t = hn[:, a:b] @ lp.ffn1[l]
                if l == 0:
                    t = F.silu(t)
                t = t @ lp.ffn2[l]
                ff.append(t * gate[:, l][:, None, None])
            h = h + torch.cat(ff, dim=1)

        return self.readout(h[:, 0, :])

    def loss(self, batch):
        return pooled_loss(self, batch)
