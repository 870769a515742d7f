"""MACE [arXiv:2206.07697] (PyTorch port of ``src/repro/models/gnn/mace.py``):
higher-order equivariant message passing by ACE symmetric contractions.
Published config: n_layers=2, 128 channels, l_max=2, correlation 3, 8
Bessel RBF.

  A-functions:  A_i = sum_j R(r_ij) (h_j (x)_CG Y(u_ij)), one ``segment_sum``
                kernel launch per CG path (15 at l_max = 2) and layer
  B-functions:  A, A (x) A, A (x) A (x) A by iterated real-CG products with
                per-path weights
  update:       per-l linear + residual; per-layer invariant readout

Irrep features are packed as (n, (l_max+1)^2, C); per-l blocks are static
slices.  The CG tensors (``equivariant.real_cg``) are made once, as float32
tensors on the model's device, where the reference converts them inside
``forward``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..equivariant import bessel_basis, l_slices, num_sh, real_cg, sh
from .common import MLP, normal, num_nodes, pooled_loss, segment_index, \
    segment_sum


def _triples(l_max: int):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    out.append((l1, l2, l3))
    return out


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 32
    out_dim: int = 1


class MACELayer(nn.Module):
    def __init__(self, cfg: MACEConfig, n_paths: int, **kw):
        super().__init__()
        c, nl = cfg.channels, cfg.l_max + 1

        def nrm(*s, div=1.0):
            return normal(s, 1.0 / math.sqrt(s[0]) / div, **kw)

        # radial MLP -> per (path, channel) weights for the A-functions
        self.radial = MLP([cfg.n_rbf, 64, n_paths * c], **kw)
        self.w_A = nrm(n_paths, c, c, div=3.0)
        self.w_B2 = nrm(n_paths, c, div=3.0)
        self.w_B3 = nrm(n_paths, c, div=3.0)
        self.lin_self = nrm(nl, c, c)
        self.lin_msg = nrm(nl, c, c)
        self.lin_b2 = nrm(nl, c, c)
        self.lin_b3 = nrm(nl, c, c)


class MACE(nn.Module):
    def __init__(self, cfg: MACEConfig, d_feat: int | None = None, *,
                 device="cuda", generator=None, init: bool = True):
        super().__init__()
        self.cfg = cfg
        self.d_feat = d_feat
        self.triples = _triples(cfg.l_max)
        self.slices = l_slices(cfg.l_max)
        self.cg = [torch.as_tensor(real_cg(*t), dtype=torch.float32,
                                   device=device) for t in self.triples]
        c = cfg.channels
        kw = dict(device=device, generator=generator, init=init)
        if d_feat is not None:
            self.in_proj = normal((d_feat, c), 1.0 / math.sqrt(d_feat), **kw)
        else:
            self.species_embed = normal((cfg.n_species, c), 0.1, **kw)
        self.layers = nn.ModuleList(MACELayer(cfg, len(self.triples), **kw)
                                    for _ in range(cfg.n_layers))
        self.readouts = nn.ModuleList(MLP([c, 16, cfg.out_dim], **kw)
                                      for _ in range(cfg.n_layers))

    def _blocks(self, h):
        return [h[:, a:b] for a, b in self.slices]

    def _cg_prod(self, xs, ys, weights=None):
        """Per-l3 CG products of two per-l block lists -> block list."""
        out = [None] * (self.cfg.l_max + 1)
        for p, (l1, l2, l3) in enumerate(self.triples):
            term = torch.einsum("uvw,nuc,nvc->nwc", self.cg[p], xs[l1],
                                ys[l2])
            if weights is not None:
                term = term * weights[p][None, None, :]
            out[l3] = term if out[l3] is None else out[l3] + term
        return out

    def forward(self, batch):
        cfg = self.cfg
        c = cfg.channels
        n = num_nodes(batch)
        src, dst = batch["edge_src"], batch["edge_dst"]
        rel = batch["pos"][src] - batch["pos"][dst]
        r = torch.linalg.vector_norm(rel, dim=-1)
        y = sh(rel, cfg.l_max)                                  # (m, 9)
        rad = bessel_basis(r, cfg.n_rbf, cfg.cutoff)            # (m, n_rbf)

        if "feats" in batch:
            h0 = batch["feats"] @ self.in_proj
        else:
            h0 = self.species_embed[batch["species"]]
        h = torch.cat([h0[:, None, :], h0.new_zeros(
            (n, num_sh(cfg.l_max) - 1, c))], dim=1)

        energy = 0.0
        index = segment_index(dst, n)
        for lp, ro in zip(self.layers, self.readouts):
            rw = lp.radial(rad).reshape(-1, len(self.triples), c)  # (m, P, C)
            # zero-length edges (self-loops / padding) have no direction
            rw = rw * (r > 1e-6)[:, None, None]
            hb = self._blocks(h)
            yb = self._blocks(y)                                # (m, 2l+1)
            # A-functions: one-particle basis, per path
            a = [None] * (cfg.l_max + 1)
            for p, (l1, l2, l3) in enumerate(self.triples):
                mixed = hb[l1][src] @ lp.w_A[p]                 # (m, u, C)
                # (uvw, ev) -> (e, u, w), then contract u with the channels
                wy = torch.einsum("uvw,ev->euw", self.cg[p], yb[l2])
                msg = wy.transpose(1, 2) @ mixed                # (m, w, C)
                term = segment_sum(msg * rw[:, p][:, None, :], dst, n,
                                   index)
                a[l3] = term if a[l3] is None else a[l3] + term
            # symmetric contractions (correlation 2, 3)
            b2 = self._cg_prod(a, a, lp.w_B2)
            b3 = self._cg_prod(b2, a, lp.w_B3)
            msg_blocks = []
            for l, hl in enumerate(self._blocks(h)):
                m = a[l] @ lp.lin_msg[l]
                m = m + b2[l] @ lp.lin_b2[l]
                m = m + b3[l] @ lp.lin_b3[l]
                m = m + hl @ lp.lin_self[l]
                msg_blocks.append(m)
            h = torch.cat(msg_blocks, dim=1)
            energy = energy + ro(h[:, 0, :])                    # (n, out)
        return energy

    def loss(self, batch):
        return pooled_loss(self, batch)
