"""SchNet [arXiv:1706.08566] (PyTorch port of
``src/repro/models/gnn/schnet.py``): continuous-filter convolutions over a
Gaussian RBF of interatomic distances, aggregated by the ``segment_sum``
kernel once an interaction.  n_interactions=3, d_hidden=64, rbf=300,
cutoff=10 (published).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..equivariant import gaussian_basis, poly_cutoff
from .common import MLP, NodeInput, num_nodes, pooled_loss, segment_sum


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    out_dim: int = 1


class SchNetLayer(nn.Module):
    def __init__(self, cfg: SchNetConfig, **kw):
        super().__init__()
        h = cfg.d_hidden
        self.filter = MLP([cfg.n_rbf, h, h], **kw)
        self.in_lin = MLP([h, h], **kw)
        self.out_mlp = MLP([h, h, h], **kw)


class SchNet(nn.Module):
    def __init__(self, cfg: SchNetConfig, d_feat: int | None = None, *,
                 device="cuda", generator=None, init: bool = True):
        super().__init__()
        self.cfg = cfg
        self.d_feat = d_feat
        h = cfg.d_hidden
        kw = dict(device=device, generator=generator, init=init)
        self.input = NodeInput(h, d_feat, **kw)
        self.readout = MLP([h, h // 2, cfg.out_dim], **kw)
        self.layers = nn.ModuleList(SchNetLayer(cfg, **kw)
                                    for _ in range(cfg.n_interactions))

    def forward(self, batch):
        cfg = self.cfg
        n = num_nodes(batch)
        src, dst = batch["edge_src"], batch["edge_dst"]
        d = torch.linalg.vector_norm(batch["pos"][src] - batch["pos"][dst],
                                     dim=-1)
        rbf = gaussian_basis(d, cfg.n_rbf, cfg.cutoff)       # (m, n_rbf)
        cut = poly_cutoff(d, cfg.cutoff)[..., None]
        x = self.input(batch)
        for lyr in self.layers:
            w = lyr.filter(rbf, act=shifted_softplus) * cut
            hsrc = lyr.in_lin(x)[src]
            msg = segment_sum(hsrc * w, dst, n)
            x = x + lyr.out_mlp(msg, act=shifted_softplus)
        return self.readout(x, act=shifted_softplus)

    def loss(self, batch):
        return pooled_loss(self, batch)
