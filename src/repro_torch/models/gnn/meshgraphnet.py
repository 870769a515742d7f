"""MeshGraphNet [arXiv:2010.03409] (PyTorch port of
``src/repro/models/gnn/meshgraphnet.py``): encode-process-decode with edge
and node MLPs, sum aggregation (the ``segment_sum`` kernel, once a layer),
residual updates.  n_layers=15, d_hidden=128, mlp_layers=2 (published).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .common import MLP, NodeInput, layer_norm, num_nodes, pooled_loss, \
    segment_index, segment_sum


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    out_dim: int = 3          # mesh dynamics output / classes
    aggregator: str = "sum"


class MeshGraphNetLayer(nn.Module):
    def __init__(self, h: int, hid: list, **kw):
        super().__init__()
        self.edge_mlp = MLP([3 * h] + hid + [h], **kw)
        self.node_mlp = MLP([2 * h] + hid + [h], **kw)


class MeshGraphNet(nn.Module):
    def __init__(self, cfg: MeshGraphNetConfig, d_feat: int | None = None, *,
                 device="cuda", generator=None, init: bool = True):
        super().__init__()
        self.cfg = cfg
        self.d_feat = d_feat
        h = cfg.d_hidden
        hid = [h] * cfg.mlp_layers
        kw = dict(device=device, generator=generator, init=init)
        self.input = NodeInput(h, d_feat, **kw)
        self.edge_enc = MLP([4] + hid + [h], **kw)
        self.node_enc = MLP([h] + hid + [h], **kw)
        self.decoder = MLP([h] + hid + [cfg.out_dim], **kw)
        self.layers = nn.ModuleList(MeshGraphNetLayer(h, hid, **kw)
                                    for _ in range(cfg.n_layers))

    def forward(self, batch):
        n = num_nodes(batch)
        src, dst = batch["edge_src"], batch["edge_dst"]
        rel = batch["pos"][src] - batch["pos"][dst]              # (m, 3)
        dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
        e = self.edge_enc(torch.cat([rel, dist], -1), norm=True)
        x = self.node_enc(self.input(batch), norm=True)
        index = segment_index(dst, n)
        for lyr in self.layers:
            e_in = torch.cat([e, x[src], x[dst]], dim=-1)
            e = e + layer_norm(lyr.edge_mlp(e_in))
            agg = segment_sum(e, dst, n, index)
            x = x + layer_norm(lyr.node_mlp(torch.cat([x, agg], -1)))
        return self.decoder(x)

    def loss(self, batch):
        return pooled_loss(self, batch)
