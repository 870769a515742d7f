"""equiformer-v2 [arXiv:2306.12059] — 12 layers, d_hidden=128, l_max=6,
m_max=2, 8 heads, SO(2)-eSCN convolutions."""
from ..models.gnn import EquiformerV2Config
from .base import ArchSpec, gnn_shapes, register


def make_config() -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2", n_layers=12,
                              channels=128, l_max=6, m_max=2, n_heads=8)


def make_reduced() -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2-smoke", n_layers=2,
                              channels=8, l_max=3, m_max=2, n_heads=2)


SPEC = register(ArchSpec(
    id="equiformer-v2", family="gnn", make_config=make_config,
    make_reduced=make_reduced, shapes=gnn_shapes(),
    source="arXiv:2306.12059; unverified"))
