"""schnet [arXiv:1706.08566] — 3 interactions, d_hidden=64, 300 RBF,
cutoff 10."""
from ..models.gnn import SchNetConfig
from .base import ArchSpec, gnn_shapes, register


def make_config() -> SchNetConfig:
    return SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0)


def make_reduced() -> SchNetConfig:
    return SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                        n_rbf=32, cutoff=10.0)


SPEC = register(ArchSpec(
    id="schnet", family="gnn", make_config=make_config,
    make_reduced=make_reduced, shapes=gnn_shapes(),
    source="arXiv:1706.08566; paper"))
