"""meshgraphnet [arXiv:2010.03409] — 15 layers, d_hidden=128, sum
aggregator, 2-layer MLPs."""
from ..models.gnn import MeshGraphNetConfig
from .base import ArchSpec, gnn_shapes, register


def make_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet", n_layers=15,
                              d_hidden=128, mlp_layers=2)


def make_reduced() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet-smoke", n_layers=3,
                              d_hidden=32, mlp_layers=2)


SPEC = register(ArchSpec(
    id="meshgraphnet", family="gnn", make_config=make_config,
    make_reduced=make_reduced, shapes=gnn_shapes(),
    source="arXiv:2010.03409; unverified"))
