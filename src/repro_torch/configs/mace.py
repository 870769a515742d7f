"""mace [arXiv:2206.07697] — 2 layers, 128 channels, l_max=2,
correlation order 3, 8 Bessel RBF, E(3)-ACE."""
from ..models.gnn import MACEConfig
from .base import ArchSpec, gnn_shapes, register


def make_config() -> MACEConfig:
    return MACEConfig(name="mace", n_layers=2, channels=128, l_max=2,
                      correlation=3, n_rbf=8)


def make_reduced() -> MACEConfig:
    return MACEConfig(name="mace-smoke", n_layers=2, channels=8, l_max=2,
                      correlation=3, n_rbf=4)


SPEC = register(ArchSpec(
    id="mace", family="gnn", make_config=make_config,
    make_reduced=make_reduced, shapes=gnn_shapes(),
    source="arXiv:2206.07697; paper"))
