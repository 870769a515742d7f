"""The four GNNs of the reference (``src/repro/models/gnn``) as
``nn.Module``s; each aggregates through the ``segment_sum`` kernel."""
from .equiformer_v2 import EquiformerV2, EquiformerV2Config
from .mace import MACE, MACEConfig
from .meshgraphnet import MeshGraphNet, MeshGraphNetConfig
from .schnet import SchNet, SchNetConfig

#: config class -> model class
MODELS = {MeshGraphNetConfig: MeshGraphNet, SchNetConfig: SchNet,
          MACEConfig: MACE, EquiformerV2Config: EquiformerV2}

__all__ = ["MeshGraphNet", "MeshGraphNetConfig", "SchNet", "SchNetConfig",
           "MACE", "MACEConfig", "EquiformerV2", "EquiformerV2Config",
           "MODELS"]
