"""Models of the port: the dense decoder-only LM (``transformer.LM``), its
building blocks (``layers``), the four GNNs (``gnn``) with their
equivariant constants (``equivariant``), Wide & Deep (``recsys``), the
weight converter (``convert``) and the LM's mesh sharding (``sharding``)."""
from .layers import LMConfig
from .transformer import LM, MeshAxes

__all__ = ["LM", "LMConfig", "MeshAxes"]
