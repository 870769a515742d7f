"""Models of the port: the dense decoder-only LM (``transformer.LM``), its
building blocks (``layers``) and the weight converter (``convert``)."""
from .layers import LMConfig
from .transformer import LM

__all__ = ["LM", "LMConfig"]
