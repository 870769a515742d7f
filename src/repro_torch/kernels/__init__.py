"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the device-dispatching wrappers (``ops``)."""
from . import ops, ref

__all__ = ["ops", "ref"]
