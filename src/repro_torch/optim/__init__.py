"""Optimizers of the port (``src/repro/optim``)."""
from .adamw import AdamW, AdamWState, HybridAdamW, cosine_schedule, \
    global_norm

__all__ = ["AdamW", "AdamWState", "HybridAdamW", "cosine_schedule",
           "global_norm"]
