"""Architecture registry of the port: importing the package registers the
five language models and the four GNNs of the reference
(``src/repro/configs``).

Module filenames are sanitized arch ids (dots/dashes -> underscores); the
registry keys are the exact ids (e.g. "qwen3-1.7b").  The reference's
recsys id is known but not ported: :func:`get` raises
:class:`NotImplementedError` naming ROADMAP A11 for it.
"""
from . import (arctic_480b, deepseek_7b, equiformer_v2, llama4_maverick,
               mace, meshgraphnet, minitron_4b, qwen3_1p7b, schnet)
from .base import NOT_PORTED, REGISTRY, ArchSpec, ShapeCell, get

ALL_ARCHS = tuple(sorted(REGISTRY))

__all__ = ["REGISTRY", "ALL_ARCHS", "NOT_PORTED", "ArchSpec", "ShapeCell",
           "get"]
