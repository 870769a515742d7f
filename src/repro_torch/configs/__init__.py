"""Architecture registry of the port: importing the package registers the
five language models, the four GNNs and the recsys model of the reference
(``src/repro/configs``).

Module filenames are sanitized arch ids (dots/dashes -> underscores); the
registry keys are the exact ids (e.g. "qwen3-1.7b").
"""
from . import (arctic_480b, deepseek_7b, equiformer_v2, llama4_maverick,
               mace, meshgraphnet, minitron_4b, qwen3_1p7b, schnet,
               wide_deep)
from .base import REGISTRY, ArchSpec, ShapeCell, get

ALL_ARCHS = tuple(sorted(REGISTRY))

__all__ = ["REGISTRY", "ALL_ARCHS", "ArchSpec", "ShapeCell", "get"]
