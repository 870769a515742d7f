"""PyTorch/CUDA port of the graph-trimming system (``src/repro`` is the
JAX/Pallas reference).

Parallel trimming by arc-consistency — AC-3, AC-4, AC-4* and AC-6 — on
the ``dense`` and ``windowed`` backends, with hand-written Hopper kernels
(``kernels/csrc``) for the windowed probe and the sparse-frontier rounds.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the package never imports ``jax`` or ``repro``.
"""
from . import core, graphs, kernels

__all__ = ["core", "graphs", "kernels"]
