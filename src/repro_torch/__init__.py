"""PyTorch/CUDA port of the graph-trimming system (``src/repro`` is the
JAX/Pallas reference).

Parallel trimming by arc-consistency — AC-3, AC-4, AC-4* and AC-6 — on
the ``dense`` and ``windowed`` backends, FW-BW SCC decomposition with
trim-2 (``core.scc`` over ``core.reach``) and k-core peeling
(``core.peel``), with hand-written Hopper kernels (``kernels/csrc``) for
the windowed probe, the sparse-frontier rounds, the windowed reach pull
and the peel's bucket extraction.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the package never imports ``jax`` or ``repro``.
"""
from . import core, graphs, kernels

__all__ = ["core", "graphs", "kernels"]
