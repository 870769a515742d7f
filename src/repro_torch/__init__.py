"""PyTorch/CUDA port of the graph-trimming system (``src/repro`` is the
JAX/Pallas reference).

Parallel trimming by arc-consistency — AC-3, AC-4, AC-4* and AC-6 — on
the ``dense`` and ``windowed`` backends, FW-BW SCC decomposition with
trim-2 (``core.scc`` over ``core.reach``), k-core peeling (``core.peel``)
and incremental trimming over edge-update batches (``core.stream``), with
hand-written Hopper kernels (``kernels/csrc``) for the windowed probe,
the sparse-frontier rounds, the windowed reach pull, the peel's bucket
extraction, the stream's counter updates, the LM prefill's attention and
the GNN layers' aggregation.
LM serving: ``configs`` (the five LM architectures, of which the three
dense ones are served), ``models`` (``LM``: prefill and KV-cache decode)
and ``launch.serve``.  GNN training: ``models.gnn`` (MeshGraphNet, SchNet,
MACE, EquiformerV2), ``optim``, ``data``, ``train`` and ``launch.train``.
``launch.trim`` is the graph engines' command line
(``python -m repro_torch.launch.trim --app stream``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the package never imports ``jax`` or ``repro``.
"""
from . import configs, core, data, graphs, kernels, launch, models, optim, \
    train

__all__ = ["configs", "core", "data", "graphs", "kernels", "launch",
           "models", "optim", "train"]
