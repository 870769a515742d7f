"""Performance toggles (PyTorch port of ``src/repro/launch/perf_flags.py``).

Every flag keeps the reference's name and default, so no result moves
until a flag is set.  Flags are read when a step is built or run (the
port traces nothing), so set them before building a cell or calling the
model.  :func:`reset` puts every flag back to its default.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PerfFlags:
    # Shape only the reference's XLA attention (``attention_ref_chunked``,
    # its stand-in for the Pallas kernel's memory traffic).  No effect in
    # the port: its flash kernel keeps the scores on chip in float32, as
    # the Pallas kernel does, and its backward is float32 torch ops.
    attn_bf16_scores: bool = False      # score tensors bf16 instead of f32
    attn_additive_mask: bool = False    # one additive bias, not selects
    # MoE: the capacity floor for small token counts; None means 8, which
    # keeps small (decode) batches dropless (``models.layers.moe_capacity``)
    moe_decode_capacity_floor: int | None = None
    # recsys: momentum-free SGD for the embedding tables
    # (``optim.HybridAdamW``); read by ``launch.cells``
    recsys_hybrid_opt: bool = False
    # LM serving: bf16 parameters for prefill and decode cells (half the
    # weight bytes of the f32 masters); read by ``launch.cells``
    serve_bf16_params: bool = False
    # Read by nothing in either package (the reference's GNNs gather
    # features once per layer pair already).
    gnn_reuse_wigner: bool = True
    # GNN: the mesh axes a large graph's node and edge arrays go on in the
    # sharded cells (``launch.cells``; None: the data axes), and the axes
    # EquiformerV2's edge pins name (it checks the edges are split over
    # them).  Without a mesh it changes nothing.
    gnn_edge_dp: tuple | None = None


FLAGS = PerfFlags()


def reset():
    global FLAGS
    FLAGS = PerfFlags()
    return FLAGS
