"""The card the port targets, and its hardware constants (PyTorch port of
``src/repro/launch/mesh.py``).

The reference targets a TPU v5e mesh of 256 or 512 chips; the port
targets one NVIDIA H100 SXM5 80GB HBM3 at 700 W.  The rates below are
that card's datasheet figures (the ones PERF.md's bound columns use);
:func:`hbm_bytes` reads the memory of the card in this process when one
is present.  The v5e constants are not carried over.

Meshes are ``torch.distributed`` process groups in the port.  The
sharded trimming backend runs on them (``core.distributed``: one rank a
card, NCCL; ``torchrun`` starts one process a card).  The LM and GNN
mesh of the reference's dry-run, :func:`make_production_mesh`, is not
ported yet (ROADMAP A6) and raises.
"""
from __future__ import annotations

#: H100 SXM5 80GB HBM3, 700 W, datasheet: dense bfloat16 tensor-core FLOP/s
PEAK_FLOPS_BF16 = 989.4e12
#: H100 SXM5 80GB HBM3, 700 W, datasheet: float32 FLOP/s on the CUDA cores
#: (the port keeps TF32 off, so float32 products run at this rate)
PEAK_FLOPS_F32 = 67e12
#: H100 SXM5 80GB HBM3, 700 W, datasheet: HBM3 bytes per second
HBM_BW = 3.35e12
#: H100 SXM5 80GB HBM3, 700 W, datasheet: device memory in bytes
HBM_BYTES = 80e9

#: peak FLOP/s by the dtype an operation computes in; any other dtype
#: counts at the float32 rate
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_F32}


def hbm_bytes() -> int:
    """Device memory of the card in this process
    (``torch.cuda.get_device_properties(0).total_memory``), or
    :data:`HBM_BYTES` where there is none."""
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(HBM_BYTES)


def n_devices() -> int:
    """Devices a dry-run cell runs on: one card.  The LM, GNN and
    recsys cells are not sharded yet (ROADMAP A6); the sharded trim
    backend's size is the process group's, not a cell's."""
    return 1


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production mesh (torch.distributed over several cards) is not "
        "ported yet: ROADMAP A6")
