"""The card the port targets, and its hardware constants (PyTorch port of
``src/repro/launch/mesh.py``).

The reference targets a TPU v5e mesh of 256 or 512 chips; the port
targets one NVIDIA H100 SXM5 80GB HBM3 at 700 W.  The rates below are
that card's datasheet figures (the ones PERF.md's bound columns use);
:func:`hbm_bytes` reads the memory of the card in this process when one
is present.  The v5e constants are not carried over.

Meshes are ``torch.distributed`` process groups in the port.  The
sharded trimming backend runs on the default group (``core.distributed``:
one rank a card, NCCL; ``torchrun`` starts one process a card); the
sharded models on a ``DeviceMesh`` over it (:func:`make_mesh`; the
reference's (data, model) axes, :func:`data_axes`): the dense and MoE
LMs (``models.sharding.shard_lm``: FSDP x TP, the experts on tp),
wide-deep (its tables row-sharded over "model") and the GNNs (parameters
replicated, a large graph's edges split over the data axes or
``perf_flags.gnn_edge_dp``), each through ``launch.cells.build_cell(...,
mesh=)``.  The reference's 256- and 512-chip dry-run mesh,
:func:`make_production_mesh`, is not ported yet (``dryrun --mesh
multi``, ROADMAP A6's last item) and raises.
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


def make_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, which ``core.distributed.process_group(device)`` or
    ``torchrun`` set up; the group's size must be the mesh's.  The
    backend must be the device's (``core.distributed.BACKEND_OF``: NCCL
    for a CUDA device, gloo for the CPU); any other pairing raises."""
    import math

    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.distributed import BACKEND_OF
    dev = torch.device(device)
    want = BACKEND_OF.get(dev.type)
    if want is None:
        raise ValueError(f"no process-group backend for device {dev}")
    if not tdist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process "
            "group: run under torchrun, or enter "
            "repro_torch.core.distributed.process_group(device)")
    have = str(tdist.get_backend()).lower()
    if want not in have:
        raise ValueError(f"tensors on {dev} need a {want} process group; "
                         f"the group's backend is {have!r}")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if math.prod(shape) != tdist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the group has {tdist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    """Axes that carry batch/FSDP sharding ('pod' folds into data)."""
    return ("pod", "data") if multi_pod else ("data",)


def n_devices() -> int:
    """Devices a dry-run cell runs on: one card.  Every family's cells
    also build on a real mesh (``cells.build_cell(..., mesh=)``), whose
    size is the process group's, as is the sharded trim backend's; the
    dry-run of the reference's 256/512-chip meshes is ROADMAP A6's last
    item."""
    return 1


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production mesh (the reference's 256/512-chip dry-run mesh, "
        "dryrun --mesh multi|both) is not ported yet: ROADMAP A6's last "
        "item; a mesh "
        "over real ranks is make_mesh(shape, axes, device=...)")
