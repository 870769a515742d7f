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
mesh=)``.  The reference's 256- and 512-chip dry-run meshes are
:func:`make_production_mesh`: a (16, 16) ("data", "model") or (2, 16,
16) ("pod", "data", "model") ``DeviceMesh`` over a *fake* process group
of 256 or 512 ranks (``torch.distributed``'s "fake" backend: every
collective returns at once and moves nothing), with this process as
rank 0.  On the meta device the dry-run runs rank 0's step of a cell
there (``launch.dryrun --mesh pod|multi|both``); on the card rank 0's
blocks are real tensors, whose values mean nothing.  The link rates
below give the dry-run's collective term: an axis whose ranks lie in one
node of :data:`NODE_CARDS` consecutive ranks talks over NVLink, any
other over the inter-node network.
"""
from __future__ import annotations

import contextlib

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

#: NVLink 4 between the 8 H100 SXM5 cards of a node (DGX H100 / HGX H100
#: datasheet): 900 GB/s a card both ways, so 450e9 B/s each way
NVLINK_BW = 450e9
#: between nodes, one 400 Gb/s NDR InfiniBand ConnectX-7 a card, as in
#: the DGX H100 (datasheet): 50e9 B/s each way
INTERNODE_BW = 50e9
#: H100 SXM5 cards a node (DGX H100): ranks 8k .. 8k + 7 share NVLink
NODE_CARDS = 8

#: the reference's production meshes (``src/repro/launch/mesh.py``),
#: by ``multi_pod``: (shape, axis names)
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


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


def n_devices(multi_pod: bool | None = None) -> int:
    """Devices a dry-run cell runs on: one card for ``None``, else the
    ranks of the production mesh (256, or 512 with ``multi_pod``)."""
    if multi_pod is None:
        return 1
    import math
    return math.prod(PRODUCTION_MESHES[bool(multi_pod)][0])


def link_bw(ranks) -> float:
    """Bytes a second each way of a collective over ``ranks``: NVLink
    when they lie in one node of :data:`NODE_CARDS` consecutive ranks,
    else the inter-node link."""
    nodes = {r // NODE_CARDS for r in ranks}
    return NVLINK_BW if len(nodes) == 1 else INTERNODE_BW


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False, device="meta"):
    """The reference's production mesh over a fake process group, for the
    block: ``with make_production_mesh(multi_pod=True) as mesh:``.

    The default group is created here, of 256 or 512 ranks with this
    process as rank 0, on torch's "fake" backend (``FakeStore``: no
    rendezvous, no network; every collective returns at once and moves
    nothing, so the values it leaves mean nothing), and destroyed on
    exit.  An initialised group is never touched: one raises.  The mesh
    is of "cuda" ranks whatever ``device`` is ("meta" for the dry-run,
    "cuda" for rank 0's blocks on the card), so DTensor issues the
    collectives it issues on NCCL.  ``make_mesh`` refuses the fake
    group: no serving or training entry point runs on it."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if torch.device(device).type not in ("meta", "cuda"):
        raise ValueError(f"a production mesh holds meta or cuda tensors, "
                         f"not {device}")
    if tdist.is_initialized():
        raise RuntimeError(
            "make_production_mesh creates its own fake process group; one "
            f"({tdist.get_backend()!r}, {tdist.get_world_size()} ranks) is "
            "already initialised")
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=n_devices(multi_pod))
    try:
        yield init_device_mesh("cuda", shape, mesh_dim_names=axes)
    finally:
        tdist.destroy_process_group()

