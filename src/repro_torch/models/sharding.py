"""The LM on a ``torch.distributed`` DeviceMesh: the reference's
``PartitionSpec`` sharding (``src/repro/models/transformer.py``
``param_specs``/``cache_specs``) as DTensor placements.

A *spec* is a tuple with one entry per tensor dimension, the content of
the reference's ``PartitionSpec``: None (replicated), a mesh-axis name,
or a tuple of names (the dimension sharded over several axes).
:func:`placements` turns a spec into a DTensor placement per mesh
dimension: ``Shard(d)`` on each mesh dimension that shards tensor
dimension ``d``, ``Replicate()`` on the rest.  A dimension sharded over
two axes (``dp=("pod", "data")``) becomes ``Shard(d)`` on both, which
DTensor splits in mesh order, the first mesh dimension major: GSPMD's
major-to-minor order, so the names of a tuple must come in mesh order.

:func:`shard_lm` replaces each parameter of an :class:`~.transformer.LM`
with a DTensor parameter placed by ``LM.param_specs`` and switches the
LM's activation pins on; ``models.convert.lm_to_numpy`` gathers a
sharded LM back to the reference's full tree (``full_tensor()``).

Helpers for the sharded forward: :func:`pin` (the reference's
``with_sharding_constraint`` as a ``redistribute``), :func:`shard_offset`
(where this rank's block of a sharded dimension starts) and
:func:`positions_like` (token positions placed like the activation).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["placements", "pin", "shard_lm", "place_module", "place",
           "local_block", "shard_offset", "positions_like"]


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (see the module
    docstring).  A name the mesh lacks, an axis used twice, or the names
    of one dimension out of mesh order raise ``ValueError``."""
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * mesh.ndim
    used = set()
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: the mesh has no axis {a!r} "
                                 f"(its axes are {names})")
            if a in used:
                raise ValueError(f"spec {spec}: axis {a!r} is used twice")
            used.add(a)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {axes} of dimension {d} "
                             f"are not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def pin(x, spec, mesh):
    """``x`` redistributed to ``spec``'s placements on ``mesh`` (the
    reference's ``with_sharding_constraint``); ``x`` as it is when
    ``mesh`` is None."""
    if mesh is None:
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def shard_offset(mesh, plc, dim: int, size: int) -> tuple:
    """``(start, length)`` of this rank's block of dimension ``dim`` (of
    global ``size``) under placements ``plc``: the mesh dimensions that
    shard it split it in mesh order, each into ``torch.chunk``'s blocks.
    Uneven blocks raise: the sharded decode assumes equal ones."""
    coord = mesh.get_coordinate()
    start, length = 0, size
    for i, p in enumerate(plc):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(i)
            if length % n:
                raise ValueError(f"dimension {dim} ({size}) does not split "
                                 f"evenly over mesh dimension "
                                 f"{mesh.mesh_dim_names[i]!r} ({n})")
            length //= n
            start += coord[i] * length
    return start, length


def positions_like(x, s: int, start: int = 0):
    """Positions ``start .. start + s - 1`` for each row of ``x`` (B, S,
    ...): a plain (B, s) int64 tensor, or, for a DTensor ``x``, a DTensor
    whose batch dimension is placed as ``x``'s and replicated elsewhere
    (no collective: every rank builds its own block)."""
    if not isinstance(x, DTensor):
        b = x.shape[0]
        return (torch.arange(s, device=x.device) + start).expand(b, s)
    mesh, plc = x.device_mesh, x.placements
    b_local = x.to_local().shape[0]
    local = (torch.arange(s, device=x.to_local().device) + start
             ).expand(b_local, s).contiguous()
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in plc]
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=(x.shape[0], s), stride=(s, 1))


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, leaf


def shard_lm(lm, mesh, axes=None):
    """Place ``lm``'s parameters on ``mesh`` by ``lm.param_specs(axes)``
    (``axes`` a ``transformer.MeshAxes``, the default ``("data",)`` x
    ``"model"``) and turn on its activation pins; returns ``lm``.  Every
    rank must hold the same weights (``lm_from_numpy`` of one tree, or one
    seed): each keeps its own block of them, nothing is sent.  A MoE
    LM's experts go on tp and their D on the fsdp axes (the reference's
    expert parallelism; ``layers._moe_ffn_sharded`` runs them)."""
    from .transformer import MeshAxes
    axes = MeshAxes() if axes is None else axes
    if lm.device.type != mesh.device_type:
        raise ValueError(f"the LM's parameters are on {lm.device}, the mesh "
                         f"is of {mesh.device_type!r} ranks")
    lm.check_axes(axes, mesh)
    place_module(lm, lm.param_specs(axes), mesh)
    lm.axes, lm.mesh = axes, mesh
    return lm


def place_module(module: nn.Module, specs: dict, mesh) -> None:
    """Replace each parameter of ``module`` with a DTensor parameter
    placed by ``specs[name]`` (``named_parameters``' names) on ``mesh``:
    each rank keeps its block, nothing is sent (:func:`local_block`)."""
    for name, p in list(module.named_parameters()):
        owner, leaf = _owner(module, name)
        placed = local_block(p.detach(), mesh, placements(specs[name], mesh))
        setattr(owner, leaf, nn.Parameter(placed,
                                          requires_grad=p.requires_grad))


def place(t, spec, mesh):
    """A batch tensor (the same whole tensor on every rank) placed by
    ``spec`` on ``mesh``, each rank keeping its block; a DTensor, or any
    tensor when ``mesh`` is None, as it is."""
    if mesh is None or isinstance(t, DTensor):
        return t
    return local_block(t, mesh, placements(spec, mesh))


def local_block(t, mesh, plc):
    """``t`` (the same whole tensor on every rank) as a DTensor placed
    ``plc`` on ``mesh``, nothing sent: this rank's block cut by
    ``torch.chunk`` in mesh order, as ``distribute_tensor(...,
    src_data_rank=None)`` cuts it.  A block that is the whole of ``t``
    (every sharding mesh dimension of one rank) is ``t`` itself where it
    is contiguous: no second copy of the weights; a smaller block is a
    copy, so ``t`` is not kept alive by it.  The one placing helper of
    the port: parameters (:func:`place_module`), batches (:func:`place`),
    restored checkpoint leaves (``train.checkpoint``).  A rank outside
    the mesh holds an empty block, as ``distribute_tensor`` gives it."""
    coord = mesh.get_coordinate()
    if coord is None:
        local = t.new_empty(0)
    else:
        local = t
        for i, p in enumerate(plc):
            if isinstance(p, Shard):
                local = torch.chunk(local, mesh.size(i), dim=p.dim)[coord[i]]
        local = (local.contiguous() if local.numel() == t.numel()
                 else local.clone(memory_format=torch.contiguous_format))
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=t.shape, stride=t.stride())
