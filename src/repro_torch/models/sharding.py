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
           "local_block", "local_zeros", "shard_offset", "local_apply",
           "positions_like", "is_fake", "check_device", "materialize",
           "sum_partial_grads"]


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
    shard it split it in mesh order, each into ``torch.chunk``'s blocks
    (DTensor's ``Shard``: blocks of ceil(n / ranks), the last ones
    shorter or empty where the ranks do not divide it)."""
    coord = mesh.get_coordinate()
    start, length = 0, size
    for i, p in enumerate(plc):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-length // mesh.size(i))
            lo = min(coord[i] * chunk, length)
            start, length = start + lo, min(chunk, length - lo)
    return start, length


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= size
    return tuple(reversed(out))


def local_apply(fn, args, in_placements, out_placements, out_shapes, mesh,
                in_grad_placements=None):
    """``local_map`` with the outputs' global shapes given: each DTensor
    of ``args`` is redistributed to its ``in_placements`` entry (None for
    a plain argument, passed as it is) and ``fn`` runs on the local
    blocks; each output block, made dense, becomes a DTensor of
    ``out_placements`` with the global shape in ``out_shapes`` (one
    placement list and one shape, or a tuple of each for a tuple of
    outputs).  ``local_map`` infers a global shape as a block times the
    ranks, which is wrong where the ranks do not divide a dimension
    (``torch.chunk``'s uneven blocks): the heads a tp does not divide,
    or an MoE's experts.  ``in_grad_placements`` are the placements of
    the inputs' gradients, as ``local_map``'s."""
    local = []
    for i, (a, pl) in enumerate(zip(args, in_placements)):
        if isinstance(a, DTensor):
            if tuple(a.placements) != tuple(pl):
                a = a.redistribute(mesh, pl)
            gpl = (tuple(in_grad_placements[i]) if in_grad_placements
                   else None)
            a = a.to_local(grad_placements=gpl)
        local.append(a)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs, pls, shapes = ((out,), (out_placements,), (out_shapes,)) \
        if single else (out, out_placements, out_shapes)
    wrapped = tuple(
        DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                           shape=tuple(shp), stride=_contiguous_strides(shp))
        for o, pl, shp in zip(outs, pls, shapes))
    return wrapped[0] if single else wrapped


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


def is_fake(mesh) -> bool:
    """Whether ``mesh`` lies over a fake process group (torch's "fake"
    backend: ``launch.mesh.make_production_mesh``)."""
    import torch.distributed as tdist
    return str(tdist.get_backend(mesh.get_group(0))).lower() == "fake"


def check_device(device, mesh, what: str) -> None:
    """``what`` on ``device`` may be placed on ``mesh``: tensors on the
    mesh's device type, or meta tensors on a fake mesh (rank 0's blocks
    of a dry-run, nothing allocated); anything else raises."""
    device = torch.device(device)
    if device.type == mesh.device_type or (device.type == "meta"
                                           and is_fake(mesh)):
        return
    raise ValueError(f"{what} on {device}, the mesh is of "
                     f"{mesh.device_type!r} ranks")


@torch.no_grad()
def materialize(module: nn.Module, device, init) -> nn.Module:
    """Give a module built and placed on the meta device real blocks on
    ``device``, in place: each parameter's local block (a DTensor's
    ``to_local()``, a plain tensor whole) becomes an empty tensor of its
    shape, filled by ``init(name, p, block)`` (``p`` the meta parameter,
    with its global shape).  Only this rank's blocks are allocated, so
    rank 0 of a fake 512-rank mesh holds its 1/512 of a sharded model.
    Returns ``module``."""
    for name, p in list(module.named_parameters()):
        owner, leaf = _owner(module, name)
        local = p.to_local() if isinstance(p, DTensor) else p
        t = torch.empty(local.shape, dtype=local.dtype, device=device)
        init(name, p, t)
        if isinstance(p, DTensor):
            t = DTensor.from_local(t, p.device_mesh, p.placements,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride())
        setattr(owner, leaf, nn.Parameter(t, requires_grad=p.requires_grad))
    return module


class _SumPartialGrads(torch.autograd.Function):
    """The identity; its gradient's partial sums are all-reduced."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and any(q.is_partial() for q in
                                          g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if q.is_partial() else q for q in g.placements])
        return g


def sum_partial_grads(x):
    """``x`` itself, whose gradient arrives with its partial sums over the
    mesh all-reduced: DTensor cannot turn a partial gradient into the
    masked partial of a vocab-sharded embedding lookup's output."""
    return _SumPartialGrads.apply(x) if isinstance(x, DTensor) else x


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
    check_device(lm.device, mesh, "the LM's parameters")
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


def local_zeros(shape, dtype, spec, mesh, device):
    """A zero tensor of global ``shape`` placed by ``spec`` on ``mesh``,
    only this rank's block allocated, on ``device`` (a plain tensor of
    ``shape`` when ``mesh`` is None; ``torch.empty`` on meta): the block
    :func:`local_block` would cut (:func:`shard_offset`'s lengths),
    nothing of the global shape made."""
    device = torch.device(device)
    make = torch.empty if device.type == "meta" else torch.zeros
    if mesh is None:
        return make(shape, dtype=dtype, device=device)
    plc = placements(spec, mesh)
    local = tuple(shard_offset(mesh, plc, d, n)[1]
                  for d, n in enumerate(shape))
    return DTensor.from_local(make(local, dtype=dtype, device=device), mesh,
                              plc, run_check=False, shape=tuple(shape),
                              stride=_contiguous_strides(shape))


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
