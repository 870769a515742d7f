"""The shared abstract path: run a step on the meta device and count what
it does (PyTorch port of ``src/repro/launch/lowering.py``).

The reference lowers a plan on abstract shapes and reads XLA's cost and
memory analysis off the compiled artifact.  PyTorch compiles nothing, so
the port runs the real step — the same Python, the same modules, the
same kernel wrappers — on ``device="meta"`` tensors, which carry shapes
and dtypes and no data, and counts in one pass (:func:`meter`):

* **FLOPs of the PyTorch ops**, by ``torch.utils.flop_counter``'s
  formulas (the registry ``FlopCounterMode`` counts with: matmuls,
  convolutions, attention), split by the dtype each op computes in;
* **the hand kernels**: inside ``analysis.capture.captured_launches`` the
  wrappers accept meta tensors and record their ``Launch`` without
  launching anything; their FLOPs and bytes come from the port's own
  cost formulas (``obs.profile.kernel_cost``), summed as each call is
  made (``obs.profile.capturing``).  A kernel whose cost reads the data
  (the graph kernels) raises there;
* **the bytes every PyTorch op reads and writes**, through a
  ``TorchDispatchMode``: each input once and each output once (a gather
  reads as many source bytes as it writes; a view moves nothing).  Eager
  PyTorch fuses nothing, so this is the traffic of the port's eager path,
  not an XLA-style fused estimate;
* **the peak of live tensor bytes**, by storage (a view counts once, an
  in-place op adds nothing), each storage freed by a ``weakref``
  finalizer when its last holder dies — the arguments count from the
  start;
* **the collectives** (``_c10d_functional.*``, which DTensor issues, and
  the ``c10d.*`` ops ``torch.distributed.all_reduce`` issues): each
  one's result bytes, as the reference's ``dryrun._result_bytes`` counts
  an HLO collective's, under the reference's kind names
  (:data:`COLLECTIVE_KINDS`), split by the mesh axis whose process group
  it ran on.  Their bytes go to the collective term, not the memory
  term.

On a ``DeviceMesh`` (``launch.mesh.make_production_mesh``: a fake group
of 256 or 512 ranks, this process rank 0) the step's tensors are
DTensors whose local blocks are meta tensors.  The meter declines the
DTensor-level op (``NotImplemented``), so DTensor's own dispatch runs
under it and the meter counts what rank 0 runs: the local ops on its
blocks and the collectives of every redistribute, at their local
shapes.  The ops DTensor's sharding propagation runs on fake tensors
are not counted.

Meta ops cost the host 50-400 µs each, and the attention backward
(``kernels.flash_attention.flash_attention_bwd``, torch ops over blocks
of query rows) runs thousands of them a layer at a training cell's
batch.  Its cost follows from its arguments' shapes alone and every
layer calls it with the same ones, so while :func:`meter` runs, the
autograd function's backward calls it through a :class:`_Replay`
(``flash_attention.BWD_HOOK``): on meta tensors a call whose signature
was metered before is replayed, its counts added again and fresh outputs
of the recorded shapes made, without running its ops.  The counts are
the same as running it.

:func:`lower` caches a meter per caller key, process-wide, as the
reference caches its compiled plans: :func:`cache_stats`,
:func:`clear_caches`.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import weakref
from collections import Counter
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from ..obs import profile
from .mesh import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32, link_bw

#: collective op -> the reference's HLO kind name
COLLECTIVE_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.broadcast_": "broadcast",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
#: the reference's kinds (``src/repro/launch/dryrun.py``), always reported
REFERENCE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")
_COMM_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
#: ops that return their input on the card
_WRAPS = ("_c10d_functional._wrap_tensor_autograd",)
#: live storages :attr:`StepCost.largest` lists
_LARGEST = 6

_aten = torch.ops.aten
#: ops that allocate without writing
_NO_WRITE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided,
             _aten.empty_permuted}
#: ops whose first argument is only read where the output is gathered
_GATHERS = {_aten.embedding, _aten.index_select, _aten.index, _aten.gather,
            _aten.take}
#: in-place ops that write their first argument without reading it
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` spans: a broadcast (stride-0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return 0 if t.numel() == 0 else n * t.element_size()


def tensors(tree) -> list:
    """Every tensor in ``tree`` (tuples, lists, dicts, NamedTuples)."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _flat(args, kwargs) -> list:
    """The tensors among an op's arguments (one level of lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _outs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _group_of(func, args, kwargs):
    """The process group a collective op ran on (its ``group_name`` or
    ``process_group`` argument), or None."""
    import torch.distributed as tdist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, a in enumerate(func._schema.arguments):
        if a.name not in ("group_name", "process_group"):
            continue
        value = args[i] if i < len(args) else kwargs.get(a.name)
        if value is None:
            return None
        return (_resolve_process_group(value) if a.name == "group_name"
                else tdist.ProcessGroup.unbox(value))
    return None


class _Meter(TorchDispatchMode):
    """Counts FLOPs by dtype, the bytes each op moves, the live and peak
    bytes of storages, and the collectives by process group (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()
        self.nbytes = 0
        self.ops = 0
        self.live = self.peak = 0
        self._sizes: dict = {}
        self._what: dict = {}
        #: the largest live storages near the peak: (bytes, the op that
        #: made it, shape, dtype), largest first
        self.largest: list = []
        self._shot = 0
        #: group name -> {kind: (calls, result bytes)}, and its ranks
        self.comms: dict = {}
        self.comm_ranks: dict = {}

    def _collective(self, func, args, kwargs, outs) -> None:
        """Count a collective's call and result bytes under its group
        (``wait_tensor``, ``_wrap_tensor_autograd`` and the like count
        none)."""
        import torch.distributed as tdist
        name = str(func._overloadpacket._qualified_op_name).replace("::", ".")
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            return
        pg = _group_of(func, args, kwargs)
        key = pg.group_name if pg is not None else "?"
        if key not in self.comms:
            self.comms[key] = {}
            self.comm_ranks[key] = (tdist.get_process_group_ranks(pg)
                                    if pg is not None else [])
        rec = self.comms[key]
        calls, nbytes = rec.get(kind, (0, 0))
        rec[kind] = (calls + 1, nbytes + sum(tensor_bytes(t) for t in outs))

    def track(self, t: torch.Tensor, op: str = "argument",
              size: int | None = None) -> None:
        """Count ``t``'s storage live from now until it is freed, at its
        bytes or at ``size``."""
        st = t.untyped_storage()
        key = st._cdata
        size = st.nbytes() if size is None else size
        old = self._sizes.get(key)
        if old == size:
            return
        if old is None:
            weakref.finalize(st, self._free, key)
        self._sizes[key] = size
        self._what[key] = (op, tuple(t.shape), str(t.dtype).split(".")[-1])
        self.live += size - (old or 0)
        if self.live > self.peak:
            self.peak = self.live
            if self.live > self._shot * 1.01:
                self._shot = self.live
                self.largest = [(self._sizes[k],) + self._what[k] for k in
                                heapq.nlargest(_LARGEST, self._sizes,
                                               key=self._sizes.get)]

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._what.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor's dispatch runs under us
        if any(t is not torch.Tensor for t in types):
            return func(*args, **kwargs)   # sharding propagation's fakes
        if (str(func._overloadpacket) in _WRAPS and args
                and args[0].device.type == "meta"):
            # on the card the wrap is its input (an AsyncCollectiveTensor
            # over it); its meta kernel would make a second tensor
            return args[0].view_as(args[0])
        out = func(*args, **kwargs)
        outs = tensors(out)
        if any(type(t) is not torch.Tensor for t in outs):
            return out
        packet = func._overloadpacket
        if func.namespace in _COMM_NAMESPACES:
            # an output is its own allocation on the card, whatever
            # storage its meta implementation views
            self._collective(func, args, kwargs, outs)
            for t in outs:
                self.track(t, str(packet), max(tensor_bytes(t),
                                               self._sizes.get(
                                                   t.untyped_storage()._cdata,
                                                   0)))
            return out
        ins = _flat(args, kwargs)
        outs = _outs(out)
        self.ops += 1
        if packet in flop_counter.flop_registry:
            flops = flop_counter.flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
            self.flops[str(ins[0].dtype).split(".")[-1]] += int(flops)
        schema = func._schema
        view = (not schema.is_mutable
                and any(r.alias_info is not None for r in schema.returns))
        if not view and packet not in _NO_WRITE:
            seen, read = set(), 0
            for i, t in enumerate(ins):
                if id(t) in seen or (i == 0 and packet in _OVERWRITES):
                    continue
                seen.add(id(t))
                b = tensor_bytes(t)
                if i == 0 and packet in _GATHERS:
                    b = min(b, sum(tensor_bytes(o) for o in outs))
                read += b
            self.nbytes += read + sum(tensor_bytes(o) for o in outs)
        for t in outs:
            self.track(t, str(packet))
        return out


@dataclasses.dataclass
class StepCost:
    """What one run of a step on meta tensors counted: FLOPs by dtype
    (PyTorch ops and hand kernels), bytes moved, hand-kernel launches by
    kernel, the bytes of the arguments, of the outputs not aliasing an
    argument and the peak of live bytes, the ops run, and the seconds the
    run took."""

    flops_by_dtype: dict
    op_bytes: int
    kernel_bytes: int
    kernel_flops: int
    launches: dict
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    ops: int
    seconds: float
    #: mesh axis -> {kind: (calls, result bytes)}
    collectives: dict = dataclasses.field(default_factory=dict)
    #: mesh axis -> its link's bytes a second (``launch.mesh.link_bw``)
    links: dict = dataclasses.field(default_factory=dict)
    #: the largest live storages within 1% of the peak: (bytes, the op
    #: that made it, shape, dtype)
    largest: list = dataclasses.field(default_factory=list)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def bytes(self) -> float:
        return float(self.op_bytes + self.kernel_bytes)

    @property
    def collective_bytes(self) -> int:
        return sum(n for rec in self.collectives.values()
                   for _, n in rec.values())

    def collective_summary(self) -> dict:
        """The reference's ``collective_bytes`` dict (``bytes_by_kind``,
        ``counts``, ``total``: result bytes by kind, calls by kind, and
        their sum), plus ``bytes_by_axis``, ``counts_by_axis`` and
        ``link_bw`` (the rate of each axis's link)."""
        kinds = dict.fromkeys(REFERENCE_KINDS, 0)
        by_kind, counts = dict(kinds), dict(kinds)
        by_axis, counts_axis = {}, {}
        for axis, rec in self.collectives.items():
            for kind, (calls, nbytes) in rec.items():
                by_kind[kind] = by_kind.get(kind, 0) + nbytes
                counts[kind] = counts.get(kind, 0) + calls
                by_axis[axis] = by_axis.get(axis, 0) + nbytes
                counts_axis[axis] = counts_axis.get(axis, 0) + calls
        return {"bytes_by_kind": by_kind, "counts": counts,
                "total": sum(by_kind.values()), "bytes_by_axis": by_axis,
                "counts_by_axis": counts_axis, "link_bw": dict(self.links)}

    def roofline(self) -> dict:
        """The reference's roofline terms for one card: compute seconds
        (each dtype's FLOPs at its peak rate), memory seconds (bytes at
        the HBM rate), collective seconds (each mesh axis's result bytes
        over its link's rate, ``launch.mesh.link_bw``; 0 with no
        collective), the dominant term and the bound, the largest of
        them."""
        t_comp = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS_F32)
                     for dt, f in self.flops_by_dtype.items())
        t_mem = self.bytes / HBM_BW
        t_coll = sum(nbytes / self.links[axis]
                     for axis, rec in self.collectives.items()
                     for _, nbytes in rec.values())
        terms = (("compute", t_comp), ("memory", t_mem),
                 ("collective", t_coll))
        return {"compute_s": t_comp, "memory_s": t_mem,
                "collective_s": t_coll,
                "dominant": max(terms, key=lambda kv: kv[1])[0],
                "bound_s": max(t_comp, t_mem, t_coll)}


class _KernelSink:
    """``obs.profile.capturing``'s sink: each hand-kernel call's FLOPs (by
    the dtype of its first tensor argument) and bytes, summed as the call
    is noted, so no call's tensors outlive it."""

    def __init__(self):
        self.flops: Counter = Counter()
        self.nbytes = 0

    def append(self, call) -> None:
        kernel, args, out = call
        flops, nbytes = profile.kernel_cost(kernel, args, out)
        dtype = next(t.dtype for t in args if isinstance(t, torch.Tensor))
        self.flops[str(dtype).split(".")[-1]] += flops
        self.nbytes += nbytes


def _signature(tree) -> tuple:
    """A hashable key of a call's arguments: each tensor's shape, strides,
    dtype and device; other values as they are (lists as tuples)."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.stride(), tree.dtype,
                tree.device)
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(x) for x in tree)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    return tree


class _Replay:
    """Wraps a function whose cost follows from its arguments' shapes and
    whose outputs are tensors of their own storage: on meta tensors, the
    first call of each signature runs and its counts (the meter's FLOPs,
    bytes and ops, the kernel sink's, and the peak it reached above the
    live bytes at entry) are recorded; a later call with the same
    signature adds them again and returns fresh tensors of the recorded
    shapes and strides.  A call on real tensors always runs."""

    def __init__(self, fn, mode: _Meter, sink, launches: list):
        self.fn, self.mode, self.sink, self.launches = fn, mode, sink, \
            launches
        self.memo: dict = {}

    def _counts(self):
        m, k = self.mode, self.sink
        return (Counter(m.flops), m.nbytes, m.ops, Counter(k.flops),
                k.nbytes, len(self.launches))

    def __call__(self, *args, **kwargs):
        ins = tensors((args, kwargs))
        if not ins or any(t.device.type != "meta" for t in ins):
            return self.fn(*args, **kwargs)
        mode = self.mode
        key = _signature((args, kwargs))
        if key in self.memo:
            return self._replay(*self.memo[key])
        before, live0, peak0 = self._counts(), mode.live, mode.peak
        mode.peak = live0
        out = self.fn(*args, **kwargs)
        inner = mode.peak - live0
        mode.peak = max(peak0, mode.peak)
        after = self._counts()
        outs = _outs(out)
        keys = {t.untyped_storage()._cdata for t in ins}
        fresh = (isinstance(out, tuple) and len(outs) == len(out)
                 and after[5] == before[5]
                 and len({t.untyped_storage()._cdata for t in outs})
                 == len(outs)
                 and all(t.untyped_storage()._cdata not in keys
                         and t.storage_offset() == 0
                         and t.untyped_storage().nbytes() == tensor_bytes(t)
                         for t in outs))
        if fresh:
            delta = (after[0] - before[0], after[1] - before[1],
                     after[2] - before[2], after[3] - before[3],
                     after[4] - before[4])
            self.memo[key] = (delta, inner, [
                (tuple(t.shape), t.stride(), t.dtype) for t in outs])
        return out

    def _replay(self, delta, inner, shapes):
        mode, sink = self.mode, self.sink
        mode.flops.update(delta[0])
        mode.nbytes += delta[1]
        mode.ops += delta[2]
        sink.flops.update(delta[3])
        sink.nbytes += delta[4]
        mode.peak = max(mode.peak, mode.live + inner)
        with _disable_current_modes():
            outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                             device="meta")
                         for shape, stride, dtype in shapes)
        for t in outs:
            mode.track(t)
        return outs


def _axis_names(mesh) -> dict:
    """Process-group name -> the mesh axis it spans."""
    if mesh is None:
        return {}
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def _by_axis(mode: _Meter, mesh) -> tuple:
    """The meter's collectives and their links' rates keyed by mesh axis
    (a group that is no axis of ``mesh`` by ``"ranks:<n>"``)."""
    names = _axis_names(mesh)
    out, links = {}, {}
    for key, rec in mode.comms.items():
        ranks = mode.comm_ranks[key]
        axis = names.get(key, f"ranks:{len(ranks)}")
        links[axis] = link_bw(ranks)
        dst = out.setdefault(axis, {})
        for kind, (calls, nbytes) in rec.items():
            c0, b0 = dst.get(kind, (0, 0))
            dst[kind] = (c0 + calls, b0 + nbytes)
    return out, links


def _drop_meta_scratch(scratch: dict) -> None:
    for key in [k for k in scratch if k[0] == "meta"]:
        del scratch[key]


def local(t):
    """A DTensor's local block (no op is dispatched); any other tensor as
    it is."""
    return t._local_tensor if isinstance(t, DTensor) else t


def meter(fn: Callable, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters and return
    ``(result, StepCost)``.  On meta tensors the hand kernels' wrappers
    record their launches instead of launching (nothing reaches a card),
    and the attention backward is replayed after its first call of each
    signature; on CPU tensors the wrappers take their plain versions and
    everything runs, as always.  DTensor arguments count by their local
    blocks; ``mesh`` names the axes of the collectives' process
    groups."""
    from ..analysis.capture import captured_launches
    from ..kernels import flash_attention as fa
    from ..kernels import frontier_compact as fc
    mode, sink = _Meter(), _KernelSink()
    held = [local(t) for t in tensors((args, kwargs))]
    # the kernels' look-back scratch is made (and counted) in each run on
    # meta tensors, not kept from an earlier one in the process
    _drop_meta_scratch(fc._SCRATCH)
    for t in held:
        mode.track(t)
    arg_bytes = mode.live
    t0 = time.perf_counter()
    with captured_launches(keep_outputs=False) as launches, \
            profile.capturing(sink):
        fa.BWD_HOOK = _Replay(fa.flash_attention_bwd, mode, sink, launches)
        try:
            with mode:
                out = fn(*args, **kwargs)
        finally:
            fa.BWD_HOOK = None
            _drop_meta_scratch(fc._SCRATCH)
    seconds = time.perf_counter() - t0
    arg_keys = {t.untyped_storage()._cdata for t in held}
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in map(local, tensors(out))}
    flops = Counter(mode.flops)
    flops.update(sink.flops)
    collectives, links = _by_axis(mode, mesh)
    cost = StepCost(
        flops_by_dtype=dict(flops), op_bytes=mode.nbytes,
        kernel_bytes=sink.nbytes, kernel_flops=sum(sink.flops.values()),
        launches=dict(Counter(r.kernel for r in launches)),
        argument_bytes=arg_bytes,
        output_bytes=sum(v for k, v in outs.items() if k not in arg_keys),
        peak_bytes=mode.peak, ops=mode.ops, seconds=seconds,
        collectives=collectives, links=links, largest=mode.largest)
    return out, cost


_CACHE: dict = {}
_STATS = {"meter_hits": 0, "meter_misses": 0}


def lower(fn: Callable, args: tuple, *, key: Any, mesh=None) -> StepCost:
    """:func:`meter` of ``fn(*args)``, cached on ``key``: the caller
    supplies it (the dry-run keys on its (arch, shape, layers, mesh,
    flags) cell coordinates), as the reference keys its compiled plans.
    The result is dropped; only the cost is kept."""
    if key in _CACHE:
        _STATS["meter_hits"] += 1
        return _CACHE[key]
    _STATS["meter_misses"] += 1
    _, cost = meter(fn, *args, mesh=mesh)
    _CACHE[key] = cost
    return cost


def cache_stats() -> dict:
    return dict(_STATS, costs=len(_CACHE))


def clear_caches() -> None:
    _CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0
