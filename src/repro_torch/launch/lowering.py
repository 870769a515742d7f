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
  start.

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
import time
import weakref
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from ..obs import profile
from .mesh import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32

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


class _Meter(TorchDispatchMode):
    """Counts FLOPs by dtype, the bytes each op moves, and the live and
    peak bytes of storages (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()
        self.nbytes = 0
        self.ops = 0
        self.live = self.peak = 0
        self._sizes: dict = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, size = st._cdata, st.nbytes()
        old = self._sizes.get(key)
        if old == size:
            return
        if old is None:
            weakref.finalize(st, self._free, key)
        self._sizes[key] = size
        self.live += size - (old or 0)
        self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
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
            self.track(t)
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

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def bytes(self) -> float:
        return float(self.op_bytes + self.kernel_bytes)

    def roofline(self) -> dict:
        """The reference's roofline terms for one card: compute seconds
        (each dtype's FLOPs at its peak rate), memory seconds (bytes at
        the HBM rate), collective seconds (0 on one card), the dominant
        term and the bound, the largest of them."""
        t_comp = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS_F32)
                     for dt, f in self.flops_by_dtype.items())
        t_mem = self.bytes / HBM_BW
        terms = (("compute", t_comp), ("memory", t_mem), ("collective", 0.0))
        return {"compute_s": t_comp, "memory_s": t_mem, "collective_s": 0.0,
                "dominant": max(terms, key=lambda kv: kv[1])[0],
                "bound_s": max(t_comp, t_mem)}


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


def meter(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters and return
    ``(result, StepCost)``.  On meta tensors the hand kernels' wrappers
    record their launches instead of launching (nothing reaches a card),
    and the attention backward is replayed after its first call of each
    signature; on CPU tensors the wrappers take their plain versions and
    everything runs, as always."""
    from ..analysis.capture import captured_launches
    from ..kernels import flash_attention as fa
    mode, sink = _Meter(), _KernelSink()
    held = tensors((args, kwargs))
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
    seconds = time.perf_counter() - t0
    arg_keys = {t.untyped_storage()._cdata for t in held}
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors(out)}
    flops = Counter(mode.flops)
    flops.update(sink.flops)
    cost = StepCost(
        flops_by_dtype=dict(flops), op_bytes=mode.nbytes,
        kernel_bytes=sink.nbytes, kernel_flops=sum(sink.flops.values()),
        launches=dict(Counter(r.kernel for r in launches)),
        argument_bytes=arg_bytes,
        output_bytes=sum(v for k, v in outs.items() if k not in arg_keys),
        peak_bytes=mode.peak, ops=mode.ops, seconds=seconds)
    return out, cost


_CACHE: dict = {}
_STATS = {"meter_hits": 0, "meter_misses": 0}


def lower(fn: Callable, args: tuple, *, key: Any) -> StepCost:
    """:func:`meter` of ``fn(*args)``, cached on ``key``: the caller
    supplies it (the dry-run keys on its (arch, shape, layers, flags)
    cell coordinates), as the reference keys its compiled plans.  The
    result is dropped; only the cost is kept."""
    if key in _CACHE:
        _STATS["meter_hits"] += 1
        return _CACHE[key]
    _STATS["meter_misses"] += 1
    _, cost = meter(fn, *args)
    _CACHE[key] = cost
    return cost


def cache_stats() -> dict:
    return dict(_STATS, costs=len(_CACHE))


def clear_caches() -> None:
    _CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0
