"""Record kernel launches without running the kernels.

The race detector needs each kernel's launch geometry exactly as its
wrapper computes it for a given shape.  Rather than re-derive that logic
here (which would drift), the real wrapper runs on ``device="meta"``
tensors with the launch funnel ``kernels._build.launch`` swapped for a
recorder — the counterpart of the reference's swap of ``pallas_call``
(``src/repro/analysis/capture.py``).  The recorder keeps every
:class:`~repro_torch.kernels._build.Launch` record and calls nothing: no
library is built or loaded, nothing reaches a card, and the launch counts
are left as they were.

A meta tensor has no storage, so ``data_ptr()`` is its offset times its
item size: a fresh tensor takes a wrapper's aligned branch, a view at an
odd offset its unaligned one.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator

from ..kernels import _build


def capturing() -> bool:
    """True inside :func:`captured_launches`."""
    return "meta" in _build.ACCEPTED


@contextmanager
def captured_launches() -> Iterator[list]:
    """Swap the launch funnel for a recorder within the block; the real
    funnel, the accepted devices and the launch counts come back on exit,
    also when the block raises."""
    records: list = []

    def record(spec, entry, *args):
        if type(spec) is _build.Launch:
            records.append(spec)
        else:
            records.extend(spec)

    real, accepted = _build.launch, _build.ACCEPTED
    counts = dict(_build.LAUNCHES)
    _build.launch = record
    _build.ACCEPTED = ("cuda", "meta")
    try:
        yield records
    finally:
        _build.launch, _build.ACCEPTED = real, accepted
        _build.LAUNCHES.update(counts)


def capture_kernel(fn: Callable, *meta_tensors, **kwargs) -> list:
    """Run the wrapper ``fn`` on meta tensors and return every launch
    record it made, in order (``prefix_positions`` makes three:
    ``tile_reduce``, ``scan_tile_sums``, ``tile_scan``)."""
    with captured_launches() as records:
        fn(*meta_tensors, **kwargs)
    return records


def kernel_basename(name: str) -> str:
    """``void (anonymous namespace)::flash_fwd<float, 64>((anonymous
    namespace)::Params)`` -> ``flash_fwd``: the ``__global__`` function's
    own name in a profiler's kernel event."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]


def profiled_launches(trace: dict, kernels) -> list:
    """The launches of a chrome trace (``torch.profiler``'s
    ``export_chrome_trace``) of the kernels named in ``kernels``, in the
    order they ran: ``(kernel, grid, block)`` with 3-tuples from each
    event's ``args``.  Kernels of PyTorch's own are left out."""
    events = [e for e in trace.get("traceEvents", ())
              if e.get("cat") == "kernel"
              and kernel_basename(e.get("name", "")) in kernels]
    events.sort(key=lambda e: e["ts"])
    return [(kernel_basename(e["name"]), tuple(e["args"]["grid"]),
             tuple(e["args"]["block"])) for e in events]
