"""Memory accounting for the MetricsPlane — the port's counterpart of
``src/repro/obs/memory.py`` (DESIGN.md §13).

Every engine owns long-lived buffers — the graph arrays, a cached
transpose, plan caches (worker ids, row ids, the pull tile), and for the
stream engine the whole ``DeltaCSR`` overlay.  This module turns them
into byte gauges without syncing the card: a tensor's bytes are
``numel * element_size`` and a numpy array's ``nbytes``, read from the
shape and dtype alone.

Two sources:

* **engine accounting** — the ``nbytes_breakdown()`` protocol of
  :class:`~repro_torch.core.enginebase.EngineBase` (each family lists
  its live components), published as
  ``repro_engine_live_bytes{family=...,component=...}``;
* **allocator accounting** — ``torch.cuda.memory_stats`` of each card
  (:func:`device_memory_stats`; nothing on a machine without one),
  published as ``repro_cuda_memory_bytes{device=...,key=...}``.  The
  reference's ``repro_device_memory_bytes`` carries XLA's allocator
  stats, whose keys differ.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def array_nbytes(tree) -> int:
    """Total bytes of every tensor or numpy array in ``tree`` (a tensor,
    an array, a dataclass such as ``CSRGraph``, or a tuple/list/dict of
    them), from shape and dtype only — no sync.  Anything else (ints,
    None, strings) adds 0."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(array_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(array_nbytes(v) for v in tree)
    fields = getattr(tree, "__dataclass_fields__", None)
    if fields:
        return sum(array_nbytes(getattr(tree, f)) for f in fields)
    return 0


#: the allocator stats kept: byte totals over all pools (20 keys), so the
#: gauge family stays under the plane's label cap
_ALLOC_KEYS = ("allocated_bytes", "reserved_bytes", "active_bytes",
               "inactive_split_bytes", "requested_bytes")


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:i": {stat: bytes}}`` from ``torch.cuda.memory_stats`` of
    every visible card: the ``.all.`` byte totals (current, peak,
    allocated, freed).  Empty without a card; never raises."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            continue
        kept = {k: int(v) for k, v in stats.items()
                if k.split(".")[0] in _ALLOC_KEYS and ".all." in k}
        if kept:
            out[f"cuda:{i}"] = kept
    return out


def engine_nbytes(engine) -> Dict[str, int]:
    """The engine's live-buffer breakdown via its ``nbytes_breakdown()``
    protocol (zero-byte components dropped)."""
    return {k: v for k, v in engine.nbytes_breakdown().items() if v}


def publish_engine_memory(plane, engine) -> None:
    """Set the per-component live-buffer gauges for one engine."""
    fam = plane.gauge(
        "repro_engine_live_bytes",
        "live device/host buffer bytes held by an engine, by component "
        "(numel x element size; no device sync)")
    total = 0
    for component, nbytes in engine.nbytes_breakdown().items():
        fam.set(nbytes, family=engine.family, component=component)
        total += nbytes
    fam.set(total, family=engine.family, component="total")


def publish_device_memory(plane) -> None:
    """Set the allocator gauges of every card (a no-op without one)."""
    stats = device_memory_stats()
    if not stats:
        return
    fam = plane.gauge("repro_cuda_memory_bytes",
                      "torch.cuda.memory_stats byte totals by card")
    for device, kv in stats.items():
        for key, v in kv.items():
            fam.set(v, device=device, key=key)


__all__ = ["array_nbytes", "device_memory_stats", "engine_nbytes",
           "publish_engine_memory", "publish_device_memory"]
