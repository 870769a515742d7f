"""Kernel registry: (engine family, method name) -> :class:`KernelSpec`
(PyTorch port of ``src/repro/core/registry.py``).

Each algorithm module (``ac3.py``, ``ac4.py``, ``ac6.py``) registers its
spec at import time under family ``"trim"``; ``core/engine.py`` resolves a
method name once at plan time.  A trim spec's ``run`` adapter has one
signature, so every method is interchangeable::

    run(graph_arrays, transpose_arrays, worker_ids, workers, active, *,
        probe, window, counters, frontier)
      -> (status, rounds, per_worker, max_qp)

with ``graph_arrays = (indptr, indices)``, ``transpose_arrays =
(t_indptr, t_indices, t_rows)`` for methods with ``needs_transpose``
(``None`` otherwise), ``rounds``/``max_qp`` 0-d int32 tensors and
``per_worker`` (P,) int32 — the last two ``None`` when ``counters=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel method.

    name:              public method name ("ac3", "ac4", "ac4*", "ac6")
    run:               uniform adapter (see the module docstring)
    needs_transpose:   reads Gᵀ arrays
    supports_windowed: honors the windowed-probe backend (AC-4 never
                       probes, so the windowed backend runs it as dense)
    supports_frontier: honors the sparse-frontier substrate; AC-3 has no
                       sparse set to compact, so ``frontier="sparse"``
                       raises for it and ``"auto"`` degrades to dense
    """

    name: str
    run: Callable
    needs_transpose: bool = False
    supports_windowed: bool = False
    supports_frontier: bool = True


_REGISTRY: dict[tuple[str, str], KernelSpec] = {}


def register_kernel(spec: KernelSpec, family: str = "trim") -> KernelSpec:
    key = (family, spec.name)
    if key in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered in "
                         f"family {family!r}")
    _REGISTRY[key] = spec
    return spec


def get_kernel(name: str, family: str = "trim") -> KernelSpec:
    try:
        return _REGISTRY[(family, name)]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; expected one of "
                         f"{available_methods(family)}") from None


def available_methods(family: str = "trim") -> tuple[str, ...]:
    return tuple(sorted(n for f, n in _REGISTRY if f == family))
