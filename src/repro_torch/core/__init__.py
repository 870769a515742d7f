"""Core library of the PyTorch port: parallel graph trimming by
arc-consistency (AC-3, AC-4, AC-4*, AC-6) through the plan-once engine::

    from repro_torch.core import plan
    engine = plan(graph, method="ac6", backend="dense", workers=16)
    result = engine.run(active=mask)

``trim()`` remains as a one-shot convenience shim.
"""
from .engine import BACKENDS, TrimEngine, plan
from .graph import CSRGraph, TrimResult, resolve_device, worker_of
from .ref import complete, peeling_alpha as peeling_alpha_oracle, sound, \
    trim_oracle
from .registry import KernelSpec, available_methods, get_kernel, \
    register_kernel
from .trim import METHODS, peeling_alpha, trim

__all__ = [
    "CSRGraph", "TrimResult", "worker_of", "resolve_device", "trim",
    "METHODS", "plan", "TrimEngine", "BACKENDS",
    "KernelSpec", "register_kernel", "get_kernel", "available_methods",
    "trim_oracle", "sound", "complete", "peeling_alpha",
    "peeling_alpha_oracle",
]
