"""Core library of the PyTorch port: parallel graph trimming by
arc-consistency (AC-3, AC-4, AC-4*, AC-6), plus its flagship application
(SCC decomposition, ``core.scc``), k-core peeling and incremental
trimming over edge-update batches, through the plan-once engine
families::

    from repro_torch.core import plan, plan_reach, plan_peel, plan_stream
    engine = plan(graph, method="ac6", backend="dense", workers=16)
    result = engine.run(active=mask)
    reach  = plan_reach(graph).run(seeds=pivot, active=mask)
    peel   = plan_peel(graph).run()          # full out-degree coreness
    stream = plan_stream(graph)              # then .apply(deletions=...)

``trim()`` remains as a one-shot convenience shim.
"""
from .engine import BACKENDS, TrimEngine, plan
from .graph import CSRGraph, DeltaCSR, TrimResult, resolve_device, \
    worker_of
from .peel import PeelEngine, PeelResult, coreness_oracle, plan_peel
from .reach import REACH_BACKENDS, ReachEngine, ReachResult, plan_reach
from .ref import complete, peeling_alpha as peeling_alpha_oracle, sound, \
    trim_oracle
from .registry import KernelSpec, available_methods, get_kernel, \
    register_kernel
from .stream import STREAM_BACKENDS, StreamEngine, StreamResult, plan_stream
from .trim import METHODS, peeling_alpha, trim

__all__ = [
    "CSRGraph", "TrimResult", "worker_of", "resolve_device", "trim",
    "METHODS", "plan", "TrimEngine", "BACKENDS",
    "plan_reach", "ReachEngine", "ReachResult", "REACH_BACKENDS",
    "plan_peel", "PeelEngine", "PeelResult", "coreness_oracle",
    "plan_stream", "StreamEngine", "StreamResult", "STREAM_BACKENDS",
    "DeltaCSR",
    "KernelSpec", "register_kernel", "get_kernel", "available_methods",
    "trim_oracle", "sound", "complete", "peeling_alpha",
    "peeling_alpha_oracle",
]
