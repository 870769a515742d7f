"""Observability — the port's counterpart of ``src/repro/obs/``
(DESIGN.md §11, §13).

Four layers, all opt-in and all free of host syncs when off:

* **per-round fixpoint stats** (``obs.stats``) — a plan built with
  ``instrument=True`` records frontier size, edges traversed, counter
  decrements and the sparse-round flag of every round into ``(R,)``
  int32 buffers on the card, attached to each result as
  ``round_stats``.  ``instrument=False`` records nothing: the same
  results, the same kernel calls, the same host syncs.
* **host spans** (``obs.recorder``) — every counted dispatch of an
  engine is one span (family, plan signature, ``"build+execute"`` when
  ``kernels/_build.py`` compiled a library during it, else
  ``"execute"``), the SCC driver adds one per generation, and each
  kernel wrapper call an instant event.  The global recorder is
  disabled until :func:`recording` installs one.
* **metrics** (``obs.metrics``, ``obs.memory``, ``obs.profile``) — the
  process-global :class:`MetricsPlane`: dispatch, round and work
  counters, live-buffer bytes per engine, the allocator's bytes, and the
  hand-written kernels' cost of a plan's first dispatch; OpenMetrics
  exposition and a JSON snapshot.  Disabled until
  :func:`collecting_metrics` installs one.
* **exporters** (``obs.export``) — JSONL (one span per line) and
  chrome://tracing JSON, both round-trippable.

Metric names that mean what the reference's mean keep its names; the
others are named for what the port measures (``repro_kernel_calls``,
``repro_plan_builds``, ``repro_rebuild_storms``,
``repro_dispatch_wall_seconds``, ``repro_plan_kernel_flops`` and
``_bytes``, ``repro_cuda_memory_bytes``; see each module).
"""
from .export import (read_chrome_trace, read_jsonl, to_chrome_trace,
                     to_jsonl)
from .memory import (array_nbytes, device_memory_stats, engine_nbytes,
                     publish_device_memory, publish_engine_memory)
from .metrics import (LABEL_CARDINALITY_CAP, RETRACE_STORM_THRESHOLD,
                      MetricsPlane, MetricsServer, RetraceStormWarning,
                      SLOTracker, collecting_metrics, get_plane,
                      load_snapshot, log_buckets, parse_openmetrics,
                      set_plane)
from .profile import (kernel_cost, plan_cost, plan_cost_of,
                      record_plan_cost)
from .recorder import (Recorder, Span, TeeRecorder, get_recorder, instant,
                       note_kernel, recording, set_recorder, span)
from .stats import (MAX_ROUND_SLOTS, RoundBuffers, RoundStats,
                    finish_rows, round_capacity, stats_init, stats_record)

__all__ = [
    "Recorder", "Span", "TeeRecorder", "get_recorder", "set_recorder",
    "recording", "span", "instant", "note_kernel",
    "MAX_ROUND_SLOTS", "RoundBuffers", "RoundStats", "round_capacity",
    "stats_init", "stats_record", "finish_rows",
    "MetricsPlane", "MetricsServer", "SLOTracker", "RetraceStormWarning",
    "LABEL_CARDINALITY_CAP", "RETRACE_STORM_THRESHOLD", "get_plane",
    "set_plane", "collecting_metrics", "load_snapshot", "log_buckets",
    "parse_openmetrics",
    "array_nbytes", "device_memory_stats", "engine_nbytes",
    "publish_engine_memory", "publish_device_memory",
    "kernel_cost", "plan_cost", "plan_cost_of", "record_plan_cost",
    "to_jsonl", "read_jsonl", "to_chrome_trace", "read_chrome_trace",
]
