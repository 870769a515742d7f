"""Span exporters: JSONL and chrome://tracing — the port's copy of
``src/repro/obs/export.py`` (DESIGN.md §11).

Both formats are round-trippable: ``read_jsonl(to_jsonl(spans, p))`` and
``read_chrome_trace(to_chrome_trace(spans, p))`` recover the span dicts
(chrome traces store timestamps in microseconds; the reader converts
back to seconds).

The chrome format is the ``trace_event`` JSON understood by
chrome://tracing and https://ui.perfetto.dev: a ``traceEvents`` list of
complete events (``ph="X"``, ``ts``/``dur`` in µs) and instant events
(``ph="i"``), with span attrs in ``args``.  Spans are laid out on one
pid, with the ``cat`` string mapped to a tid so each category gets its
own track.
"""
from __future__ import annotations

import json
from typing import List


def _as_dicts(spans) -> List[dict]:
    return [sp if isinstance(sp, dict) else sp.to_dict() for sp in spans]


def to_jsonl(spans, path: str) -> str:
    """One span per line.  Non-JSON attr values degrade to ``str``."""
    with open(path, "w") as fh:
        for sp in _as_dicts(spans):
            fh.write(json.dumps(sp, default=str) + "\n")
    return path


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def to_chrome_trace(spans, path: str) -> str:
    """Write a chrome://tracing ``trace_event`` JSON file."""
    dicts = _as_dicts(spans)
    cats = sorted({sp["cat"] for sp in dicts})
    tid = {cat: i for i, cat in enumerate(cats)}
    events = []
    for sp in dicts:
        ev = {
            "name": sp["name"],
            "cat": sp["cat"],
            "ph": sp["ph"],
            "ts": sp["ts"] * 1e6,
            "pid": 1,
            "tid": tid[sp["cat"]],
            "args": sp.get("attrs", {}),
        }
        if sp["ph"] == "X":
            ev["dur"] = sp["dur"] * 1e6
        elif sp["ph"] == "i":
            ev["s"] = "t"            # instant scope: thread
        events.append(ev)
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
             "args": {"name": cat}} for cat, t in tid.items()]
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh, default=str)
    return path


def read_chrome_trace(path: str) -> List[dict]:
    """Read back spans written by :func:`to_chrome_trace` (metadata
    events are dropped; µs convert back to seconds)."""
    with open(path) as fh:
        doc = json.load(fh)
    out = []
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M":
            continue
        out.append({
            "name": ev["name"],
            "cat": ev["cat"],
            "ph": ev["ph"],
            "ts": ev["ts"] / 1e6,
            "dur": ev.get("dur", 0.0) / 1e6,
            "attrs": ev.get("args", {}),
        })
    return out
