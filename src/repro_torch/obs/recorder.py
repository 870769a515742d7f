"""Process-global span recorder — the port's copy of
``src/repro/obs/recorder.py`` (DESIGN.md §11).

A :class:`Recorder` collects :class:`Span` records — named, categorized
wall-time intervals with free-form JSON-serializable attributes.  The
engines' shared ``EngineBase._dispatch`` emits one span per counted
dispatch (engine family, plan signature, build-vs-execute phase); drivers
add their own structural spans (the SCC driver's generations); the kernel
wrappers add one instant event per call (:func:`note_kernel`).

The process-global recorder is **disabled** by default: ``span()`` on a
disabled recorder is a no-op context and ``add``/``instant`` return
immediately, so un-observed runs pay one attribute read per dispatch.
Install an enabled recorder for a scope with::

    with obs.recording() as rec:
        engine.run()
    rec.to_chrome_trace("trace.json")        # chrome://tracing
    rec.to_jsonl("spans.jsonl")              # one span per line

Timestamps are ``time.perf_counter`` seconds relative to the recorder's
epoch (its construction time).  A span's wall time is the host's: the
port's fixpoints end in a host sync, so a dispatch span covers its device
work too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

from . import export as _export
from . import metrics as _metrics
from . import profile as _profile


@dataclasses.dataclass
class Span:
    """One recorded interval (``ph="X"``) or instant event (``ph="i"``).

    ts/dur are seconds relative to the owning recorder's epoch; exporters
    convert to microseconds (the chrome ``trace_event`` unit).
    """

    name: str
    cat: str = "span"
    ts: float = 0.0
    dur: float = 0.0
    ph: str = "X"
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "ph": self.ph,
                "ts": self.ts, "dur": self.dur, "attrs": dict(self.attrs)}


class Recorder:
    """Span collector.  Construct enabled; the module-global default is a
    disabled instance (see :func:`get_recorder`)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: List[Span] = []
        self.epoch = time.perf_counter()

    def clear(self) -> None:
        self.spans = []
        self.epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **attrs):
        """Context manager timing its body.  Yields the mutable
        :class:`Span` (attrs may be filled in from inside the body);
        yields ``None`` and records nothing when disabled."""
        if not self.enabled:
            yield None
            return
        sp = Span(name=name, cat=cat,
                  ts=time.perf_counter() - self.epoch, attrs=dict(attrs))
        try:
            yield sp
        finally:
            sp.dur = (time.perf_counter() - self.epoch) - sp.ts
            self.spans.append(sp)

    def add(self, name: str, cat: str = "span", *, ts: float, dur: float,
            **attrs) -> Optional[Span]:
        """Record an already-measured interval (``ts`` in perf_counter
        seconds, absolute — converted to the recorder's epoch)."""
        if not self.enabled:
            return None
        sp = Span(name=name, cat=cat, ts=ts - self.epoch, dur=dur,
                  attrs=dict(attrs))
        self.spans.append(sp)
        return sp

    def instant(self, name: str, cat: str = "instant",
                **attrs) -> Optional[Span]:
        if not self.enabled:
            return None
        sp = Span(name=name, cat=cat, ph="i",
                  ts=time.perf_counter() - self.epoch, attrs=dict(attrs))
        self.spans.append(sp)
        return sp

    # -- queries -----------------------------------------------------------
    def select(self, name: Optional[str] = None, cat: Optional[str] = None,
               **attrs) -> List[Span]:
        """Spans matching every given criterion (attrs match by
        equality on ``span.attrs``)."""
        out = []
        for sp in self.spans:
            if name is not None and sp.name != name:
                continue
            if cat is not None and sp.cat != cat:
                continue
            if any(sp.attrs.get(k) != v for k, v in attrs.items()):
                continue
            out.append(sp)
        return out

    def total(self, name: Optional[str] = None, cat: Optional[str] = None,
              **attrs) -> float:
        """Summed duration (seconds) of the matching spans."""
        return sum(sp.dur for sp in self.select(name, cat, **attrs))

    # -- exporters ---------------------------------------------------------
    def to_jsonl(self, path: str) -> str:
        return _export.to_jsonl(self.spans, path)

    def to_chrome_trace(self, path: str) -> str:
        return _export.to_chrome_trace(self.spans, path)

    def __repr__(self):
        state = "enabled" if self.enabled else "disabled"
        return f"Recorder({state}, spans={len(self.spans)})"


class TeeRecorder(Recorder):
    """Records into a ``primary`` recorder while forwarding every event
    to additional target recorders.

    This is how nested :func:`recording` scopes compose: the inner scope
    installs a tee over (inner, outer) so the inner recorder sees only
    its own scope while the outer recorder's timeline stays gap-free.
    Queries and exporters read the primary's spans; each target gets a
    copy stamped against its own epoch.
    """

    def __init__(self, primary: Recorder, *others: Recorder):
        self.primary = primary
        self.others = tuple(others)
        self.enabled = True

    @property
    def epoch(self) -> float:
        return self.primary.epoch

    @property
    def spans(self) -> List[Span]:
        return self.primary.spans

    def clear(self) -> None:
        self.primary.clear()

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **attrs):
        t0 = time.perf_counter()
        sp = Span(name=name, cat=cat, ts=t0 - self.primary.epoch,
                  attrs=dict(attrs))
        try:
            yield sp
        finally:
            sp.dur = time.perf_counter() - t0
            self.primary.spans.append(sp)
            for rec in self.others:
                # attrs may have been filled in from inside the body;
                # forward the final contents.
                rec.add(sp.name, sp.cat, ts=t0, dur=sp.dur, **sp.attrs)

    def add(self, name: str, cat: str = "span", *, ts: float, dur: float,
            **attrs) -> Optional[Span]:
        sp = self.primary.add(name, cat, ts=ts, dur=dur, **attrs)
        for rec in self.others:
            rec.add(name, cat, ts=ts, dur=dur, **attrs)
        return sp

    def instant(self, name: str, cat: str = "instant",
                **attrs) -> Optional[Span]:
        t0 = time.perf_counter()
        sp = self.primary.add(name, cat, ts=t0, dur=0.0, **attrs)
        if sp is not None:
            sp.ph = "i"
        for rec in self.others:
            isp = rec.add(name, cat, ts=t0, dur=0.0, **attrs)
            if isp is not None:
                isp.ph = "i"
        return sp

    def __repr__(self):
        return (f"TeeRecorder(primary={self.primary!r}, "
                f"others={len(self.others)})")


_GLOBAL = Recorder(enabled=False)


def get_recorder() -> Recorder:
    """The process-global recorder (disabled unless one was installed)."""
    return _GLOBAL


def set_recorder(rec: Recorder) -> Recorder:
    """Install ``rec`` as the process-global recorder; returns the
    previous one (so callers can restore it)."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = rec
    return prev


@contextlib.contextmanager
def recording(recorder: Optional[Recorder] = None, *, tee: bool = True):
    """Install an enabled recorder for the scope of the ``with`` block and
    restore the previous global on exit (exception-safe).  Yields the
    recorder.

    Nested scopes compose: when an enabled recorder is already installed
    and ``tee=True`` (the default), the scope installs a
    :class:`TeeRecorder` so spans land in *both* the new recorder and
    the enclosing one.  Pass ``tee=False`` for last-wins isolation (the
    outer recorder sees a gap for the inner scope's duration).
    """
    rec = Recorder() if recorder is None else recorder
    prev = get_recorder()
    if tee and prev.enabled and prev is not rec:
        set_recorder(TeeRecorder(rec, prev))
    else:
        set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)


def span(name: str, cat: str = "span", **attrs):
    """``get_recorder().span(...)`` — a no-op context when disabled."""
    return _GLOBAL.span(name, cat=cat, **attrs)


def instant(name: str, cat: str = "instant", **attrs):
    return _GLOBAL.instant(name, cat=cat, **attrs)


def note_kernel(kernel: str, path: str, args=(), out=None) -> None:
    """One call of a kernel wrapper (``kernels/ops.py``): an instant event
    (cat ``"kernel"``) when a recorder is enabled, one count of
    ``repro_kernel_calls{kernel=,path=}`` when the plane is, and the call
    (``args``, ``out``) inside :func:`~repro_torch.obs.profile.capturing`.  ``path`` is
    ``"cuda"`` where the wrapper launched its kernel (these calls equal
    ``ops.LAUNCHES``) and ``"plain"`` where a CPU tensor took the plain
    version.  The reference notes kernel choices at trace time
    (``repro_kernel_traces``); the port traces nothing, so it counts
    calls."""
    if _GLOBAL.enabled:
        _GLOBAL.instant(kernel, cat="kernel", path=path)
    if _profile._SINKS:
        _profile.note_call(kernel, args, out)
    plane = _metrics.get_plane()
    if plane.enabled:
        plane.counter(
            "repro_kernel_calls",
            "kernel wrapper calls by path (cuda: a launch of the "
            "hand-written kernel; plain: its PyTorch version on the CPU)",
        ).inc(kernel=kernel, path=path)
