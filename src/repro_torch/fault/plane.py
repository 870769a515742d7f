"""Process-global FaultPlane (DESIGN.md §14; the port's own copy of
``src/repro/fault/plane.py``), on the MetricsPlane pattern.

A :class:`FaultPlane` owns a :class:`~repro_torch.fault.schedule.
FaultSchedule` and exposes the one method the instrumented sites call,
:meth:`FaultPlane.arm`.  The default global plane is **disabled**: every
site reads one ``plane.enabled`` attribute and does nothing else, so
runs without injection are bit-identical to runs without the plane
(``tests/test_torch_fault.py``).

When an armed point fires, ``arm`` raises the injected
:class:`~repro_torch.fault.schedule.DeviceFault` or :class:`IOFault`
and, while the process-global MetricsPlane is enabled, bumps
``repro_faults_injected``.  Recovery code reports back through
:meth:`FaultPlane.record_recovery`, which feeds ``repro_recoveries``.

Install a plane for a scope with :func:`injecting_faults`::

    with injecting_faults(FaultSchedule(seed=7, at={"pre-dispatch": [2]})):
        engine.run()        # the second dispatch raises DeviceFault
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Optional, Union

from .schedule import FAULT_POINTS, FaultSchedule, fault_kind


class FaultPlane:
    """Fault-injection control plane: per-point arming counters and the
    schedule that decides which armings fire.  ``enabled`` is False when
    constructed without a schedule (the default global plane)."""

    def __init__(self, schedule: Optional[FaultSchedule] = None):
        self.schedule = schedule
        self.enabled = schedule is not None
        self.armings: Counter = Counter()      # point -> times armed
        self.injected: Counter = Counter()     # point -> faults fired
        self.recoveries: Counter = Counter()   # (point, strategy) -> count

    def arm(self, point: str, **ctx) -> None:
        """Count one arming of ``point``; raise the injected fault when
        the schedule says this arming fires.  ``ctx`` (family, dispatch
        seq, ...) rides on the exception as ``.ctx``."""
        if not self.enabled:
            return
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; expected "
                             f"one of {FAULT_POINTS}")
        self.armings[point] += 1
        count = self.armings[point]
        if self.schedule.should_fire(point, count):
            self.injected[point] += 1
            exc = fault_kind(point)(point, count)
            exc.ctx = dict(ctx)
            self._publish_fault(point, type(exc).__name__)
            raise exc

    def record_recovery(self, point: str, strategy: str) -> None:
        """Report one successful recovery from a fault at ``point`` by
        ``strategy`` ("retry", "restore", "restart", "skip").  Counts on
        the disabled plane too; publishes while the MetricsPlane is on."""
        self.recoveries[(point, strategy)] += 1
        from .. import obs
        mp = obs.get_plane()
        if mp.enabled:
            mp.counter(
                "repro_recoveries",
                "successful recoveries from (injected or real) faults, "
                "by fault point and recovery strategy",
            ).inc(point=point, strategy=strategy)

    def _publish_fault(self, point: str, kind: str) -> None:
        from .. import obs
        mp = obs.get_plane()
        if mp.enabled:
            mp.counter(
                "repro_faults_injected",
                "faults injected by the FaultPlane, by fault point and "
                "exception kind",
            ).inc(point=point, kind=kind)

    def snapshot(self) -> dict:
        """JSON-able view of the plane's counters."""
        return {
            "enabled": self.enabled,
            "schedule": self.schedule.describe() if self.schedule else None,
            "armings": dict(self.armings),
            "injected": dict(self.injected),
            "recoveries": {f"{p}/{s}": c
                           for (p, s), c in self.recoveries.items()},
        }

    def __repr__(self):
        state = "enabled" if self.enabled else "disabled"
        return (f"FaultPlane({state}, armed={sum(self.armings.values())}, "
                f"injected={sum(self.injected.values())})")


_PLANE = FaultPlane()


def get_fault_plane() -> FaultPlane:
    """The process-global fault plane (disabled unless one was
    installed)."""
    return _PLANE


def set_fault_plane(plane: FaultPlane) -> FaultPlane:
    """Install ``plane`` as the process-global fault plane; returns the
    previous one."""
    global _PLANE
    prev = _PLANE
    _PLANE = plane
    return prev


@contextlib.contextmanager
def injecting_faults(schedule: Optional[Union[FaultSchedule,
                                              FaultPlane]] = None):
    """Install an enabled FaultPlane for the ``with`` block and restore
    the previous global on exit (exception included); yields the plane.
    ``schedule=None`` installs an inert schedule: armed, never firing."""
    if isinstance(schedule, FaultPlane):
        plane = schedule
    else:
        plane = FaultPlane(schedule if schedule is not None
                           else FaultSchedule())
    prev = set_fault_plane(plane)
    try:
        yield plane
    finally:
        set_fault_plane(prev)


__all__ = ["FaultPlane", "get_fault_plane", "set_fault_plane",
           "injecting_faults"]
