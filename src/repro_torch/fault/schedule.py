"""Deterministic fault schedules (DESIGN.md §14; the port's own copy of
``src/repro/fault/schedule.py``).

A :class:`FaultSchedule` decides, for every arming of a named fault
point, whether an injected fault fires.  Two triggers compose:

* ``at={"pre-dispatch": [3]}`` — fire on exactly the listed armings
  (1-based, counted per point), for chaos tests that need a fault at one
  specific dispatch;
* ``rate=0.05`` — every arming also draws from a per-point RNG stream
  and fires with the given probability, for soak tests.

Determinism is the contract: each point owns its own
``numpy.random.Generator`` seeded from ``(seed, point index)``, so the
decision sequence of one point never depends on how armings of other
points interleave with it, and the same seed gives the same decisions as
the reference's schedule.

Dispatch-path points raise :class:`DeviceFault` (a ``RuntimeError``, the
shape of a real device failure); IO-path points raise :class:`IOFault`
(an ``OSError``).  Both carry ``.point`` and ``.count`` so recovery code
can pick a strategy per fault point.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

#: the named fault points the engines and launchers arm, in the arming
#: order of a serving tick (DESIGN.md §14)
FAULT_POINTS = ("pre-dispatch", "post-dispatch", "mid-update-batch",
                "checkpoint-write", "metrics-server")

#: points whose failures are IO-shaped (every other one is device-shaped)
IO_POINTS = frozenset({"checkpoint-write", "metrics-server"})


class DeviceFault(RuntimeError):
    """Injected device-side failure (lost dispatch, device reset)."""

    def __init__(self, point: str, count: int):
        super().__init__(f"injected DeviceFault at {point!r} "
                         f"(arming #{count})")
        self.point = point
        self.count = count


class IOFault(OSError):
    """Injected IO-side failure (torn checkpoint write, dead scrape)."""

    def __init__(self, point: str, count: int):
        super().__init__(f"injected IOFault at {point!r} (arming #{count})")
        self.point = point
        self.count = count


def fault_kind(point: str):
    """The exception class an injected fault at ``point`` raises."""
    return IOFault if point in IO_POINTS else DeviceFault


class FaultSchedule:
    """Seeded, replayable decision rule for the named fault points.

    seed:       base seed; combined with the point index per stream.
    at:         {point: iterable of 1-based arming counts} — exact fires.
    rate:       per-arming fire probability (0 disables the random path).
    points:     restrict the ``rate`` path to a subset of FAULT_POINTS
                (``at`` entries always apply).
    max_faults: total fire budget across all points (None = unbounded).
    """

    def __init__(self, seed: int = 0, *,
                 at: Optional[Dict[str, Iterable[int]]] = None,
                 rate: float = 0.0,
                 points: Optional[Iterable[str]] = None,
                 max_faults: Optional[int] = None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        for p in list(at or {}) + list(points or []):
            if p not in FAULT_POINTS:
                raise ValueError(f"unknown fault point {p!r}; expected one "
                                 f"of {FAULT_POINTS}")
        self.seed = int(seed)
        self.at = {p: frozenset(int(c) for c in counts)
                   for p, counts in (at or {}).items()}
        self.rate = float(rate)
        self.points = frozenset(points if points is not None
                                else FAULT_POINTS)
        self.max_faults = max_faults
        self.fired = 0
        # one independent stream per point: decisions are a pure function
        # of (seed, point, arming count), never of cross-point interleaving
        self._rngs = {p: np.random.default_rng([self.seed, i])
                      for i, p in enumerate(FAULT_POINTS)}

    def should_fire(self, point: str, count: int) -> bool:
        """Decide arming ``count`` (1-based) of ``point``.  Advances the
        point's RNG stream exactly once a call while the random path is
        live, so replays stay aligned."""
        draw = (self._rngs[point].random()
                if self.rate and point in self.points else 1.0)
        if self.max_faults is not None and self.fired >= self.max_faults:
            return False
        fire = count in self.at.get(point, ()) or draw < self.rate
        if fire:
            self.fired += 1
        return fire

    def describe(self) -> dict:
        """JSON-able summary (checkpoint metadata, logs)."""
        return {"seed": self.seed, "rate": self.rate,
                "at": {p: sorted(c) for p, c in self.at.items()},
                "points": sorted(self.points),
                "max_faults": self.max_faults}

    def __repr__(self):
        return (f"FaultSchedule(seed={self.seed}, rate={self.rate}, "
                f"at={ {p: sorted(c) for p, c in self.at.items()} }, "
                f"fired={self.fired})")


__all__ = ["FAULT_POINTS", "IO_POINTS", "DeviceFault", "IOFault",
           "fault_kind", "FaultSchedule"]
