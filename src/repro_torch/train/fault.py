"""Straggler detection for the trainer (the ``StragglerMonitor`` of
``src/repro/train/fault.py``): rolling per-step timing; flags steps slower
than ``threshold x`` the rolling median, and escalates after ``patience``
consecutive flags.

Not ported: ``ElasticManager`` (mesh rebuilds and checkpoint replay,
ROADMAP A6 and A8).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.times: deque[float] = deque(maxlen=window)
        self._consecutive = 0
        self.flagged_steps: list[int] = []
        self._step = 0
        self._t0: float | None = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self) -> str:
        """Returns action: 'ok' | 'warn' | 'escalate'."""
        dt = time.perf_counter() - self._t0
        self._step += 1
        return self.observe(dt)

    def observe(self, step_time: float) -> str:
        median = float(np.median(self.times)) if len(self.times) >= 5 else None
        self.times.append(step_time)
        if median is None:
            return "ok"
        if step_time > self.threshold * median:
            self._consecutive += 1
            self.flagged_steps.append(self._step)
            if self._consecutive >= self.patience:
                self._consecutive = 0
                return "escalate"
            return "warn"
        self._consecutive = 0
        return "ok"

    @property
    def median(self) -> float | None:
        return float(np.median(self.times)) if self.times else None
