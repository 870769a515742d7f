"""Bounded exponential-backoff retry around fault-prone calls (the port's
own copy of ``src/repro/fault/retry.py``).

:func:`call_with_retries` retries a ``DeviceFault`` or ``IOFault`` with
exponential backoff up to a hard bound; a retried call that succeeds
reports a ``"retry"`` recovery to the FaultPlane (``repro_recoveries``).
Past the bound the fault re-raises: the caller restores from a
checkpoint or fails.

Only wrap calls that are safe to re-execute: engine runs (trim, reach,
peel, ``retrim(full=True)``) and code that has not committed host state.
A ``StreamEngine.apply`` past its ``mid-update-batch`` point has resolved
its batch against the host mirrors and is not retry-safe: recover it by
restoring the latest checkpoint and re-applying (DESIGN.md §14).
"""
from __future__ import annotations

import time

from .plane import get_fault_plane
from .schedule import DeviceFault, IOFault


def backoff_delay(attempt: int, *, base: float = 0.05,
                  cap: float = 2.0) -> float:
    """Delay before retry ``attempt`` (0-based): ``base * 2**attempt``,
    capped."""
    return min(cap, base * (2 ** attempt))


def call_with_retries(fn, *, retries: int = 3, base_delay: float = 0.05,
                      max_delay: float = 2.0,
                      retry_on=(DeviceFault, IOFault),
                      sleep=time.sleep, on_retry=None):
    """Call ``fn()``; on a ``retry_on`` exception back off and retry, at
    most ``retries`` times (``retries + 1`` calls), then re-raise.
    ``sleep`` is injectable so tests run without delays;
    ``on_retry(exc, attempt)`` observes each failed attempt."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    last = None
    for attempt in range(retries + 1):
        try:
            out = fn()
        except retry_on as e:
            last = e
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(e, attempt)
            sleep(backoff_delay(attempt, base=base_delay, cap=max_delay))
            continue
        if last is not None:
            get_fault_plane().record_recovery(
                getattr(last, "point", "unknown"), "retry")
        return out


__all__ = ["call_with_retries", "backoff_delay"]
