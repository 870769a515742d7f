"""FaultPlane: checkpoint/resume and deterministic fault injection
(DESIGN.md §14) — the port of ``src/repro/fault/``.

A process-global, disabled-by-default plane the engines arm at named
fault points (``pre-dispatch`` and ``post-dispatch`` in every counted
dispatch, ``mid-update-batch`` in ``StreamEngine.apply``,
``checkpoint-write`` before a checkpoint's bytes move,
``metrics-server`` in each scrape), a seeded replayable
:class:`~repro_torch.fault.schedule.FaultSchedule`, bounded-backoff
:func:`~repro_torch.fault.retry.call_with_retries`, and engine
checkpoint/restore over ``train/checkpoint.py``'s manifest writer
(``save_engine``, ``restore_engine(ckpt_dir, step=None, device=...)``).

The checkpoint helpers are loaded lazily, so importing the plane from the
engines' dispatch path does not import the train package.
"""
from .plane import (FaultPlane, get_fault_plane, injecting_faults,
                    set_fault_plane)
from .retry import backoff_delay, call_with_retries
from .schedule import (FAULT_POINTS, IO_POINTS, DeviceFault, FaultSchedule,
                       IOFault, fault_kind)

_CKPT_EXPORTS = ("save_tree", "save_engine", "engine_from_state",
                 "restore_engine")


def __getattr__(name):
    if name in _CKPT_EXPORTS:
        from . import ckpt
        return getattr(ckpt, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FaultPlane", "get_fault_plane", "set_fault_plane", "injecting_faults",
    "FaultSchedule", "DeviceFault", "IOFault", "fault_kind",
    "FAULT_POINTS", "IO_POINTS",
    "call_with_retries", "backoff_delay",
    *_CKPT_EXPORTS,
]
