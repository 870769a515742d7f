"""The traced run's readings: host syncs by torch's sync debug mode, and
device time from ``torch.profiler`` (CUPTI) over a few calls.

Harness spans (``torch.profiler.record_function`` named ``trimbench.*``)
mark plan, warm-up, each call and each synchronise.  The traced window
runs from the first call's start to the last synchronise's end; its idle
gaps are the stretches with no device item, each named by the harness
span and the outermost torch op the host was inside when the device ran
dry (``python`` when it was between ops).
"""
from __future__ import annotations

import contextlib
import re
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

SYNC_WARNING = "called a synchronizing CUDA operation"
#: spin kernels and a pause before a profile's first real item: the
#: profiler has been seen to lose up to ~20 of the first device items
#: after it starts
PROFILE_WARMUP = 64
PROFILE_SETTLE_S = 0.02
SPIN = "spin_kernel"
TOP = 10
NAME_CHARS = 120


def span(name: str):
    """A harness span, seen by the profiler as a CPU event."""
    return torch.profiler.record_function(f"trimbench.{name}")


def count_syncs(fn, calls: int) -> float:
    """Host syncs a call of ``fn`` makes, over ``calls`` calls."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in rec) / calls


@contextlib.contextmanager
def profiled():
    """``torch.profiler.profile`` of the CPU and the card, entered once it
    records the card's items (see ``PROFILE_WARMUP``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        yield prof


def short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS]


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _annotation(event) -> bool:
    """A span's shadow on the device timeline (``record_function`` marks
    its interval there too), not a device item."""
    return (getattr(event, "is_user_annotation", False)
            or event.name.startswith("trimbench."))


class Profile:
    """The readings of one profile.

    ``items``: (name, start_us, end_us) of each device item in the traced
    window; ``busy_s`` their union; ``window_s`` the traced window;
    ``gaps``: (name, seconds) of each idle stretch in it."""

    def __init__(self, prof):
        dev_t = torch.autograd.DeviceType.CUDA
        events = list(prof.events())
        host = [e for e in events if e.device_type != dev_t]
        calls = [e for e in host if e.name == "trimbench.call"]
        syncs = [e for e in host if e.name == "trimbench.sync"]
        self.items, self.gaps = [], []
        self.busy_s = self.window_s = 0.0
        if not calls or not syncs:
            return
        lo = min(e.time_range.start for e in calls)
        hi = max(e.time_range.end for e in syncs)
        self.window_s = (hi - lo) / 1e6
        self.items = [(e.name, max(e.time_range.start, lo),
                       min(e.time_range.end, hi))
                      for e in events if e.device_type == dev_t
                      and not _annotation(e) and SPIN not in e.name
                      and e.time_range.end > lo and e.time_range.start < hi]
        busy = merged((s, e) for _, s, e in self.items)
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        spans = [e for e in host if e.name.startswith("trimbench.")]
        ops = [e for e in host if e.name.startswith("aten::")]
        s_start = np.array([e.time_range.start for e in spans], np.float64)
        s_end = np.array([e.time_range.end for e in spans], np.float64)
        o_start = np.array([e.time_range.start for e in ops], np.float64)
        o_end = np.array([e.time_range.end for e in ops], np.float64)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            self.gaps.append((self._host_at(g0, spans, s_start, s_end, ops,
                                            o_start, o_end), (g1 - g0) / 1e6))

    @staticmethod
    def _host_at(t, spans, s_start, s_end, ops, o_start, o_end) -> str:
        inside = np.nonzero((s_start <= t) & (s_end > t))[0]
        name = (spans[inside[np.argmax(s_start[inside])]].name
                if inside.size else "trimbench.none")
        inside = np.nonzero((o_start <= t) & (o_end > t))[0]
        op = (ops[inside[np.argmin(o_start[inside])]].name
              if inside.size else "python")
        return f"{name.removeprefix('trimbench.')}/{op}"

    def device_ops(self):
        """The device items that took most time, summed by name."""
        total = defaultdict(float)
        for name, s, e in self.items:
            total[short(name)] += (e - s) / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self):
        """The idle time in the traced window, summed by what the host was
        doing when each gap began."""
        total = defaultdict(float)
        for name, seconds in self.gaps:
            total[short(name)] += seconds
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def seconds_in(self, names) -> float:
        """Device seconds of the items whose name holds one of ``names``
        as a whole word (a kernel's name, with or without its
        signature)."""
        if not names:
            return 0.0
        pat = re.compile(r"(?<![A-Za-z0-9_])(?:"
                         + "|".join(map(re.escape, sorted(names)))
                         + r")(?![A-Za-z0-9_])")
        return sum((e - s) / 1e6 for name, s, e in self.items
                   if pat.search(name))
