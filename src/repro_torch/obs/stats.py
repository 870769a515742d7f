"""Per-round fixpoint statistics — the port's counterpart of
``src/repro/obs/stats.py`` (DESIGN.md §11).

When a plan is built with ``instrument=True`` every round of its fixpoint
records a few stats — frontier size, edges traversed, counter decrements,
whether the round took the compacted (sparse) body — into ``(R,)`` int32
buffers on the engine's device, one slot a round.  ``R`` is the pow2
round capacity of :func:`round_capacity`.

The port's fixpoints are driven from the host, so the round index is the
loop's own Python int.  It is clamped to the last slot: a run past the
capacity folds its tail rounds into ``buf[R-1]``, so per-buffer *totals*
stay exact.  Work charged before the loop (AC-4's degree scan) goes to
slot 0.

**No host sync.**  A value the host already holds — ``r_sparse``, or a
frontier count the loop test brought back — goes to a host array and is
never read back.  Any other value is a one-element device tensor (a sum
the round enqueued); :func:`stats_record` only keeps a reference to it.
When the run ends, :meth:`RoundBuffers.finish` concatenates all of them
in one operation and adds each stat's rounds into its buffer slice by
slice (a handful of device items a run, none a round).  :class:`RoundStats` moves the buffers
to numpy only when a query asks, and ``to_dict()`` gives the reference's
document.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

# Default cap on the per-round breakdown: 1024 slots resolve every round
# of the bench families; longer runs fold their tail into the last slot.
MAX_ROUND_SLOTS = 1024


def _pow2(x: int) -> int:
    # local copy (core.graph has one too): obs imports nothing of core
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def round_capacity(n: int, max_rounds: Optional[int] = None) -> int:
    """Round-buffer capacity for an n-vertex fixpoint: ``max_rounds``
    pow2-padded when given, else ``min(n + 2, 1024)`` pow2-padded."""
    if max_rounds is not None:
        if max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        return _pow2(max_rounds)
    return _pow2(min(int(n) + 2, MAX_ROUND_SLOTS))


class RoundBuffers:
    """One run's stats while the host drives its rounds: host-known values
    as ``(row, slot, int)`` and device values as ``(name, slot, tensor)``
    (one element, 0-d or (1,)), both kept as they come until
    :meth:`finish` (a round pays a few list appends)."""

    __slots__ = ("names", "max_rounds", "_host", "_dev", "_row")

    def __init__(self, max_rounds: int, names: Sequence[str]):
        self.names = tuple(names)
        self._row = {name: i for i, name in enumerate(self.names)}
        self.max_rounds = int(max_rounds)
        self._host: list = []
        self._dev: list = []

    def record(self, rnd: int, **values) -> "RoundBuffers":
        slot = min(int(rnd), self.max_rounds - 1)
        for name, v in values.items():
            row = self._row[name]       # KeyError: not a stat of this run
            if isinstance(v, torch.Tensor):
                self._dev.append((name, slot, v))
            else:
                self._host.append((row, slot, v))
        return self

    def finish(self):
        """``(device, host)``: ``{name: (R,) int32 tensor}`` for the stats
        with device values, ``{name: (R,) int64 numpy}`` for all.  One
        concatenation of every device value, one zeroed buffer, then one
        slice add per run of consecutive slots (the overflow slot summed
        apart)."""
        dev: Dict[str, torch.Tensor] = {}
        if self._dev:
            # grouped by stat, so each stat's values are one slice of one
            # concatenation, and each stat one row of one zeroed buffer
            names = [nm for nm in self.names
                     if any(e[0] == nm for e in self._dev)]
            order = [t if t.dim() == 1 else t.reshape(1) for name in names
                     for nm, _, t in self._dev if nm == name]
            vals = torch.cat(order)
            bufs = torch.zeros((len(names), self.max_rounds),
                               dtype=torch.int32, device=vals.device)
            last, lo = self.max_rounds - 1, 0
            for buf, name in zip(bufs, names):
                slots = [slot for nm, slot, _ in self._dev if nm == name]
                for start, a, b in _runs(slots, last):
                    run = vals[lo + a:lo + b]
                    if start == last and b - a > 1:
                        buf[last].add_(run.sum())
                    else:
                        buf[start:start + b - a].add_(run)
                dev[name] = buf
                lo += len(slots)
        host = np.zeros((len(self.names), self.max_rounds), np.int64)
        if self._host:
            rows, slots, vs = zip(*self._host)
            np.add.at(host, (np.asarray(rows), np.asarray(slots)),
                      np.asarray(vs, np.int64))
        return dev, dict(zip(self.names, host))


def _runs(slots, last: int):
    """Split a stat's slots (in recording order) into runs of slots that
    rise by one: ``[(first slot, first index, end index)]``.  Entries in
    the overflow slot ``last`` after it was first reached form one run."""
    runs = []
    for i, slot in enumerate(slots):
        if runs:
            start, a, b = runs[-1]
            if slot == start + b - a or (slot == last and start == last):
                runs[-1] = (start, a, b + 1)
                continue
            if slot == last and start + b - a - 1 == last:
                runs.append((last, i, i + 1))
                continue
        runs.append((slot, i, i + 1))
    return runs


def stats_init(max_rounds: int, names: Sequence[str]) -> RoundBuffers:
    """Empty round buffers for one run: ``(R,)`` per name."""
    return RoundBuffers(max_rounds, names)


def stats_record(bufs: RoundBuffers, rnd: int, **values) -> RoundBuffers:
    """Add ``values`` into round slot ``rnd`` (clamped to the last slot):
    Python ints on the host, one-element tensors kept for
    :meth:`~RoundBuffers.finish`."""
    return bufs.record(rnd, **values)


def finish_rows(rows: Sequence[RoundBuffers], max_rounds: int, names,
                device):
    """Stack B runs' buffers into ``(B, R)`` ``(device, host)`` dicts (a
    stat that some row recorded on the device takes zeros in the rest)."""
    done = [r.finish() for r in rows]
    dev_names = sorted({k for d, _ in done for k in d})
    dev = {}
    for k in dev_names:
        dev[k] = torch.stack([
            d[k] if k in d else torch.zeros((max_rounds,), dtype=torch.int32,
                                            device=device)
            for d, _ in done])
    host = {k: (np.stack([h[k] for _, h in done]) if done
                else np.zeros((0, max_rounds), np.int64)) for k in names}
    return dev, host


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RoundStats:
    """Host-side view of one run's round buffers.

    ``buffers`` maps stat name → ``(R,)`` (or ``(B, R)`` for a batch)
    tensors or arrays; ``host`` optionally adds a host-side part of the
    same shape (the values the host knew).  ``per_worker`` carries the
    per-worker traversed-edge totals ``(workers,)`` (or ``(B, workers)``)
    where the run kept counters.  Device tensors move to numpy on the
    first query.
    """

    def __init__(self, rounds, buffers: Dict[str, object],
                 per_worker=None, max_rounds: Optional[int] = None,
                 host: Optional[Dict[str, np.ndarray]] = None):
        self._rounds = rounds
        self._buffers = dict(buffers)
        self._hostpart = dict(host or {})
        self._per_worker = per_worker
        self._max_rounds = max_rounds
        self._np: Optional[Dict[str, np.ndarray]] = None

    def row(self, i: int) -> "RoundStats":
        """Row ``i`` of a batched run's stats (views, no copy)."""
        def take(d):
            return {k: v[i] for k, v in d.items()}
        return RoundStats(self._rounds[i], take(self._buffers),
                          per_worker=(None if self._per_worker is None
                                      else self._per_worker[i]),
                          max_rounds=self._max_rounds,
                          host=take(self._hostpart))

    # -- materialization ---------------------------------------------------
    def _host(self) -> Dict[str, np.ndarray]:
        if self._np is None:
            out = {}
            for k in self.names:
                acc = None
                for part in (self._buffers.get(k), self._hostpart.get(k)):
                    if part is None:
                        continue
                    arr = _to_numpy(part).astype(np.int64)
                    acc = arr if acc is None else acc + arr
                out[k] = acc.astype(np.int32)
            self._np = out
        return self._np

    @property
    def rounds(self) -> np.ndarray:
        return _to_numpy(self._rounds)

    @property
    def max_rounds(self) -> int:
        if self._max_rounds is not None:
            return self._max_rounds
        return int(next(iter(self._host().values())).shape[-1])

    @property
    def names(self):
        return sorted(set(self._buffers) | set(self._hostpart))

    @property
    def per_worker(self) -> Optional[np.ndarray]:
        if self._per_worker is None:
            return None
        return _to_numpy(self._per_worker)

    @property
    def overflowed(self) -> bool:
        """True when some run took more rounds than the buffer resolves
        (totals are still exact; the tail is folded into the last slot)."""
        return bool(np.any(self.rounds > self.max_rounds))

    # -- queries -----------------------------------------------------------
    def per_round(self, name: str) -> np.ndarray:
        """The ``(R,)`` (or ``(B, R)``) per-round breakdown for a stat."""
        return self._host()[name]

    def total(self, name: str) -> np.ndarray:
        """Exact total over all rounds (summing the clamped buffer)."""
        return self._host()[name].sum(axis=-1)

    def max_worker_edges(self) -> Optional[np.ndarray]:
        if self._per_worker is None:
            return None
        return self.per_worker.max(axis=-1)

    def imbalance(self) -> Optional[np.ndarray]:
        """max/mean per-worker traversed edges — the paper's work-skew
        metric (1.0 = perfectly balanced)."""
        pw = self.per_worker
        if pw is None:
            return None
        mean = pw.mean(axis=-1)
        return pw.max(axis=-1) / np.maximum(mean, 1e-12)

    def to_dict(self) -> dict:
        """JSON-friendly summary (python lists / scalars only), the
        reference's document."""
        d = {
            "rounds": np.asarray(self.rounds).tolist(),
            "max_rounds": self.max_rounds,
            "overflowed": self.overflowed,
            "totals": {k: self.total(k).tolist() for k in self.names},
            "per_round": {k: self.per_round(k).tolist()
                          for k in self.names},
        }
        if self._per_worker is not None:
            d["per_worker"] = self.per_worker.tolist()
            d["max_worker_edges"] = self.max_worker_edges().tolist()
            d["imbalance"] = self.imbalance().tolist()
        return d

    def __repr__(self):
        names = ",".join(self.names)
        return (f"RoundStats(rounds={self.rounds.tolist()}, "
                f"R={self.max_rounds}, stats=[{names}])")


__all__ = ["MAX_ROUND_SLOTS", "round_capacity", "stats_init",
           "stats_record", "finish_rows", "RoundBuffers", "RoundStats"]
