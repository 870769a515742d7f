"""Host-sync lint over the plan catalog — the port's counterpart of
``src/repro/analysis/purity.py``.

The reference runs each fixpoint as one ``lax.while_loop`` and forbids
host callbacks and transfers inside it.  The port's fixpoints are driven
from the host on purpose, and every sync is marked ``# host sync`` in the
code: one loop test a round (which AC-4, AC-6, reach, peel and the stream
also use to choose the dense or the compacted body), one test per probe
micro-step (``core/common.py`` ``_probe_loop``), and the reach pull's
window-overflow test.  So this lint counts the syncs instead of
forbidding them, and holds each plan to a declared budget
(``PlanEntry``): ``per_round * rounds`` + the probe loops' tests +
``constant``.

**Counting.**  A :class:`SyncCounter` (a ``TorchFunctionMode``) counts
host reads — ``item``, ``__bool__``, ``__int__``, ``__float__``,
``__index__``, ``tolist``, ``cpu`` and ``numpy``, each of which waits for
the card — and host-to-device copies — ``torch.tensor`` / ``as_tensor``
of host data and ``to`` with a change of device — which wait too.  It
sees them on CPU tensors, so the lint runs without a card; on the card
``torch.cuda.set_sync_debug_mode`` counts the same syncs.  The probe
loops' tests are derived independently: a probe loop runs while a row is
active and every active row advances or stops each step, so it takes
``max(probes) + 1`` tests (the probe counters are the paper's metric,
held against the reference elsewhere).  ``torch.from_numpy`` makes a
view, not a copy, and is not counted; its ``.to(device)`` is.  A
``x.cpu().numpy()`` chain counts twice here and syncs once on a card;
no fixpoint has one.

**Checkers:**

* ``host-sync-over-budget``: more syncs than the plan's budget;
* ``host-transfer-in-loop``: a host-to-device copy after the first round
  began (after the first host read, before the last);
* ``host-wide-dtype``: a graph array handed to a plan is 64-bit (the
  plans' graphs fit int32; the counterpart of ``check_host_dtypes``);
* ``plan-failure``: a plan that raises;
* ``instrument-not-inert`` (:func:`check_instrument_diff`, the twin of
  the reference's jaxpr diff): with ``instrument=False`` a plan's run at
  ``max_rounds`` 0 and at ``PLAN_MAX_ROUNDS`` must make the same host
  syncs in the same order and the same kernel wrapper calls (each a
  launch record on a card) with the same argument shapes and dtypes;
* ``instrument-missing-stats``: with ``instrument=True`` a plan's result
  must carry ``round_stats``.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.overrides import TorchFunctionMode

from .findings import Finding

READS = frozenset({"item", "__bool__", "__int__", "__float__", "__index__",
                   "tolist", "cpu", "numpy"})
FACTORIES = frozenset({"tensor", "as_tensor"})
MOVES = frozenset({"to", "cuda"})
WIDE_DTYPES = frozenset({torch.int64, torch.float64, torch.complex128})


class SyncCounter(TorchFunctionMode):
    """Counts host reads and host-to-device copies; ``events`` keeps their
    order (``"read"`` or ``"copy"``) so a copy can be placed in a
    round."""

    def __init__(self):
        super().__init__()
        self.events: list[str] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        out = func(*args, **kwargs)
        if name in READS:
            self.events.append("read")
        elif name in FACTORIES:
            if args and not isinstance(args[0], torch.Tensor):
                self.events.append("copy")
        elif name in MOVES and args and isinstance(args[0], torch.Tensor) \
                and isinstance(out, torch.Tensor) \
                and out.device != args[0].device:
            self.events.append("copy")
        return out

    @property
    def syncs(self) -> int:
        return len(self.events)

    def copies_in_loop(self) -> int:
        """Copies after the first host read and before the last one."""
        reads = [i for i, e in enumerate(self.events) if e == "read"]
        if not reads:
            return 0
        return sum(e == "copy" for e in self.events[reads[0]:reads[-1]])


@contextmanager
def probe_tests():
    """Record the probe counters of every probe loop run within the block
    (``core.common._probe_loop``); ``tests()`` of the yielded recorder is
    the number of loop tests they took.  Reads nothing while recording,
    so it can run inside a sync count."""
    from ..core import common
    real = common._probe_loop
    probes: list = []

    def recording(*args, **kwargs):
        found, ptr, p = real(*args, **kwargs)
        probes.append(p)
        return found, ptr, p

    class Recorder:
        def tests(self) -> int:
            return sum((int(p.max()) if p.numel() else 0) + 1
                       for p in probes)

    common._probe_loop = recording
    try:
        yield Recorder()
    finally:
        common._probe_loop = real


def rounds_of(result) -> int:
    """The rounds a plan's result reports (an int, or a result object)."""
    r = result if isinstance(result, int) else result.rounds
    return int(r)


def count_syncs(thunk):
    """Run ``thunk`` once; returns ``(result, counter, probe_tests)``."""
    with probe_tests() as rec:
        with SyncCounter() as counter:
            result = thunk()
        return result, counter, rec.tests()


def budget(entry, rounds: int, probe_loop_tests: int) -> int:
    return entry.per_round * rounds + probe_loop_tests + entry.constant


def check_plan_syncs(entries) -> tuple[list, int]:
    """Run every plan once under the sync counter; hold it to its
    budget."""
    findings: list[Finding] = []
    subjects = 0
    for entry in entries:
        subject = f"plan:{entry.name}"
        subjects += 1
        try:
            thunk, _ = entry.build()
            result, counter, tests = count_syncs(thunk)
            rounds = rounds_of(result)
        except Exception as e:
            findings.append(Finding(
                "plan-failure", "error", subject,
                f"running the plan raised {type(e).__name__}: "
                f"{str(e).splitlines()[0][:200] if str(e) else ''}"))
            continue
        allowed = budget(entry, rounds, tests)
        if counter.syncs > allowed:
            findings.append(Finding(
                "host-sync-over-budget", "error", subject,
                f"{counter.syncs} host syncs for {rounds} rounds and "
                f"{tests} probe-loop tests; the budget is {allowed} "
                f"({entry.per_round} a round + the probe tests + "
                f"{entry.constant})"))
        moved = counter.copies_in_loop()
        if moved:
            findings.append(Finding(
                "host-transfer-in-loop", "error", subject,
                f"{moved} host-to-device copies inside the round loop: "
                f"each one waits for the card"))
    return findings, subjects


def _call_record(calls) -> list:
    """Kernel wrapper calls as ``(kernel, args)`` with each tensor
    argument reduced to its shape and dtype."""
    def arg(a):
        if isinstance(a, torch.Tensor):
            return ("tensor", tuple(a.shape), str(a.dtype))
        return a
    return [(k, tuple(arg(a) for a in args)) for k, args, _ in calls]


def instrument_trace(entry, instrument: bool, max_rounds):
    """One warmed run of ``entry`` planned with ``instrument`` and
    ``max_rounds``: ``(result, sync events, kernel calls)``."""
    from ..obs.profile import capturing
    thunk, _ = entry.build(instrument=instrument, max_rounds=max_rounds)
    with capturing() as calls:
        with SyncCounter() as counter:
            result = thunk()
    return result, counter.events, _call_record(calls)


def check_instrument_diff(entries) -> tuple[list, int]:
    """``instrument=False`` must be inert to ``max_rounds``: the same
    syncs and the same kernel calls at 0 and ``PLAN_MAX_ROUNDS``;
    ``instrument=True`` must attach stats to the result."""
    from .catalog import PLAN_MAX_ROUNDS
    findings: list[Finding] = []
    subjects = 0
    for entry in entries:
        subject = f"plan:{entry.name}"
        subjects += 1
        try:
            _, ev0, calls0 = instrument_trace(entry, False, 0)
            _, ev1, calls1 = instrument_trace(entry, False, PLAN_MAX_ROUNDS)
            inst, _, _ = instrument_trace(entry, True, PLAN_MAX_ROUNDS)
        except Exception as e:
            findings.append(Finding(
                "plan-failure", "error", subject,
                f"the instrument diff's runs raised {type(e).__name__}: "
                f"{str(e).splitlines()[0][:200] if str(e) else ''}"))
            continue
        if ev0 != ev1 or calls0 != calls1:
            findings.append(Finding(
                "instrument-not-inert", "error", subject,
                f"instrument=False differs between max_rounds=0 and "
                f"max_rounds={PLAN_MAX_ROUNDS}: {len(ev0)} vs {len(ev1)} "
                f"host syncs, {len(calls0)} vs {len(calls1)} kernel calls "
                f"— the stat capacity leaks into the un-instrumented plan"))
        if getattr(inst, "round_stats", None) is None:
            findings.append(Finding(
                "instrument-missing-stats", "error", subject,
                "instrument=True returned no round_stats — the plan "
                "records no per-round stats"))
    return findings, subjects


def check_host_dtypes(entries) -> tuple[list, int]:
    """No 64-bit array may be handed to a plan (the catalog's graphs fit
    int32): it doubles the memory and the traffic of every O(n + m)
    pass."""
    findings: list[Finding] = []
    subjects = 0
    for entry in entries:
        subject = f"plan:{entry.name}"
        subjects += 1
        try:
            _, arrays = entry.build()
        except Exception:
            continue  # reported by check_plan_syncs
        for a in arrays:
            if a.dtype in WIDE_DTYPES:
                findings.append(Finding(
                    "host-wide-dtype", "error", subject,
                    f"array of dtype {a.dtype} shape {tuple(a.shape)} is "
                    f"handed to the plan; its graph fits int32"))
    return findings, subjects
