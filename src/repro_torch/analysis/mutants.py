"""Mutation corpus: deliberately broken twins proving each checker fires
— the port's counterpart of ``src/repro/analysis/mutants.py``.

A static checker that has never caught anything is indistinguishable from
one that cannot.  Every rule of the port's analysis plane therefore has
at least one minimal mutant — a launch with an overlapping block map, a
plan with a smuggled host read, a generator emitting int64 — and
``python -m repro_torch.analysis.check --mutants`` exits nonzero unless
every mutant that runs is caught by the checker named in its ``expect``
field.

**B10, the mutant kernels.**  The reference's six twins are
``pallas_call``s of one 1-D blocked int32 copy (``_mutant_pallas``) with
the output index map under mutation.  Here they are launch records of the
port's copy kernel (``kernels/mutant_copy.py``, ``csrc/mutant_copy.cu``),
built through the real capture path with the same names, ``expect``
checkers and the reference's geometry (n = 64, blocks of 16 or 32, grid
n // block, one element a thread), and their mutated block maps declared
in ``MUTANT_DECLARATIONS``.  They are never launched: a twin refuses to
run outside capture (the out-of-bounds one would write out of bounds on a
card).  The well-formed geometry is the real kernel, whose block owns
``PER_THREAD`` elements a thread (one where a slice is not 16-byte
aligned), and its capture must come out clean (``MUTANT_CONTROLS``).

**The rest of the corpus, mapped:** the reference's jaxpr mutants become
plans whose host syncs break the budget (``analysis.syncs``), and its
two instrument mutants plans whose un-instrumented run depends on
``max_rounds`` (``max-rounds-leak``) or whose instrumented result has no
stats (``instrument-without-stats``); the probe and generator mutants
are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..kernels import _build
from ..kernels.mutant_copy import PER_THREAD
from .capture import capture_kernel, capturing
from .catalog import LaunchDecl, OutputDecl, rows, tensor
from .findings import Finding

# -- mutant launches (B10) --------------------------------------------------

N, LIB = 64, "mutant_copy"


def _map(index) -> OutputDecl:
    """An owned 1-D output of block extent ``block.x`` whose block map is
    ``index(b)`` (the mutated part)."""
    return OutputDecl("owned", lambda launch, shape: (launch.block[0],),
                      lambda launch, shape, b: (index(b[0]),))


MUTANT_DECLARATIONS: dict[tuple[str, str], LaunchDecl] = {
    # the real kernels: PER_THREAD elements a thread where aligned, one
    # where not
    (LIB, "mutant_copy"): LaunchDecl({"out": rows(PER_THREAD)}),
    (LIB, "mutant_copy_carry"): LaunchDecl({"out": rows(PER_THREAD)}),
    (LIB, "mutant_copy_scalar"): LaunchDecl({"out": rows()}),
    (LIB, "mutant_copy_carry_scalar"): LaunchDecl({"out": rows()}),
    # blocks 2i and 2i+1 both write block i
    (LIB, "overlap_copy"): LaunchDecl({"out": _map(lambda b: b // 2)}),
    # every block writes block 0
    (LIB, "broadcast_copy"): LaunchDecl({"out": _map(lambda b: 0)}),
    # block i writes block i + 1
    (LIB, "oob_copy"): LaunchDecl({"out": _map(lambda b: b + 1)}),
    (LIB, "partial_copy"): LaunchDecl({"out": _map(lambda b: b)}),
    # scratch across blocks, and no ordered protocol declared
    (LIB, "carry_copy"): LaunchDecl({"out": _map(lambda b: b)}),
    # rogue_copy deliberately absent: the unregistered-kernel mutant
}


def _mutant_launch(kernel: str, n: int, block: int, scratch: bool = False,
                   out_n: int | None = None):
    """The copy kernel's launch in the repo's wrapper idiom, grid ``(n //
    block,)`` as the reference's, with the kernel's name (and so its
    declared block map), an oversized output and cross-block scratch
    under mutation control.  Runs only under capture."""
    def fn(x):
        if not capturing():
            raise RuntimeError("a mutant launch is never run on a card")
        out = torch.empty((out_n or n,), dtype=torch.int32, device=x.device)
        spec = _build.Launch(LIB, kernel, (n // block, 1, 1), (block, 1, 1),
                             0, {"out": out}, scratch)
        _build.launch(spec, "mutant_copy_launch", _build.c_ptr(x),
                      _build.c_ptr(out), n, _build.stream_of(x))
        return out
    return capture_kernel(fn, tensor(n, "int32"))


@dataclass
class MutantKernel:
    name: str
    expect: str  # checker that must fire
    build: Callable[[], list]


MUTANT_KERNELS: tuple[MutantKernel, ...] = (
    MutantKernel("overlapping-index-map", "write-race",
                 lambda: _mutant_launch("overlap_copy", N, 16)),
    MutantKernel("broadcast-write", "undeclared-sequential",
                 lambda: _mutant_launch("broadcast_copy", N, 16)),
    MutantKernel("shifted-oob-write", "oob-write",
                 lambda: _mutant_launch("oob_copy", N, 16)),
    # the output has 4 blocks but the 2-block grid writes only 0 and 1
    MutantKernel("half-covered-output", "uncovered-block",
                 lambda: _mutant_launch("partial_copy", N, 32, out_n=128)),
    MutantKernel("carry-no-sequential", "carry-without-sequential",
                 lambda: _mutant_launch("carry_copy", N, 16, scratch=True)),
    MutantKernel("unregistered-body", "unregistered-kernel",
                 lambda: _mutant_launch("rogue_copy", N, 16)),
)


def _control(carry: bool) -> list:
    from ..kernels.mutant_copy import mutant_copy
    c = tensor(1, "int32") if carry else None
    return capture_kernel(mutant_copy, tensor(N, "int32"), c, block=16)


#: the well-formed geometry, the real kernel: its capture must be clean
MUTANT_CONTROLS: tuple[tuple[str, Callable], ...] = (
    ("mutant-copy", lambda: _control(False)),
    ("mutant-copy-carry", lambda: _control(True)),
)


# -- mutant plans -------------------------------------------------------------

@dataclass
class MutantPlan:
    """A plan in ``PlanEntry``'s shape whose budget is one sync a round
    plus the final loop test.  ``build(instrument=False,
    max_rounds=None)``."""

    name: str
    expect: str
    build: Callable[..., tuple]
    check: str = "syncs"  # syncs | host_dtypes | instrument
    constant: int = 1
    per_round: int = 1

    @property
    def family(self) -> str:
        return "mutant"

    @property
    def variant(self) -> str:
        return self.name


def _countdown(body):
    """A host-driven fixpoint over 8 counters: one loop test a round."""
    def thunk():
        c = torch.arange(8, dtype=torch.int32)
        rounds = 0
        while bool((c > 0).any()):
            c = body(c)
            rounds += 1
        return rounds
    return thunk, ()


def _build_extra_read_plan(instrument=False, max_rounds=None):
    def body(c):
        int(c.sum())            # BUG under test: a second read a round
        return c - 1
    return _countdown(body)


def _build_transfer_plan(instrument=False, max_rounds=None):
    def body(c):
        return c - torch.tensor(1, dtype=torch.int32)  # a per-round copy
    return _countdown(body)


def _build_raising_plan(instrument=False, max_rounds=None):
    def body(c):
        return c - int(c)       # a multi-element tensor has no int: raises
    return _countdown(body)


def _build_int64_plan(instrument=False, max_rounds=None):
    thunk, _ = _countdown(lambda c: c - 1)
    # a 64-bit array handed to a plan whose graph fits int32
    return thunk, (torch.zeros(8, dtype=torch.int64),)


class _Stats:
    """A result whose ``round_stats`` says whether stats were recorded."""

    def __init__(self, rounds, round_stats):
        self.rounds = rounds
        self.round_stats = round_stats


def _build_leaky_instrument_plan(instrument=False, max_rounds=None):
    def body(c):
        if max_rounds:          # BUG under test: max_rounds leaks into
            int(c.max())        # the un-instrumented run
        return c - 1
    thunk, arrays = _countdown(body)
    return (lambda: _Stats(thunk(), {} if instrument else None)), arrays


def _build_statless_instrument_plan(instrument=False, max_rounds=None):
    thunk, arrays = _countdown(lambda c: c - 1)
    # BUG under test: instrument=True records no stats
    return (lambda: _Stats(thunk(), None)), arrays


MUTANT_PLANS: tuple[MutantPlan, ...] = (
    MutantPlan("callback-in-while-body", "host-sync-over-budget",
               _build_extra_read_plan),
    MutantPlan("transfer-in-while-body", "host-transfer-in-loop",
               _build_transfer_plan),
    MutantPlan("device-get-in-body", "plan-failure", _build_raising_plan),
    MutantPlan("int64-host-arg", "host-wide-dtype", _build_int64_plan,
               check="host_dtypes"),
    MutantPlan("max-rounds-leak", "instrument-not-inert",
               _build_leaky_instrument_plan, check="instrument"),
    MutantPlan("instrument-without-stats", "instrument-missing-stats",
               _build_statless_instrument_plan, check="instrument"),
)


# -- mutant retrace probes & generators --------------------------------------

class _FakeEngine:
    def __init__(self, kwargs, signature):
        self._kwargs = kwargs
        self._signature = signature

    def _plan_kwargs(self):
        return dict(self._kwargs)

    def plan_signature(self):
        return self._signature


def _nan_probe():
    return _FakeEngine({"method": "ac4", "load_factor": float("nan")},
                       "mutant[nan]")


def _unhashable_probe():
    return _FakeEngine({"method": "ac4", "window": [16]},
                       "mutant[unhashable]")


def _weak_type_probe():
    return _FakeEngine({"method": "ac4", "window": np.int32(16)},
                       "mutant[weak]")


class _UnstableFactory:
    """Each replan reports a different signature — a replan storm."""

    def __init__(self):
        self.count = 0

    def __call__(self):
        self.count += 1
        return _FakeEngine({"method": "ac4", "epoch": self.count},
                           f"mutant[unstable-{self.count}]")


@dataclass
class MutantProbe:
    name: str
    expect: str
    factory: Callable


MUTANT_PROBES: tuple[MutantProbe, ...] = (
    MutantProbe("nan-plan-kwarg", "nan-kwarg", _nan_probe),
    MutantProbe("unhashable-plan-kwarg", "unhashable-plan-kwargs",
                _unhashable_probe),
    MutantProbe("numpy-scalar-kwarg", "non-canonical-kwarg",
                _weak_type_probe),
    MutantProbe("unstable-replan", "unstable-plan", _UnstableFactory()),
)


def _int64_generator(device="cuda"):
    from ..core.graph import CSRGraph
    n = 64
    src = np.arange(n - 1, dtype=np.int64)  # BUG under test
    return CSRGraph.from_edges(n, src, src + 1, device=device)


@dataclass
class MutantGenerator:
    name: str
    expect: str
    factory: Callable


MUTANT_GENERATORS: tuple[MutantGenerator, ...] = (
    MutantGenerator("int64-edge-arrays", "generator-int64",
                    _int64_generator),
)


# -- harness ------------------------------------------------------------------

def verify_mutants() -> list[dict]:
    """Run every mutant through its checker.

    Returns one record per mutant run: ``{name, expect, caught,
    findings}``.  ``caught`` is True iff a finding with the expected
    checker name fired for that mutant — any mutant surviving its checker
    is a hole in the analysis plane.
    """
    from . import races, retrace, syncs
    from .catalog import LAUNCH_DECLARATIONS
    results: list[dict] = []

    def record(name, expect, findings):
        caught = any(f.checker == expect for f in findings)
        results.append({"name": name, "expect": expect, "caught": caught,
                        "findings": findings})

    decls = {**LAUNCH_DECLARATIONS, **MUTANT_DECLARATIONS}
    for mk in MUTANT_KERNELS:
        subject = f"mutant-kernel:{mk.name}"
        findings: list[Finding] = []
        try:
            for launch in mk.build():
                findings.extend(races.check_capture(subject, launch, decls))
        except Exception as e:
            findings.append(Finding("capture-failure", "error", subject,
                                    str(e)))
        record(mk.name, mk.expect, findings)

    checks = {"syncs": syncs.check_plan_syncs,
              "host_dtypes": syncs.check_host_dtypes,
              "instrument": syncs.check_instrument_diff}
    for mp in MUTANT_PLANS:
        findings, _ = checks[mp.check]([mp])
        record(mp.name, mp.expect, findings)

    for pr in MUTANT_PROBES:
        findings, _ = retrace.check_retrace_risk(
            probes=[(f"mutant:{pr.name}", pr.factory)])
        record(pr.name, pr.expect, findings)

    for mg in MUTANT_GENERATORS:
        findings, _ = retrace.check_generator_dtypes(
            registry={mg.name: (mg.factory, {})}, tiny={mg.name: {}})
        record(mg.name, mg.expect, findings)
    return results


def verify_controls() -> list[tuple[str, list]]:
    """The well-formed geometry's captures and their findings (none
    expected)."""
    from . import races
    out = []
    for name, build in MUTANT_CONTROLS:
        findings: list[Finding] = []
        for launch in build():
            findings.extend(races.check_capture(f"mutant-control:{name}",
                                                launch, MUTANT_DECLARATIONS))
        out.append((name, findings))
    return out
