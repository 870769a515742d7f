"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped, the rest of the run is driven
on the CPU at a tiny size with ``TrimEngine.run`` wrapped to plant each
fault a trim cell can have.  (These cells run on one card: there is no
exchange between chips to leave out.)"""
import time

import pytest
import torch

from repro_torch.core import engine as port_engine
from repro_torch.core.graph import TrimResult
from trimbench import harness, spec

WORKLOADS = ["kron26.ac6", "urand26.ac6", "kron24.ac4", "kron26.ac6.status"]


def unchanged_state(res, n):
    """The step returns its state as it came in: every vertex live, no
    arc counted."""
    pw = res._pw
    return TrimResult(torch.ones(n, dtype=torch.int32), res._rounds,
                      per_worker_edges=None if pw is None
                      else torch.zeros_like(pw))


def half_left_out(res, n):
    """Half of the vertices left out (kept as they came in), the workers'
    counts extrapolated from the other half."""
    st = res.status.clone()
    st[n // 2:] = 1
    pw = res._pw
    if pw is not None:
        pw = pw.clone()
        half = pw.numel() // 2
        pw[half:] = pw[:half].sum() // max(half, 1)
    return TrimResult(st, res._rounds, per_worker_edges=pw)


def answer_altered(res, n):
    """One vertex's answer flipped where it is produced."""
    st = res.status.clone()
    st[n // 3] = 1 - st[n // 3]
    return TrimResult(st, res._rounds, per_worker_edges=res._pw)


def counter_altered(res, n):
    """One worker's count off by one."""
    pw = res._pw
    if pw is not None:
        pw = pw.clone()
        pw[1] += 1
    return TrimResult(res.status, res._rounds, per_worker_edges=pw)


FAULTS = [unchanged_state, half_left_out, answer_altered, counter_altered]


def run(workload, scale=11):
    cfg = dict(spec.cell(workload).config, scale=scale)
    return harness.run_cell(workload, 2**31 + 99, 0.2, False,
                            t0=time.perf_counter(), device="cpu",
                            config=cfg)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"


#: a cell with counters off has no count to alter
CASES = [(w, f) for w in WORKLOADS for f in FAULTS
         if f is not counter_altered or spec.cell(w).mix["counters"]]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_caught(workload, fault, monkeypatch):
    real = port_engine.TrimEngine.run

    def broken(self, *a, **kw):
        return fault(real(self, *a, **kw), self.graph.n)

    monkeypatch.setattr(port_engine.TrimEngine, "run", broken)
    out = run(workload)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


def test_kept_answers_keep_every_wrong_value():
    """A kept status is the answer as it was, every wrong value a
    mismatch."""
    from trimbench import reference
    kept = harness.Kept(5, pinned=False)
    kept.put(2, torch.tensor([0, 1, 7, -1, 1], dtype=torch.int32),
             torch.tensor([3, 4]))
    (status, counts), = [s for s in kept.samples() if s[1] is not None]
    assert status.tolist() == [0, 1, 7, -1, 1]
    live = torch.tensor([False, True, True, False, True])
    assert reference.judge(status, None, live)["status_mismatch"] == 2
    assert counts.tolist() == [3, 4]
