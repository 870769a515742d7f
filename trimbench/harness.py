"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the metrics.

Set-up builds the cell's graph on the device from the seed, plans the
engine the mix names (``repro_torch.core.engine.plan``; AC-4's Gᵀ is the
port's own transpose, built in the first warm-up call) and warms it up.
The window then calls ``TrimEngine.run`` back to back from one caller,
each call ended by a synchronise, for ``seconds``.  A reservoir of the
window's answers, drawn from the seed, is copied to the host as each is
chosen and judged against the reference once the window has closed, the
memory peak has been read and the engine freed.  ``memory_peak_bytes``
is the window's peak: the graph, the engine and one call's state, not
the generator's scratch of set-up.

A ``--trace 1`` run adds, between warm-up and window, ``TRACED_CALLS``
calls under torch's sync debug mode and as many under the profiler, and
reports the per-layer metrics in place of the end-to-end ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import random
import sys
import time

import numpy as np
import torch

from trimbench import leastbytes, reference, spec
from trimbench import trace as tr

TRACED_CALLS = 20
#: answers of the window kept for the check (a reservoir over all calls)
SAMPLES = 4
PEAKS = "peaks.json"


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics read (``metrics/<name>.py``)."""

    host_syncs_per_call: float | None = None
    resident_bytes: int | None = None
    rounds: int | None = None
    per_worker_edges: object = None
    profile: tr.Profile | None = None
    calls: int = 0
    hand_kernels: frozenset = frozenset()
    least_bytes: int | None = None
    bytes_per_s: float | None = None


def hand_kernel_names() -> frozenset:
    """The names of the port's own CUDA kernels (its launch catalog)."""
    from repro_torch.analysis.catalog import LAUNCH_DECLARATIONS
    return frozenset(kernel for _, kernel in LAUNCH_DECLARATIONS)


def peak_bytes_per_s(kind: str):
    """The card's HBM bytes a second by its name, or None if unknown."""
    peaks = json.loads((spec.HERE / PEAKS).read_text())
    entry = peaks.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def plan_engine(mix: dict, indptr, indices, device, sync=lambda: None,
                mark=lambda phase: None):
    """The engine the mix names, planned on the graph and warmed up, as
    every run and every reading of ``control.py`` makes it (AC-4's Gᵀ is
    the port's own transpose, built in the first call).  ``mark`` is
    told of each phase's end: ``plan``, then ``first_call``."""
    from repro_torch.core.engine import plan
    from repro_torch.core.graph import CSRGraph

    with tr.span("plan"):
        engine = plan(CSRGraph(indptr, indices), method=mix["method"],
                      backend=mix["backend"], workers=int(mix["workers"]),
                      chunk=int(mix["chunk"]), window=int(mix["window"]),
                      frontier=mix["frontier"], unmasked=True,
                      device=device)
    mark("plan")
    with tr.span("warmup"):
        for _ in range(int(mix["warmup_calls"])):
            engine.run(counters=bool(mix["counters"]))
            sync()
            mark("first_call")
    return engine


class Kept:
    """The window's kept answers, copied to the host as each is chosen
    (on a card into pinned slots: a DMA of the (n,) int32 status, with no
    allocation on the device), so that the device's peak is the trim's
    own.  The per-worker counts are the result's own host copy."""

    def __init__(self, n: int, pinned: bool):
        self.status = [torch.empty(n, dtype=torch.int32, pin_memory=pinned)
                       for _ in range(SAMPLES)]
        self.counts = [None] * SAMPLES
        self.filled = 0

    def put(self, j: int, status, counts) -> None:
        self.status[j].copy_(status)
        self.counts[j] = None if counts is None else np.array(counts)
        self.filled = max(self.filled, j + 1)

    def samples(self) -> list:
        """``(status, counts)`` of each answer kept."""
        return list(zip(self.status, self.counts))[:self.filled]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device="cuda", bench=None, config=None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``config`` replaces the cell's configuration (the CPU tests run tiny
    graphs through the same path)."""
    cell = spec.cell(workload, bench)
    cfg = cell.config if config is None else config
    mix = cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    phases = {"start": time.perf_counter() - t0}
    gen = spec.load_module("generators", cfg["generator"])
    indptr, indices = gen.make(cfg, seed, dev)
    sync()
    phases["graph"] = time.perf_counter() - t0
    n, m = indptr.numel() - 1, indices.numel()
    counted = bool(mix["counters"])

    engine = plan_engine(mix, indptr, indices, dev, sync,
                         lambda k: phases.setdefault(
                             k, time.perf_counter() - t0))

    def call():
        return engine.run(counters=counted)

    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    print("set-up, seconds from process start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) + f", warm {setup_s:.3f}"
        f"; set-up peak {setup_peak} bytes (the generator's scratch, not "
        "reported)", file=sys.stderr)

    reading = None
    if trace:
        syncs = tr.count_syncs(call, TRACED_CALLS) if cuda else None
        with tr.profiled() if cuda else contextlib.nullcontext() as prof:
            for _ in range(TRACED_CALLS):
                with tr.span("call"):
                    traced = call()
                with tr.span("sync"):
                    sync()
        reading = Reading(
            host_syncs_per_call=syncs, resident_bytes=engine.nbytes(),
            rounds=traced.rounds, per_worker_edges=traced.per_worker_edges,
            profile=tr.Profile(prof) if cuda else None, calls=TRACED_CALLS,
            hand_kernels=hand_kernel_names())
        del traced

    # the window: one caller, calls back to back
    rng = random.Random(seed % (1 << 64))
    kept = Kept(n, cuda)
    latencies = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        c0 = time.perf_counter()
        res = call()
        sync()
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        i = len(latencies) - 1
        j = i if i < SAMPLES else rng.randrange(i + 1)
        if j < SAMPLES:
            kept.put(j, res.status,
                     res.per_worker_edges if counted else None)
        del res
        if c1 >= deadline:
            break
    window_s = c1 - start
    calls = len(latencies)
    # the trim's own peak: the kept answers are on the host
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # judge the window's answers against the reference, the engine freed
    samples = kept.samples()
    del kept, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    live, _ = reference.trim(indptr, indices)
    ref_pw = (reference.counters(mix["method"], indptr, indices, live,
                                 int(mix["workers"]), int(mix["chunk"]))
              if counted else None)
    judged = [reference.judge(st, pw, live, ref_pw) for st, pw in samples]
    checks = reference.worst(judged)
    failed = sum(not reference.passes(j) for j in judged)
    correct = bool(judged) and reference.passes(checks)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    if trace:
        reading.least_bytes = leastbytes.least_bytes(mix["method"], indptr,
                                                     indices, live)
        reading.bytes_per_s = peak_bytes_per_s(kind)
        metrics = {}
        for entry in cell.per_layer:
            value = spec.load_module("metrics", entry["name"]).read(reading)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        e2e = {
            "trim_throughput": m * calls / window_s / 1e6,
            "trim_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        }
        metrics = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                   for e in cell.end_to_end}

    out = {"correct": correct, "attempted": calls, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                      "count": cell.chips, "memory_peak_bytes": window_peak}}
    if trace and reading.profile is not None:
        out["device"]["busy_s"] = reading.profile.busy_s
        out["device"]["window_s"] = reading.profile.window_s
        out["breakdown"] = {"device_ops": reading.profile.device_ops(),
                            "idle_gaps": reading.profile.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": reference.LIMITS[k]}
                     for k, v in checks.items()}
    return out


def report_checks(out: dict, stream=sys.stderr) -> None:
    """Each number compared beside its limit, one line each."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=stream)
