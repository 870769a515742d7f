#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's trimming engine on one CUDA device.

    python3 chip_smoke.py               # the check, about 2 minutes on an H100
    python3 chip_smoke.py --profile     # also: where the time goes (phase 5)

Phases (each prints its findings; any mismatch raises, so the script exits
non-zero and prints no result line):

0. the card's name and power limit, the torch/CUDA versions, the kernel
   build (nvcc, one process per source, in parallel).
1. every Hopper kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's real shapes (n = 4,194,304, W = 16; the
   "auto" frontier caps of the RMAT scale-22 graph: cap = 65,536,
   ecap = 4,194,304) and at edge cases (n = 1, ragged tails, all-inactive
   rows, capacity and ecap overflow, zero-degree rows); the kernel's time,
   the plain version's, one library call's where one computes the same
   function, and the bytes bound at 3.35 TB/s.
2. the deterministic counters of ``BENCH_trim.json`` (rounds, edges_total,
   max_per_worker, trimmed, max_qp) for 6 families x 4 methods x
   {dense, windowed} at the benchmark's own sizes.
3. the real size: RMAT scale 22 (4.19M vertices, 33.5M edges, the
   benchmark's RMAT parameters at the paper's average degree 8), 4 methods
   x 2 backends: all eight status masks equal each other and the numpy
   oracle, windowed counters equal dense counters, AC-6 traverses <= m.
4. the launch counts of phases 2 and 3: every kernel ran on the real-size
   main path (phase 3), whose counts go into the kernel table.

The last two lines are the kernel table and the result, as JSON.  Needs
one CUDA device; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet

# benchmarks/bench_trim.py JSON_SIZES (the sizes BENCH_trim.json was made at)
JSON_SIZES = {
    "ER": dict(n=30_000, m=36_000, seed=1),
    "BA": dict(n=20_000, deg=3, seed=1),
    "RMAT": dict(n_log2=14, m=20_480, seed=1, a=0.4, b=0.1, c=0.1),
    "chain": dict(n=5_000),
    "layered": dict(n=30_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=30_000, m=120_000, sink_frac=0.9, seed=1),
}
JSON_KEYS = ("rounds", "edges_total", "max_per_worker", "trimmed", "max_qp")
METHODS = ("ac3", "ac4", "ac4*", "ac6")
BACKENDS = ("dense", "windowed")
REAL = dict(n_log2=22, m=33_554_432, seed=1)
KERNELS = {   # name -> (CUDA source, the Pallas kernel it replaces)
    "first_live_scan": ("src/repro_torch/kernels/csrc/first_live_scan.cu",
                        "src/repro/kernels/first_live_scan.py:46"),
    "prefix_positions": ("src/repro_torch/kernels/csrc/frontier_compact.cu",
                         "src/repro/kernels/frontier_compact.py:62"),
    "frontier_compact": ("src/repro_torch/kernels/csrc/frontier_compact.cu",
                         "src/repro/kernels/frontier_compact.py:91"),
    "sparse_expand": ("src/repro_torch/kernels/csrc/frontier_compact.cu",
                      "src/repro/kernels/frontier_compact.py:109"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest absolute difference over a tuple of int/bool outputs."""
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# -- phase 1: kernels against their plain versions -----------------------------

def kernel_phase(dev, g_t, cap, ecap):
    """Hold each kernel against its plain version at edge cases and at the
    real shapes (``g_t``: Gᵀ of the real graph, as AC-4's sparse rounds
    expand it); time kernel, plain version and library call there."""
    import numpy as np
    import torch

    from repro_torch.kernels import first_live_scan as fls
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)

    def t(a, dtype=None):
        out = torch.as_tensor(a, device=dev)
        return out if dtype is None else out.to(dtype)

    # edge cases: n = 1, ragged tails, all-inactive rows, overflow, zero
    # degree rows — each must be bit-identical
    for n, w in ((1, 16), (333, 16), (4097, 16), (1000, 5)):
        for frac in (0.5, 0.0):
            args = (t(rng.random((n, w)) < 0.3), t(rng.random((n, w)) < 0.8),
                    t(rng.random(n) < frac))
            check(max_abs_err(fls.first_live_scan(*args),
                              ref.first_live_ref(*args)) == 0,
                  f"first_live_scan n={n} W={w} active={frac}")
    for n in (1, 2, 4095, 4096, 4097, 3 * 4096 + 7, 5_000_000):
        for x in (t(rng.integers(0, 5, n), torch.int32), t(rng.random(n) < .4)):
            check(max_abs_err(fc.prefix_positions(x),
                              ref.prefix_positions_ref(x)) == 0,
                  f"prefix_positions n={n} {x.dtype}")
    for n, c in ((1, 1), (700, 16), (4097, 64), (4097, 8192)):
        for mask in (np.zeros(n, bool), np.ones(n, bool), rng.random(n) < .2):
            mk = t(mask)
            check(max_abs_err(fc.frontier_compact(mk, c),
                              ref.frontier_compact_ref(mk, c)) == 0,
                  f"frontier_compact n={n} cap={c}")
    small = g_t.indptr[:5001] - 0
    small_idx = g_t.indices[: int(small[-1])]
    for c, e, p in ((8192, 8192, 1.0), (512, 64, 0.9), (64, 512, 0.05)):
        ids, _ = ref.frontier_compact_ref(t(rng.random(5000) < p), c)
        check(max_abs_err(fc.sparse_expand(small, small_idx, ids, e),
                          ref.sparse_expand_ref(small, small_idx, ids, e))
              == 0, f"sparse_expand cap={c} ecap={e}")
    torch.cuda.synchronize()
    log("# phase 1: edge cases bit-identical (n=1, ragged tails, "
        "all-inactive, capacity/ecap overflow, zero-degree rows)")

    # real shapes
    n = g_t.n
    window = 16
    flags = t(rng.random((n, window)) < 0.5)
    valid = t(rng.random((n, window)) < 0.9)
    active = t(rng.random(n) < 0.25)
    x = t(rng.integers(0, 64, n), torch.int32)
    members = torch.zeros(n, dtype=torch.bool, device=dev)
    members[t(rng.choice(n, cap - 7, replace=False))] = True
    ids, count = ref.frontier_compact_ref(members, cap)
    deg_t = (g_t.indptr[1:] - g_t.indptr[:-1])
    total_edges = int(deg_t[members].sum())
    check(total_edges <= ecap, "phase 1 frontier fits ecap")

    cases = {
        "first_live_scan": (
            lambda: fls.first_live_scan(flags, valid, active),
            lambda: ref.first_live_ref(flags, valid, active), None,
            # active byte of every row, both tiles of active rows, outputs
            n + 2 * window * int(active.sum()) + 5 * n),
        "prefix_positions": (
            lambda: fc.prefix_positions(x),
            lambda: ref.prefix_positions_ref(x),
            lambda: torch.cumsum(x, 0, dtype=torch.int32),
            4 * n + 4 * n + 4),
        "frontier_compact": (
            lambda: fc.frontier_compact(members, cap),
            lambda: ref.frontier_compact_ref(members, cap),
            lambda: torch.nonzero(members),
            n + 4 * cap + 4),
        "sparse_expand": (
            lambda: fc.sparse_expand(g_t.indptr, g_t.indices, ids, ecap),
            lambda: ref.sparse_expand_ref(g_t.indptr, g_t.indices, ids, ecap),
            None,
            # ids, two indptr entries per real id, one index per edge; the
            # (ecap,) src/tgt/pos int32 + valid bool outputs
            4 * cap + 8 * int(count) + 4 * total_edges + 13 * ecap),
    }
    rows = {}
    for name, (kern, plain, lib, nbytes) in cases.items():
        err = max_abs_err(kern(), plain())
        check(err == 0, f"{name}: kernel differs from its plain version at "
                        f"the real shapes (max |err| {err})")
        row = dict(max_abs_err=err, ms=time_ms(kern), plain_ms=time_ms(plain),
                   library_ms=time_ms(lib) if lib else None,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        rows[name] = row
        log(f"# phase 1: {name}: bit-identical at the real shapes; "
            f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms'] if lib is None else round(row['library_ms'], 4)} "
            f"bound_ms={row['bound_ms']:.4f}")
    return rows


# -- phase 2: the committed reference counters ---------------------------------

def reference_phase(dev):
    import numpy as np

    from repro_torch.core import plan
    from repro_torch.graphs import generators as G

    bench = json.loads((ROOT / "BENCH_trim.json").read_text())["families"]
    for family, kw in JSON_SIZES.items():
        g = G.BENCHMARK_GRAPHS[family][0](**kw, device=dev)
        gt = g.transpose()
        t0 = time.perf_counter()
        for method in METHODS:
            want = {k: bench[family]["methods"][method][k] for k in JSON_KEYS}
            for backend in BACKENDS:
                res = plan(g, method=method, backend=backend, workers=16,
                           chunk=1, transpose=gt, device=dev).run()
                pw = np.asarray(res.per_worker_edges)
                got = dict(rounds=res.rounds, edges_total=int(pw.sum()),
                           max_per_worker=int(pw.max()),
                           trimmed=res.n_trimmed, max_qp=res.max_frontier)
                check(got == want, f"{family}/{method}/{backend}: {got} != "
                                   f"BENCH_trim.json {want}")
        log(f"# phase 2: {family} n={g.n} m={g.m}: 4 methods x 2 backends "
            f"match BENCH_trim.json ({time.perf_counter() - t0:.2f} s)")


# -- phase 3: the real size ----------------------------------------------------

def real_phase(dev, g, gt):
    import numpy as np
    import torch

    from repro_torch.core import plan, trim_oracle

    runs = {}
    for method in METHODS:
        for backend in BACKENDS:
            eng = plan(g, method=method, backend=backend, workers=16,
                       transpose=gt, device=dev)
            walls = []
            # the first run also builds the worker map and Gᵀ's row ids
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = eng.run()
                status = res.status.cpu().numpy()
                walls.append((time.perf_counter() - t0) * 1e3)
            runs[method, backend] = res
            log(f"# phase 3: {method}/{backend}: wall_ms first={walls[0]:.1f}"
                f" second={walls[1]:.1f} rounds={res.rounds} "
                f"edges={res.edges_traversed} "
                f"trimmed={int((status == 0).sum())}")
    t0 = time.perf_counter()
    want = trim_oracle(*g.to_numpy())
    log(f"# phase 3: numpy oracle: {int((~want).sum())} of {g.n} trimmed "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    for (method, backend), res in runs.items():
        check(np.array_equal(np.asarray(res.status.cpu()).astype(bool), want),
              f"{method}/{backend}: status differs from the oracle")
        if backend == "windowed":
            dense = runs[method, "dense"]
            check((res.rounds, res.max_frontier) ==
                  (dense.rounds, dense.max_frontier)
                  and np.array_equal(res.per_worker_edges,
                                     dense.per_worker_edges),
                  f"{method}: windowed counters differ from dense")
    for backend in BACKENDS:
        check(runs["ac6", backend].edges_traversed <= g.m,
              "AC-6 traversed more than m edges")
    log("# phase 3: 8 status masks equal each other and the oracle; "
        "windowed counters equal dense; AC-6 edges <= m")


# -- phase 5 (--profile): where the time goes ----------------------------------

def profile_phase(dev, g, gt):
    """Per method at the real size: wall time, device-busy time from
    torch.profiler (CUDA kernel time summed over one stream), the idle
    share, the host syncs (counted by torch's sync debug mode on a separate
    run), and the kernels that take the most device time."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import plan

    for method, backend in (("ac3", "windowed"), ("ac3", "dense"),
                            ("ac4", "dense"), ("ac4*", "dense"),
                            ("ac6", "windowed"), ("ac6", "dense")):
        eng = plan(g, method=method, backend=backend, workers=16,
                   transpose=gt, device=dev)
        eng.run().materialize()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = eng.run().materialize()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                tot, cnt = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (tot + e.device_time / 1e3, cnt + 1)
        busy = sum(tot for tot, _ in by_name.values())
        kern = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.run().materialize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in rec)
        top = "; ".join(f"{name[:48]} {tot:.1f}ms x{cnt}"
                        for name, (tot, cnt) in kern[:6])
        log(f"# profile: {method}/{backend}: wall_ms={wall:.1f} "
            f"device_busy_ms={busy:.1f} idle_share={1 - busy / wall:.3f} "
            f"rounds={res.rounds} host_syncs={syncs} | {top}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the real-size runs (phase 5)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graphs import generators as G
    from repro_torch.core.common import frontier_plan
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"# torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"# phase 0: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in took.items())})")

    t0 = time.perf_counter()
    g = G.rmat(**REAL, device=dev)
    gt = g.transpose()
    fplan = frontier_plan("auto", g.n, g.m)
    log(f"# set-up: rmat(n_log2=22, m={REAL['m']}) n={g.n} m={g.m} and its "
        f"transpose in {time.perf_counter() - t0:.1f} s; auto frontier "
        f"cap={fplan.cap} ecap={fplan.ecap}")

    rows = kernel_phase(dev, gt, fplan.cap, fplan.ecap)
    ops.reset_launches()
    reference_phase(dev)
    log(f"# phase 4: launches in phase 2 (BENCH_trim.json sizes): "
        f"{dict(ops.LAUNCHES)}")
    ops.reset_launches()
    real_phase(dev, g, gt)
    launches = dict(ops.LAUNCHES)
    log(f"# phase 4: launches in phase 3 (the real-size main path): "
        f"{launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the main path")
    if args.profile:
        profile_phase(dev, g, gt)

    table = [dict(name=name, route="cuda", source=KERNELS[name][0],
                  replaces=KERNELS[name][1], launches=launches[name],
                  **rows[name]) for name in KERNELS]
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
