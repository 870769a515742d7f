#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA device: the trimming engine,
the static checks, then the SCC driver, the reachability engine, the
k-core peel, the stream engine (incremental trimming), the command line,
LM serving and GNN training.

    python3 chip_smoke.py               # the check, a few minutes on an H100
    python3 chip_smoke.py --profile     # also: where the time goes (phase 7)

Phases (each prints its findings; any mismatch raises, so the script exits
non-zero and prints no result line):

0. the card's name and power limit, the torch/CUDA versions, the kernel
   build (nvcc, one process per source, in parallel).
1. every Hopper kernel against its plain PyTorch version on the card, bit
   for bit, at the main paths' real shapes (n = 4,194,304, W = 16; the
   "auto" frontier caps of the RMAT scale-22 graph: cap = 65,536,
   ecap = 4,194,304; frontier_expand with 100%, 25% and 0% of rows
   pending; bucket_peel at k in {0, 1, 7} with negative counters;
   counter_scatter with B in {1, 65,536, 1,048,576} RMAT-skewed updates,
   and with all B on one source) and at edge cases (n = 0, n = 1, B = 0,
   ragged tails, all-inactive rows, capacity and ecap overflow,
   zero-degree rows, W in {4, 8, 17, 32}, non-contiguous and unaligned
   inputs, all-dead buckets, sentinel and negative sources); the kernel's
   time (CUDA events over back-to-back calls, and its device time alone
   from the profiler), the plain version's, one library call's where one
   computes the same function, and the bytes bound at 3.35 TB/s.
   flash_attention against its plain version (the Pallas kernel's
   arithmetic) at qwen3-1.7b's prefill shape (B, Hq, Hkv, S, D) = (8, 16,
   8, 2048, 128), causal, in f32 (to 1e-4) and bf16 (to 1e-2), and at
   edge cases (Sq < Sk, Sq > Sk, single blocks, D = 16, non-causal, GQA
   groups 1-3, transposed and sliced inputs); its bound is operations
   (2 B Hq S (S+1) D FLOP at 989 TFLOP/s bf16), its library call SDPA.
   segment_sum against its plain version to 1e-5 of each segment's sum of
   |v| (float atomics add in another order) at the training path's shapes
   (MeshGraphNet on molecule (8,192, 128) -> 3,840 and on minibatch_lg
   (168,960, 128) -> 169,984; EquiformerV2 on molecule (8,192, 6,272) ->
   3,840), at one layer's aggregation at ogb-products scale ((61,859,140,
   128) -> 2,449,029, 31.7 GB, uniform and RMAT-skewed ids) and at edge
   cases (m = 0, n = 1, d in {1, 3, 4, 6272}, f32 and bf16, ids in [-2,
   n + 2) int32 and int64, column slices, 3-D values); its bound is bytes,
   its library call ``index_add_``.
2. the deterministic counters of ``BENCH_trim.json`` (rounds, edges_total,
   max_per_worker, trimmed, max_qp) for 6 families x 4 methods x
   {dense, windowed} at the benchmark's own sizes.
3. the trimming main path at the real size: RMAT scale 22 (4.19M
   vertices, 33.5M edges, the benchmark's RMAT parameters at the paper's
   average degree 8), 4 methods x 2 backends: all eight status masks
   equal each other and the numpy oracle, windowed counters equal dense
   counters, AC-6 traverses <= m.
4. the launch counts of phases 2 and 3: every trimming kernel ran on the
   real-size trimming path (phase 3).
5. the committed SCC and peel counts at their benchmarks' sizes:
   ``BENCH_scc.json`` ``sccs`` and AC-6 ``rounds`` (labels partition like
   Tarjan's), and the eight integer keys of ``BENCH_peel.json`` on the
   size-≤2 SCC fringe graphs; ``peel(k=1)`` equals AC-4.
6. the SCC / reach / peel path at the real size (the same RMAT and Gᵀ),
   with the launch counts set to 0 just before it and read just after:
   reach on both backends and the auto and dense frontiers against scipy's
   BFS; ``scc_decompose`` against scipy's strong components over the
   canonical CSR; the full coreness peel against a numpy k-core oracle;
   frontier_expand and bucket_peel must have been launched.
7. (``--profile``, run last) one call of each real-size path under
   torch.profiler: the eight trims, ``scc_decompose``, the full peel, and
   the stream engine's deletion-only ``apply``, ``apply`` with
   insertions and ``retrim(full=True)``: wall and device-busy time, idle
   share, host syncs, the largest device items.
8. the stream engine at ``BENCH_stream.json``'s sizes with
   ``bench_family``'s feed: ``n``, ``m``, ``batch_edges``,
   ``median_incr_rounds`` and ``trimmed`` must match, and after the check
   batch ``retrim()`` equals a fresh AC-4 run on ``snapshot()``; then a
   mixed feed on that RMAT (load factor 0.05, deletions and
   re-insertions) that compacts at least twice, grows the insert buffer
   and revives (``dirty``), checked against AC-4 on every tick.
9. the stream engine at the real size (the same RMAT; the trim-stream
   server's feed: 33,554 deletions a tick, re-inserting from the fourth
   tick the batch deleted three ticks before; 8 ticks), with the launch
   counts set to 0 just before it and read just after: every tick's
   ``retrim()`` equals AC-4 on ``snapshot()``, the last one the numpy
   oracle too; counter_scatter must have been launched.  Set-up times,
   apply ms per tick, rounds, ``dirty``, updates/s and one
   ``retrim(full=True)``.
10. the command line on the card: ``--app trim``, ``scc``, ``stream`` and
   ``peel`` on ``--graph RMAT`` (scale 17).
11. LM serving at full width: ``serve_lm("qwen3-1.7b")`` at its published
   config (28 layers, random weights from seed 0), 8 requests of 2048
   prompt tokens and 32 generated tokens, with the launch counts set to 0
   just before it and read just after: flash_attention must have run 28
   times (once a layer, in the one prefill).  Prefill and decode times,
   tok/s, peak device memory, weight and cache bytes.  Then decode
   against forward at full width: ``decode_step(pos=p)`` after
   ``prefill(tokens[:, :p])`` equals ``forward(tokens)[:, p]`` (the
   prefill through the kernel, decode through plain einsums) in f32 at
   B = 2, T = 512 (to 1e-3), and in bf16 at B = 8, T = 2048, where both
   decode and forward are held against the f32 forward on the same
   weights (decode within 1.5x the bf16 forward's distance).
   ``--profile`` adds a prefill and a decode step to phase 7.
12. GNN training at full width (f32, no TF32): MeshGraphNet, SchNet, MACE
   and EquiformerV2 at their published configs on the molecule cell (128
   graphs of 30 nodes and 64 edges from ``GraphBatchStream(seed=0)``,
   batched as one disjoint union), 5 AdamW steps each through the
   ``Trainer``, weights from a seeded generator on the card.  The first
   step's loss (1e-4 relative) and gradients (1e-3 of each tensor's largest
   entry) equal the port's CPU path on the same weights and batch; the loss
   falls; segment_sum runs 15 / 3 / 30 / 24 times a step.  Then
   MeshGraphNet full-graph on minibatch_lg's exact counts (169,984 nodes,
   168,960 edges, d_feat 602, 41 classes, numpy seed 0), 3 steps: ms per
   step, nodes/s, peak memory, launches; and ``python -m
   repro_torch.launch.train --arch meshgraphnet --steps 5``.  The launch
   counts are set to 0 before each run and summed.  ``--profile`` adds one
   molecule and one minibatch_lg step to phase 7.
13. (run right after phase 1) the static checks on the card's machine,
   with the launch counts set to 0 just before and read just after: (a)
   ``python -m repro_torch.analysis.check --strict`` (0 errors, 0
   warnings; subject counts per checker) and ``--mutants`` (every mutant
   run caught, the A7 ones waiting), also through ``launch.trim --app
   check``; (b) the declarations held against the card: every
   ``KERNEL_CATALOG`` point, the copy kernel's and one real-size call of
   each kernel (phase 1's shapes) run on zero-filled CUDA tensors under
   torch.profiler, and the kernels' grid and block read from the chrome
   trace must equal the captured launch records, in order; every kernel
   must have run.  Then (c) ``mutant_copy`` (the corpus's well-formed
   geometry; its twins never run) against ``x.clone()`` bit for bit at
   n = 4,194,304, n = 0, n = 1 and a ragged tail, with and without the
   carry word: kernel, plain and ``x.clone()`` times and the bytes bound;
   (d) the host syncs of one warm AC-4 and one AC-6 trim at RMAT scale 22,
   counted by ``torch.cuda.set_sync_debug_mode("warn")`` and by the CPU
   lint's counter, must both equal the lint's budget for the rounds and
   probe steps the card ran.

The last two lines are the kernel table and the result, as JSON.  Needs
one CUDA device; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
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
# benchmarks/bench_scc.py SIZES (the sizes BENCH_scc.json was made at)
SCC_SIZES = {
    "ER": dict(n=50_000, m=400_000, seed=1),
    "BA": dict(n=20_000, deg=8, seed=1),
    "RMAT": dict(n_log2=14, m=131_072, seed=1),
    "chain": dict(n=5_000),
    "layered": dict(n=50_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=50_000, m=200_000, sink_frac=0.9, seed=1),
}
# benchmarks/bench_peel.py SIZES and FRINGE (BENCH_peel.json)
PEEL_SIZES = {
    "ER": dict(n=30_000, m=240_000, seed=1),
    "BA": dict(n=20_000, deg=8, seed=1),
    "RMAT": dict(n_log2=14, m=131_072, seed=1),
    "chain": dict(n=5_000),
    "layered": dict(n=30_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=30_000, m=120_000, sink_frac=0.9, seed=1),
}
FRINGE = dict(pairs=48, loops=16)
PEEL_KEYS = ("generations_base", "generations_trim2", "pivots_base",
             "pivots_trim2", "trim2_removed", "trim2_sccs", "max_core",
             "one_core")
KERNELS = {   # name -> (CUDA source, the Pallas kernel it replaces)
    "first_live_scan": ("src/repro_torch/kernels/csrc/first_live_scan.cu",
                        "src/repro/kernels/first_live_scan.py:46"),
    "prefix_positions": ("src/repro_torch/kernels/csrc/frontier_compact.cu",
                         "src/repro/kernels/frontier_compact.py:62"),
    "frontier_compact": ("src/repro_torch/kernels/csrc/frontier_compact.cu",
                         "src/repro/kernels/frontier_compact.py:91"),
    "sparse_expand": ("src/repro_torch/kernels/csrc/frontier_compact.cu",
                      "src/repro/kernels/frontier_compact.py:109"),
    "frontier_expand": ("src/repro_torch/kernels/csrc/frontier_expand.cu",
                        "src/repro/kernels/frontier_expand.py:43"),
    "bucket_peel": ("src/repro_torch/kernels/csrc/bucket_peel.cu",
                    "src/repro/kernels/bucket_peel.py:43"),
    "counter_scatter": ("src/repro_torch/kernels/csrc/counter_scatter.cu",
                        "src/repro/kernels/counter_scatter.py:63"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87"),
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_reduce.py:47"),
    "mutant_copy": ("src/repro_torch/kernels/csrc/mutant_copy.cu",
                    "src/repro/analysis/mutants.py:60"),
}
TRIM_PATH = ("first_live_scan", "prefix_positions", "frontier_compact",
             "sparse_expand")
SCC_PEEL_PATH = ("frontier_expand", "bucket_peel")
STREAM_PATH = ("counter_scatter",)
SERVE_PATH = ("flash_attention",)
TRAIN_PATH = ("segment_sum",)
# phase 13 launches every kernel; the copy kernel is this path's own
ANALYSIS_PATH = tuple(KERNELS)
MUTANT_N = 4_194_304
# benchmarks/bench_stream.py SIZES (the sizes BENCH_stream.json was made at)
STREAM_SIZES = {
    "ER": dict(n=50_000, m=400_000, seed=1, simple=True),
    "BA": dict(n=20_000, deg=8, seed=1),
    "RMAT": dict(n_log2=14, m=131_072, seed=1),
    "chain": dict(n=5_000),
    "layered": dict(n=50_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=50_000, m=200_000, sink_frac=0.9, seed=1),
}
STREAM_KEYS = ("n", "m", "batch_edges", "median_incr_rounds", "trimmed")
STREAM_TICKS = 8          # real-size ticks of the trim-stream feed
# phase 11: qwen3-1.7b at its published config, 8 requests of 2048 prompt
# tokens and 32 generated tokens; the flash kernel's real shape follows
SERVE = dict(arch="qwen3-1.7b", batch=8, prompt_len=2048, gen_len=32, seed=0)
FLASH_REAL = dict(b=8, hq=16, hkv=8, s=2048, d=128)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM data sheet
# bf16 outputs of size ~1 round by up to 2^-8; the f32 kernel and its plain
# version sum in f32 in other orders
FLASH_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# segment_sum: |kernel - plain| <= SEG_TOL * (the segment's sum of |v|) +
# 1e-6.  Both sum in f32, the kernel's atomics in an order that changes from
# run to run; a k-term sum moves by ~sqrt(k) 2^-24 of its largest partial
SEG_TOL = 1e-5
# phase 12: the four GNNs at their published configs on the molecule cell
# (configs.base.gnn_shapes), 5 AdamW steps each; MeshGraphNet full-graph on
# the minibatch_lg cell's exact counts, 3 steps
GNN_ARCHS = ("meshgraphnet", "schnet", "mace", "equiformer-v2")
MOLECULE = dict(batch=128, n_nodes=30, n_edges=64)
TRAIN_STEPS = 5
LG = dict(n=169_984, m=168_960, d_feat=602, classes=41, steps=3)
# segment_sum launches per training step (one per aggregation: a layer of
# MeshGraphNet, an interaction of SchNet, a CG path of a MACE layer, and the
# softmax normaliser and the messages of an EquiformerV2 layer)
SEG_PER_STEP = {"meshgraphnet": lambda c: c.n_layers,
                "schnet": lambda c: c.n_interactions,
                "mace": lambda c: 15 * c.n_layers,
                "equiformer-v2": lambda c: 2 * c.n_layers}
# one layer's aggregation at ogb-products scale (configs.base.gnn_shapes)
OGB = dict(n=2_449_029, m=61_859_140, d=128)
# phase 12 step against the CPU: loss relative, gradients to a share of
# each tensor's largest entry (the f32 sums run in other orders)
TRAIN_TOL = dict(loss=1e-4, grad=1e-3)
# the message of torch's sync debug mode for one synchronizing operation
# (enabling the mode also warns, once a process, with another message that
# mentions synchronizing operations: it is not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"
INF_NOTE = (" (overflows float32: the reference's clip scales every update "
            "to 0, so the parameters stay as they are; ROADMAP C)")


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: the durations of the CUDA kernels and
    copies it launches (torch.profiler, CUPTI), summed over ``reps`` calls,
    per call.  Unlike :func:`time_ms` it leaves out the host's gaps
    between launches, which bound a small kernel behind a Python
    wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / reps


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

    from repro_torch.kernels import bucket_peel as bpl
    from repro_torch.kernels import counter_scatter as cs
    from repro_torch.kernels import first_live_scan as fls
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import frontier_expand as fex
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
    for n, w in ((1, 16), (333, 16), (4097, 16), (4097, 4), (1000, 8),
                 (1000, 17), (513, 32)):
        for frac in (0.5, 0.0, 1.0):
            flags, valid = t(rng.random((n, w)) < .1), t(rng.random((n, w)) < .8)
            pending = t(rng.random(n) < frac)
            check(max_abs_err((fex.frontier_expand(flags, valid, pending),),
                              (ref.frontier_expand_ref(flags, valid,
                                                       pending),)) == 0,
                  f"frontier_expand n={n} W={w} pending={frac}")
        wide = t(rng.random((2 * n, w)) < .1)[::2]       # non-contiguous
        check(max_abs_err((fex.frontier_expand(wide, valid, pending),),
                          (ref.frontier_expand_ref(wide, valid, pending),))
              == 0, f"frontier_expand non-contiguous n={n} W={w}")
    for n in (1, 3, 5, 333, 4096, 4099):
        counters = t(rng.integers(-3, 9, n), torch.int32)
        for alive in (t(rng.random(n) < .6), t(np.zeros(n, bool))):
            for k in (0, 1, 7):
                kt = t([k], torch.int32)
                for off in (0, 1):                       # 1: unaligned views
                    got = bpl.bucket_peel(counters[off:], alive[off:], kt)
                    want = ref.bucket_peel_ref(counters[off:], alive[off:],
                                               kt)
                    check(max_abs_err((got,), (want,)) == 0,
                          f"bucket_peel n={n} k={k} offset={off}")
    for n in (0, 1, 3, 5, 4099):
        for b in (0, 1, 7, 4096):
            counters = t(rng.integers(-2, 6, n), torch.int32)
            status = t(rng.random(n) < .7)
            src, delta = counter_updates(rng, n, b, dev)
            before = counters.clone()
            one = torch.full_like(src, int(rng.integers(0, max(n, 1))))
            for args in ((counters, status, src, delta),
                         (counters[1:], status[1:], src, delta),
                         (counters, status, src[::2], delta[::2]),
                         (counters, status, one, delta)):
                check(max_abs_err(cs.counter_scatter(*args),
                                  ref.counter_scatter_ref(*args)) == 0,
                      f"counter_scatter n={n} B={b}")
            check(torch.equal(counters, before),
                  "counter_scatter modified its input")
    torch.cuda.synchronize()
    log("# phase 1: edge cases bit-identical (n=0, n=1, B=0, ragged tails, "
        "all-inactive, capacity/ecap overflow, zero-degree rows, W in "
        "{4, 8, 16, 17, 32}, non-contiguous and unaligned inputs, "
        "all-dead buckets, negative counters, sentinel and negative "
        "sources, all updates on one source)")

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
    # frontier_expand: a sparse frontier over every row's window
    xflags = t(rng.random((n, window)) < 0.02)
    pending_all = torch.ones(n, dtype=torch.bool, device=dev)
    # bucket_peel: counters in [-2, 64), 60% alive, the level on the device
    pcount = t(rng.integers(-2, 64, n), torch.int32)
    palive = t(rng.random(n) < 0.6)
    k7 = t([7], torch.int32)
    for frac in (0.25, 0.0):
        pend = t(rng.random(n) < frac)
        check(max_abs_err((fex.frontier_expand(xflags, valid, pend),),
                          (ref.frontier_expand_ref(xflags, valid, pend),))
              == 0, f"frontier_expand real shapes pending={frac}")
        rows = int(pend.sum())

        def kern():
            return fex.frontier_expand(xflags, valid, pend)
        log(f"# phase 1: frontier_expand, {frac:.0%} pending: "
            f"kernel_ms={time_ms(kern):.4f} "
            f"device_ms={device_ms(kern):.4f} plain_ms="
            f"{time_ms(lambda: ref.frontier_expand_ref(xflags, valid, pend)):.4f} "
            f"bound_ms={(2 * n + 2 * window * rows) / HBM_BYTES_PER_S * 1e3:.4f}")
    for k in (0, 1):
        kt = t([k], torch.int32)
        check(max_abs_err((bpl.bucket_peel(pcount, palive, kt),),
                          (ref.bucket_peel_ref(pcount, palive, kt),)) == 0,
              f"bucket_peel real shapes k={k}")

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
        "frontier_expand": (
            lambda: (fex.frontier_expand(xflags, valid, pending_all),),
            lambda: (ref.frontier_expand_ref(xflags, valid, pending_all),),
            None,
            # every row pending: pending byte, both tiles, the hit byte
            n + 2 * window * n + n),
        "bucket_peel": (
            lambda: (bpl.bucket_peel(pcount, palive, k7),),
            lambda: (ref.bucket_peel_ref(pcount, palive, k7),),
            None,
            # int32 counter, alive byte, frontier byte per vertex
            4 * n + n + n),
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
            f"kernel_ms={row['ms']:.4f} device_ms={device_ms(kern):.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms'] if lib is None else round(row['library_ms'], 4)} "
            f"bound_ms={row['bound_ms']:.4f}")

    # counter_scatter: RMAT-skewed sources (the sources of random edges of
    # the real graph, so hubs repeat), plus the sentinel n and negatives;
    # then the adversarial batch with every update on one source
    counters = t(rng.integers(-2, 64, n), torch.int32)
    status = t(rng.random(n) < 0.7)
    for b in (1, 65_536, 1_048_576):
        src, delta = counter_updates(rng, n, b, dev, pool=g_t.indices)
        for label, s_ in (("rmat", src), ("one source", torch.full_like(
                src, int(g_t.indices[0])))):
            args = (counters, status, s_, delta)
            err = max_abs_err(cs.counter_scatter(*args),
                              ref.counter_scatter_ref(*args))
            check(err == 0, f"counter_scatter B={b} {label}: kernel differs "
                            f"from its plain version (max |err| {err})")
            ok = (s_ >= 0) & (s_ < n)
            ids_ok, delta_ok = s_[ok].long(), delta[ok]

            def lib():
                new = counters.index_add(0, ids_ok, delta_ok)
                return new, status & (new <= 0)
            row = dict(max_abs_err=err,
                       ms=time_ms(lambda: cs.counter_scatter(*args)),
                       plain_ms=time_ms(
                           lambda: ref.counter_scatter_ref(*args)),
                       library_ms=time_ms(lib),
                       bound_ms=(10 * n + 8 * b) / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes")
            log(f"# phase 1: counter_scatter B={b} ({label}): "
                f"bit-identical; kernel_ms={row['ms']:.4f} device_ms="
                f"{device_ms(lambda: cs.counter_scatter(*args)):.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms="
                f"{row['library_ms']:.4f} (index_add_ of the in-range "
                f"updates + the compare) bound_ms={row['bound_ms']:.4f}")
            if b == 65_536 and label == "rmat":
                rows["counter_scatter"] = row
    return rows


def counter_updates(rng, n: int, b: int, dev, pool=None):
    """A (B,) update batch for counter_scatter: sources uniform in [0, n),
    or ``pool`` entries at uniform positions (Gᵀ's indices: the sources
    of random edges, so RMAT hubs repeat), with 1% sentinel n and 1%
    negatives; deltas in {-1, 0, +1} with one in 97 large (up to 2^16 in
    magnitude)."""
    import torch
    if pool is None:
        src = rng.integers(0, max(n, 1), b)
    else:
        src = pool[torch.as_tensor(rng.integers(0, pool.shape[0], b),
                                   device=pool.device)].cpu().numpy()
    kind = rng.random(b)
    src[kind < 0.01] = n
    src[(kind >= 0.01) & (kind < 0.02)] = -1 - rng.integers(0, 5)
    delta = rng.integers(-1, 2, b)
    delta[::97] = rng.integers(-(1 << 16), 1 << 16, delta[::97].size)
    return (torch.as_tensor(src, dtype=torch.int32, device=dev),
            torch.as_tensor(delta, dtype=torch.int32, device=dev))


def flash_phase(dev):
    """Phase 1 for flash_attention: the kernel against its plain version
    (the Pallas kernel's arithmetic) at edge cases and at the real
    prefill shape of qwen3-1.7b, in f32 and bf16; times there.  Returns
    the bf16 row of the kernel table (the serving path's dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                              (b, hkv, sk, d))]

    def err(got, want):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"flash_attention shape/dtype {tuple(got.shape)} {got.dtype}")
        return float((got.float() - want.float()).abs().max())

    # Sq < Sk, Sq > Sk (zero rows and mean rows), one short block, D = 16,
    # non-causal, GQA groups 1, 2 and 3
    for (b, hq, hkv, sq, sk, d, causal) in (
            (2, 4, 2, 256, 512, 128, True), (1, 2, 1, 384, 128, 64, True),
            (1, 4, 2, 128, 64, 32, True), (2, 3, 1, 96, 96, 16, True),
            (1, 4, 4, 48, 48, 128, True), (1, 8, 2, 256, 384, 64, False),
            (3, 6, 2, 128, 128, 16, True)):
        for dtype in (torch.float32, torch.bfloat16):
            args = qkv(b, hq, hkv, sq, sk, d, dtype)
            e = err(fa.flash_attention(*args, causal=causal),
                    ref.flash_attention_ref(*args, causal=causal))
            check(e <= FLASH_TOL[str(dtype).split(".")[1]],
                  f"flash_attention {(b, hq, hkv, sq, sk, d, causal)} "
                  f"{dtype}: max |err| {e}")
    # non-contiguous: the model's transposed (B, S, H, D) views, and a
    # strided slice of the keys
    q, k, v = (torch.randn((2, 256, h, 64), generator=gen, device=dev)
               for h in (8, 4, 4))
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    e = err(fa.flash_attention(*views), ref.flash_attention_ref(*views))
    check(e <= FLASH_TOL["float32"], f"flash_attention strided: {e}")
    wide = [t[:, :, ::2] for t in qkv(1, 4, 2, 256, 512, 32, torch.float32)]
    e = err(fa.flash_attention(*wide), ref.flash_attention_ref(*wide))
    check(e <= FLASH_TOL["float32"], f"flash_attention sliced: {e}")
    torch.cuda.synchronize()
    log("# phase 1: flash_attention edge cases within tolerance (f32 1e-4, "
        "bf16 1e-2): Sq < Sk, Sq > Sk (zero and mean rows), S <= 128 "
        "single blocks, D in {16, 32, 64, 128}, non-causal, GQA groups 1, "
        "2, 3, transposed and sliced inputs")

    b, hq, hkv, s, d = (FLASH_REAL[k_] for k_ in ("b", "hq", "hkv", "s",
                                                    "d"))
    flops = 2 * b * hq * s * (s + 1) * d       # QK^T and PV, causal
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        args = qkv(b, hq, hkv, s, s, d, dtype)
        name = str(dtype).split(".")[1]
        e = err(fa.flash_attention(*args), ref.flash_attention_ref(*args))
        check(e <= FLASH_TOL[name], f"flash_attention real shape {name}: "
                                    f"max |err| {e}")
        nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) \
            * args[0].element_size()
        bound = max(flops / PEAK_FLOPS[name], nbytes / HBM_BYTES_PER_S) * 1e3

        def kern():
            return fa.flash_attention(*args)

        def lib():
            return F.scaled_dot_product_attention(*args, is_causal=True,
                                                  enable_gqa=True)
        lib_err = err(lib(), ref.flash_attention_ref(*args))
        r = dict(max_abs_err=e, ms=time_ms(kern, reps=10),
                 plain_ms=time_ms(lambda: ref.flash_attention_ref(*args),
                                  reps=3, warmup=1),
                 library_ms=time_ms(lib, reps=10), bound_ms=bound,
                 bound_by="operations")
        log(f"# phase 1: flash_attention {name} (B, Hq, Hkv, S, D) = "
            f"({b}, {hq}, {hkv}, {s}, {d}) causal: max |err| {e:.3g} "
            f"(tolerance {FLASH_TOL[name]}); kernel_ms={r['ms']:.4f} "
            f"device_ms={device_ms(kern, reps=10):.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"(SDPA, enable_gqa; max |err| {lib_err:.3g}) "
            f"bound_ms={bound:.4f} ({flops / 1e9:.1f} GFLOP at "
            f"{PEAK_FLOPS[name] / 1e12:.0f} TFLOP/s; {nbytes / 1e6:.0f} MB); "
            f"achieved {flops / r['ms'] / 1e9:.1f} TFLOP/s")
        row = r
        del args
    return row


def segment_check(got, values, ids, n: int, what: str) -> float:
    """Hold a segment_sum result against the plain version: |err| <=
    SEG_TOL * (the segment's sum of |v|) + 1e-6, per entry.  Returns the
    largest |err| / sum |v|.  The sum of |v| is taken in chunks of rows, so
    a 31.7 GB input is not copied whole."""
    import torch

    from repro_torch.kernels import ref
    want = ref.segment_sum_ref(values, ids, n)
    absum = torch.zeros_like(want)
    for lo in range(0, values.shape[0], 1 << 22):
        absum += ref.segment_sum_ref(values[lo:lo + (1 << 22)].abs(),
                                     ids[lo:lo + (1 << 22)], n)
    check(got.shape == want.shape and got.dtype == torch.float32,
          f"segment_sum {what}: shape/dtype {tuple(got.shape)} {got.dtype}")
    err = (got - want).abs()
    check(bool((err <= SEG_TOL * absum + 1e-6).all()),
          f"segment_sum {what}: differs from its plain version beyond "
          f"{SEG_TOL} of the segment's sum of |v|")
    rel = float((err / absum.clamp(min=1e-30)).max()) if err.numel() else 0.0
    del want, absum, err
    return rel


def segment_phase(dev):
    """Phase 1 for segment_sum: the kernel against its plain version at edge
    cases and at the training path's real shapes (MeshGraphNet on molecule
    and minibatch_lg, EquiformerV2 on molecule) and at one layer's
    aggregation at ogb-products scale, with uniform and RMAT-skewed ids;
    times there.  Returns the minibatch_lg row of the kernel table."""
    import numpy as np
    import torch

    from repro_torch.data import GraphBatchStream
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.models.gnn.common import molecule_union

    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def vals(m, d, dtype=torch.float32):
        return torch.randn((m, d), generator=gen, device=dev).to(dtype)

    def ids_in(lo, hi, m, dtype=torch.int32):
        return torch.as_tensor(rng.integers(lo, hi, m), dtype=dtype,
                               device=dev)

    # m = 0, n = 1, d in {1, 3, 4, 6272}, ids in [-2, n + 2), int64 ids,
    # bf16, a column slice (row stride > d, unaligned start) and 3-D values
    worst = 0.0
    for m, d, n in ((0, 4, 7), (5, 4, 1), (1000, 1, 177), (1000, 3, 177),
                    (1000, 4, 177), (333, 6272, 50)):
        for dtype in (torch.float32, torch.bfloat16):
            for lo, hi, idt in ((0, n, torch.int32), (-2, n + 2, torch.int32),
                                (-2, n + 2, torch.int64)):
                v, i = vals(m, d, dtype), ids_in(lo, hi, m, idt)
                worst = max(worst, segment_check(
                    ss.segment_sum(v, i, n), v, i, n,
                    f"m={m} d={d} n={n} {dtype} ids [{lo}, {hi})"))
    wide = vals(4096, 134)
    i = ids_in(0, 300, 4096)
    for cols in (slice(0, 128), slice(1, 129), slice(3, 9)):
        worst = max(worst, segment_check(ss.segment_sum(wide[:, cols], i, 300),
                                         wide[:, cols], i, 300, "slice"))
    v3 = wide[:, :120].reshape(4096, 15, 8)
    got = ops.segment_sum(v3, i, 300)
    check(got.shape == (300, 15, 8), "segment_sum 3-D shape")
    worst = max(worst, segment_check(got, v3, i, 300, "3-D"))
    torch.cuda.synchronize()
    log(f"# phase 1: segment_sum edge cases within {SEG_TOL} of each "
        f"segment's sum of |v| (largest {worst:.3g}): m = 0, n = 1, d in "
        f"{{1, 3, 4, 6272}}, f32 and bf16, ids in [-2, n + 2) int32 and "
        f"int64, column slices, 3-D values")

    union = molecule_union(GraphBatchStream(**MOLECULE, seed=0).batch_at(0),
                           dev)
    n_mol = MOLECULE["batch"] * MOLECULE["n_nodes"]
    lg_ids = ids_in(0, LG["n"], LG["m"], torch.int64)
    cases = [("MeshGraphNet molecule", vals(union["edge_dst"].shape[0], 128),
              union["edge_dst"], n_mol),
             ("MeshGraphNet minibatch_lg", vals(LG["m"], 128), lg_ids,
              LG["n"]),
             ("EquiformerV2 molecule", vals(union["edge_dst"].shape[0],
                                            49 * 128),
              union["edge_dst"], n_mol)]
    row = None
    for label, v, i, n in cases:
        row_ = segment_time(label, v, i, n)
        if label == "MeshGraphNet minibatch_lg":
            row = row_
        del v
    del cases, lg_ids, union

    # one layer's aggregation at ogb-products scale: 31.7 GB of values
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m, d, n = OGB["m"], OGB["d"], OGB["n"]
    v = vals(m, d)
    uni = torch.randint(0, n, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    segment_time("ogb_products uniform", v, uni, n, reps=5)
    del uni
    # RMAT-skewed destinations: the generator's column bits (a=0.57,
    # b=0.19, c=0.19, so a bit is 1 with p = b + d = 0.24) folded into [0, n)
    skew = torch.zeros((m,), dtype=torch.int64, device=dev)
    for _ in range(22):
        skew = skew * 2 + (torch.rand((m,), generator=gen, device=dev)
                           < 0.24)
    skew = skew % n
    hub = int(torch.bincount(skew, minlength=n).max())
    skew = skew.to(torch.int32)
    segment_time(f"ogb_products RMAT-skewed (hub in-degree {hub:,})", v,
                 skew, n, reps=5)
    log(f"# phase 1: segment_sum at ogb-products scale: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del v, skew
    torch.cuda.empty_cache()
    return row


def segment_time(label, v, ids, n: int, reps: int = 20):
    """Check and time segment_sum at one real shape: kernel (CUDA events
    and profiler), plain version, and the library call (``index_add_`` of
    the rows into a zeroed output; all ids are in range); the bytes bound
    reads each value and id once and writes each output once."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as ss
    m, d = v.shape
    rel = segment_check(ss.segment_sum(v, ids, n), v, ids, n, label)
    nbytes = m * d * v.element_size() + m * ids.element_size() + 4 * n * d

    def kern():
        return ss.segment_sum(v, ids, n)

    def lib():
        return torch.zeros((n, d), device=v.device).index_add_(0, ids, v)
    row = dict(max_abs_err=float((kern() - ref.segment_sum_ref(v, ids, n))
                                 .abs().max()),
               ms=time_ms(kern, reps=reps),
               plain_ms=time_ms(lambda: ref.segment_sum_ref(v, ids, n),
                                reps=reps),
               library_ms=time_ms(lib, reps=reps),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    log(f"# phase 1: segment_sum {label} ({m:,}, {d}) -> {n:,}: max |err| "
        f"{row['max_abs_err']:.3g} ({rel:.3g} of the segment's sum of |v|); "
        f"kernel_ms={row['ms']:.4f} device_ms={device_ms(kern, reps=reps):.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"(zeros + index_add_) bound_ms={row['bound_ms']:.4f} "
        f"({nbytes / 1e6:.0f} MB)")
    return row


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


# -- phase 5: the committed SCC and peel counts --------------------------------

def scc_peel_reference_phase(dev):
    import numpy as np

    from repro_torch.core import plan, plan_peel
    from repro_torch.core.scc import same_partition, scc_decompose, \
        tarjan_oracle
    from repro_torch.graphs import generators as G

    bench = json.loads((ROOT / "BENCH_scc.json").read_text())["families"]
    for family, kw in SCC_SIZES.items():
        g = G.BENCHMARK_GRAPHS[family][0](**kw, device=dev)
        t0 = time.perf_counter()
        labels, _ = scc_decompose(g, device=dev)
        rounds = plan(g, method="ac6", device=dev).run(counters=False).rounds
        got = dict(sccs=len(np.unique(labels)), rounds=rounds)
        want = {k: bench[family][k] for k in got}
        check(got == want, f"{family}: {got} != BENCH_scc.json {want}")
        check(same_partition(labels, tarjan_oracle(*g.to_numpy())),
              f"{family}: SCC labels differ from Tarjan's partition")
        log(f"# phase 5: BENCH_scc {family} n={g.n} m={g.m}: sccs="
            f"{got['sccs']} rounds={rounds} match; labels partition like "
            f"Tarjan ({time.perf_counter() - t0:.2f} s)")
    bench = json.loads((ROOT / "BENCH_peel.json").read_text())["families"]
    for family, kw in PEEL_SIZES.items():
        g = G.with_tiny_scc_fringe(G.BENCHMARK_GRAPHS[family][0](
            **kw, device=dev), **FRINGE)
        t0 = time.perf_counter()
        _, base = scc_decompose(g, trim2=False, device=dev)
        _, t2 = scc_decompose(g, trim2=True, device=dev)
        peel = plan_peel(g, device=dev)
        res = peel.run()
        got = dict(generations_base=base["generations"],
                   generations_trim2=t2["generations"],
                   pivots_base=base["pivots"], pivots_trim2=t2["pivots"],
                   trim2_removed=t2["trim2_removed"],
                   trim2_sccs=t2["trim2_sccs"], max_core=res.max_core,
                   one_core=int((res.coreness >= 1).sum()))
        want = {k: bench[family][k] for k in PEEL_KEYS}
        check(got == want, f"{family}: {got} != BENCH_peel.json {want}")
        check(bool((peel.run(k=1).status == plan(
            g, method="ac4", device=dev).run().status).all()),
              f"{family}: peel(k=1) differs from AC-4")
        log(f"# phase 5: BENCH_peel {family} n={g.n} m={g.m}: 8 keys match "
            f"{got}; peel(k=1) == AC-4 ({time.perf_counter() - t0:.2f} s)")


# -- phase 6: SCC / reach / peel at the real size ------------------------------

def kcore_oracle(src, dst, n: int, k: int):
    """The out-degree k-core by rounds of np.bincount on a copy of the
    edge arrays: drop every vertex with fewer than k live out-edges until
    none is dropped."""
    import numpy as np
    alive = np.ones(n, bool)
    while True:
        keep = alive[src] & alive[dst]
        src, dst = src[keep], dst[keep]
        new = alive & (np.bincount(src, minlength=n) >= k)
        if (new == alive).all():
            return alive
        alive = new


def scc_peel_real_phase(dev, g, gt):
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import breadth_first_order, \
        connected_components

    from repro_torch.core import plan, plan_peel, plan_reach
    from repro_torch.core.scc import same_partition, scc_decompose

    indptr, indices = g.to_numpy()
    # scipy's strong components are wrong on a CSR that keeps duplicate
    # edges (RMAT has them) unsorted: over the raw float64 CSR of
    # rmat(n_log2=12, m=32768, seed=1) scipy 1.17 reports 2,232
    # components where Tarjan and scc_decompose give 2,023.  Summing the
    # duplicates and sorting the indices first gives Tarjan's partition,
    # so every scipy oracle here reads the canonical CSR.
    csr = sp.csr_matrix((np.ones(g.m), indices, indptr), shape=(g.n, g.n),
                        copy=True)     # sum_duplicates works in place
    csr.sum_duplicates()
    csr.sort_indices()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # peel: full coreness, twice (the first run also builds the row ids)
    peel = plan_peel(g, transpose=gt, device=dev)
    walls = []
    for _ in range(2):
        res, wall = timed(lambda: peel.run().materialize())
        walls.append(wall)
    core = res.coreness
    src = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(indptr))
    t0 = time.perf_counter()
    for k in (1, 2, res.max_core):
        check(np.array_equal(core >= k, kcore_oracle(src, indices, g.n, k)),
              f"peel: the {k}-core differs from the numpy oracle")
    oracle_s = time.perf_counter() - t0
    ac4 = plan(g, method="ac4", transpose=gt, device=dev).run()
    check(torch.equal(peel.run(k=1).status, ac4.status),
          "peel(k=1) differs from AC-4 at the real size")
    log(f"# phase 6: peel: rounds={res.rounds} max_core={res.max_core} "
        f"one_core={int((core >= 1).sum())} wall_ms first={walls[0]:.1f} "
        f"second={walls[1]:.1f}; k-cores 1, 2, {res.max_core} equal the "
        f"numpy oracle ({oracle_s:.1f} s on the host); peel(k=1) == AC-4")

    # reach: both backends x {auto, dense} frontiers from vertex 0 and
    # from the first vertex of the 1-core other than 0
    for seed in (0, int(np.flatnonzero(core[1:] >= 1)[0]) + 1):
        want = np.zeros(g.n, bool)
        want[breadth_first_order(csr, seed, directed=True,
                                 return_predecessors=False)] = True
        for backend in ("windowed", "dense"):
            for frontier in ("auto", "dense"):
                eng = plan_reach(g, backend=backend, transpose=gt,
                                 frontier=frontier, device=dev)
                eng.run(seed)                  # builds the tile / row ids
                r, wall = timed(lambda: eng.run(seed).materialize())
                check(np.array_equal(r.mask, want),
                      f"reach {backend}/{frontier} from {seed} differs "
                      "from scipy's BFS")
                log(f"# phase 6: reach {backend}/{frontier} from {seed}: "
                    f"reached={int(want.sum())} rounds={r.rounds} "
                    f"wall_ms={wall:.1f}; equals scipy BFS")

    # SCC: default arguments, twice (each call plans its four engines and
    # builds Gᵀ once, as the reference does: a counting sort on the host,
    # timed alone here)
    _, transpose_ms = timed(g.transpose)
    walls = []
    for _ in range(2):
        (labels, stats), wall = timed(lambda: scc_decompose(g, device=dev))
        walls.append(wall)
    t0 = time.perf_counter()
    ncomp, comp = connected_components(csr, directed=True,
                                       connection="strong")
    check(len(np.unique(labels)) == ncomp and same_partition(labels, comp),
          "scc_decompose differs from scipy's strong components")
    log(f"# phase 6: scc: sccs={ncomp} generations={stats['generations']} "
        f"pivots={stats['pivots']} trim_dispatches="
        f"{stats['trim_dispatches']} trim2_dispatches="
        f"{stats['trim2_dispatches']} reach_dispatches="
        f"{stats['reach_dispatches']} trimmed_total={stats['trimmed_total']}"
        f" trim2_removed={stats['trim2_removed']} wall_ms first="
        f"{walls[0]:.1f} second={walls[1]:.1f} (of which one Gᵀ build "
        f"alone takes {transpose_ms:.1f}); partition equals scipy's "
        f"on the canonical CSR ({time.perf_counter() - t0:.1f} s on the "
        "host)")


# -- phases 8 and 9: the stream engine ----------------------------------------

class StreamFeed:
    """The trim-stream server's update feed (``src/repro/launch/serve.py``,
    the tick loop): each tick deletes ``k`` random live edges of the
    generated graph and, once ``lag`` batches wait, re-inserts the batch
    deleted ``lag`` ticks before.  Edges are addressed by their position
    in the generated graph, so compaction never changes the feed."""

    def __init__(self, g, k: int, seed: int = 0, lag: int = 3):
        import numpy as np
        indptr, indices = g.to_numpy()
        self.src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(indptr))
        self.dst = indices.astype(np.int64)
        self.rng = np.random.default_rng(seed)
        self.alive = np.ones(g.m, bool)
        self.pending = []
        self.k, self.lag = k, lag

    def next(self, insert: bool = True):
        """The next batch as ``apply`` keyword arguments; ``insert=False``
        holds the re-insertions back for a later tick."""
        import numpy as np
        k = min(self.k, int(self.alive.sum()))
        ids = self.rng.choice(np.nonzero(self.alive)[0], k, replace=False)
        self.alive[ids] = False
        ins = (self.pending.pop(0)
               if insert and len(self.pending) >= self.lag else None)
        if ins is not None:
            self.alive[ins] = True
        self.pending.append(ids)
        return dict(deletions=(self.src[ids], self.dst[ids]),
                    insertions=None if ins is None else (self.src[ins],
                                                         self.dst[ins]))


def stream_reference_phase(dev):
    """BENCH_stream.json's integer keys under ``bench_family``'s feed, then
    a mixed feed that compacts, grows and revives."""
    import numpy as np
    import torch

    from repro_torch.core import plan, plan_stream
    from repro_torch.graphs import generators as G

    bench = json.loads((ROOT / "BENCH_stream.json").read_text())["families"]
    for family, kw in STREAM_SIZES.items():
        g = G.BENCHMARK_GRAPHS[family][0](**kw, device=dev)
        t0 = time.perf_counter()
        engine = plan_stream(g)
        rng = np.random.default_rng(0)
        src, dst = engine.delta._src_np.copy(), engine.delta._dst_np.copy()
        k = max(1, g.m // 100)
        alive = np.ones(g.m, bool)

        def next_batch():
            ids = rng.choice(np.nonzero(alive)[0], k, replace=False)
            alive[ids] = False
            return src[ids], dst[ids]

        engine.apply(deletions=next_batch())
        want = plan(engine.snapshot(), method="ac4", device=dev).run().status
        check(torch.equal(engine.retrim().status, want),
              f"{family}: retrim() differs from AC-4 on the snapshot")
        engine.retrim(full=True)
        engine.apply(deletions=next_batch())
        engine.retrim(full=True)
        rounds, incr, full = [], [], []
        for _ in range(bench[family]["batches"]):
            batch = next_batch()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rounds.append(engine.apply(deletions=batch).rounds)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            engine.retrim(full=True)
            torch.cuda.synchronize()
            incr.append((t2 - t1) * 1e3)
            full.append((time.perf_counter() - t2) * 1e3)
        got = dict(n=g.n, m=g.m, batch_edges=k,
                   median_incr_rounds=int(np.median(rounds)),
                   trimmed=engine.retrim().n_trimmed)
        want = {key: bench[family][key] for key in STREAM_KEYS}
        check(got == want, f"{family}: {got} != BENCH_stream.json {want}")
        log(f"# phase 8: BENCH_stream {family} n={g.n} m={g.m}: keys match "
            f"{got}; apply ms median={np.median(incr):.2f} "
            f"retrim(full) ms median={np.median(full):.2f} "
            f"({time.perf_counter() - t0:.2f} s)")

    # mixed feed on the benchmark's RMAT: 1% deletions a tick, re-inserting
    # from the fourth tick; capacity 256 < one batch, load factor 0.05
    g = G.rmat(**STREAM_SIZES["RMAT"], device=dev)
    engine = plan_stream(g, load_factor=0.05)
    feed = StreamFeed(g, g.m // 100)
    dirty, cap0 = 0, engine.delta.capacity
    for tick in range(10):
        res = engine.apply(**feed.next())
        dirty += res.dirty
        want = plan(engine.snapshot(), method="ac4", device=dev).run().status
        check(torch.equal(engine.retrim().status, want),
              f"mixed feed tick {tick}: retrim() differs from AC-4")
    check(engine.compactions >= 2 and engine.delta.capacity > cap0
          and dirty >= 1,
          f"mixed feed: compactions={engine.compactions} capacity "
          f"{cap0}->{engine.delta.capacity} dirty ticks={dirty}")
    log(f"# phase 8: mixed feed on RMAT n={g.n}: 10 ticks equal AC-4 on the "
        f"snapshot; compactions={engine.compactions} capacity {cap0}->"
        f"{engine.delta.capacity} dirty ticks={dirty}")


def stream_real_phase(dev, g):
    """The trim-stream feed at the real size; every tick checked against
    AC-4 on the snapshot, the last one against the numpy oracle too.
    Returns the engine and its feed (``--profile`` continues them)."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaCSR, plan, plan_stream, trim_oracle

    k = g.m // 1000                      # the CLI's batch_frac of 0.001
    t0 = time.perf_counter()
    delta = DeltaCSR(g, capacity=max(4096, 16 * k))
    t1 = time.perf_counter()
    engine = plan_stream(delta)          # Gᵀ, permutation, full retrim
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    feed = StreamFeed(g, k)
    log(f"# phase 9: set-up: DeltaCSR (host index: argsort of {g.m} keys) "
        f"{(t1 - t0) * 1e3:.1f} ms; plan_stream (counting-sort Gᵀ + "
        f"permutation, plan-time retrim(full=True)) {(t2 - t1) * 1e3:.1f} "
        f"ms; capacity={delta.capacity} plan={engine.plan_signature()}; "
        f"feed arrays {(time.perf_counter() - t2) * 1e3:.1f} ms")
    walls = {False: [], True: []}       # apply ms, by "with insertions"
    for tick in range(STREAM_TICKS):
        batch = feed.next()
        n_upd = len(batch["deletions"][0]) + (
            0 if batch["insertions"] is None else len(batch["insertions"][0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.apply(**batch)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        walls[batch["insertions"] is not None].append(apply_ms)
        t0 = time.perf_counter()
        snap = engine.snapshot()
        t1 = time.perf_counter()
        want = plan(snap, method="ac4", device=dev).run().status
        check(torch.equal(engine.retrim().status, want),
              f"real-size tick {tick}: retrim() differs from AC-4")
        log(f"# phase 9: tick {tick}: {'with insertions' if batch['insertions'] is not None else 'deletion-only'} "
            f"updates={n_upd} apply_ms={apply_ms:.1f} rounds={res.rounds} "
            f"dirty={res.dirty} updates_per_s={n_upd / apply_ms * 1e3:.0f} "
            f"trimmed={res.n_trimmed}; snapshot {(t1 - t0) * 1e3:.0f} ms, "
            f"AC-4 check {(time.perf_counter() - t1) * 1e3:.0f} ms: equal")
    log(f"# phase 9: apply_ms median: deletion-only "
        f"{np.median(walls[False]):.1f} (ticks {len(walls[False])}), with "
        f"insertions {np.median(walls[True]):.1f} "
        f"(ticks {len(walls[True])})")
    t0 = time.perf_counter()
    want = trim_oracle(*snap.to_numpy())
    check(np.array_equal(engine.retrim().status.cpu().numpy().astype(bool),
                         want), "real-size stream differs from the oracle")
    log(f"# phase 9: last tick equals the numpy oracle "
        f"({time.perf_counter() - t0:.1f} s on the host); compactions="
        f"{engine.compactions} n_ins={engine.delta.n_ins} "
        f"n_tomb={engine.delta.n_tomb}")
    before = engine.retrim().status.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = engine.retrim(full=True)
    torch.cuda.synchronize()
    check(torch.equal(full.status, before), "retrim(full=True) differs")
    log(f"# phase 9: retrim(full=True): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, rounds={full.rounds}")
    return engine, feed


# -- phase 13: the static checks ----------------------------------------------

def static_checks_phase():
    """(a): the checker's strict and mutant runs through both entry
    points."""
    from repro_torch.analysis import check as ac
    from repro_torch.launch import trim as cli
    out = ROOT / "build" / "analysis_strict.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    check(ac.main(["--strict", "--json", str(out)]) == 0,
          "the static checks failed under --strict")
    report = json.loads(out.read_text())
    check(report["counts"]["error"] == 0 and report["counts"]["warning"] == 0,
          f"static checks: {report['counts']}")
    t_strict = time.perf_counter() - t0
    t0 = time.perf_counter()
    mutants, ok = ac.run_mutant_checks()
    check(ok, "a mutant survived its checker, or the copy kernel's own "
              "geometry was flagged")
    caught = sum(f.checker == "mutant-caught" for f in mutants.findings)
    waiting = sum(f.checker == "mutant-waiting" for f in mutants.findings)
    check(cli.main(["--app", "check", "--mutants"]) == 0,
          "launch.trim --app check --mutants failed")
    log(f"# phase 13: static checks --strict: 0 errors, 0 warnings; "
        f"subjects per checker {report['subjects_checked']} "
        f"({t_strict:.1f} s on the host CPU); --mutants: {caught} caught, "
        f"{waiting} waiting (A7), copy kernel clean "
        f"({time.perf_counter() - t0:.2f} s for both entry points)")


def card_launches(calls):
    """Run ``calls`` (thunks) on the card under torch.profiler; the port's
    kernels that ran, in order, as ``(kernel, grid, block)`` from the
    chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.capture import profiled_launches
    from repro_torch.analysis.catalog import LAUNCH_DECLARATIONS
    from repro_torch.analysis.mutants import MUTANT_DECLARATIONS
    names = {k for _, k in (*LAUNCH_DECLARATIONS, *MUTANT_DECLARATIONS)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "analysis_trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    return profiled_launches(trace, names)


def declarations_phase(dev, g_t, cap, ecap):
    """(b): every catalog point and one real-size call per kernel: the
    captured launch records against the kernels the card ran."""
    import torch

    from repro_torch.analysis.capture import capture_kernel
    from repro_torch.analysis.catalog import KERNEL_CATALOG, tensor
    from repro_torch.kernels import bucket_peel as bpl
    from repro_torch.kernels import counter_scatter as cs
    from repro_torch.kernels import first_live_scan as fls
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import frontier_expand as fex
    from repro_torch.kernels import mutant_copy as mc
    from repro_torch.kernels import segment_sum as ss

    n = g_t.n
    b, hq, hkv, s_, d = (FLASH_REAL[k] for k in ("b", "hq", "hkv", "s", "d"))
    # phase 1's real shapes, zero-filled (zeros are valid input to each)
    real = [
        (fls.first_live_scan, ((n, 16), (n, 16), n), ("bool",) * 3, {}),
        (fc.prefix_positions, (n,), ("int32",), {}),
        (fc.frontier_compact, (n, cap), ("bool", None), {}),
        (fc.sparse_expand, (n + 1, g_t.m, cap, ecap),
         ("int32", "int32", "int32", None), {}),
        (fex.frontier_expand, ((n, 16), (n, 16), n), ("bool",) * 3, {}),
        (bpl.bucket_peel, (n, n, 1), ("int32", "bool", "int32"), {}),
        (cs.counter_scatter, (n, n, 65_536, 65_536),
         ("int32", "bool", "int32", "int32"), {}),
        (fa.flash_attention, ((b, hq, s_, d), (b, hkv, s_, d),
                              (b, hkv, s_, d)), ("bfloat16",) * 3, {}),
        (ss.segment_sum, ((LG["m"], 128), LG["m"], LG["n"]),
         ("float32", "int64", None), {}),
        (mc.mutant_copy, (MUTANT_N,), ("int32",), {}),
        (mc.mutant_copy, (64, 1), ("int32", "int32"), {"block": 16}),
        (mc.mutant_copy, (64,), ("int32",), {"block": 16}),
    ]

    def args_on(shapes, dtypes, device):
        return [sh if dt is None else tensor(sh, dt, 0, device)
                for sh, dt in zip(shapes, dtypes)]

    want, calls, points = [], [], 0
    for entry in KERNEL_CATALOG:
        for point in entry.points:
            want += entry.build(point)
            calls.append(lambda e=entry, p=point: e.run(p, dev))
            points += 1
    for fn, shapes, dtypes, kw in real:
        want += capture_kernel(fn, *args_on(shapes, dtypes, "meta"), **kw)
        args = args_on(shapes, dtypes, dev)
        calls.append(lambda fn=fn, args=args, kw=kw: fn(*args, **kw))
    got = card_launches(calls)
    want = [(w.kernel, tuple(w.grid), tuple(w.block)) for w in want]
    for i, (w, g_) in enumerate(zip(want, got)):
        check(w == g_, f"launch {i}: captured {w}, the card ran {g_}")
    check(len(want) == len(got), f"{len(want)} launches captured, "
                                 f"{len(got)} on the card")
    torch.cuda.synchronize()
    log(f"# phase 13: declarations held against the card: {len(got)} "
        f"launches ({points} catalog points, {len(real)} real-size calls; "
        f"{len({k for k, _, _ in got})} kernels) ran with the captured "
        f"kernel, grid and block, in order")


def mutant_copy_phase(dev):
    """(c): the copy kernel against x.clone(), bit for bit; times at
    n = MUTANT_N.  Returns its row of the kernel table."""
    import torch

    from repro_torch.kernels import mutant_copy as mc
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def ints(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int32)
    carry = torch.tensor([7], dtype=torch.int32, device=dev)
    for n in (0, 1, 255, 1000, 4097):
        x = ints(n)
        for c in (None, carry):
            for block in (16, 256, 1024):
                got = mc.mutant_copy(x, c, block=block)
                check(torch.equal(got, ref.mutant_copy_ref(x, c)),
                      f"mutant_copy n={n} block={block} carry={c}")
    x = ints(MUTANT_N)
    err = max_abs_err((mc.mutant_copy(x),), (x.clone(),))
    check(err == 0, "mutant_copy differs from x.clone() at the real size")
    check(torch.equal(mc.mutant_copy(x, carry), x + 7),
          "mutant_copy with a carry differs at the real size")

    def kern():
        return mc.mutant_copy(x)
    row = dict(max_abs_err=err, ms=time_ms(kern),
               plain_ms=time_ms(lambda: ref.mutant_copy_ref(x)),
               library_ms=time_ms(x.clone),
               bound_ms=8 * MUTANT_N / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    log(f"# phase 13: mutant_copy bit-identical to x.clone() (n = 0, 1, "
        f"255, 1000, 4097 and {MUTANT_N:,}; blocks 16, 256, 1024; with and "
        f"without the carry word); n={MUTANT_N:,}: kernel_ms="
        f"{row['ms']:.4f} device_ms={device_ms(kern):.4f} plain_ms="
        f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"(x.clone()) bound_ms={row['bound_ms']:.4f}")
    return row


def sync_budget_phase(dev, g, gt):
    """(d): one warm AC-4 and one AC-6 trim at the real size: the host
    syncs torch counts on the card, and the CPU lint's counter, against
    the lint's budget for the rounds and probe steps the card ran."""
    import warnings

    import torch

    from repro_torch.analysis import syncs
    from repro_torch.analysis.catalog import PLAN_CATALOG
    from repro_torch.core import plan
    budgets = {e.name: e for e in PLAN_CATALOG}
    # the auto frontier syncs as the sparse one does: one read a round,
    # which also carries the dense/sparse choice
    for method, entry in (("ac4", "trim/ac4[probe=dense,frontier=sparse]"),
                          ("ac6", "trim/ac6[probe=dense,frontier=sparse]")):
        eng = plan(g, method=method, workers=16, transpose=gt, device=dev)
        eng.run()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            with syncs.probe_tests() as probes:
                with syncs.SyncCounter() as counter:
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        res = eng.run()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
        card = sum(SYNC_WARNING in str(w.message) for w in rec)
        rounds, tests = res.rounds, probes.tests()
        want = syncs.budget(budgets[entry], rounds, tests)
        log(f"# phase 13: {method} at RMAT scale 22 (auto frontier): "
            f"{rounds} rounds, {tests} probe-loop tests; host syncs on the "
            f"card {card}, counted by the lint {counter.syncs}, budget "
            f"{want}")
        sites = [f"{Path(w.filename).name}:{w.lineno}" for w in rec
                 if SYNC_WARNING in str(w.message)]
        check(card == want and counter.syncs == want,
              f"{method}: {card} syncs on the card ({sites}), "
              f"{counter.syncs} by the lint ({counter.events}), budget "
              f"{want}")


# -- phase 10: the command line ------------------------------------------------

def cli_phase():
    from repro_torch.launch import trim as cli
    for app in ("trim", "scc", "stream", "peel"):
        t0 = time.perf_counter()
        cli.main(["--app", app, "--graph", "RMAT"])
        log(f"# phase 10: --app {app} --graph RMAT done in "
            f"{time.perf_counter() - t0:.1f} s")


# -- phase 11: LM serving at full width --------------------------------------

def decode_vs_forward(lm, tokens, prompt: int, steps: int):
    """The logits at positions prompt - 1 .. prompt + steps - 1, two ways:
    ``forward(tokens)``, and ``prefill(tokens[:, :prompt])``'s last logits
    followed by ``steps`` decode steps teacher-forced on ``tokens``.  The
    prefill and forward attend through the flash kernel, decode through
    plain einsums.  Returns two (B, steps + 1, V) f32 tensors."""
    import torch
    full, _, _ = lm(tokens)
    check(bool(torch.isfinite(full).all()), "non-finite logits")
    fwd = full[:, prompt - 1:prompt + steps].clone()
    del full
    last, cache = lm.prefill(tokens[:, :prompt], cache_len=tokens.shape[1])
    got = [last]
    for p in range(prompt, prompt + steps):
        logits, cache = lm.decode_step(cache, tokens[:, p:p + 1], p)
        got.append(logits)
    return fwd, torch.stack(got, dim=1)


def serve_phase(dev):
    """Phase 11: ``serve_lm`` at the published width, launch counts set to
    0 just before it and read just after; then the prefill against the
    decode at full width in bf16, and in f32 at B = 2."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, serve_lm
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get(SERVE["arch"]).make_config()
    lm = LM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SERVE["seed"]))     # as serve_lm draws it
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in lm.parameters())
    total = SERVE["prompt_len"] + SERVE["gen_len"]
    cache_bytes = 2 * cfg.n_layers * SERVE["batch"] * total \
        * cfg.n_kv_heads * cfg.d_head * 2
    log(f"# phase 11: {cfg.name}: {cfg.param_count():,} parameters "
        f"({weights / 1e9:.2f} GB in {cfg.param_dtype}), drawn on the card "
        f"in {(time.perf_counter() - t0) * 1e3:.0f} ms; KV cache "
        f"{cache_bytes / 1e9:.2f} GB in {cfg.compute_dtype}")
    ops.reset_launches()
    toks, stats = serve_lm(SERVE["arch"], batch=SERVE["batch"],
                           prompt_len=SERVE["prompt_len"],
                           gen_len=SERVE["gen_len"], seed=SERVE["seed"],
                           smoke=False, device=dev, lm=lm, return_stats=True)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times "
          f"in one prefill, not {cfg.n_layers}")
    check(toks.shape == (SERVE["batch"], SERVE["gen_len"] + 1)
          and toks.min() >= 0 and toks.max() < cfg.vocab,
          f"served tokens {toks.shape} out of range")
    dec = np.asarray(stats["decode_ms"])
    n_tok = SERVE["batch"] * SERVE["gen_len"]
    log(f"# phase 11: serve_lm {SERVE['batch']} x {SERVE['prompt_len']} "
        f"prompt tokens, {SERVE['gen_len']} new: launches {launches}; "
        f"prefill_ms={stats['prefill_ms']:.1f} decode_ms per step median "
        f"{np.median(dec):.2f} (first {dec[0]:.2f}, max {dec.max():.2f}); "
        f"{n_tok / dec.sum() * 1e3:.0f} tok/s decode; peak device memory "
        f"{peak / 1e9:.2f} GB")
    _, warm = generate(lm, torch.as_tensor(
        np.random.default_rng(SERVE["seed"] + 1).integers(
            0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"])),
        device=dev), SERVE["gen_len"])
    dec = np.asarray(warm["decode_ms"])
    log(f"# phase 11: warm repeat: prefill_ms={warm['prefill_ms']:.1f} "
        f"decode_ms per step median {np.median(dec):.2f}; "
        f"{n_tok / dec.sum() * 1e3:.0f} tok/s decode; prefill "
        f"{SERVE['batch'] * SERVE['prompt_len'] / warm['prefill_ms'] * 1e3:.0f}"
        f" tok/s")

    # decode against forward.  f32: directly, to 1e-3.  bf16: 28 layers of
    # bf16 rounding move the full-width logits (std 1, max ~5.4) by up to
    # ~0.12 on either path (measured on an H100: 0.11-0.13 for forward and
    # for decode), more than the reference's 2-layer 6e-2.  So both are
    # held against the f32 forward on the same weights: the bf16 forward
    # within 5% of the largest logit, and decode at most 1.5x as far from
    # it as the bf16 forward.
    rng = np.random.default_rng(SERVE["seed"] + 2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (
        SERVE["batch"], SERVE["prompt_len"])), device=dev)
    prompt, steps = SERVE["prompt_len"] - 128, 4
    lm32 = LM(dataclasses.replace(cfg, compute_dtype=torch.float32),
              device=dev, init=False)
    lm32.load_state_dict(lm.state_dict(), assign=True)    # shared weights
    fwd, dec = decode_vs_forward(lm32, tokens[:2, :512], 384, steps)
    err = float((dec - fwd).abs().max())
    check(err <= 1e-3, f"f32, B=2, T=512: decode differs from forward "
                       f"(max |err| {err}, tolerance 1e-3)")
    log(f"# phase 11: f32, B=2, T=512: prefill(384) and {steps} decode "
        f"steps equal forward(512): max |err| {err:.3g} (tolerance 1e-3)")
    truth = lm32(tokens)[0][:, prompt - 1:prompt + steps].clone()
    del lm32
    fwd, dec = decode_vs_forward(lm, tokens, prompt, steps)
    noise = float((fwd - truth).abs().max())
    err = float((dec - truth).abs().max())
    direct = float((dec - fwd).abs().max())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    check(noise <= 0.05 * float(truth.abs().max()),
          f"bf16 forward lies {noise} from the f32 forward")
    check(err <= 1.5 * noise, f"bf16, B={SERVE['batch']}, T="
          f"{SERVE['prompt_len']}: decode lies {err} from the f32 forward, "
          f"over 1.5x the bf16 forward's {noise}")
    log(f"# phase 11: bf16, B={SERVE['batch']}, T={SERVE['prompt_len']}: "
        f"prefill({prompt}) and {steps} decode steps against forward: max "
        f"|err| {direct:.3g}, argmax equal {agree:.3f}; against the f32 "
        f"forward: decode {err:.3g}, bf16 forward {noise:.3g} (decode "
        f"within 1.5x); |logits| max {float(truth.abs().max()):.2f}")
    torch.cuda.empty_cache()
    return lm, launches


# -- phase 12: GNN training at full width --------------------------------------

def grad_check(model, cpu_model, union_dev, union_cpu, arch: str):
    """One molecule step's loss and gradients on the card against the same
    step on the CPU (the plain segment sum), on the same weights and batch.
    Returns (loss on the card, relative loss error, worst gradient error
    as a share of its tensor's largest entry, the gradients' float32
    global norm as AdamW computes it, and the largest |g| with its
    parameter's name)."""
    import torch

    from repro_torch.models.gnn.common import molecule_loss
    from repro_torch.optim import global_norm
    loss = molecule_loss(model, union_dev)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    closs = molecule_loss(cpu_model, union_cpu)
    cgrads = torch.autograd.grad(closs, list(cpu_model.parameters()))
    lerr = abs(loss.item() - closs.item()) / abs(closs.item())
    gerr = max(float((g.cpu() - c).abs().max())
               / max(float(c.abs().max()), 1e-30)
               for g, c in zip(grads, cgrads))
    check(lerr <= TRAIN_TOL["loss"], f"{arch}: loss on the card differs from "
          f"the CPU's by {lerr:.3g} relative")
    check(gerr <= TRAIN_TOL["grad"], f"{arch}: a gradient on the card "
          f"differs from the CPU's by {gerr:.3g} of its largest entry")
    top = max((float(g.abs().max()), name) for g, (name, _) in
              zip(grads, model.named_parameters()))
    return loss.item(), lerr, gerr, float(global_norm(grads)), top


def train_run(model, stream, put, steps: int, loss_fn):
    """``steps`` AdamW steps (lr 1e-3, the launcher's) through the port's
    Trainer, the launch counts set to 0 just before and read just after.
    Returns (losses, step seconds, launches, (peak device bytes, bytes
    already held when the run began: the model, the batch and what earlier
    phases keep, such as the served LM))."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.train import Trainer, TrainerConfig

    opt = AdamW(lr=1e-3)
    params = list(model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    tr = Trainer(make_train_step(model, opt, loss_fn), params,
                 opt.init(params), stream,
                 TrainerConfig(num_steps=steps, log_every=steps), put_batch=put)
    hist = tr.run()
    launches = dict(ops.LAUNCHES)
    losses = [h["loss"] for h in hist]
    check(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    return losses, list(tr.monitor.times), launches, \
        (torch.cuda.max_memory_allocated(), held)


def loss_after(model, batch, loss_fn, before: float, what: str,
               frozen=None) -> float:
    """The loss on the first step's batch after training; it must lie
    below the first step's loss on that batch (the stream's batches differ
    from step to step, so the history alone does not show learning).
    ``frozen``: the parameters before training, where the gradients' f32
    global norm overflowed: the reference's AdamW then clips every update
    to 0, so the parameters must be unchanged bit for bit and the loss the
    same up to the atomics' order (1e-5 relative)."""
    import torch
    with torch.no_grad():
        after = loss_fn(model, batch).item()
    if frozen is None:
        check(math.isfinite(after) and after < before,
              f"{what}: the loss on the first batch went {before} -> {after}")
    else:
        check(all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                    frozen)),
              f"{what}: parameters moved under an infinite global norm")
        check(abs(after - before) <= 1e-5 * abs(before),
              f"{what}: the loss on the first batch went {before} -> {after} "
              "with the parameters unchanged")
    return after


class FixedBatch:
    """A stream that serves one batch at every step (full-graph training)."""

    def __init__(self, batch):
        self.batch = batch

    def batch_at(self, step: int):
        return self.batch


def lg_batch(dev):
    """The minibatch_lg cell at its exact counts: a random graph, features
    and labels from numpy seed 0, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    n, m = LG["n"], LG["m"]
    host = {"feats": rng.standard_normal((n, LG["d_feat"]), np.float32),
            "pos": rng.standard_normal((n, 3), np.float32),
            "edge_src": rng.integers(0, n, m),
            "edge_dst": rng.integers(0, n, m),
            "labels": rng.integers(0, LG["classes"], n)}
    return {k: torch.as_tensor(v, device=dev) for k, v in host.items()}


def train_phase(dev):
    """Phase 12: the four GNNs at their published configs on the molecule
    cell (5 steps each; the first step's loss and gradients against the CPU
    on the same weights and batch), MeshGraphNet on minibatch_lg (3 steps),
    and the train launcher.  Returns the summed launch counts and the step
    closures that ``--profile`` times."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import GraphBatchStream
    from repro_torch.launch import train as cli
    from repro_torch.models import convert
    from repro_torch.models.gnn import MODELS
    from repro_torch.models.gnn.common import (molecule_loss,
                                               molecule_union, pooled_loss)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    profiled = {}
    for arch in GNN_ARCHS:
        cfg = configs.get(arch).make_config()
        t0 = time.perf_counter()
        model = MODELS[type(cfg)](cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        cpu_model = convert.gnn_from_numpy(cfg, convert.gnn_to_numpy(model),
                                           device="cpu")
        stream = GraphBatchStream(**MOLECULE, seed=0)
        batch0 = stream.batch_at(0)
        loss0, lerr, gerr, gnorm, top = grad_check(
            model, cpu_model, molecule_union(batch0, dev),
            molecule_union(batch0, "cpu"), arch)
        check_s = time.perf_counter() - t0
        # EquiformerV2 at its published depth: each equivariant layer norm
        # divides an all-zero l > 0 block by sqrt(1e-6), so the gradients
        # reach ~1e29 at initialisation and their f32 global norm
        # overflows.  The reference does the same at the published depth
        # with 8 channels (tests/test_torch_train.py; ROADMAP C)
        frozen = ([p.detach().clone() for p in model.parameters()]
                  if math.isinf(gnorm) else None)
        losses, times, launches, peak = train_run(
            model, stream, lambda b: molecule_union(b, dev), TRAIN_STEPS,
            molecule_loss)
        want = TRAIN_STEPS * SEG_PER_STEP[arch](cfg)
        check(launches["segment_sum"] == want,
              f"{arch}: segment_sum launched {launches['segment_sum']} times "
              f"in {TRAIN_STEPS} steps, not {want}")
        check(abs(losses[0] - loss0) <= TRAIN_TOL["loss"] * abs(loss0),
              f"{arch}: the trainer's first loss {losses[0]} is not the "
              f"checked step's {loss0}")
        after = loss_after(model, molecule_union(batch0, dev), molecule_loss,
                           loss0, arch, frozen)
        del frozen
        add(launches)
        n_par = sum(p.numel() for p in model.parameters())
        log(f"# phase 12: {arch} ({n_par:,} parameters) on molecule "
            f"(B={MOLECULE['batch']}, {MOLECULE['n_nodes']} nodes, "
            f"{MOLECULE['n_edges']} edges): step 1 against the CPU: loss "
            f"{lerr:.3g} relative (tolerance {TRAIN_TOL['loss']}), gradients "
            f"{gerr:.3g} of their largest entry (tolerance "
            f"{TRAIN_TOL['grad']}) ({check_s:.1f} s); global norm "
            f"{gnorm:.4g}{INF_NOTE if math.isinf(gnorm) else ''}, largest "
            f"|g| {top[0]:.4g} ({top[1]}); loss "
            f"{' -> '.join(f'{x:.4f}' for x in losses)}, on the first batch "
            f"{loss0:.4f} -> {after:.4f}; step_ms first "
            f"{times[0] * 1e3:.1f}, median of the rest "
            f"{np.median(times[1:]) * 1e3:.1f}; launches {launches}; peak "
            f"device memory {peak[0] / 1e9:.2f} GB ({peak[1] / 1e9:.2f} GB "
            f"held before the run)")
        if arch == "meshgraphnet":
            held = molecule_union(stream.batch_at(7), dev)
            profiled["meshgraphnet molecule step"] = (model, held,
                                                      molecule_loss)
        del cpu_model
        torch.cuda.empty_cache()

    # MeshGraphNet on minibatch_lg: full-graph node classification
    t0 = time.perf_counter()
    batch = lg_batch(dev)
    cfg = dataclasses.replace(configs.get("meshgraphnet").make_config(),
                              out_dim=LG["classes"])
    model = MODELS[type(cfg)](cfg, d_feat=LG["d_feat"], device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, times, launches, peak = train_run(
        model, FixedBatch(batch), None, LG["steps"], pooled_loss)
    after = loss_after(model, batch, pooled_loss, losses[0], "minibatch_lg")
    want = LG["steps"] * cfg.n_layers
    check(launches["segment_sum"] == want,
          f"minibatch_lg: segment_sum launched {launches['segment_sum']} "
          f"times, not {want}")
    add(launches)
    med = float(np.median(times[1:]))
    log(f"# phase 12: meshgraphnet on minibatch_lg ({LG['n']:,} nodes, "
        f"{LG['m']:,} edges, d_feat {LG['d_feat']}, {LG['classes']} "
        f"classes; data drawn in {setup_s:.1f} s): loss "
        f"{' -> '.join(f'{x:.4f}' for x in losses)} -> {after:.4f}; "
        f"step_ms first "
        f"{times[0] * 1e3:.1f}, median of the rest {med * 1e3:.1f}; "
        f"{LG['n'] / med:,.0f} nodes/s; launches {launches}; peak device "
        f"memory {peak[0] / 1e9:.2f} GB ({peak[1] / 1e9:.2f} GB held before "
        f"the run)")
    profiled["meshgraphnet minibatch_lg step"] = (model, batch, pooled_loss)

    # the launcher, as a user runs it: the published config on the card
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["--arch", "meshgraphnet", "--steps", str(TRAIN_STEPS)])
    line = out.getvalue().strip().splitlines()[-1]
    check(line.startswith("[train] meshgraphnet: first loss "),
          f"the train launcher printed {line!r}")
    add(dict(ops.LAUNCHES))
    log(line)
    log(f"# phase 12: python -m repro_torch.launch.train --arch meshgraphnet "
        f"--steps {TRAIN_STEPS} done in {time.perf_counter() - t0:.1f} s; "
        f"launches {dict(ops.LAUNCHES)}")
    return totals, profiled


# -- phase 7 (--profile): where the time goes ----------------------------------

def profile_run(label, fn):
    """One call of ``fn`` under torch.profiler: wall time, device-busy
    time (CUDA kernel and copy time summed over the one stream), the idle
    share, the host syncs (counted by torch's sync debug mode on a
    separate call), and the device items that take the most time."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        note = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.device_time / 1e3, cnt + 1)
    busy = sum(tot for tot, _ in by_name.values())
    items = sum(cnt for _, cnt in by_name.values())
    kern = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(SYNC_WARNING in str(w.message) for w in rec)
    top = "; ".join(f"{name[:48]} {tot:.1f}ms x{cnt}"
                    for name, (tot, cnt) in kern[:6])
    log(f"# profile: {label}: wall_ms={wall:.1f} "
        f"device_busy_ms={busy:.1f} idle_share={1 - busy / wall:.3f} "
        f"{note} host_syncs={syncs} device_items={items} | {top}")

def host_profile(label, fn, top: int = 8):
    """One call of ``fn`` under cProfile: the host functions that take the
    most time of their own (numpy and torch calls count as one entry
    each)."""
    import cProfile
    import pstats

    import torch
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    note = fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    log(f"# profile: {label} on the host: wall_ms={wall:.1f} {note} | "
        + "; ".join(f"{fn_[2]} ({Path(fn_[0]).name}:{fn_[1]}) "
                    f"{tt * 1e3:.1f}ms x{nc}"
                    for fn_, (_, nc, tt, _, _) in rows))


def profile_phase(dev, g, gt, stream, feed, lm, profiled):
    """Per trimming method at the real size, then one ``scc_decompose``,
    one full peel, the stream engine's deletion-only ``apply``, its
    ``apply`` with insertions and ``retrim(full=True)``, the served LM's
    prefill (8 x 2048 tokens) and one decode step, and one MeshGraphNet
    training step on molecule and on minibatch_lg (forward, backward and
    AdamW): see :func:`profile_run`.  Each engine and step runs once before
    it is profiled; each stream call takes the feed's next batch."""
    from repro_torch.core import plan, plan_peel
    from repro_torch.core.scc import scc_decompose

    for method, backend in (("ac3", "windowed"), ("ac3", "dense"),
                            ("ac4", "dense"), ("ac4*", "dense"),
                            ("ac6", "windowed"), ("ac6", "dense")):
        eng = plan(g, method=method, backend=backend, workers=16,
                   transpose=gt, device=dev)
        eng.run().materialize()
        profile_run(f"{method}/{backend}",
                    lambda: f"rounds={eng.run().materialize().rounds}")

    def scc():
        _, stats = scc_decompose(g, device=dev)
        return (f"generations={stats['generations']} "
                f"pivots={stats['pivots']}")
    profile_run("scc_decompose", scc)
    peel = plan_peel(g, transpose=gt, device=dev)
    peel.run().materialize()
    profile_run("peel", lambda: f"rounds={peel.run().materialize().rounds}")

    def apply(insert, batch=None):
        res = stream.apply(**(batch or feed.next(insert=insert)))
        return f"rounds={res.rounds} dirty={res.dirty}"
    batch = feed.next(insert=False)     # drawn outside the host profile
    host_profile("stream apply, deletion-only",
                 lambda: apply(False, batch))
    profile_run("stream apply, deletion-only", lambda: apply(False))
    profile_run("stream apply, with insertions", lambda: apply(True))
    profile_run("stream retrim(full=True)",
                lambda: f"rounds={stream.retrim(full=True).rounds}")

    import numpy as np
    import torch
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, lm.cfg.vocab, (SERVE["batch"], SERVE["prompt_len"])), device=dev)
    held = {}

    def prefill():
        held["logits"], held["cache"] = lm.prefill(
            prompts, cache_len=SERVE["prompt_len"] + SERVE["gen_len"])
        return f"B={SERVE['batch']} S={SERVE['prompt_len']}"
    profile_run("serve prefill", prefill)
    tok = held["logits"].argmax(-1, keepdim=True)

    def step():
        lm.decode_step(held["cache"], tok, SERVE["prompt_len"])
        return f"B={SERVE['batch']} pos={SERVE['prompt_len']}"
    profile_run("serve decode step", step)
    del lm, held
    torch.cuda.empty_cache()

    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW
    for label, (model, batch, loss_fn) in profiled.items():
        opt = AdamW(lr=1e-3)
        params = list(model.parameters())
        state = {"opt": opt.init(params)}
        train_step = make_train_step(model, opt, loss_fn)

        def one_step():
            _, state["opt"], metrics = train_step(params, state["opt"],
                                                  batch)
            return f"loss={metrics['loss'].item():.4f}"
        one_step()
        profile_run(label, one_step)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the real-size runs (phase 7, last)")
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
    rows["flash_attention"] = flash_phase(dev)
    rows["segment_sum"] = segment_phase(dev)
    t0 = time.perf_counter()
    ops.reset_launches()
    static_checks_phase()
    declarations_phase(dev, gt, fplan.cap, fplan.ecap)
    analysis_launches = dict(ops.LAUNCHES)
    log(f"# phase 13: launches in (a) and (b): {analysis_launches}")
    for name in ANALYSIS_PATH:
        check(analysis_launches[name] > 0,
              f"{name} was never launched in the static checks' phase")
    rows["mutant_copy"] = mutant_copy_phase(dev)
    sync_budget_phase(dev, g, gt)
    log(f"# phase 13: done in {time.perf_counter() - t0:.1f} s")
    ops.reset_launches()
    reference_phase(dev)
    log(f"# phase 4: launches in phase 2 (BENCH_trim.json sizes): "
        f"{dict(ops.LAUNCHES)}")
    ops.reset_launches()
    real_phase(dev, g, gt)
    trim_launches = dict(ops.LAUNCHES)
    log(f"# phase 4: launches in phase 3 (the real-size trimming path): "
        f"{trim_launches}")
    for name in TRIM_PATH:
        check(trim_launches[name] > 0,
              f"{name} was never launched on the trimming path")
    scc_peel_reference_phase(dev)
    ops.reset_launches()
    scc_peel_real_phase(dev, g, gt)
    scc_launches = dict(ops.LAUNCHES)
    log(f"# phase 6: launches in phase 6 (the real-size SCC / reach / peel "
        f"path): {scc_launches}")
    for name in SCC_PEEL_PATH:
        check(scc_launches[name] > 0,
              f"{name} was never launched on the SCC / reach / peel path")
    stream_reference_phase(dev)
    ops.reset_launches()
    stream, feed = stream_real_phase(dev, g)
    stream_launches = dict(ops.LAUNCHES)
    log(f"# phase 9: launches in phase 9 (the real-size stream path): "
        f"{stream_launches}")
    for name in STREAM_PATH:
        check(stream_launches[name] > 0,
              f"{name} was never launched on the stream path")
    cli_phase()
    lm, serve_launches = serve_phase(dev)
    for name in SERVE_PATH:
        check(serve_launches[name] > 0,
              f"{name} was never launched on the serving path")
    train_launches, profiled = train_phase(dev)
    log(f"# phase 12: launches in phase 12 (the training path, counts set "
        f"to 0 before each run and summed): {train_launches}")
    for name in TRAIN_PATH:
        check(train_launches[name] > 0,
              f"{name} was never launched on the training path")
    if args.profile:
        profile_phase(dev, g, gt, stream, feed, lm, profiled)

    path_launches = {**{n: trim_launches for n in TRIM_PATH},
                     **{n: scc_launches for n in SCC_PEEL_PATH},
                     **{n: stream_launches for n in STREAM_PATH},
                     **{n: serve_launches for n in SERVE_PATH},
                     **{n: train_launches for n in TRAIN_PATH},
                     "mutant_copy": analysis_launches}
    launches = {name: path_launches[name][name] for name in KERNELS}
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
