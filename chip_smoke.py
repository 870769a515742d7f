#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA device: the trimming engine,
the static checks, then the SCC driver, the reachability engine, the
k-core peel, the stream engine (incremental trimming), the command line,
LM serving, GNN training, the trim-stream server and wide-deep.

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
   inputs, all-dead buckets, sentinel and negative sources;
   frontier_compact at its tile size +-1, over 38 tiles with a ragged
   tail, on mask[1:], with count > capacity, all-true and empty masks,
   each called twice so the second call meets the first's status words,
   and at the real shape with 1,024 and 0 members; prefix_positions, one
   launch of scan_lookback, in int32 and bool at one tile, a ragged tail
   and x[1:], twice in a row and interleaved with frontier_compact on one
   stream, and timed at the real shape in both dtypes; sparse_expand, one
   launch of expand_lookback, with a hub row over 9 slot tiles, sentinel
   ids, zero-degree runs, total 0, total = ecap and total > ecap, twice
   and interleaved with frontier_compact, prefix_positions and
   segment_sum under torch's sync debug mode "error", and one device item
   a profiled call at the real shape; first_live_probe, both its kernels,
   at n in {0, 1, 333, 4097}, W in {4, 8, 16, 17, 32}, pointers past the
   row's end, zero-degree rows, no scanning row and m = 0, and at the
   real shape (Gᵀ's rows, W = 16, 25% scanning, half the vertices live),
   where the whole windowed probe is timed before (the plain (n, W) gather
   feeding first_live_scan) and after (one first_live_probe launch, the
   engines' probe around it: one port kernel item, no tensor larger than
   (n + 1,)); the probe's bound counted by 32-byte sectors; bucket_peel
   also with L2 flushed before each call); the kernel's
   time (CUDA events over back-to-back calls, and its device time alone
   from the profiler), the plain version's, one library call's where one
   computes the same function (CUDA events, and its device time alone),
   and the bytes bound at 3.35 TB/s.
   flash_attention's two kernels against their plain version (the Pallas
   kernel's arithmetic) at qwen3-1.7b's prefill shape (B, Hq, Hkv, S, D) =
   (8, 16, 8, 2048, 128), causal, in f32 (to 1e-4, flash_fwd) and bf16 (to
   1e-2, flash_fwd_wgmma), and at edge cases in both dtypes (Sq < Sk, Sq >
   Sk, single blocks, D in {16, 32, 64, 128}, non-causal, GQA groups 1-3,
   transposed, sliced and unaligned inputs), logging the kernel each
   (dtype, D) reached; flash_fwd_wgmma's SASS must hold HGMMA instructions
   (``cuobjdump -sass``), printed with ptxas's registers and spills; the
   bound is operations (2 B Hq S (S+1) D FLOP at 989 TFLOP/s bf16), the
   library call SDPA (CUDA events and device time).
   segment_sum against its plain version to 1e-5 of each segment's sum of
   |v| (the kernel adds in sorted order plus carries) at the training
   path's shapes
   (MeshGraphNet on molecule (8,192, 128) -> 3,840 and on minibatch_lg
   (168,960, 128) -> 169,984; EquiformerV2 on molecule (8,192, 6,272) ->
   3,840), at one layer's aggregation at ogb-products scale ((61,859,140,
   128) -> 2,449,029, 31.7 GB, uniform and RMAT-skewed ids) and at edge
   cases (m = 0, n = 1, d in {1, 3, 4, 6272}, f32 and bf16, ids in [-2,
   n + 2) int32 and int64, column slices, 3-D values, mostly empty
   segments, a hub of 90% of the rows, d = 300), every call twice and
   once more with the caller's index, all three bit-identical; the index
   and the sum under torch's sync debug mode "error" (no host sync); the
   library's SASS must hold no atomic but the ticket's integer increment
   and a profiled call only segment_rows (one launch, no memset); times
   with the index built apart, and the index's own time (``index_ms`` in
   the kernels line: a forward builds it once for all its sums); its
   bound is bytes, its library call ``index_add_``.
2. the deterministic counters of ``BENCH_trim.json`` (rounds, edges_total,
   max_per_worker, trimmed, max_qp) for 6 families x 4 methods x
   {dense, windowed} at the benchmark's own sizes; beside them one
   instrumented dense run a method must equal the plain dense run
   (status, rounds, per-worker counters, max frontier), its round totals
   equal its counters, and it gives phase 14 (a) its method keys.
3. the trimming main path at the real size: RMAT scale 22 (4.19M
   vertices, 33.5M edges, the benchmark's RMAT parameters at the paper's
   average degree 8), 4 methods x 2 backends: all eight status masks
   equal each other and the numpy oracle, windowed counters equal dense
   counters, AC-6 traverses <= m.
4. the launch counts of phases 2 and 3: every trimming kernel ran on the
   real-size trimming path (phase 3).
5. the committed SCC and peel counts at their benchmarks' sizes:
   ``BENCH_scc.json`` ``sccs``, AC-6 ``rounds`` and
   ``frontier_path_taken`` (``rounds`` from the plain AC-6 run; the path
   from an instrumented one that must equal it, its ``r_sparse`` total by
   ``bench_scc.py``'s rule; labels partition like Tarjan's), and
   the eight integer keys of ``BENCH_peel.json`` on the size-≤2 SCC
   fringe graphs; ``peel(k=1)`` equals AC-4.
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
   times (once a layer, in the one prefill), on flash_fwd_wgmma (bf16,
   D = 128).  Prefill and decode times, tok/s, peak device memory, weight
   and cache bytes.  Then decode
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
   caught), also through ``launch.trim --app check``; (b) the declarations held against the card: every
   ``KERNEL_CATALOG`` point, the copy kernel's and one real-size call of
   each kernel (phase 1's shapes) run on zero-filled CUDA tensors under
   torch.profiler, and the kernels' grid and block read from the chrome
   trace must equal the captured launch records, in order; every kernel
   must have run.  Then (c) ``mutant_copy`` (the corpus's well-formed
   geometry; its twins never run) against ``x.clone()`` bit for bit at
   n = 4,194,304, n = 0 to 7 (n % 4 in {0, 1, 2, 3}) and ragged tails,
   aligned and at an unaligned ``x[1:]``, with and without the carry
   word: kernel, plain and ``x.clone()`` times, warm (L2-resident) and
   cold (L2 flushed before each call), and the bytes bound;
   (d) the host syncs of one warm AC-4 and one AC-6 trim at RMAT scale 22,
   counted by ``torch.cuda.set_sync_debug_mode("warn")`` and by the CPU
   lint's counter, must both equal the lint's budget for the rounds and
   probe steps the card ran.
14. (after phase 9) observability: (a) ``BENCH_obs.json`` at its own
   sizes (16 workers, chunk 1, as ``BENCH_trim.json``'s): every method's
   ``edges_total``, ``max_per_worker``, ``imbalance``, ``rounds`` and
   ``trimmed`` (phase 2's instrumented runs), the eight ``scc`` keys of an
   instrumented ``scc_decompose`` under a recorder, and ``ordering_ok``;
   then, with the launch counts set to 0 just
   before and read just after, at RMAT scale 22: (b) the 8 trims, reach
   on both backends (against a plain twin), the full peel, phase 9's
   first ``OBS_TICKS`` stream ticks and ``scc_decompose`` with
   ``instrument=True`` equal phases 3, 6 and 9 bit for bit, round totals
   equal the counters; the wall-time overhead of the ``OVERHEAD_TRIMS``
   and the peel, device items added by the dense trims (at most
   ``INSTRUMENT_ITEMS`` a round + ``INSTRUMENT_FOLD_ITEMS``; each run's
   count is the largest of three profiles in turns), the host
   syncs of AC-4 and AC-6 equal to the plain runs'; (c) the recorder
   around the SCC run: dispatch spans equal the engines' dispatches,
   generation spans the generations, exported to JSONL and a chrome trace
   and read back; (d) ``nbytes_breakdown()`` of an AC-4 engine's cached
   resources against the growth of ``torch.cuda.memory_allocated()``
   (bound ``ALLOC_SLACK`` a tensor), and ``device_memory_stats()``; (e)
   ``repro_torch.launch.trim``'s ``main`` (as phase 10 calls it) with
   ``--app scc --graph RMAT --metrics-json``: the snapshot reads back with
   the dispatch, round and live-bytes families.
15. (after phase 14) faults and checkpoints at RMAT scale 22, with the
   launch counts set to 0 just before and read just after (every kernel
   of the trim, SCC / reach / peel, stream and training paths must run):
   (a) AC-4 dense and AC-6 windowed under an inert FaultPlane equal phase
   3's status and per-worker counters, with the lint's host-sync budget
   (AC-4: phase 13's count); (b) a ``pre-dispatch`` and a
   ``post-dispatch`` fault, each through ``call_with_retries``, on those
   two trims, the pull reach and the full peel: results equal phases 3
   and 6, one dispatch counted; (c) the four engines through
   ``save_engine`` and ``restore_engine``: save ms, restore ms and bytes,
   the restored runs equal; (d) the stream saved after phase 9's tick 4,
   restored, ticks 5-8 replayed against phase 9's status and counters
   (tick 5 under a retried ``mid-update-batch`` fault, tick 6 under a
   ``pre-dispatch`` fault recovered from the tick-5 checkpoint), and one
   more deletion-only tick against phase 9's engine; (e)
   ``scc_decompose(checkpoint_every=1)`` faulted at its last
   ``pre-dispatch``, then ``resume=True``: phase 6's labels, generations
   and pivots; (f) MeshGraphNet on the molecule cell resumed at step 2 of
   4: restored state bit for bit, losses equal an uninterrupted run's
   (bit for bit where two uninterrupted runs agree, else to phase 12's
   1e-4); (g) ``python -m repro_torch.launch.trim --app scc --graph RMAT
   --checkpoint-dir D --fault-seed 7 --fault-rate 0.05 --retries 5`` in a
   subprocess: its final checkpoint holds the labels of a run without
   faults.  Checkpoints go under ``build/chip_smoke_ckpt`` and are removed.
16. (after phase 12) the trim-stream server, with the launch counts set to
   0 just before (a) and read just after: (a) ``serve_trim_stream`` on
   phase 9's graph (registered as ``RMAT22``), feed (33,554 deletions a
   tick, seed 0) and capacity, 8 ticks, ``metrics_port=0``, a checkpoint
   every 4 ticks: the final checkpoint's status and counters equal phase
   9's after its eighth tick bit for bit; a scraper thread fetches
   ``/healthz`` and ``/metrics`` once during the feed (200, 200,
   ``repro_serve_updates`` in the text); the ``--metrics-json``
   snapshot's ``repro_serve_updates`` equals the ticks' sum;
   counter_scatter, frontier_compact and sparse_expand must have run; the
   set-up, apply ms per tick, save ms and bytes.  (b) the reference's
   acceptance scenario: an uninterrupted in-process run on ``--graph
   RMAT`` (scale 13, 8 ticks of 256, a checkpoint every 2), then ``python
   -m repro_torch.launch.serve --app trim-stream`` with the same flags,
   SIGKILLed after its first checkpoint and restarted: the final
   checkpoints' status, counters, feed_alive and rng_state are equal.
17. (after phase 16) wide-deep at its published config (2,521,512,975
   parameters, random weights from a seeded generator on the card, TF32
   off), the launch counts set to 0 before and read after (no port kernel
   runs): (a) ``serve_recsys`` at the serve_p99 (512) and serve_bulk
   (262,144) batches: ms a batch (median of 10, synchronised) and req/s;
   (b) the forward at B = 512 against the CPU path on the same weights
   (the touched table rows and the dense parameters copied to the host),
   to 1e-5 of the largest logit; (c) ``retrieval_scores`` against
   1,048,576 candidates: its time, the top-100 values to 1e-5 and the
   indices where the values are distinct; (d) ``python -m
   repro_torch.launch.train --arch wide-deep --steps 3`` in-process at the
   train_batch cell's 65,536 rows: step ms and peak memory, its first loss
   equal to a fresh model's on batch 0, and on that batch's first 4,096
   rows the loss (1e-4 relative) and the MLP's and touched table rows'
   gradients (1e-3 of each largest entry) equal the CPU path's; whether
   ``F.embedding``'s backward gives the same bits on a rerun; (e) one
   ``HybridAdamW`` step: its moment bytes against AdamW's, the SGD tables
   equal to ``p - sgd_lr * g`` bit for bit.

The last two lines are the kernel table and the result, as JSON.  Needs
one CUDA device; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
    # the same Pallas kernel with the XLA gather that feeds it
    # (src/repro/core/common.py:204-209) inside
    "first_live_probe": ("src/repro_torch/kernels/csrc/first_live_scan.cu",
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
TRIM_PATH = ("first_live_probe", "frontier_compact", "sparse_expand")
SCC_PEEL_PATH = ("frontier_expand", "bucket_peel")
STREAM_PATH = ("counter_scatter",)
# the trim-stream server's ticks: the deletion-only counter scatter and the
# sparse decrement rounds' compaction and expansion
SERVER_PATH = ("counter_scatter", "frontier_compact", "sparse_expand")
SERVE_PATH = ("flash_attention",)
TRAIN_PATH = ("segment_sum",)
# phase 13 launches every kernel; the copy kernel is this path's own, and
# so are first_live_scan (the Pallas kernel's own contract, which the
# engines' probe no longer takes) and prefix_positions (no path calls it
# since sparse_expand scans its degrees itself)
ANALYSIS_PATH = tuple(KERNELS)
ANALYSIS_OWN = ("first_live_scan", "prefix_positions", "mutant_copy")
# the failure of a profiled call that holds no device item at all, the one
# failure a profile check retries (tools/kernel_ab.py reruns a turn on it)
NO_ITEMS = "the profiler reported no device item"
PROFILE_SETTLE_S = 0.02
PROFILE_WARMUP = 64
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
# phase 14: benchmarks/bench_obs.py WORKERS and CHUNK (its sizes are
# JSON_SIZES); the device items instrument=True may add a round on the
# auto frontier (a reduction is a memset and a reduce, plus a cast for a
# bool input: AC-3 counts its deaths in the loop test, a cast more than
# any(), and sums its probes; AC-4 multiplies and sums its decrements;
# AC-6 sums its deaths and its probes) and a run to fold its buffers (one
# stack, one zero buffer, a slice add a stat; AC-4's degree scan a sum)
OBS_WORKERS, OBS_CHUNK = 16, 1
INSTRUMENT_ITEMS = {"ac3": 3, "ac4": 3, "ac4*": 3, "ac6": 5}
INSTRUMENT_FOLD_ITEMS = 6
# phase 14 (b) times the overhead of instrument=True on these trims (and
# the peel), and replays this many of phase 9's ticks instrumented (the
# feed's first insertions come at tick 3)
OVERHEAD_TRIMS = (("ac4", "dense"), ("ac6", "windowed"))
OBS_TICKS = 4
# phase 15: checkpoints go under build/ (gitignored) and are removed at the
# end; the stream is saved after tick REPLAY_FROM of phase 9 and replayed
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
REPLAY_FROM = 4
FAULT_TRIMS = (("ac4", "dense"), ("ac6", "windowed"))
# PyTorch's caching allocator: 511 bytes of rounding and at most 1 MiB of
# an unsplit segment remainder a tensor
ALLOC_SLACK = 511 + (1 << 20)
# phase 11: qwen3-1.7b at its published config, 8 requests of 2048 prompt
# tokens and 32 generated tokens; the flash kernel's real shape follows
SERVE = dict(arch="qwen3-1.7b", batch=8, prompt_len=2048, gen_len=32, seed=0)
FLASH_REAL = dict(b=8, hq=16, hkv=8, s=2048, d=128)
# bf16 outputs of size ~1 round by up to 2^-8; the f32 kernel and its plain
# version sum in f32 in other orders
FLASH_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# segment_sum: |kernel - plain| <= SEG_TOL * (the segment's sum of |v|) +
# 1e-6.  Both sum in f32, the kernel a segment's rows in sorted order plus
# its carries, the plain version in index_add_'s order; a k-term sum moves
# by ~sqrt(k) 2^-24 of its largest partial
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
# phase 16: the trim-stream server checkpoints every 4 of phase 9's ticks
SERVE_CKPT_EVERY = 4
# phase 17: wide-deep at its published config: the launcher's steps at the
# train_batch cell, the rows of its first batch held against the CPU
RECSYS = dict(steps=3, check_batch=4096)
RECSYS_TOL = dict(fwd=1e-5, loss=1e-4, grad=1e-3)
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


def profiled(**kw):
    """``torch.profiler.profile`` of the CPU and the card, entered only
    once it records the card's items.  The profiler has been seen to lose
    the first device items after it starts (up to 23 of a trim's first
    items in a profile, still after a 20 ms pause), so the card first runs
    ``PROFILE_WARMUP`` spin kernels (``torch.cuda._sleep``) and idles
    ``PROFILE_SETTLE_S``; :func:`device_events` leaves them out."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def run():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **kw) as prof:
            for _ in range(PROFILE_WARMUP):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
            yield prof
    return run()


def device_events(prof) -> list:
    """The device items (kernels and copies) of a :func:`profiled` block
    in launch order, without its spin kernels."""
    import torch
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.name),
                  key=lambda e: e.time_range.start)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: the durations of the CUDA kernels and
    copies it launches (torch.profiler, CUPTI), summed over ``reps`` calls,
    per call.  Unlike :func:`time_ms` it leaves out the host's gaps
    between launches, which bound a small kernel behind a Python
    wrapper.  A profile that holds no device item at all is taken again,
    three times at most, as :func:`device_items` does."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profiled() as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time for e in device_events(prof)]
        if times:
            return sum(times) / 1e3 / reps
    check(False, f"device_ms: {NO_ITEMS} in 3 profiled runs")


def cold_device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with the L2 cache cold: a 256 MB
    buffer (five times the H100's 50 MB L2) is written before each call,
    and only the device items that ``fn`` launches (by name) are
    counted."""
    import torch

    flush = torch.empty((256 << 20,), dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):     # a profile has been seen to miss every item
        with profiled() as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in device_events(prof)}
        if names:
            break
    check(bool(names), f"cold_device_ms: {NO_ITEMS} in 3 profiled calls")
    with profiled() as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.device_time for e in device_events(prof)
                  if e.name in names)
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
    from repro_torch.obs.profile import bound_ms, kernel_cost
    import numpy as np
    import torch

    from repro_torch.kernels import _build
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
    # the single-pass scan on x[1:] (element loads), twice in a row, and
    # interleaved with frontier_compact, whose scratch buffer it shares
    st = _build.SCAN_TILE
    for n in (1, st - 1, st, st + 1, 3 * st + 7, 1_000_003):
        mk = t(rng.random(n) < 0.3)
        for base in (t(rng.integers(-3, 1000, n + 1), torch.int32),
                     t(rng.random(n + 1) < 0.4)):
            for off in (0, 1, 0, 1):
                x = base[off:off + n]
                check(max_abs_err(fc.prefix_positions(x),
                                  ref.prefix_positions_ref(x)) == 0,
                      f"prefix_positions n={n} {x.dtype} offset={off}")
                check(max_abs_err(fc.frontier_compact(mk, 512),
                                  ref.frontier_compact_ref(mk, 512)) == 0,
                      f"frontier_compact n={n} after prefix_positions")
    tile = _build.COMPACT_TILE
    for n, c in ((1, 1), (700, 16), (4097, 64), (4097, 8192),
                 (tile - 1, 512), (tile, 512), (tile + 1, 512),
                 (37 * tile + 5, 70_000), (37 * tile + 5, 9_000)):
        for mask in (np.zeros(n + 1, bool), np.ones(n + 1, bool),
                     rng.random(n + 1) < .2):
            for off in (0, 1):                           # 1: mask[1:]
                mk = t(mask)[off:off + n]
                want = ref.frontier_compact_ref(mk, c)
                for _ in range(2):           # the second reads stale words
                    check(max_abs_err(fc.frontier_compact(mk, c), want)
                          == 0, f"frontier_compact n={n} cap={c} "
                                f"offset={off}")
    small = g_t.indptr[:5001] - 0
    small_idx = g_t.indices[: int(small[-1])]
    for c, e, p in ((8192, 8192, 1.0), (512, 64, 0.9), (64, 512, 0.05)):
        ids, _ = ref.frontier_compact_ref(t(rng.random(5000) < p), c)
        check(max_abs_err(fc.sparse_expand(small, small_idx, ids, e),
                          ref.sparse_expand_ref(small, small_idx, ids, e))
              == 0, f"sparse_expand cap={c} ecap={e}")
    expand_edge_cases(dev, rng)
    probe_edge_cases(dev, rng)
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
        "sources, all updates on one source; sparse_expand with a hub over "
        "9 slot tiles, sentinels, zero-degree runs, total 0, total = ecap "
        "and total > ecap, twice and interleaved with frontier_compact, "
        "prefix_positions and segment_sum, no host sync; first_live_probe "
        "at n = 0, 1, 333, 4097, W in {4, 8, 16, 17, 32}, "
        "start >= deg, zero-degree rows, no scanning row and m = 0, twice, "
        "no host sync; frontier_compact at n = "
        f"{tile - 1}, {tile}, {tile + 1} and {37 * tile + 5} (38 tiles), "
        "all-true, empty and 20% masks, count > capacity, aligned and "
        "mask[1:], each twice; prefix_positions in int32 and bool at one "
        "tile, ragged tails and x[1:], twice in a row and interleaved with "
        "frontier_compact)")

    # real shapes
    n = g_t.n
    window = 16
    flags = t(rng.random((n, window)) < 0.5)
    valid = t(rng.random((n, window)) < 0.9)
    active = t(rng.random(n) < 0.25)
    x = t(rng.integers(0, 64, n), torch.int32)
    members = torch.zeros(n, dtype=torch.bool, device=dev)
    members[t(rng.choice(n, cap - 7, replace=False))] = True
    ids, _ = ref.frontier_compact_ref(members, cap)
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
            f"bound_ms={bound_ms(*kernel_cost('frontier_expand', (xflags, valid, pend))):.4f}")
    # frontier_compact where few members leave most slots to the sentinel
    # fill (the sparse rounds), and the empty frontier
    for members_n in (1024, 0):
        few = torch.zeros(n, dtype=torch.bool, device=dev)
        few[t(rng.choice(n, members_n, replace=False))] = True
        check(max_abs_err(fc.frontier_compact(few, cap),
                          ref.frontier_compact_ref(few, cap)) == 0,
              f"frontier_compact real shape, {members_n} members")

        def kern():
            return fc.frontier_compact(few, cap)
        log(f"# phase 1: frontier_compact, {members_n} members of cap "
            f"{cap}: kernel_ms={time_ms(kern):.4f} "
            f"device_ms={device_ms(kern):.4f} library device_ms="
            f"{device_ms(lambda: torch.nonzero(few)):.4f} bound_ms="
            f"{bound_ms(*kernel_cost('frontier_compact', (few, cap))):.4f}")
    for k in (0, 1):
        kt = t([k], torch.int32)
        check(max_abs_err((bpl.bucket_peel(pcount, palive, kt),),
                          (ref.bucket_peel_ref(pcount, palive, kt),)) == 0,
              f"bucket_peel real shapes k={k}")

    cases = {
        "first_live_scan": (
            lambda: fls.first_live_scan(flags, valid, active),
            lambda: ref.first_live_ref(flags, valid, active), None,
            kernel_cost("first_live_scan", (flags, valid, active))),
        "prefix_positions": (
            lambda: fc.prefix_positions(x),
            lambda: ref.prefix_positions_ref(x),
            lambda: torch.cumsum(x, 0, dtype=torch.int32),
            kernel_cost("prefix_positions", (x,))),
        "frontier_compact": (
            lambda: fc.frontier_compact(members, cap),
            lambda: ref.frontier_compact_ref(members, cap),
            lambda: torch.nonzero(members),
            kernel_cost("frontier_compact", (members, cap))),
        "sparse_expand": (
            lambda: fc.sparse_expand(g_t.indptr, g_t.indices, ids, ecap),
            lambda: ref.sparse_expand_ref(g_t.indptr, g_t.indices, ids, ecap),
            None,
            kernel_cost("sparse_expand", (g_t.indptr, g_t.indices, ids,
                                          ecap))),
        "frontier_expand": (
            lambda: (fex.frontier_expand(xflags, valid, pending_all),),
            lambda: (ref.frontier_expand_ref(xflags, valid, pending_all),),
            None,
            kernel_cost("frontier_expand", (xflags, valid, pending_all))),
        "bucket_peel": (
            lambda: (bpl.bucket_peel(pcount, palive, k7),),
            lambda: (ref.bucket_peel_ref(pcount, palive, k7),),
            None,
            kernel_cost("bucket_peel", (pcount, palive, k7))),
    }
    # the windowed probe at the real shape: Gᵀ's rows, W = 16, 25% of the
    # rows scanning from a pointer in [0, deg], half the vertices live
    pdeg = g_t.indptr[1:] - g_t.indptr[:-1]
    pstatus = t(rng.random(n) < 0.5)
    pscan = t(rng.random(n) < 0.25)
    pstart = (t(rng.random(n)) * (pdeg + 1).float()).floor().to(torch.int32)
    pargs = (pstatus, g_t.indptr, g_t.indices, pstart, pscan, window)
    pfirst, pfound = ref.first_live_probe_ref(*pargs)
    cases["first_live_probe"] = (
        lambda: fls.first_live_probe(*pargs),
        lambda: ref.first_live_probe_ref(*pargs), None,
        kernel_cost("first_live_probe", pargs, (pfirst, pfound)))
    rows = {}
    for name, (kern, plain, lib, cost) in cases.items():
        err = max_abs_err(kern(), plain())
        check(err == 0, f"{name}: kernel differs from its plain version at "
                        f"the real shapes (max |err| {err})")
        row = dict(max_abs_err=err, ms=time_ms(kern), plain_ms=time_ms(plain),
                   library_ms=time_ms(lib) if lib else None,
                   bound_ms=bound_ms(*cost), bound_by="bytes")
        rows[name] = row
        lib_dev = "" if lib is None else \
            f" (library device_ms={device_ms(lib):.4f})"
        log(f"# phase 1: {name}: bit-identical at the real shapes; "
            f"kernel_ms={row['ms']:.4f} device_ms={device_ms(kern):.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms'] if lib is None else round(row['library_ms'], 4)}"
            f"{lib_dev} bound_ms={row['bound_ms']:.4f}")

    windowed_probe_phase(dev, pargs, flags.shape)
    device_items(lambda: fc.sparse_expand(g_t.indptr, g_t.indices, ids,
                                          ecap),
                 lambda items: items == ["expand_lookback"],
                 "sparse_expand as one launch of expand_lookback")
    log("# phase 1: sparse_expand: one device item a call (expand_lookback) "
        "at the real shape")
    # bucket_peel's 25 MB of inputs sit in L2 across a warm timing loop
    log(f"# phase 1: bucket_peel k=7: cold device_ms="
        f"{cold_device_ms(lambda: bpl.bucket_peel(pcount, palive, k7)):.4f} "
        f"(L2 flushed before each call; warm device_ms="
        f"{device_ms(lambda: bpl.bucket_peel(pcount, palive, k7)):.4f})")

    # prefix_positions over a bool mask of the real size: 1 byte read and
    # 4 written an element
    xb = t(rng.random(n) < 0.4)
    check(max_abs_err(fc.prefix_positions(xb), ref.prefix_positions_ref(xb))
          == 0, "prefix_positions bool at the real shape")

    def kern():
        return fc.prefix_positions(xb)

    def lib():
        return torch.cumsum(xb, 0, dtype=torch.int32)
    log(f"# phase 1: prefix_positions bool: bit-identical at the real shape; "
        f"kernel_ms={time_ms(kern):.4f} device_ms={device_ms(kern):.4f} "
        f"library_ms={time_ms(lib):.4f} (torch.cumsum; device_ms="
        f"{device_ms(lib):.4f}) bound_ms="
        f"{bound_ms(*kernel_cost('prefix_positions', (xb,))):.4f}")

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
                       bound_ms=bound_ms(*kernel_cost(
                           "counter_scatter", args)), bound_by="bytes")
            log(f"# phase 1: counter_scatter B={b} ({label}): "
                f"bit-identical; kernel_ms={row['ms']:.4f} device_ms="
                f"{device_ms(lambda: cs.counter_scatter(*args)):.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms="
                f"{row['library_ms']:.4f} (index_add_ of the in-range "
                f"updates + the compare; device_ms={device_ms(lib):.4f}) "
                f"bound_ms={row['bound_ms']:.4f}")
            if b == 65_536 and label == "rmat":
                rows["counter_scatter"] = row
    return rows


def expand_edge_cases(dev, rng):
    """sparse_expand (one launch of expand_lookback) bit for bit against
    its plain version: a hub row over 9 slot tiles, half sentinel ids, a
    run of zero-degree rows, total 0, total = ecap and total > ecap; each
    twice, interleaved on one stream with frontier_compact,
    prefix_positions and segment_sum (they share its scratch), with no
    host sync and one launch a call."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import segment_sum as ss
    slot = _build.EXPAND_SLOT_TILE
    x = torch.as_tensor(rng.integers(0, 9, 3 * _build.SCAN_TILE + 5),
                        dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.random(3 * _build.COMPACT_TILE + 9) < 0.3,
                           device=dev)
    vals = torch.ones((5000, 4), device=dev)
    seg = torch.as_tensor(rng.integers(0, 40, 5000), dtype=torch.int32,
                          device=dev)
    for kind in ("hub", "sentinels", "zero_run", "total0", "total_eq",
                 "total_gt"):
        n = 5000
        deg = rng.integers(1, 12, n)
        deg[rng.random(n) < 0.3] = 0
        if kind == "hub":
            deg[17] = 9 * slot + 11
        if kind == "zero_run":
            deg[100:3000] = 0
        if kind == "total0":
            deg[:] = 0
        indptr = np.concatenate([[0], np.cumsum(deg)])
        m = max(int(indptr[-1]), 1)
        ids = np.sort(rng.choice(n, 3000, replace=False))
        ids = np.concatenate([ids, np.full(4096 - ids.size, n)])
        if kind == "sentinels":
            ids = np.sort(np.where(rng.random(ids.size) < 0.5, n, ids))
        total = int(deg[ids[ids < n]].sum())
        ecap = max({"total_eq": total, "total_gt": total // 3}.get(
            kind, total + 2 * slot + 5), 1)
        ip, ix, it = (torch.as_tensor(a.astype(np.int32), device=dev)
                      for a in (indptr, rng.integers(0, n, m), ids))
        want = ref.sparse_expand_ref(ip, ix, it, ecap)
        before = ops.LAUNCHES["sparse_expand"]
        for _ in range(2):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fc.sparse_expand(ip, ix, it, ecap)
                pos, _ = fc.prefix_positions(x)
                cids, _ = fc.frontier_compact(mask, 4096)
                sums = ss.segment_sum(vals, seg, 40)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(max_abs_err(got, want) == 0,
                  f"sparse_expand {kind} (total {total}, ecap {ecap})")
            check(torch.equal(pos, ref.prefix_positions_ref(x)[0])
                  and torch.equal(cids, ref.frontier_compact_ref(mask,
                                                                 4096)[0])
                  and torch.equal(sums, ref.segment_sum_ref(vals, seg, 40)),
                  f"a kernel sharing sparse_expand's scratch ({kind})")
        check(ops.LAUNCHES["sparse_expand"] == before + 2,
              f"sparse_expand {kind}: not one launch a call")


def probe_edge_cases(dev, rng):
    """first_live_probe, bit for bit against the plain
    gather + row scan: n in {0, 1, 333, 4097}, W in {4, 8, 16, 17, 32},
    pointers at or past the row's end, mostly zero-degree rows, no
    scanning row and no edge at all; each twice, with no host sync."""
    import numpy as np
    import torch

    from repro_torch.kernels import first_live_scan as fls
    from repro_torch.kernels import ref
    for n in (0, 1, 333, 4097):
        for kind in ("random", "start_ge_deg", "zero_degree", "no_scanning",
                     "m0"):
            deg = rng.integers(0, 40, n)
            deg[rng.random(n) < (0.75 if kind == "zero_degree" else 0.2)] = 0
            if kind == "m0":
                deg[:] = 0
            indptr = np.concatenate([[0], np.cumsum(deg)])
            start = (deg + rng.integers(0, 3, n) if kind == "start_ge_deg"
                     else rng.integers(0, 45, n))
            args = [torch.as_tensor(a, device=dev) for a in (
                rng.random(n) < 0.5, indptr.astype(np.int32),
                rng.integers(0, max(n, 1), int(indptr[-1])).astype(np.int32),
                start.astype(np.int32),
                rng.random(n) < (0.0 if kind == "no_scanning" else 0.3))]
            for w in (4, 8, 16, 17, 32):
                want = ref.first_live_probe_ref(*args, w)
                for call in range(2):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        got = fls.first_live_probe(*args, w)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    check(max_abs_err(got, want) == 0,
                          f"first_live_probe call {call + 1} n={n} W={w} "
                          f"{kind}")


def device_items(fn, ok=None, what: str = "") -> list:
    """The names of the device items one profiled call of ``fn`` runs
    (after one warm call), in order, kernel names cut at their template
    arguments.  With ``ok``, the check fails at once if they do not pass
    ``ok``.  A profile that holds no device item at all (the profiler has
    been seen to miss every item of a call) is taken again, three times
    at most; that and nothing else."""
    import torch

    from repro_torch.analysis.capture import kernel_basename
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profiled() as prof:
            fn()
            torch.cuda.synchronize()
        items = [kernel_basename(e.name) for e in device_events(prof)]
        if items:
            check(ok is None or ok(items), f"{what}: the card ran {items}")
            return items
        log(f"# phase 1: {what}: profiled call {attempt + 1} of 3: "
            f"{NO_ITEMS}")
    check(False, f"{what}: {NO_ITEMS} in 3 profiled calls")


def item_counts(fns, reps: int = 3) -> list:
    """The device items (kernels and copies) of one call of each of
    ``fns``, profiled ``reps`` times in turns after one warm call each:
    for each, the largest count and the counts of every profile.  The
    profiler has been seen to lose items (see :func:`profiled`) and never
    to report one that did not run, so the largest count is the call's.
    Where a profile holds fewer, the log says where in the call they
    were missing."""
    import torch

    from repro_torch.analysis.capture import kernel_basename
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    seqs = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            with profiled() as prof:
                fn()
                torch.cuda.synchronize()
            seqs[i].append([kernel_basename(e.name)
                            for e in device_events(prof)])
            spins = sum("spin_kernel" in e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
            if spins < PROFILE_WARMUP:
                log(f"# the profiler lost {PROFILE_WARMUP - spins} of its "
                    f"{PROFILE_WARMUP} warm-up items")
    out = []
    for got in seqs:
        full = max(got, key=len)
        check(len(full) > 0, f"{NO_ITEMS}: {[len(x) for x in got]}")
        for x in got:
            if len(x) < len(full):
                p = next((j for j, (a, b) in enumerate(zip(x, full))
                          if a != b), len(x))
                k = len(full) - len(x)
                lost = (f"items {p} to {p + k - 1} missing"
                        if x[p:] == full[p + k:] else
                        f"items in order up to {p}, then others missing")
                log(f"# a profile of {len(x)} of {len(full)} device items: "
                    f"{lost}")
        out.append((len(full), [len(x) for x in got]))
    return out


def largest_tensor(fn) -> int:
    """The most elements of any tensor an operation makes in ``fn`` (a
    torch dispatch mode over every operator call)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in tree_leaves(out):
                if isinstance(x, torch.Tensor):
                    self.numel = max(self.numel, x.numel())
            return out
    with Largest() as mode:
        fn()
    torch.cuda.synchronize()
    return mode.numel


def windowed_probe_phase(dev, pargs, tile_shape):
    """The whole windowed probe at the real shape, before and after the
    fused kernel: the plain (n, W) gather on the card feeding the
    first_live_scan kernel (the path the engines took until now) against
    one first_live_probe launch, and the engines'
    probe_first_live_windowed around it; the largest tensor each makes."""
    import torch

    from repro_torch.core.common import probe_first_live_windowed
    from repro_torch.kernels import first_live_scan as fls
    from repro_torch.kernels import ref
    status, indptr, indices, start, scanning, window = pargs

    def before():
        return fls.first_live_scan(*ref.window_tiles(
            status, indptr, indices, start, window), scanning)

    def probe():
        return fls.first_live_probe(*pargs)

    def engine():
        return probe_first_live_windowed(*pargs)
    check(max_abs_err(before(), probe()) == 0,
          "first_live_probe differs from the gather + first_live_scan path")
    items = device_items(engine, lambda items:
                         items.count("first_live_probe") == 1
                         and "first_live_w16" not in items,
                         "the windowed probe's one probe launch")
    big_before, big_after = largest_tensor(before), largest_tensor(engine)
    check(big_after <= tile_shape[0] + 1,
          f"the windowed probe made a tensor of {big_after} elements")
    log(f"# phase 1: windowed probe, n={tile_shape[0]} W={window} "
        f"{float(scanning.float().mean()):.0%} scanning: gather + "
        f"first_live_scan device_ms={device_ms(before):.4f} "
        f"(largest tensor {big_before} elements); first_live_probe "
        f"device_ms={device_ms(probe):.4f}; "
        f"probe_first_live_windowed device_ms={device_ms(engine):.4f} "
        f"wall_ms={time_ms(engine):.4f} (largest tensor {big_after} "
        f"elements; items {len(items)}: {sorted(set(items))})")


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


def flash_build_report():
    """The Hopper flash kernel as built: its HGMMA instructions per
    instantiation (``cuobjdump -sass``; none means it missed the tensor
    cores) and ptxas's registers and spills.  Returns ``{D: (hgmma,
    "ptxas line")}``."""
    import re

    from repro_torch.kernels import _build
    found, fn = {}, None
    for line in _build.sass("flash_attention").splitlines():
        if "Function : " in line:
            m = re.search(r"flash_fwd_wgmmaILi(\d+)E", line)
            fn = int(m.group(1)) if m else None
            if fn is not None:
                found[fn] = [0, ""]
        elif fn is not None and "HGMMA" in line:
            found[fn][0] += 1
    fn = None
    for line in _build.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_fwd_wgmmaILi(\d+)E", line)
            fn = int(m.group(1)) if m else None
        elif fn in found and ("spill" in line or "registers" in line):
            found[fn][1] += line.split(":")[-1].strip() + "; "
    check(sorted(found) == [64, 128] and all(c > 0 for c, _ in
                                             found.values()),
          f"flash_fwd_wgmma's SASS holds no HGMMA: {found}")
    return {d: tuple(v) for d, v in found.items()}


def flash_phase(dev):
    """Phase 1 for flash_attention: both kernels against their plain
    version (the Pallas kernel's arithmetic) at edge cases and at the real
    prefill shape of qwen3-1.7b, in f32 and bf16; times there.  Returns
    the bf16 row of the kernel table (the serving path's dtype, on
    flash_fwd_wgmma)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    built = flash_build_report()
    log("# phase 1: flash_fwd_wgmma as built: " + "; ".join(
        f"D={d}: {n} HGMMA in its SASS, ptxas {ptx}"
        for d, (n, ptx) in sorted(built.items())))
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
    # non-causal, GQA groups 1, 2 and 3; bf16 at D in {64, 128} runs
    # flash_fwd_wgmma, the rest flash_fwd
    reached = {}
    for (b, hq, hkv, sq, sk, d, causal) in (
            (2, 4, 2, 256, 512, 128, True), (1, 2, 1, 384, 128, 64, True),
            (1, 4, 2, 128, 64, 32, True), (2, 3, 1, 96, 96, 16, True),
            (1, 4, 4, 48, 48, 128, True), (1, 8, 2, 256, 384, 64, False),
            (3, 6, 2, 128, 128, 16, True)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            args = qkv(b, hq, hkv, sq, sk, d, dtype)
            e = err(fa.flash_attention(*args, causal=causal),
                    ref.flash_attention_ref(*args, causal=causal))
            check(e <= FLASH_TOL[name],
                  f"flash_attention {(b, hq, hkv, sq, sk, d, causal)} "
                  f"{dtype}: max |err| {e}")
            reached[(name, d)] = fa.kernel_for(dtype, d)
    # non-contiguous: the model's transposed (B, S, H, D) views (read by
    # strides, or by TMA), a strided slice of the keys, and a bf16 input
    # that breaks TMA's alignment (the wrapper copies it)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 128)):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn((2, 256, h, d), generator=gen,
                               device=dev).to(dtype) for h in (8, 4, 4))
        views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        e = err(fa.flash_attention(*views), ref.flash_attention_ref(*views))
        check(e <= FLASH_TOL[name], f"flash_attention strided {name}: {e}")
    wide = [t[:, :, ::2] for t in qkv(1, 4, 2, 256, 512, 32, torch.float32)]
    e = err(fa.flash_attention(*wide), ref.flash_attention_ref(*wide))
    check(e <= FLASH_TOL["float32"], f"flash_attention sliced: {e}")
    q, k, v = qkv(1, 4, 2, 256, 256, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    shifted = flat[1:].view(q.shape).copy_(q)            # 2-byte offset
    check(not fa.tma_ready(shifted), "the shifted input is TMA-aligned")
    e = err(fa.flash_attention(shifted, k, v),
            ref.flash_attention_ref(q, k, v))
    check(e <= FLASH_TOL["bfloat16"], f"flash_attention unaligned: {e}")
    torch.cuda.synchronize()
    log("# phase 1: flash_attention edge cases within tolerance (f32 1e-4, "
        "bf16 1e-2): Sq < Sk, Sq > Sk (zero and mean rows), S <= 128 "
        "single blocks, D in {16, 32, 64, 128}, non-causal, GQA groups 1, "
        "2, 3, transposed (f32 and bf16), sliced and unaligned inputs; "
        "kernels reached: " + ", ".join(
            f"{n} D={d} {k_}" for (n, d), k_ in sorted(reached.items())))

    b, hq, hkv, s, d = (FLASH_REAL[k_] for k_ in ("b", "hq", "hkv", "s",
                                                    "d"))
    from repro_torch.obs.profile import PEAK_FLOPS, bound_ms, kernel_cost
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        args = qkv(b, hq, hkv, s, s, d, dtype)
        name = str(dtype).split(".")[1]
        e = err(fa.flash_attention(*args), ref.flash_attention_ref(*args))
        check(e <= FLASH_TOL[name], f"flash_attention real shape {name}: "
                                    f"max |err| {e}")
        # the bf16 output against the plain version's f32 result, before
        # its rounding: the kernel's own error, about one output rounding
        e32 = float((fa.flash_attention(*args).float()
                     - ref.flash_attention_ref(*(t.float() for t in args)))
                    .abs().max())
        # QK^T and PV, causal: 2 B Hq S (S + 1) D
        flops, nbytes = kernel_cost("flash_attention", (*args, True, None))
        bound = bound_ms(flops, nbytes, name)

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
        dev_ms = device_ms(kern, reps=10)
        log(f"# phase 1: flash_attention {name} (B, Hq, Hkv, S, D) = "
            f"({b}, {hq}, {hkv}, {s}, {d}) causal on "
            f"{fa.kernel_for(dtype, d)}: max |err| {e:.3g} (tolerance "
            f"{FLASH_TOL[name]}; {e32:.3g} against the plain version's f32 "
            f"result); kernel_ms={r['ms']:.4f} device_ms={dev_ms:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"(SDPA, enable_gqa; device_ms={device_ms(lib, reps=10):.4f}; "
            f"max |err| {lib_err:.3g}) bound_ms={bound:.4f} "
            f"({flops / 1e9:.1f} GFLOP at {PEAK_FLOPS[name] / 1e12:.0f} "
            f"TFLOP/s; {nbytes / 1e6:.0f} MB); achieved "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s ({flops / dev_ms / 1e9:.1f}"
            f" on the device time)")
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
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.models.gnn.common import molecule_union

    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def vals(m, d, dtype=torch.float32):
        return torch.randn((m, d), generator=gen, device=dev).to(dtype)

    def ids_in(lo, hi, m, dtype=torch.int32):
        return torch.as_tensor(rng.integers(lo, hi, m), dtype=dtype,
                               device=dev)

    def thrice(v, i, n, what):
        """Check one call, and hold a second call and one with the
        caller's index to its bits."""
        got = ss.segment_sum(v, i, n)
        rel = segment_check(got, v, i, n, what)
        check(torch.equal(got, ss.segment_sum(v, i, n)) and torch.equal(
            got, ss.segment_sum(v, i, n, ss.segment_index(i, n))),
            f"segment_sum {what}: two calls differ")
        return rel

    # m = 0, n = 1, d in {1, 3, 4, 300, 6272}, ids in [-2, n + 2), int64
    # ids, bf16, a column slice (row stride > d, unaligned start), 3-D
    # values, mostly empty segments and a hub of 90% of the rows
    worst = 0.0
    for m, d, n in ((0, 4, 7), (5, 4, 1), (1000, 1, 177), (1000, 3, 177),
                    (1000, 4, 177), (333, 6272, 50), (20_000, 300, 3000)):
        for dtype in (torch.float32, torch.bfloat16):
            for lo, hi, idt in ((0, n, torch.int32), (-2, n + 2, torch.int32),
                                (-2, n + 2, torch.int64)):
                v, i = vals(m, d, dtype), ids_in(lo, hi, m, idt)
                worst = max(worst, thrice(
                    v, i, n, f"m={m} d={d} n={n} {dtype} ids [{lo}, {hi})"))
    wide = vals(4096, 134)
    i = ids_in(0, 300, 4096)
    for cols in (slice(0, 128), slice(1, 129), slice(3, 9)):
        worst = max(worst, thrice(wide[:, cols], i, 300, "slice"))
    v3 = wide[:, :120].reshape(4096, 15, 8)
    got = ops.segment_sum(v3, i, 300)
    check(got.shape == (300, 15, 8), "segment_sum 3-D shape")
    worst = max(worst, segment_check(got, v3, i, 300, "3-D"))
    m, n = 20_000, 3_000
    for d in (1, 3, 128):
        v = vals(m, d)
        empty = ids_in(0, 40, m) * 71                  # 40 of 3,000 used
        hub = torch.where(torch.as_tensor(rng.random(m) < 0.9, device=dev),
                          5, ids_in(0, n, m))
        worst = max(worst, thrice(v, empty, n, f"d={d} empty segments"),
                    thrice(v, hub, n, f"d={d} a hub of 90% of the rows"))
    # neither the index nor the sum syncs with the host
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        index = ss.segment_index(hub, n)
        ss.segment_sum(v, hub, n, index)
        ss.segment_sum(v, hub, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # no atomic in the library but the CTA ticket's increment (into the
    # scratch), no memset on the stream
    sass = _build.sass("segment_sum")
    atomics = re.findall(r"\b(?:REDG?|ATOMG?)\.[\w.]*", sass)
    check(all(a.startswith("ATOMG.") and ".INC" in a for a in atomics),
          f"segment_sum's SASS holds an atomic other than the ticket's: "
          f"{sorted(set(atomics))}")
    items = device_items(lambda: ss.segment_sum(v, hub, n, index),
                         lambda items: items == ["segment_rows"],
                         "segment_sum with an index as one segment_rows")
    torch.cuda.synchronize()
    log(f"# phase 1: segment_sum edge cases within {SEG_TOL} of each "
        f"segment's sum of |v| (largest {worst:.3g}): m = 0, n = 1, d in "
        f"{{1, 3, 4, 128, 300, 6272}}, f32 and bf16, ids in [-2, n + 2) "
        f"int32 and int64, column slices, 3-D values, 40 of 3,000 segments "
        f"used, a hub of 90% of the rows; a second call and one with the "
        f"caller's index bit-identical; no host sync; no atomic in the "
        f"SASS but the ticket's {sorted(set(atomics))}; a call with an "
        f"index runs {items} and nothing else")

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
    """Check and time segment_sum at one real shape: the kernels with the
    index built apart, as a forward reuses it (CUDA events and profiler;
    two calls bit-identical), the index itself, a call that builds its own,
    the plain version, and the library call (``index_add_`` of the rows
    into a zeroed output; all ids are in range); the bytes bound reads each
    value and id once and writes each output once."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as ss
    m, d = v.shape
    index = ss.segment_index(ids, n)
    rel = segment_check(ss.segment_sum(v, ids, n, index), v, ids, n, label)
    from repro_torch.obs.profile import bound_ms, kernel_cost
    _, nbytes = kernel_cost("segment_sum", (v, ids, n))

    def kern():
        return ss.segment_sum(v, ids, n, index)

    def build():
        return ss.segment_index(ids, n)

    def lib():
        return torch.zeros((n, d), device=v.device).index_add_(0, ids, v)
    got = kern()
    check(torch.equal(got, kern()), f"segment_sum {label}: two calls differ")
    row = dict(max_abs_err=float((got - ref.segment_sum_ref(v, ids, n))
                                 .abs().max()),
               ms=time_ms(kern, reps=reps),
               index_ms=time_ms(build, reps=reps),
               plain_ms=time_ms(lambda: ref.segment_sum_ref(v, ids, n),
                                reps=reps),
               library_ms=time_ms(lib, reps=reps),
               bound_ms=bound_ms(0, nbytes), bound_by="bytes")
    del got
    log(f"# phase 1: segment_sum {label} ({m:,}, {d}) -> {n:,}: max |err| "
        f"{row['max_abs_err']:.3g} ({rel:.3g} of the segment's sum of |v|); "
        f"kernel_ms={row['ms']:.4f} device_ms={device_ms(kern, reps=reps):.4f} "
        f"index: kernel_ms={row['index_ms']:.4f} device_ms="
        f"{device_ms(build, reps=reps):.4f}; without an index: kernel_ms="
        f"{time_ms(lambda: ss.segment_sum(v, ids, n), reps=reps):.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"(zeros + index_add_; device_ms={device_ms(lib, reps=reps):.4f}) "
        f"bound_ms={row['bound_ms']:.4f} "
        f"({nbytes / 1e6:.0f} MB)")
    return row


# -- phase 2: the committed reference counters ---------------------------------

def reference_phase(dev):
    """BENCH_trim.json's keys on both backends, as before.  Beside each
    method's plain runs, an instrumented dense run must equal the plain
    dense run (status, rounds, the per-worker counters, max frontier),
    its round totals must equal its counters, and it gives phase 14 (a)
    the method keys of ``BENCH_obs.json``, whose sizes, workers and chunk
    are the same.  Returns those keys by family."""
    import numpy as np
    import torch

    from repro_torch.core import plan
    from repro_torch.graphs import generators as G

    bench = json.loads((ROOT / "BENCH_trim.json").read_text())["families"]
    obs_keys = {}
    for family, kw in JSON_SIZES.items():
        g = G.BENCHMARK_GRAPHS[family][0](**kw, device=dev)
        gt = g.transpose()
        t0 = time.perf_counter()
        obs_keys[family] = {}
        for method in METHODS:
            want = {k: bench[family]["methods"][method][k] for k in JSON_KEYS}
            plain = {}
            for backend in BACKENDS:
                res = plain[backend] = plan(
                    g, method=method, backend=backend, workers=OBS_WORKERS,
                    chunk=OBS_CHUNK, transpose=gt, device=dev).run()
                pw = np.asarray(res.per_worker_edges)
                got = dict(rounds=res.rounds, edges_total=int(pw.sum()),
                           max_per_worker=int(pw.max()),
                           trimmed=res.n_trimmed, max_qp=res.max_frontier)
                check(got == want, f"{family}/{method}/{backend}: {got} != "
                                   f"BENCH_trim.json {want}")
            res = plan(g, method=method, workers=OBS_WORKERS,
                       chunk=OBS_CHUNK, transpose=gt, instrument=True,
                       device=dev).run()
            ref = plain["dense"]
            pw = np.asarray(res.per_worker_edges).astype(np.int64)
            check(torch.equal(res.status, ref.status)
                  and (res.rounds, res.max_frontier) == (ref.rounds,
                                                         ref.max_frontier)
                  and np.array_equal(pw, ref.per_worker_edges),
                  f"{family}/{method}: the instrumented dense run differs "
                  "from the plain one")
            check(int(res.round_stats.total("r_edges")) == int(pw.sum())
                  and int(res.round_stats.total("r_frontier"))
                  == res.n_trimmed,
                  f"{family}/{method}: round stats disagree with the "
                  "counters")
            obs_keys[family][method] = {
                "edges_total": int(pw.sum()),
                "max_per_worker": int(pw.max()),
                "imbalance": round(float(pw.max() / max(pw.mean(), 1e-9)),
                                   3),
                "rounds": res.rounds, "trimmed": res.n_trimmed}
        log(f"# phase 2: {family} n={g.n} m={g.m}: 4 methods x 2 backends "
            f"match BENCH_trim.json; each method's instrumented dense run "
            f"equals the plain one and its round totals its counters "
            f"({time.perf_counter() - t0:.2f} s)")
    return obs_keys


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
    return runs


# -- phase 5: the committed SCC and peel counts --------------------------------

def scc_peel_reference_phase(dev):
    import numpy as np
    import torch

    from repro_torch.core import plan, plan_peel
    from repro_torch.core.scc import same_partition, scc_decompose, \
        tarjan_oracle
    from repro_torch.graphs import generators as G

    bench = json.loads((ROOT / "BENCH_scc.json").read_text())["families"]
    for family, kw in SCC_SIZES.items():
        g = G.BENCHMARK_GRAPHS[family][0](**kw, device=dev)
        t0 = time.perf_counter()
        labels, _ = scc_decompose(g, device=dev)
        plain = plan(g, method="ac6", device=dev).run(counters=False)
        rounds = plain.rounds
        # bench_scc.py's rule: an instrumented AC-6 run's r_sparse total
        # decides dense, sparse or mixed; that run equals the plain one
        res = plan(g, method="ac6", instrument=True,
                   device=dev).run(counters=False)
        check(res.rounds == rounds and torch.equal(res.status, plain.status),
              f"{family}: the instrumented AC-6 run differs from the plain "
              "one")
        rs = res.round_stats
        sparse = int(rs.total("r_sparse")) if "r_sparse" in rs.names else 0
        path = ("dense" if sparse == 0 else "sparse" if sparse >= rounds
                else "mixed")
        got = dict(sccs=len(np.unique(labels)), rounds=rounds,
                   frontier_path_taken=path)
        want = {k: bench[family][k] for k in got}
        check(got == want, f"{family}: {got} != BENCH_scc.json {want}")
        check(same_partition(labels, tarjan_oracle(*g.to_numpy())),
              f"{family}: SCC labels differ from Tarjan's partition")
        log(f"# phase 5: BENCH_scc {family} n={g.n} m={g.m}: sccs="
            f"{got['sccs']} rounds={rounds} frontier_path_taken={path} "
            f"({sparse} sparse rounds of the instrumented run, which equals "
            f"the plain one) match; labels partition like "
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
    # from the first vertex of the 1-core other than 0 (phase 15 reruns the
    # pull from 0)
    reach0 = None
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
                if (seed, backend, frontier) == (0, "windowed", "auto"):
                    reach0 = r.mask
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
    return dict(peel=res, peel_engine=peel, scc=(labels, stats),
                reach0=reach0)


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
    Returns the engine and its feed (``--profile`` continues them), the
    first ``OBS_TICKS`` ticks' status, rounds and dirty flag (phase 14
    replays them instrumented), and what phase 15 (d) replays: the engine
    saved after tick ``REPLAY_FROM``, the later ticks' batches, and every
    tick's status and counters on the host."""
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
    from repro_torch import fault
    walls = {False: [], True: []}       # apply ms, by "with insertions"
    ticks = []
    replay = dict(dir=str(CKPT_DIR / "stream"), batches=[], host=[])
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
        if tick < OBS_TICKS:
            ticks.append((res.status.clone(), res.rounds, res.dirty))
        replay["host"].append(tuple(x.cpu().numpy() for x in engine._state))
        if tick >= REPLAY_FROM:
            replay["batches"].append(batch)
        if tick + 1 == REPLAY_FROM:
            ms, nbytes = timed_save(
                lambda: fault.save_engine(replay["dir"], engine, tick + 1),
                replay["dir"], tick + 1)
            log(f"# phase 9: engine saved after tick {tick} for phase 15 "
                f"(d): save_ms={ms:.1f} bytes={nbytes}")
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
    return engine, feed, ticks, replay


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
    check(cli.main(["--app", "check", "--mutants"]) == 0,
          "launch.trim --app check --mutants failed")
    log(f"# phase 13: static checks --strict: 0 errors, 0 warnings; "
        f"subjects per checker {report['subjects_checked']} "
        f"({t_strict:.1f} s on the host CPU); --mutants: {caught} caught, "
        f"copy kernel clean "
        f"({time.perf_counter() - t0:.2f} s for both entry points)")


def card_launches(calls):
    """Run ``calls`` (thunks) on the card under torch.profiler; the port's
    kernels that ran, in order, as ``(kernel, grid, block)`` from the
    chrome trace."""
    import torch

    from repro_torch.analysis.capture import profiled_launches
    from repro_torch.analysis.catalog import LAUNCH_DECLARATIONS
    from repro_torch.analysis.mutants import MUTANT_DECLARATIONS
    names = {k for _, k in (*LAUNCH_DECLARATIONS, *MUTANT_DECLARATIONS)}
    torch.cuda.synchronize()
    with profiled() as prof:
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
        (fls.first_live_probe, (n, n + 1, g_t.m, n, n, 16),
         ("bool", "int32", "int32", "int32", "bool", None), {}),
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
        (ss.segment_sum, ((LG["m"], 1), LG["m"], LG["n"]),
         ("float32", "int64", None), {}),
        (fc.prefix_positions, (n,), ("bool",), {}),
        (mc.mutant_copy, (MUTANT_N,), ("int32",), {}),
        (mc.mutant_copy, (64, 1), ("int32", "int32"), {"block": 16}),
        (mc.mutant_copy, (64,), ("int32",), {"block": 16}),
        # unaligned views (offset 1): the byte-load compaction and scan,
        # and the scalar copy
        (fc.frontier_compact, (n - 1, cap), ("bool", None), {}, 1),
        (fc.prefix_positions, (n - 1,), ("int32",), {}, 1),
        (mc.mutant_copy, (MUTANT_N - 1,), ("int32",), {}, 1),
    ]

    def args_on(shapes, dtypes, device, offset=0):
        return [sh if dt is None else tensor(sh, dt, offset, device)
                for sh, dt in zip(shapes, dtypes)]

    want, calls, points = [], [], 0
    for entry in KERNEL_CATALOG:
        for point in entry.points:
            want += entry.build(point)
            calls.append(lambda e=entry, p=point: e.run(p, dev))
            points += 1
    for fn, shapes, dtypes, kw, *offset in real:
        want += capture_kernel(fn, *args_on(shapes, dtypes, "meta", *offset),
                               **kw)
        args = args_on(shapes, dtypes, dev, *offset)
        calls.append(lambda fn=fn, args=args, kw=kw: fn(*args, **kw))
    want = [(w.kernel, tuple(w.grid), tuple(w.block)) for w in want]
    for attempt in range(3):   # a profile has been seen to miss every item
        got = card_launches(calls)
        if got:
            break
        log(f"# phase 13: profiled run {attempt + 1} of 3: {NO_ITEMS}")
    check(bool(got), f"phase 13: {NO_ITEMS} in 3 profiled runs")
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
    n = MUTANT_N, warm (x in L2 from the call before) and cold (L2 flushed
    before each call).  Returns its row of the kernel table."""
    import torch

    from repro_torch.kernels import mutant_copy as mc
    from repro_torch.kernels import ref
    from repro_torch.obs.profile import bound_ms, kernel_cost

    gen = torch.Generator(device=dev).manual_seed(0)

    def ints(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int32)
    carry = torch.tensor([7], dtype=torch.int32, device=dev)
    # n % 4 in {0, 1, 2, 3}; offset 1: an unaligned x[1:] (scalar kernels)
    for n in (0, 1, 2, 3, 5, 6, 7, 255, 1000, 4097, 4098, 4099):
        base = ints(n + 1)
        for off in (0, 1):
            x = base[off:off + n]
            for c in (None, carry):
                for block in (16, 256, 1024):
                    got = mc.mutant_copy(x, c, block=block)
                    check(torch.equal(got, ref.mutant_copy_ref(x, c)),
                          f"mutant_copy n={n} offset={off} block={block} "
                          f"carry={c}")
    base = ints(MUTANT_N + 1)
    x = base[:MUTANT_N]
    err = max_abs_err((mc.mutant_copy(x),), (x.clone(),))
    check(err == 0, "mutant_copy differs from x.clone() at the real size")
    check(torch.equal(mc.mutant_copy(x, carry), x + 7),
          "mutant_copy with a carry differs at the real size")
    xu = base[1:]
    check(torch.equal(mc.mutant_copy(xu), xu.clone()),
          "mutant_copy differs from x.clone() at the real size, x[1:]")

    def kern():
        return mc.mutant_copy(x)
    row = dict(max_abs_err=err, ms=time_ms(kern),
               plain_ms=time_ms(lambda: ref.mutant_copy_ref(x)),
               library_ms=time_ms(x.clone),
               bound_ms=bound_ms(*kernel_cost("mutant_copy", (x, None))),
               bound_by="bytes")
    log(f"# phase 13: mutant_copy bit-identical to x.clone() (n = 0-7, "
        f"255, 1000, 4097-4099 and {MUTANT_N:,}, aligned and x[1:]; blocks "
        f"16, 256, 1024; with and without the carry word); n="
        f"{MUTANT_N:,}: kernel_ms={row['ms']:.4f} device_ms="
        f"{device_ms(kern):.4f} cold device_ms={cold_device_ms(kern):.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms="
        f"{row['library_ms']:.4f} (x.clone(); device_ms="
        f"{device_ms(x.clone):.4f} cold device_ms="
        f"{cold_device_ms(x.clone):.4f}) bound_ms={row['bound_ms']:.4f}; "
        f"x[1:] (scalar) device_ms="
        f"{device_ms(lambda: mc.mutant_copy(xu)):.4f}")
    return row


def budget_syncs(eng, entry: str, what: str):
    """One run of a warm engine with its host syncs counted twice, by
    torch on the card and by the CPU lint's counter; both must equal the
    lint's budget (``PLAN_CATALOG[entry]``) for the rounds and probe-loop
    tests the card ran.  Returns ``(result, syncs, rounds, tests)``."""
    import warnings

    import torch

    from repro_torch.analysis import syncs
    from repro_torch.analysis.catalog import PLAN_CATALOG
    budget = next(e for e in PLAN_CATALOG if e.name == entry)
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
    want = syncs.budget(budget, rounds, tests)
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in rec
             if SYNC_WARNING in str(w.message)]
    check(card == want and counter.syncs == want,
          f"{what}: {card} syncs on the card ({sites}), {counter.syncs} by "
          f"the lint ({counter.events}), budget {want}")
    return res, card, rounds, tests


def sync_budget_phase(dev, g, gt):
    """(d): one warm AC-4 and one AC-6 trim at the real size: the host
    syncs torch counts on the card, and the CPU lint's counter, against
    the lint's budget for the rounds and probe steps the card ran.
    Returns the card's count of each (phase 15 (a) holds an inert
    FaultPlane to them)."""
    import torch

    from repro_torch.core import plan
    counts = {}
    # the auto frontier syncs as the sparse one does: one read a round,
    # which also carries the dense/sparse choice
    for method, entry in (("ac4", "trim/ac4[probe=dense,frontier=sparse]"),
                          ("ac6", "trim/ac6[probe=dense,frontier=sparse]")):
        eng = plan(g, method=method, workers=16, transpose=gt, device=dev)
        eng.run()
        torch.cuda.synchronize()
        _, card, rounds, tests = budget_syncs(eng, entry, method)
        counts[method] = card
        log(f"# phase 13: {method} at RMAT scale 22 (auto frontier): "
            f"{rounds} rounds, {tests} probe-loop tests; host syncs on the "
            f"card and counted by the lint {card}, equal to the budget")
    return counts


# -- phase 14: observability on the card --------------------------------------

def obs_reference_phase(dev, methods_by_family):
    """(a): ``BENCH_obs.json`` at its own sizes (``bench_obs.py``: 16
    workers, chunk 1): every method's five keys (from phase 2's
    instrumented dense runs, whose ``r_edges`` totals equal their
    per-worker sums), the eight ``scc`` keys (its span counts included)
    and ``ordering_ok``."""
    from repro_torch import obs
    from repro_torch.core.scc import scc_decompose
    from repro_torch.graphs import generators as G

    doc = json.loads((ROOT / "BENCH_obs.json").read_text())
    check(doc["workers"] == OBS_WORKERS, "BENCH_obs.json workers")
    orders = []
    for family, kw in JSON_SIZES.items():
        bench = doc["families"][family]
        g = G.BENCHMARK_GRAPHS[family][0](**kw, device=dev)
        check((g.n, g.m) == (bench["n"], bench["m"]), f"{family}: n, m")
        t0 = time.perf_counter()
        methods = methods_by_family[family]
        with obs.recording() as rec:
            _, stats = scc_decompose(g, counters=True, workers=OBS_WORKERS,
                                     chunk=OBS_CHUNK, instrument=True,
                                     device=dev)
        pw = stats["per_worker_edges"]
        scc = {"generations": stats["generations"],
               "trim_rounds": stats["trim_rounds"],
               "reach_rounds": stats["reach_rounds"],
               "trim_edges_total": int(pw.sum()),
               "trim_max_per_worker": int(pw.max()),
               "trim_imbalance": round(float(pw.max() / max(pw.mean(),
                                                             1e-9)), 3),
               "dispatch_spans": len(rec.select("dispatch", cat="engine")),
               "generation_spans": len(rec.select("generation",
                                                  cat="scc"))}
        mx = {m: methods[m]["max_per_worker"] for m in METHODS}
        ordering = bool(mx["ac3"] > mx["ac4"] >= mx["ac6"])
        check(methods == bench["methods"],
              f"{family}: {methods} != BENCH_obs.json {bench['methods']}")
        check(scc == bench["scc"],
              f"{family}: scc {scc} != BENCH_obs.json {bench['scc']}")
        check(ordering == bench["ordering_ok"], f"{family}: ordering_ok")
        orders.append(ordering)
        log(f"# phase 14: BENCH_obs {family} n={g.n} m={g.m}: 4 x 5 method "
            f"keys, 8 scc keys and ordering_ok={ordering} match; max per "
            f"worker ac3 {mx['ac3']} ac4 {mx['ac4']} ac4* {mx['ac4*']} ac6 "
            f"{mx['ac6']} ({time.perf_counter() - t0:.2f} s)")
    check(all(orders) == doc["ordering_ok"], "BENCH_obs.json ordering_ok")


def card_syncs(fn) -> int:
    """Host syncs of one call of ``fn``, counted by torch's sync debug
    mode."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in rec)


def median_wall_ms(fns, reps: int = 3) -> list:
    """Median wall ms of each of ``fns``, called in turns."""
    import numpy as np
    import torch
    walls = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[i].append((time.perf_counter() - t0) * 1e3)
    return [float(np.median(w)) for w in walls]


def obs_real_phase(dev, g, gt, trims, real6, ticks):
    """(b)-(e) at RMAT scale 22: the instrumented trims, reach, full peel,
    four stream ticks and ``scc_decompose`` against the plain runs of
    phases 3, 6 and 9 (reach against a plain twin), bit for bit; the
    recorder around the
    SCC run, exported and read back; memory; the command line's
    snapshot."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import plan, plan_peel, plan_reach, plan_stream
    from repro_torch.core.scc import same_partition, scc_decompose

    # (b) the trims: equal to phase 3's, totals equal the counters; the
    # device items of the dense ones and the syncs of AC-4 and AC-6; the
    # wall overhead of one AC-4 and one AC-6 trim, in turns
    t_b = time.perf_counter()
    for (method, backend), want in trims.items():
        kw = dict(method=method, backend=backend, workers=16, transpose=gt,
                  device=dev)
        plain, inst = plan(g, **kw), plan(g, instrument=True, **kw)
        res = inst.run()
        rs = res.round_stats
        check(torch.equal(res.status, want.status)
              and (res.rounds, res.max_frontier) == (want.rounds,
                                                     want.max_frontier)
              and np.array_equal(res.per_worker_edges, want.per_worker_edges),
              f"{method}/{backend}: instrumented run differs from phase 3")
        check(int(rs.total("r_edges")) == res.edges_traversed
              and int(rs.total("r_frontier")) == res.n_trimmed,
              f"{method}/{backend}: round totals differ from the counters")
        note = ""
        if (method, backend) in OVERHEAD_TRIMS:
            p_ms, i_ms = median_wall_ms([plain.run, inst.run])
            note = (f"; wall_ms plain {p_ms:.1f} instrumented {i_ms:.1f} "
                    f"({i_ms - p_ms:+.2f})")
        if backend == "dense":
            (n0, c0), (n1, c1) = item_counts([plain.run, inst.run])
            extra = n1 - n0
            check(0 <= extra <= INSTRUMENT_ITEMS[method] * res.rounds
                  + INSTRUMENT_FOLD_ITEMS,
                  f"{method}: instrument=True added {extra} device items in "
                  f"{res.rounds} rounds (profiled plain {c0}, instrumented "
                  f"{c1})")
            note += (f"; device items +{extra} (bound "
                     f"{INSTRUMENT_ITEMS[method]} a round + "
                     f"{INSTRUMENT_FOLD_ITEMS}; profiled plain {c0}, "
                     f"instrumented {c1})")
            if method in ("ac4", "ac6"):
                s0, s1 = card_syncs(plain.run), card_syncs(inst.run)
                check(s0 == s1, f"{method}: {s1} host syncs instrumented, "
                                f"{s0} plain")
                note += f"; host syncs {s1} = plain {s0}"
        log(f"# phase 14: {method}/{backend} instrumented: rounds="
            f"{res.rounds} r_frontier {rs.per_round('r_frontier')[:res.rounds].tolist()}"
            f" r_edges {rs.per_round('r_edges')[:res.rounds].tolist()} equal "
            f"phase 3 bit for bit{note}")

    # reach, from vertex 0 on both backends
    for backend in ("windowed", "dense"):
        kw = dict(backend=backend, transpose=gt, device=dev)
        plain, inst = plan_reach(g, **kw), plan_reach(g, instrument=True, **kw)
        a, b = plain.run(0), inst.run(0)
        check(torch.equal(a.mask, b.mask) and a.rounds == b.rounds
              and int(b.round_stats.total("r_frontier")) == b.n_reached,
              f"reach {backend}: instrumented sweep differs")
        log(f"# phase 14: reach {backend} instrumented: rounds={b.rounds} "
            "equal the plain sweep")

    # the full peel: equal to phase 6's; then phase 6's warm engine and
    # the instrumented one once each, in turns
    ipeel = plan_peel(g, transpose=gt, instrument=True, device=dev)
    res = ipeel.run()
    rs = res.round_stats
    res = res.materialize()
    want = real6["peel"]
    check(np.array_equal(res.coreness, want.coreness)
          and np.array_equal(res.peel_round, want.peel_round)
          and res.rounds == want.rounds, "instrumented peel differs")
    check(int(rs.total("r_frontier")) == g.n, "peel: r_frontier total")
    p_ms, i_ms = median_wall_ms([real6["peel_engine"].run, ipeel.run],
                                reps=1)
    log(f"# phase 14: peel instrumented: rounds={res.rounds} (capacity "
        f"{rs.max_rounds}, overflowed={rs.overflowed}) equal phase 6; "
        f"wall_ms plain {p_ms:.1f} instrumented {i_ms:.1f} "
        f"({i_ms - p_ms:+.2f}, {(i_ms - p_ms) / res.rounds * 1e3:.1f} us a "
        "round)")
    del ipeel

    # the first ticks of phase 9's feed again, on an instrumented engine,
    # against what phase 9's plain engine gave
    k = g.m // 1000
    engine = plan_stream(g, capacity=max(4096, 16 * k), instrument=True)
    feed = StreamFeed(g, k)
    for tick, (status, rounds, dirty) in enumerate(ticks):
        b = engine.apply(**feed.next())
        check(torch.equal(b.status, status) and (b.rounds, b.dirty)
              == (rounds, dirty) and b.round_stats is not None,
              f"stream tick {tick}: instrumented apply differs")
        log(f"# phase 14: stream tick {tick} instrumented: rounds="
            f"{b.rounds} dirty={dirty} r_frontier "
            f"{b.round_stats.per_round('r_frontier')[:b.rounds].tolist()} "
            "equal phase 9's plain engine")
    del engine, feed
    log(f"# phase 14: (b) without scc_decompose done in "
        f"{time.perf_counter() - t_b:.1f} s")

    # (b)+(c) scc_decompose under a recorder, against phase 6's run
    with obs.recording() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, stats = scc_decompose(g, instrument=True, device=dev)
        wall = (time.perf_counter() - t0) * 1e3
    labels0, stats0 = real6["scc"]
    check(same_partition(labels, labels0)
          and all(stats[k] == stats0[k] for k in (
              "generations", "pivots", "trimmed_total", "trim2_removed",
              "trim_dispatches", "reach_dispatches")),
          "instrumented scc_decompose differs from phase 6")
    check(stats["trim_rounds"] > 0 and stats["reach_rounds"] > 0,
          f"scc round totals {stats['trim_rounds']} {stats['reach_rounds']}")
    spans = rec.select("dispatch", cat="engine")
    gens = rec.select("generation", cat="scc")
    check(len(spans) == stats["trim_dispatches"] + stats["reach_dispatches"]
          and len(gens) == stats["generations"],
          f"{len(spans)} dispatch and {len(gens)} generation spans for "
          f"{stats}")
    out = ROOT / "build" / "obs"
    out.mkdir(parents=True, exist_ok=True)
    want_spans = [sp.to_dict() for sp in rec.spans]
    back = obs.read_jsonl(rec.to_jsonl(str(out / "scc_spans.jsonl")))
    chrome = obs.read_chrome_trace(rec.to_chrome_trace(
        str(out / "scc_trace.json")))
    check(back == json.loads(json.dumps(want_spans, default=str)),
          "the JSONL spans differ when read back")
    check([(d["name"], d["cat"], d["ph"]) for d in chrome]
          == [(d["name"], d["cat"], d["ph"]) for d in want_spans]
          and sum(d["name"] == "dispatch" for d in chrome) == len(spans),
          "the chrome trace differs when read back")
    kernels = rec.select(cat="kernel")
    log(f"# phase 14: scc_decompose instrumented: wall_ms={wall:.1f}; "
        f"trim_rounds={stats['trim_rounds']} reach_rounds="
        f"{stats['reach_rounds']}; {len(spans)} dispatch spans = "
        f"{stats['trim_dispatches']} trim + {stats['reach_dispatches']} "
        f"reach dispatches, {len(gens)} generation spans, {len(kernels)} "
        f"kernel calls ({', '.join(sorted({sp.name for sp in kernels}))}); "
        f"{len(want_spans)} events through JSONL and a chrome trace and back")

    # (d) memory: what caching a trim engine's resources (Gᵀ, its row ids,
    # the worker map: 4 tensors) added to the allocator against its
    # nbytes_breakdown().  The caching allocator rounds a tensor up to a
    # multiple of 512 bytes, and a block of its large pool keeps its
    # segment's remainder when no more than 1 MiB is left: at most
    # ALLOC_SLACK bytes a tensor (the cache is emptied first, so each
    # tensor gets a fresh segment)
    eng = plan(g, method="ac4", workers=16, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    eng._transpose_arrays()
    eng._ids()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    bd = eng.nbytes_breakdown()
    cached = sum(v for c, v in bd.items() if c != "graph")
    check(0 <= grown - cached <= 4 * ALLOC_SLACK,
          f"allocator grew {grown} bytes caching {cached} bytes ({bd})")
    stats = obs.device_memory_stats()["cuda:0"]
    log(f"# phase 14: memory: ac4 engine {bd}: cached {cached} bytes, the "
        f"allocator grew {grown} (+{grown - cached}, bound 4 x "
        f"{ALLOC_SLACK}); "
        f"device_memory_stats: " + ", ".join(
            f"{k}={v}" for k, v in sorted(stats.items())
            if k.endswith((".current", ".peak"))))
    del eng

    # (e) the command line's metrics snapshot, through its main() as
    # phase 10 runs it
    from repro_torch.launch import trim as cli
    path = out / "metrics.json"
    t0 = time.perf_counter()
    cli.main(["--app", "scc", "--graph", "RMAT", "--metrics-json",
              str(path)])
    plane = obs.load_snapshot(json.loads(path.read_text()))
    need = {"repro_dispatches", "repro_fixpoint_rounds",
            "repro_engine_live_bytes"}
    check(need <= set(plane.families),
          f"the snapshot holds {sorted(plane.families)}")
    disp = {dict(k)["family"]: c.value
            for k, c in plane.families["repro_dispatches"].children.items()}
    log(f"# phase 14: launch.trim --app scc --graph RMAT --metrics-json: "
        f"{len(plane.families)} families "
        f"({', '.join(sorted(plane.families))}); dispatches {disp} "
        f"({time.perf_counter() - t0:.1f} s)")


# -- phase 15: faults and checkpoints -----------------------------------------

def ckpt_bytes(path: str, step: int) -> int:
    """Bytes of one checkpoint step on disk (its .npy files and
    manifest)."""
    d = Path(path) / f"step_{step:08d}"
    return sum(f.stat().st_size for f in d.iterdir())


def timed_save(fn, path: str, step: int):
    """Wall ms of one synchronous save (the card's copies to the host and
    the disk writes), and the bytes it wrote."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3, ckpt_bytes(path, step)


def fault_phase(dev, g, gt, trims, real6, replay, syncs13):
    """Phase 15: the FaultPlane and checkpoints at RMAT scale 22, each
    result held bit for bit to the plain runs of phases 3, 6, 9 and 13."""
    import os
    import shutil

    import numpy as np
    import torch

    from repro_torch import fault as flt
    from repro_torch.core import plan, plan_peel, plan_reach
    from repro_torch.core.scc import scc_decompose
    from repro_torch.train import checkpoint as ckpt_lib

    def no_sleep(_):
        pass

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the four engines of (b) and (c), planned as phases 3 and 6 planned
    # them; ``run`` gives each one's result, ``same`` holds it to the
    # earlier phase's
    def trim_case(method, backend):
        want = trims[method, backend]
        return dict(
            make=lambda: plan(g, method=method, backend=backend, workers=16,
                              transpose=gt, device=dev),
            run=lambda e: e.run(),
            same=lambda r: (torch.equal(r.status, want.status)
                            and r.rounds == want.rounds
                            and np.array_equal(r.per_worker_edges,
                                               want.per_worker_edges)))
    cases = {f"{m}/{b}": trim_case(m, b) for m, b in FAULT_TRIMS}
    cases["reach pull"] = dict(
        make=lambda: plan_reach(g, backend="windowed", transpose=gt,
                                device=dev),
        run=lambda e: e.run(0).materialize(),
        same=lambda r: np.array_equal(r.mask, real6["reach0"]))
    peel_want = real6["peel"]
    cases["peel"] = dict(
        make=lambda: plan_peel(g, transpose=gt, device=dev),
        run=lambda e: e.run().materialize(),
        same=lambda r: (np.array_equal(r.coreness, peel_want.coreness)
                        and r.rounds == peel_want.rounds))

    # (a) an inert plane: armed at every dispatch, firing never
    t_a = time.perf_counter()
    for (method, backend), entry in zip(
            FAULT_TRIMS, ("trim/ac4[probe=dense,frontier=sparse]",
                          "trim/ac6[probe=windowed,frontier=dense]")):
        eng = cases[f"{method}/{backend}"]["make"]()
        eng.run()
        torch.cuda.synchronize()
        with flt.injecting_faults() as plane:
            res, card, rounds, tests = budget_syncs(
                eng, entry, f"{method}/{backend} under an inert plane")
        check(cases[f"{method}/{backend}"]["same"](res)
              and plane.armings["pre-dispatch"] == 1
              and plane.armings["post-dispatch"] == 1
              and not plane.injected,
              f"(a) {method}/{backend} under an inert plane differs from "
              "phase 3")
        # phase 13 ran the same AC-4 plan (its AC-6 was dense)
        same13 = (method, backend) == ("ac4", "dense")
        if same13:
            check(card == syncs13[method], f"(a) {method}: {card} host "
                  f"syncs, phase 13 counted {syncs13[method]}")
        log(f"# phase 15 (a): {method}/{backend} under an inert FaultPlane:"
            f" status and per-worker counters equal phase 3's; {card} host "
            f"syncs ({rounds} rounds, {tests} probe-loop tests), the lint's "
            f"budget" + (" and phase 13's count" if same13 else ""))
    log(f"# phase 15 (a): {time.perf_counter() - t_a:.1f} s")

    # (b) a pre-dispatch and a post-dispatch fault, retried
    t_b = time.perf_counter()
    engines = {}
    for name, case in cases.items():
        for point in ("pre-dispatch", "post-dispatch"):
            eng = case["make"]()
            with flt.injecting_faults(
                    flt.FaultSchedule(0, at={point: [1]})) as plane:
                res = flt.call_with_retries(lambda: case["run"](eng),
                                            retries=2, sleep=no_sleep)
            check(case["same"](res) and plane.injected[point] == 1
                  and plane.recoveries[(point, "retry")] == 1
                  and eng.dispatches == 1,
                  f"(b) {name}: a retried {point} fault differs from the "
                  f"fault-free run (dispatches {eng.dispatches})")
            engines[name] = eng
        log(f"# phase 15 (b): {name}: a pre-dispatch and a post-dispatch "
            "fault, each retried once: results equal phases 3/6, one "
            "dispatch counted")
    log(f"# phase 15 (b): {time.perf_counter() - t_b:.1f} s")

    # (c) save, restore, run
    t_c = time.perf_counter()
    for i, (name, eng) in enumerate(engines.items()):
        path = str(CKPT_DIR / f"engine{i}")
        save_ms, nbytes = timed_save(
            lambda: flt.save_engine(path, eng, 1), path, 1)
        (restored, step, _, _), restore_ms = timed(
            lambda: flt.restore_engine(path, device=dev))
        res, run_ms = timed(lambda: cases[name]["run"](restored))
        check(step == 1 and cases[name]["same"](res)
              and restored.dispatches == eng.dispatches + 1,
              f"(c) {name}: the restored engine's run differs")
        log(f"# phase 15 (c): {name}: save_ms={save_ms:.1f} "
            f"restore_ms={restore_ms:.1f} bytes={nbytes} "
            f"({restored.plan_signature()}); the restored run "
            f"({run_ms:.1f} ms) equals phases 3/6")
        del restored
        shutil.rmtree(path)
    del engines
    log(f"# phase 15 (c): {time.perf_counter() - t_c:.1f} s")

    # (d) the stream: restore after tick REPLAY_FROM and replay the rest
    t_d = time.perf_counter()
    host = replay["host"]

    def same_tick(eng, tick):
        status, counters = host[tick]
        return (np.array_equal(eng._state[0].cpu().numpy(), status)
                and np.array_equal(eng._state[1].cpu().numpy(), counters)
                and np.array_equal(
                    eng.retrim().status.cpu().numpy().astype(bool), status))

    (stream, step, _, _), restore_ms = timed(
        lambda: flt.restore_engine(replay["dir"], device=dev))
    check(step == REPLAY_FROM and same_tick(stream, REPLAY_FROM - 1),
          "(d) the restored stream differs from phase 9's tick")
    log(f"# phase 15 (d): stream restored as it was after phase 9's tick "
        f"{REPLAY_FROM - 1} in {restore_ms:.1f} ms")
    tick5 = str(CKPT_DIR / "stream5")
    dirty = []
    for i, batch in enumerate(replay["batches"]):
        tick = REPLAY_FROM + i
        if i == 0:
            # retry-safe: nothing has committed at this point
            with flt.injecting_faults(flt.FaultSchedule(
                    0, at={"mid-update-batch": [1]})) as plane:
                res = flt.call_with_retries(lambda: stream.apply(**batch),
                                            retries=2, sleep=no_sleep)
            check(plane.injected["mid-update-batch"] == 1,
                  "(d) the mid-update-batch fault did not fire")
            how = "a mid-update-batch fault, retried with the same batch"
        elif i == 1:
            # the host mirrors moved: restore the previous tick's
            # checkpoint and re-apply
            with flt.injecting_faults(flt.FaultSchedule(
                    0, at={"pre-dispatch": [1]})) as plane:
                try:
                    stream.apply(**batch)
                    fired = False
                except flt.DeviceFault:
                    fired = True
            check(fired, "(d) the pre-dispatch fault did not fire")
            (stream, _, _, _), restore_ms = timed(
                lambda: flt.restore_engine(tick5, device=dev))
            res = stream.apply(**batch)
            how = (f"a pre-dispatch fault, recovered by restoring the "
                   f"checkpoint after tick {tick - 1} ({restore_ms:.1f} ms) "
                   "and re-applying")
        else:
            res = stream.apply(**batch)
            how = "no fault"
        dirty.append(res.dirty)
        check(same_tick(stream, tick),
              f"(d) replayed tick {tick} differs from phase 9's")
        if i == 0:
            save_ms, nbytes = timed_save(
                lambda: flt.save_engine(tick5, stream, tick + 1), tick5,
                tick + 1)
            how += f"; saved: save_ms={save_ms:.1f} bytes={nbytes}"
        log(f"# phase 15 (d): tick {tick}: {how}; status, counters and "
            f"retrim() equal phase 9's (dirty={res.dirty})")
    # one more deletion-only tick on the replayed engine and on phase 9's
    # own, which ended at the same tick: a batch that revives nothing goes
    # through counter_scatter (an insertion tick above may revive).
    # Phase 9 ended with retrim(full=True), which recounts the dead
    # vertices' counters, so only the live ones (live out-degrees) compare
    extra = replay["feed"].next(insert=False)
    for eng in (stream, replay["engine"]):
        res = eng.apply(**extra)
        check(not res.dirty, "(d) a deletion-only batch came back dirty")
    (s1, c1), (s2, c2) = stream._state, replay["engine"]._state
    check(torch.equal(s1, s2) and torch.equal(c1[s1], c2[s2]),
          "(d) the replayed engine and phase 9's differ after one more "
          "deletion-only tick")
    log(f"# phase 15 (d): dirty flags of the replayed ticks {dirty}; one "
        f"more deletion-only tick on both engines: status and live "
        f"counters equal; {time.perf_counter() - t_d:.1f} s")
    del stream

    # (e) SCC: a fault at the last pre-dispatch, then resume
    t_e = time.perf_counter()
    labels0, stats0 = real6["scc"]
    last = stats0["trim_dispatches"] + stats0["reach_dispatches"]
    path = str(CKPT_DIR / "scc")
    with flt.injecting_faults(flt.FaultSchedule(
            0, at={"pre-dispatch": [last]})) as plane:
        try:
            scc_decompose(g, checkpoint_dir=path, checkpoint_every=1,
                          device=dev)
            fired = False
        except flt.DeviceFault:
            fired = True
    saved = ckpt_lib.latest_step(path)
    check(fired and saved is not None,
          f"(e) the fault at pre-dispatch #{last} did not fire")
    (labels, stats), resume_ms = timed(lambda: scc_decompose(
        g, checkpoint_dir=path, checkpoint_every=1, resume=True, device=dev))
    check(np.array_equal(labels, labels0)
          and (stats["generations"], stats["pivots"])
          == (stats0["generations"], stats0["pivots"]),
          "(e) the resumed SCC differs from phase 6's")
    log(f"# phase 15 (e): scc_decompose(checkpoint_every=1), a fault at "
        f"pre-dispatch #{last} of {last} (phase 6's dispatches), "
        f"generation {saved} on disk ({ckpt_bytes(path, saved)} bytes); "
        f"resume=True in {resume_ms:.1f} ms: labels, generations "
        f"({stats['generations']}) and pivots ({stats['pivots']}) equal "
        f"phase 6's; {time.perf_counter() - t_e:.1f} s")
    shutil.rmtree(path)

    # (f) the trainer: MeshGraphNet on the molecule cell resumes at 2 of 4
    t_f = time.perf_counter()
    from repro_torch.launch import train as tcli
    from repro_torch.train import Trainer, TrainerConfig

    def trainer(steps, ckpt=None):
        step, params, opt_state, stream_, put = tcli.build(
            "meshgraphnet", 0, smoke=False, device=dev)
        return Trainer(step, params, opt_state, stream_,
                       TrainerConfig(num_steps=steps, ckpt_dir=ckpt,
                                     ckpt_every=2, log_every=100),
                       put_batch=put)

    def state(tr):
        return [t for _, t in ckpt_lib.leaves({"p": tr.params,
                                               "o": tr.opt_state})]

    whole = [[h["loss"] for h in trainer(4).run()] for _ in range(2)]
    path = str(CKPT_DIR / "trainer")
    first = trainer(2, path)
    losses = [h["loss"] for h in first.run()]
    second = trainer(4, path)
    check(second.start_step == 2
          and all(torch.equal(a, b) for a, b in zip(state(second),
                                                    state(first))),
          "(f) the restored parameters or AdamW state differ from the "
          "saved ones")
    losses += [h["loss"] for h in second.run()]
    if whole[0] == whole[1]:
        check(losses == whole[0], f"(f) resumed losses {losses} differ "
              f"from the uninterrupted {whole[0]}")
        how = "bit for bit (two uninterrupted runs agree bit for bit)"
    else:
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, whole[0]))
        check(err <= TRAIN_TOL["loss"], f"(f) resumed losses {losses} "
              f"differ from the uninterrupted {whole[0]} by {err:.3g}")
        how = (f"to {err:.3g} relative (two uninterrupted runs differ, so "
               f"the tolerance is phase 12's {TRAIN_TOL['loss']})")
    log(f"# phase 15 (f): meshgraphnet molecule: restored at step 2 of 4 "
        f"({ckpt_bytes(path, 2)} bytes), parameters and AdamW state equal "
        f"the saved ones bit for bit; losses {losses} equal the "
        f"uninterrupted run's {how}; {time.perf_counter() - t_f:.1f} s")
    del first, second
    shutil.rmtree(path)

    # (g) the command line, in its own process
    t_g = time.perf_counter()
    from repro_torch.graphs import make
    path = str(CKPT_DIR / "cli")
    argv = [sys.executable, "-m", "repro_torch.launch.trim", "--app", "scc",
            "--graph", "RMAT", "--checkpoint-dir", os.path.relpath(path, ROOT),
            "--fault-seed",
            "7", "--fault-rate", "0.05", "--retries", "5"]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(
                             ROOT / "src")))
    check(out.returncode == 0, f"(g) the CLI failed: {out.stderr[-2000:]}")
    tree, step, _ = ckpt_lib.load_flat(path)
    clean, _ = scc_decompose(make("RMAT", device=dev), device=dev)
    check(np.array_equal(tree["labels"].astype(np.int64), clean)
          and tree["regions"].shape[0] == 0,
          "(g) the CLI's final labels differ from a run without faults")
    resumed = out.stdout.count("resuming from latest checkpoint")
    log(f"# phase 15 (g): {' '.join(argv[1:])}: exit 0, {resumed} "
        f"resume(s); the final checkpoint (generation {step}) holds the "
        f"labels of a run without faults; {time.perf_counter() - t_g:.1f} "
        f"s; {out.stdout.strip().splitlines()[-1]}")
    shutil.rmtree(path)


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
    from repro_torch.kernels import flash_attention as fa
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
    # the wrapper's dispatch is static: (dtype, D) decides the kernel
    kernel = fa.kernel_for(cfg.compute_dtype, cfg.d_head)
    check(kernel == "flash_fwd_wgmma", f"the {cfg.compute_dtype} prefill "
          f"at D={cfg.d_head} runs {kernel}, not flash_fwd_wgmma")
    check(toks.shape == (SERVE["batch"], SERVE["gen_len"] + 1)
          and toks.min() >= 0 and toks.max() < cfg.vocab,
          f"served tokens {toks.shape} out of range")
    dec = np.asarray(stats["decode_ms"])
    n_tok = SERVE["batch"] * SERVE["gen_len"]
    log(f"# phase 11: serve_lm {SERVE['batch']} x {SERVE['prompt_len']} "
        f"prompt tokens, {SERVE['gen_len']} new: launches {launches} "
        f"(flash_attention on {kernel}); "
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
    same up to rounding (1e-5 relative)."""
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


# -- phase 16: the trim-stream server -------------------------------------------

class TeeOut:
    """A stdout that also keeps what was written (to read the port the
    metrics server printed)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def scrape_once(tee, found: dict, timeout_s: float = 120.0) -> None:
    """Wait for the server's port in ``tee``, then for a finished tick on
    ``/healthz``, then fetch ``/metrics`` and ``/healthz`` once."""
    import urllib.request
    deadline = time.monotonic() + timeout_s
    port = None
    while time.monotonic() < deadline:
        if port is None:
            m = re.search(r"127\.0\.0\.1:(\d+)/metrics", "".join(tee.text))
            port = int(m.group(1)) if m else None
        if port is not None:
            base = f"http://127.0.0.1:{port}"
            try:
                health = urllib.request.urlopen(f"{base}/healthz", timeout=5)
                doc = json.loads(health.read())
                if doc.get("ticks_done", 0) >= 1:
                    metrics = urllib.request.urlopen(f"{base}/metrics",
                                                     timeout=5)
                    found.update(health=health.status, doc=doc,
                                 metrics=metrics.status,
                                 text=metrics.read().decode())
                    return
            except OSError:
                pass
        time.sleep(0.01)


def server_real_phase(dev, tick8):
    """Phase 16 (a): ``serve_trim_stream`` on phase 9's graph with phase 9's
    feed and capacity: its final checkpoint must hold phase 9's state
    after tick 8 (``tick8``: status and counters on the host)."""
    import threading

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.train import checkpoint as ckpt_lib

    path = str(CKPT_DIR / "serve")
    mjson = str(CKPT_DIR / "serve_metrics.json")
    k = REAL["m"] // 1000                # phase 9's batch
    serve._STREAM_GRAPHS["RMAT22"] = ("rmat", dict(REAL))
    tee, found = TeeOut(sys.stdout), {}
    scraper = threading.Thread(target=scrape_once, args=(tee, found),
                               daemon=True)
    t0 = time.perf_counter()
    sys.stdout = tee
    scraper.start()
    try:
        with obs.recording() as rec:
            engine = serve.serve_trim_stream(
                "RMAT22", ticks=STREAM_TICKS, batch=k, seed=0,
                metrics_port=0, metrics_json=mjson, checkpoint_dir=path,
                checkpoint_every=SERVE_CKPT_EVERY, device=dev)
    finally:
        sys.stdout = tee.out
        del serve._STREAM_GRAPHS["RMAT22"]
    wall = time.perf_counter() - t0
    scraper.join(timeout=10)
    tree, step, meta = ckpt_lib.load_flat(path)
    check(step == STREAM_TICKS and meta["feed"]["tick"] == STREAM_TICKS,
          f"(a) the final checkpoint is step {step}")
    check(np.array_equal(tree["status"].astype(bool), tick8[0].astype(bool))
          and np.array_equal(tree["counters"], tick8[1]),
          "(a) the server's final status or counters differ from phase 9's "
          "after tick 8")
    check(found.get("health") == 200 and found.get("metrics") == 200
          and "repro_serve_updates" in found.get("text", ""),
          f"(a) the scrape during the feed failed: {found}")
    ticks = rec.select("tick", cat="serve")
    dispatches = rec.select("dispatch", cat="engine")
    updates = sum(t.attrs["updates"] for t in ticks)
    snap = json.loads(Path(mjson).read_text())["families"]
    got = sum(c["value"] for c in snap["repro_serve_updates"]["children"])
    check(len(ticks) == STREAM_TICKS and got == updates,
          f"(a) repro_serve_updates {got} != the ticks' {updates}")
    save = snap["repro_checkpoint_seconds"]["children"][0]
    setup_ms = ticks[0].ts * 1e3            # the recorder starts with the call
    tick_ms = [t.dur * 1e3 for t in ticks]
    log(f"# phase 16 (a): serve_trim_stream('RMAT22', ticks={STREAM_TICKS}, "
        f"batch={k}) on phase 9's graph and feed: {wall:.1f} s in all; "
        f"set-up {setup_ms:.1f} ms from the call to the first tick (the "
        f"graph's generation, the DeltaCSR index, Gᵀ and the plan-time "
        f"retrim, {dispatches[0].dur * 1e3:.1f} ms); apply ms per tick "
        f"{[round(x, 1) for x in tick_ms]} (median "
        f"{np.median(tick_ms):.1f}); {updates} updates; final checkpoint "
        f"(step {step}) status and counters equal phase 9's after tick "
        f"{STREAM_TICKS} bit for bit; scraped /healthz and /metrics "
        f"(200, 200) after tick {found['doc']['ticks_done']}; "
        f"repro_serve_updates {got} = the ticks' sum; saves: "
        f"{save['count']} at {save['sum'] / save['count'] * 1e3:.1f} ms "
        f"each on the loop's thread ({save['labels']['mode']}), "
        f"{ckpt_bytes(path, step)} bytes; dirty ticks "
        f"{meta['feed']['dirty_ticks']}, compactions {engine.compactions}")
    del engine
    torch.cuda.empty_cache()


def server_kill_phase(dev):
    """Phase 16 (b): the reference's acceptance scenario on the card: an
    uninterrupted run, then the CLI SIGKILLed after its first checkpoint
    and restarted; the final checkpoints must be equal."""
    import contextlib
    import io
    import os

    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.train import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    whole = str(CKPT_DIR / "serve_whole")
    with contextlib.redirect_stdout(io.StringIO()):
        serve.serve_trim_stream("RMAT", ticks=8, batch=256, seed=0,
                                checkpoint_dir=whole, checkpoint_every=2,
                                device=dev)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    killed = None
    for attempt in range(3):
        path = str(CKPT_DIR / f"serve_killed{attempt}")
        argv = [sys.executable, "-m", "repro_torch.launch.serve", "--app",
                "trim-stream", "--graph", "RMAT", "--ticks", "8",
                "--update-batch", "256", "--checkpoint-dir", path,
                "--checkpoint-every", "2"]
        proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        try:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and proc.poll() is None:
                step = ckpt_lib.latest_step(path)
                if step is not None and step > 0:
                    break
                time.sleep(0.002)
            proc.kill()                          # SIGKILL: no cleanup
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
        step = ckpt_lib.latest_step(path)
        if step is not None and step < 8:
            killed = (path, step)
            break
        log(f"# phase 16 (b): attempt {attempt}: the process reached step "
            f"{step} before the kill; again")
    check(killed is not None, "(b) the CLI was never killed mid-feed")
    path, at = killed
    out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"(b) the restarted CLI failed: "
          f"{out.stderr[-2000:]}")
    check(f"resumed from {path} at tick {at}/8" in out.stdout,
          f"(b) the restart did not resume at tick {at}")
    ta, sa, ma = ckpt_lib.load_flat(whole)
    tb, sb, mb = ckpt_lib.load_flat(path)
    for key in ("status", "counters", "feed_alive"):
        check(np.array_equal(ta[key], tb[key]), f"(b) {key} differs")
    check(sa == sb == 8 and ma["feed"]["rng_state"] == mb["feed"]["rng_state"],
          "(b) the steps or the feed's RNG state differ")
    log(f"# phase 16 (b): {' '.join(argv[1:])}: SIGKILLed at its step-{at} "
        f"checkpoint, restarted: resumed at tick {at}, final checkpoint "
        f"(step 8) status, counters, feed_alive and rng_state equal the "
        f"uninterrupted in-process run's; "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{out.stdout.strip().splitlines()[-1]}")


# -- phase 17: wide-deep at its published width ----------------------------------

def recsys_batch(cfg, b: int, seed: int, dev):
    """``b`` requests on ``dev``: dense features, ids over each field's
    whole vocabulary (as ``RecsysStream`` draws them) and labels."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    host = {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            "sparse_ids": np.stack(
                [rng.integers(0, v, (b, cfg.ids_per_field))
                 for v in cfg.vocab_sizes], axis=1).astype(np.int32),
            "labels": rng.integers(0, 2, (b,)).astype(np.float32)}
    return {k: torch.as_tensor(v, device=dev) for k, v in host.items()}


def recsys_host_copy(model, batch):
    """The CPU path on the same weights: a CPU ``WideDeep`` holding the
    card model's dense parameters and, per field, the table rows
    ``batch`` touches (the only rows its forward reads), with the batch's
    ids remapped into them.  Returns (model, batch, per-field row ids)."""
    import dataclasses

    import torch

    from repro_torch.models.recsys import WideDeep
    ids = batch["sparse_ids"]
    rows, local = [], []
    for f in range(model.cfg.n_sparse):
        u, inv = torch.unique(ids[:, f], return_inverse=True)
        rows.append(u)
        local.append(inv)
    cfg = dataclasses.replace(model.cfg,
                              vocab_sizes=tuple(len(u) for u in rows))
    host = WideDeep(cfg, device="cpu", init=False)
    with torch.no_grad():
        for name, p in host.named_parameters():
            src = model.get_parameter(name)
            if name.startswith(("tables.", "wide_tables.")):
                src = src[rows[int(name.split(".t")[-1])]]
            p.copy_(src.cpu())
    hb = {k: v.cpu() for k, v in batch.items()}
    hb["sparse_ids"] = torch.stack(local, dim=1).cpu().to(torch.int32)
    return host, hb, rows


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.cpu() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def recsys_phase(dev):
    """Phase 17: wide-deep at its published config on the card: serving at
    the serve_p99 and serve_bulk batches, the forward and retrieval against
    the CPU path on the same weights, the train launcher at train_batch
    with its first step against the CPU, and one HybridAdamW step."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.launch import train as tcli
    from repro_torch.models.recsys import WideDeep, loss_grads
    from repro_torch.optim import AdamW, HybridAdamW

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    spec = configs.get("wide-deep")
    cfg, cells = spec.make_config(), spec.shapes

    def new_model():
        return WideDeep(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = new_model()
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    tbytes = sum(p.numel() * 4 for n, p in model.named_parameters()
                 if "tables" in n)
    log(f"# phase 17: wide-deep: {n_par:,} parameters (param_count() "
        f"{cfg.param_count():,}), tables {tbytes:,} bytes in float32, drawn "
        f"on the card in {(time.perf_counter() - t0) * 1e3:.0f} ms")

    # (a) serving at the serve_p99 and serve_bulk batches
    for cell in ("serve_p99", "serve_bulk"):
        b = cells[cell].meta["batch"]
        scores, stats = serve.serve_recsys(batch=b, model=model,
                                           return_stats=True)
        check(scores.shape == (b,) and np.isfinite(scores).all(),
              f"(a) {cell}: scores of shape {scores.shape}, or not finite")
        ms = float(np.median(stats["batch_ms"]))
        log(f"# phase 17 (a): {cell} batch {b}: {ms:.3f} ms a batch "
            f"(median of 10, synchronised; "
            f"{min(stats['batch_ms']):.3f}-{max(stats['batch_ms']):.3f}), "
            f"{b / ms * 1e3:,.0f} req/s")

    # (b) the card's forward against the CPU path on the same weights
    b = cells["serve_p99"].meta["batch"]
    batch = recsys_batch(cfg, b, 1, dev)
    host, hb, _ = recsys_host_copy(model, batch)
    with torch.no_grad():
        err = rel_err(model(batch), host(hb))
    check(err <= RECSYS_TOL["fwd"], f"(b) the forward at B={b} differs "
          f"from the CPU's by {err:.3g} of its largest logit")
    log(f"# phase 17 (b): forward at B={b} equals the CPU path's on the "
        f"same weights to {err:.3g} of its largest logit (tolerance "
        f"{RECSYS_TOL['fwd']})")

    # (c) retrieval against retrieval_cand's candidates
    n_cand = cells["retrieval_cand"].meta["n_candidates"]
    query = recsys_batch(cfg, 1, 2, dev)
    query["candidates"] = torch.randn(
        n_cand, cfg.retrieval_dim, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        vals, idx = model.retrieval_scores(query)
        ms = time_ms(lambda: model.retrieval_scores(query), reps=10)
        host, hq, _ = recsys_host_copy(model, query)
        hq["candidates"] = query["candidates"].cpu()
        hv, hi = host.retrieval_scores(hq)
    verr = rel_err(vals, hv)
    hv = hv.numpy()
    distinct = np.ones(100, bool)
    distinct[1:] &= np.diff(hv) != 0
    distinct[:-1] &= np.diff(hv) != 0
    check(verr <= RECSYS_TOL["fwd"] and np.array_equal(
        idx.cpu().numpy()[distinct], hi.numpy()[distinct]),
        f"(c) the top-100 differ from the CPU's ({verr:.3g})")
    log(f"# phase 17 (c): retrieval_scores against {n_cand:,} candidates: "
        f"{ms:.3f} ms (CUDA events); top-100 values equal the CPU's to "
        f"{verr:.3g}, indices equal at the {int(distinct.sum())} distinct "
        f"values")
    del model, host, query, batch
    torch.cuda.empty_cache()

    # (d) the train launcher at train_batch, as a user runs it
    made, trainer = [], tcli.Trainer

    class KeptTrainer(trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = io.StringIO()
    t0 = time.perf_counter()
    tcli.Trainer = KeptTrainer
    try:
        with contextlib.redirect_stdout(out):
            hist = tcli.main(["--arch", "wide-deep", "--steps",
                              str(RECSYS["steps"])])
    finally:
        tcli.Trainer = trainer
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    line = out.getvalue().strip().splitlines()[-1]
    check(line.startswith("[train] wide-deep: first loss ")
          and all(math.isfinite(h["loss"]) for h in hist),
          f"the train launcher printed {line!r}")
    times = made[0].monitor.times
    stream = made[0].stream
    del made
    torch.cuda.empty_cache()
    log(line)
    log(f"# phase 17 (d): python -m repro_torch.launch.train --arch "
        f"wide-deep --steps {RECSYS['steps']} (batch {stream.batch}): "
        f"{wall:.1f} s in all; step ms {[round(t * 1e3, 1) for t in times]}; "
        f"peak device memory {peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held "
        f"before)")

    # the launcher's first step against the CPU on the same weights
    model = new_model()
    params = model.params()
    full = {k: torch.as_tensor(v, device=dev)
            for k, v in stream.batch_at(0).items()}
    with torch.no_grad():
        first = model.loss(full).item()
    check(abs(first - hist[0]["loss"]) <= RECSYS_TOL["loss"] * abs(first),
          f"(d) the launcher's first loss {hist[0]['loss']} is not {first}")
    small = {k: v[:RECSYS["check_batch"]] for k, v in full.items()}
    del full
    loss = model.loss(small)
    grads = dict(zip(params, loss_grads(loss, params)))
    host, hb, rows = recsys_host_copy(model, small)
    hparams = host.params()
    hloss = host.loss(hb)
    hgrads = dict(zip(hparams, loss_grads(hloss, hparams)))
    lerr = abs(loss.item() - hloss.item()) / abs(hloss.item())
    gerr = 0.0
    for name, g in grads.items():
        if "tables" in name:
            g = g[rows[int(name.split("/t")[-1])]]
        gerr = max(gerr, rel_err(g, hgrads[name]))
    check(lerr <= RECSYS_TOL["loss"] and gerr <= RECSYS_TOL["grad"],
          f"(d) step 1 against the CPU: loss {lerr:.3g}, gradients {gerr:.3g}")
    again = torch.autograd.grad(model.loss(small),
                                [params[f"tables/t{f}"] for f in (0, 4, 12)])
    same = all(torch.equal(a, grads[f"tables/t{f}"])
               for a, f in zip(again, (0, 4, 12)))
    log(f"# phase 17 (d): the launcher's first loss equals a fresh model's "
        f"on batch 0 ({first:.6f}); on its first {RECSYS['check_batch']} "
        f"rows the card's loss equals the CPU path's to {lerr:.3g} "
        f"(tolerance {RECSYS_TOL['loss']}) and the MLP's and the touched "
        f"table rows' gradients to {gerr:.3g} of their largest entry "
        f"(tolerance {RECSYS_TOL['grad']}); F.embedding's backward rerun "
        f"on tables t0, t4, t12: {'the same bits' if same else 'OTHER BITS'}")
    del again, host, hparams, hgrads

    # (e) one HybridAdamW step at the published width
    full_state = AdamW(lr=1e-3).init(params)
    adamw_bytes = sum(t.numel() * t.element_size()
                      for t in full_state.mu + full_state.nu)
    del full_state
    torch.cuda.empty_cache()
    opt = HybridAdamW(adamw=AdamW(lr=1e-3))
    state = opt.init(params)
    hybrid_bytes = sum(t.numel() * t.element_size()
                       for t in state.mu + state.nu)
    want = {n: (p.detach() - opt.sgd_lr * grads[n])
            for n, p in params.items() if "tables" in n}
    grad_list = [grads[n] for n in params]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = opt.step(params, grad_list, state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(params[n].detach(), w) for n, w in want.items()),
          "(e) an SGD table is not p - sgd_lr * g bit for bit")
    check(int(state.count) == 1, "(e) the step count is not 1")
    dense_bytes = sum(p.numel() * 4 for n, p in params.items()
                      if "tables" not in n)
    log(f"# phase 17 (e): HybridAdamW: moments {hybrid_bytes:,} bytes (the "
        f"{dense_bytes:,} bytes of dense parameters twice, and a 0-d zero a "
        f"table) against AdamW's {adamw_bytes:,}; one step {step_ms:.1f} ms; "
        f"the {len(want)} SGD tables equal p - {opt.sgd_lr} g bit for bit")
    del model, params, grads, grad_list, want, state, small, loss
    torch.cuda.empty_cache()


# -- phase 7 (--profile): where the time goes ----------------------------------

# the port's kernels of the trimming path, whose device time each trim's
# profile also lists
TRIM_KERNELS = ("first_live_probe", "compact_lookback", "expand_lookback")


def profile_run(label, fn, sparse=None):
    """One call of ``fn`` under torch.profiler: wall time, device-busy
    time (CUDA kernel and copy time summed over the one stream), the idle
    share, the host syncs (counted by torch's sync debug mode on a
    separate call), and the device items that take the most time.  With
    ``sparse`` = (n, ecap): also the device time of the trimming kernels
    in the timed call, and of the ``index_add_`` calls that add a source
    of at most ecap into (n,) counters (AC-4's sparse decrement over the
    expanded buffer's real edges) in a third call, profiled with the
    operators' shapes (their recording costs host time, so the timed call
    goes without)."""
    import warnings

    import torch

    from repro_torch.analysis.capture import kernel_basename
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        note = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in device_events(prof):
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
    if sparse is not None:
        n, ecap = sparse
        ours = {}
        for name, (tot, cnt) in by_name.items():
            if kernel_basename(name) in TRIM_KERNELS:
                ours[kernel_basename(name)] = (tot, cnt)
        torch.cuda.synchronize()
        with profiled(record_shapes=True) as shaped:
            fn()
            torch.cuda.synchronize()
        adds = [e for e in shaped.events() if e.name == "aten::index_add_"
                and (e.input_shapes or [])[:1] == [[n]]
                and any(len(sh) == 1 and sh[0] <= ecap
                        for sh in e.input_shapes[2:3])]
        add_ms = sum(getattr(e, "device_time_total", None)
                     or e.cuda_time_total for e in adds) / 1e3
        top += (" | port kernels: " + "; ".join(
            f"{k} {tot:.4f}ms x{cnt}" for k, (tot, cnt) in ours.items())
            + f"; index_add_ of a source of at most {ecap} {add_ms:.4f}ms "
            f"x{len(adds)}")
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
    from repro_torch.core.common import frontier_plan
    from repro_torch.core.scc import scc_decompose

    for method, backend in (("ac3", "windowed"), ("ac3", "dense"),
                            ("ac4", "dense"), ("ac4*", "dense"),
                            ("ac6", "windowed"), ("ac6", "dense")):
        eng = plan(g, method=method, backend=backend, workers=16,
                   transpose=gt, device=dev)
        eng.run().materialize()
        profile_run(f"{method}/{backend}",
                    lambda: f"rounds={eng.run().materialize().rounds}",
                    sparse=(g.n, frontier_plan("auto", g.n, g.m).ecap))

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
    t_start = time.perf_counter()

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
    syncs13 = sync_budget_phase(dev, g, gt)
    log(f"# phase 13: done in {time.perf_counter() - t0:.1f} s")
    ops.reset_launches()
    obs_methods = reference_phase(dev)
    log(f"# phase 4: launches in phase 2 (BENCH_trim.json sizes): "
        f"{dict(ops.LAUNCHES)}")
    ops.reset_launches()
    trims = real_phase(dev, g, gt)
    trim_launches = dict(ops.LAUNCHES)
    log(f"# phase 4: launches in phase 3 (the real-size trimming path): "
        f"{trim_launches}")
    for name in TRIM_PATH:
        check(trim_launches[name] > 0,
              f"{name} was never launched on the trimming path")
    scc_peel_reference_phase(dev)
    ops.reset_launches()
    real6 = scc_peel_real_phase(dev, g, gt)
    scc_launches = dict(ops.LAUNCHES)
    log(f"# phase 6: launches in phase 6 (the real-size SCC / reach / peel "
        f"path): {scc_launches}")
    for name in SCC_PEEL_PATH:
        check(scc_launches[name] > 0,
              f"{name} was never launched on the SCC / reach / peel path")
    stream_reference_phase(dev)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ops.reset_launches()
    stream, feed, ticks, replay = stream_real_phase(dev, g)
    stream_launches = dict(ops.LAUNCHES)
    log(f"# phase 9: launches in phase 9 (the real-size stream path): "
        f"{stream_launches}")
    for name in STREAM_PATH:
        check(stream_launches[name] > 0,
              f"{name} was never launched on the stream path")
    t0 = time.perf_counter()
    obs_reference_phase(dev, obs_methods)
    ops.reset_launches()
    obs_real_phase(dev, g, gt, trims, real6, ticks)
    obs_launches = dict(ops.LAUNCHES)
    log(f"# phase 14: launches in (b)-(e) (instrumented real-size paths): "
        f"{obs_launches}; done in {time.perf_counter() - t0:.1f} s")
    for name in TRIM_PATH + SCC_PEEL_PATH + STREAM_PATH:
        check(obs_launches[name] > 0,
              f"{name} was never launched on an instrumented path")
    t0 = time.perf_counter()
    ops.reset_launches()
    fault_phase(dev, g, gt, trims, real6,
                dict(replay, feed=feed, engine=stream), syncs13)
    fault_launches = dict(ops.LAUNCHES)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"# phase 15: launches in (a)-(g): {fault_launches}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in TRIM_PATH + SCC_PEEL_PATH + STREAM_PATH + TRAIN_PATH:
        check(fault_launches[name] > 0,
              f"{name} was never launched on the faults' and checkpoints' "
              "paths")
    tick8 = replay["host"][STREAM_TICKS - 1]     # phase 16 (a) holds this
    del trims, real6, obs_methods, ticks, replay
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
    if not args.profile:                # phase 17 wants the card's memory
        del lm, profiled
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ops.reset_launches()
    server_real_phase(dev, tick8)
    server_launches = dict(ops.LAUNCHES)
    log(f"# phase 16: launches in (a) (the server at the real size): "
        f"{server_launches}")
    for name in SERVER_PATH:
        check(server_launches[name] > 0,
              f"{name} was never launched on the trim-stream server's path")
    server_kill_phase(dev)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"# phase 16: done in {time.perf_counter() - t0:.1f} s")
    del tick8
    t0 = time.perf_counter()
    ops.reset_launches()
    recsys_phase(dev)
    recsys_launches = dict(ops.LAUNCHES)
    check(not any(recsys_launches.values()),
          f"the recsys path launched a port kernel: {recsys_launches}")
    log(f"# phase 17: launches {recsys_launches} (the recsys path runs no "
        f"TPU kernel's port); done in {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_phase(dev, g, gt, stream, feed, lm, profiled)

    path_launches = {**{n: trim_launches for n in TRIM_PATH},
                     **{n: scc_launches for n in SCC_PEEL_PATH},
                     **{n: stream_launches for n in STREAM_PATH},
                     **{n: serve_launches for n in SERVE_PATH},
                     **{n: train_launches for n in TRAIN_PATH},
                     **{n: analysis_launches for n in ANALYSIS_OWN}}
    launches = {name: path_launches[name][name] for name in KERNELS}
    log(f"# total: {time.perf_counter() - t_start:.1f} s")
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
