#!/usr/bin/env python3
"""Time the Hopper kernels of two checkouts of this repository on one card,
in turns, or sweep two kernels' tuning constants in one checkout.

    python3 tools/kernel_ab.py PATH_A PATH_B
    python3 tools/kernel_ab.py --sweep

A B: turns A, B, B, A, each in a process of its own.  Each process runs,
from its own checkout, phase 1 of that checkout's ``chip_smoke.py`` (every
kernel against its plain version at the main paths' real shapes:
``kernel_phase``, ``flash_phase``, ``segment_phase``, and
``mutant_copy_phase`` of phase 13) and prints the kernel table rows it
returns; then it times the host side of each wrapper, the microseconds
one call takes to return (Python, the ctypes call and the launch; the
median of 5 runs of 2,000 calls) at a small shape whose kernel takes a
few microseconds, so the card never holds the host back (``segment_sum``
also with the caller's index, where the checkout's wrapper takes one);
then it trains each of the four GNNs at its published config on the
molecule cell through the launcher's ``build`` and the Trainer, 20 steps,
and keeps the median wall time of steps 3 to 20.  The last line is one
JSON object: kernel -> the kernel times (CUDA events over back-to-back
calls, wrapper host time included), the plain versions' and the host
microseconds of the four turns, and the GNNs' step times.  Two versions
are compared only inside one such call, on one card.

--sweep, from this checkout in one process: ``prefix_positions`` at n =
4,194,304, int32 and bool, built with scan tiles of 4,096, 8,192 and
16,384 elements (``_build.use_scan_tile``), small to large and back, with
``torch.cumsum`` in every turn; then ``segment_sum``'s merge-path split
(``kernels/segment_sum.py`` ``MIN_ITEMS`` and ``SM_THREADS``) at the
shapes the four GNNs launch on the molecule cell, recorded from one
training step of each, each shape weighted by its launches a step; the
settings in order, then reversed.  Each variant is held against its plain
version first; times are device times from the profiler
(``chip_smoke.device_ms``).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = (4096, 8192, 16384)
#: (MIN_ITEMS, SM_THREADS) settings of segment_sum's split
SPLITS = ((1, 2048), (2, 2048), (4, 2048), (8, 2048), (16, 2048),
          (32, 2048), (4, 1024), (8, 1024), (4, 4096), (8, 4096))

CHILD = r"""
import json, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.core.common import frontier_plan
from repro_torch.graphs import generators as G
from repro_torch.kernels import _build
_build.build_all()
dev = torch.device("cuda")
g = G.rmat(**cs.REAL, device=dev)
gt = g.transpose()
fp = frontier_plan("auto", g.n, g.m)
rows = cs.kernel_phase(dev, gt, fp.cap, fp.ecap)
rows["flash_attention"] = cs.flash_phase(dev)
rows["segment_sum"] = cs.segment_phase(dev)
rows["mutant_copy"] = cs.mutant_copy_phase(dev)

import time
from repro_torch.kernels import bucket_peel, counter_scatter, \
    first_live_scan, flash_attention, frontier_compact, frontier_expand, \
    mutant_copy, segment_sum
gen = torch.Generator(device=dev).manual_seed(0)
n = 4096
b16 = torch.rand((n, 16), generator=gen, device=dev) < 0.5
mask = torch.rand((n,), generator=gen, device=dev) < 0.2
i32 = torch.randint(0, 8, (n,), generator=gen, device=dev,
                    dtype=torch.int32)
ip = torch.arange(n + 1, device=dev, dtype=torch.int32) * 4
ix = torch.randint(0, n, (4 * n,), generator=gen, device=dev,
                   dtype=torch.int32)
ids, _ = frontier_compact.frontier_compact(mask, 1024)
q = torch.randn((1, 2, 128, 64), generator=gen, device=dev).bfloat16()
kv = torch.randn((1, 1, 128, 64), generator=gen, device=dev).bfloat16()
vals = torch.randn((n, 16), generator=gen, device=dev)
calls = {
    "first_live_scan": lambda: first_live_scan.first_live_scan(b16, b16,
                                                               mask),
    "prefix_positions": lambda: frontier_compact.prefix_positions(i32),
    "frontier_compact": lambda: frontier_compact.frontier_compact(mask,
                                                                  1024),
    "sparse_expand": lambda: frontier_compact.sparse_expand(ip, ix, ids,
                                                            4096),
    "frontier_expand": lambda: frontier_expand.frontier_expand(b16, b16,
                                                               mask),
    "bucket_peel": lambda: bucket_peel.bucket_peel(i32, mask, i32[:1]),
    "counter_scatter": lambda: counter_scatter.counter_scatter(
        i32, mask, i32[:512], i32[:512]),
    "flash_attention": lambda: flash_attention.flash_attention(q, kv, kv),
    "segment_sum": lambda: segment_sum.segment_sum(vals, i32, 8),
    "mutant_copy": lambda: mutant_copy.mutant_copy(i32),
}
for name, fn in calls.items():
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        runs.append((time.perf_counter() - t0) / 2000 * 1e6)
        torch.cuda.synchronize()
    rows[name]["host_us"] = sorted(runs)[2]
# a checkout whose segment_sum takes the caller's index: its host time
# with one (a forward builds it once for all its aggregations)
import inspect
if "index" in inspect.signature(segment_sum.segment_sum).parameters:
    index = segment_sum.segment_index(i32, 8)
    fn = lambda: segment_sum.segment_sum(vals, i32, 8, index)
    fn()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        runs.append((time.perf_counter() - t0) / 2000 * 1e6)
        torch.cuda.synchronize()
    rows["segment_sum"]["host_us_index"] = sorted(runs)[2]

# the molecule cell's training steps, as the launcher builds them
import statistics
from repro_torch.launch import train as cli
from repro_torch.train import Trainer, TrainerConfig
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
train = {}
for arch in ("meshgraphnet", "schnet", "mace", "equiformer-v2"):
    step, params, opt_state, stream, put = cli.build(arch, smoke=False,
                                                     device=dev)
    tr = Trainer(step, params, opt_state, stream,
                 TrainerConfig(num_steps=20, log_every=20), put_batch=put)
    tr.run()
    torch.cuda.synchronize()
    train[arch] = statistics.median(list(tr.monitor.times)[2:]) * 1e3
    del step, params, opt_state, tr
    torch.cuda.empty_cache()
print(json.dumps({"rows": rows, "train_ms": train}))
"""


def turn(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"{root}: exit {out.returncode}\n{out.stderr}")
    print(out.stdout, flush=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def ab(a: Path, b: Path, smi: str) -> None:
    runs = [turn(r) for r in (a, b, b, a)]
    table = {k: {key: [r["rows"][k][key] for r in runs]
                 for key in ("ms", "plain_ms", "host_us")}
             for k in runs[0]["rows"]}
    train = {k: [r["train_ms"][k] for r in runs] for k in runs[0]["train_ms"]}
    print("kernel ms | host us a call, turns A B B A:")
    for k, v in table.items():
        print(f"  {k:18s} " + " ".join(f"{x:.4f}" for x in v["ms"])
              + " | " + " ".join(f"{x:.1f}" for x in v["host_us"]))
    print("molecule step ms, turns A B B A:")
    for k, v in train.items():
        print(f"  {k:18s} " + " ".join(f"{x:.1f}" for x in v))
    print(json.dumps({"card": smi, "order": ["A", "B", "B", "A"],
                      "A": str(a), "B": str(b), "rows": table,
                      "train_ms": train}))


def gnn_segment_shapes(dev) -> dict:
    """(m, d, n, dtype) -> [launches, the ids of the first] of segment_sum
    in one molecule training step of each GNN at its published config."""
    import torch

    from repro_torch.kernels import segment_sum as ss
    from repro_torch.launch import train as cli
    seen, real = {}, ss.segment_sum

    def record(values, seg_ids, num_segments, index=None):
        key = (*values.shape, num_segments, values.dtype)
        seen.setdefault(key, [0, seg_ids.clone()])[0] += 1
        return real(values, seg_ids, num_segments, index)
    ss.segment_sum = record
    try:
        for arch in ("meshgraphnet", "schnet", "mace", "equiformer-v2"):
            step, params, opt_state, stream, put = cli.build(
                arch, smoke=False, device=dev)
            step(params, opt_state, put(stream.batch_at(0)))
            torch.cuda.synchronize()
    finally:
        ss.segment_sum = real
    return seen


def sweep(smi: str) -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import segment_sum as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 4_194_304
    xs = {"int32": torch.randint(0, 64, (n,), generator=gen, device=dev,
                                 dtype=torch.int32),
          "bool": torch.rand((n,), generator=gen, device=dev) < 0.4}
    out = {"card": smi, "scan": {}, "segment": {}, "shapes": {}}
    shipped = _build.SCAN_TILE
    for tile in TILES + TILES[::-1]:
        _build.use_scan_tile(tile)
        for name, x in xs.items():
            cs.check(cs.max_abs_err(fc.prefix_positions(x),
                                    ref.prefix_positions_ref(x)) == 0,
                     f"scan tile {tile} {name}")
            ms = cs.device_ms(lambda: fc.prefix_positions(x), reps=50)
            lib = cs.device_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32),
                               reps=50)
            out["scan"].setdefault(f"{name} tile {tile}", []).append(ms)
            out["scan"].setdefault(f"{name} cumsum", []).append(lib)
            print(f"# scan {name} tile {tile}: device_ms={ms:.4f} "
                  f"(torch.cumsum {lib:.4f})", flush=True)
    _build.use_scan_tile(shipped)

    cases = {}
    for (m, d, segs, dtype), (count, ids) in gnn_segment_shapes(dev).items():
        label = f"({m}, {d}) -> {segs} {dtype}"
        out["shapes"][label] = count
        v = torch.randn((m, d), generator=gen, device=dev).to(dtype)
        cases[label] = (v, ids, segs, ss.segment_index(ids, segs), count)
    print(f"# segment_sum shapes of one molecule step of the four GNNs, "
          f"with their launches: {out['shapes']}", flush=True)
    # MeshGraphNet's minibatch_lg shape, timed beside them (weight 0)
    ids = torch.randint(0, cs.LG["n"], (cs.LG["m"],), generator=gen,
                        device=dev)
    cases["minibatch_lg (168960, 128) -> 169984"] = (
        torch.randn((cs.LG["m"], 128), generator=gen, device=dev), ids,
        cs.LG["n"], ss.segment_index(ids, cs.LG["n"]), 0)
    default = (ss.MIN_ITEMS, ss.SM_THREADS)
    for min_items, sm_threads in SPLITS + SPLITS[::-1]:
        ss.MIN_ITEMS, ss.SM_THREADS = min_items, sm_threads
        total = 0.0
        for key, (v, ids, segs, index, count) in cases.items():
            cs.segment_check(ss.segment_sum(v, ids, segs, index), v, ids,
                             segs, f"{key} split {min_items}/{sm_threads}")
            ms = cs.device_ms(lambda: ss.segment_sum(v, ids, segs, index),
                              reps=50)
            out["segment"].setdefault(f"{key} {min_items}/{sm_threads}",
                                      []).append(ms)
            total += count * ms
        label = f"min_items={min_items} sm_threads={sm_threads}"
        out["segment"].setdefault(label, []).append(total)
        print(f"# segment_sum {label}: device ms a molecule step of the "
              f"four GNNs {total:.4f}", flush=True)
    ss.MIN_ITEMS, ss.SM_THREADS = default
    print(json.dumps(out))


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[1:] == ["--sweep"]:
        sweep(smi)
    else:
        ab(*(Path(p).resolve() for p in sys.argv[1:3]), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
