#!/usr/bin/env python3
"""Time the Hopper kernels of two checkouts of this repository on one card,
in turns, or sweep kernels' tuning constants in one checkout.

    python3 tools/kernel_ab.py PATH_A PATH_B
    python3 tools/kernel_ab.py --sweep [scan|segment|expand ...]

A B: turns A, B, B, A, each in a process of its own.  Each process runs,
from its own checkout, phase 1 of that checkout's ``chip_smoke.py`` (every
kernel against its plain version at the main paths' real shapes:
``kernel_phase``, ``flash_phase``, ``segment_phase``, and
``mutant_copy_phase`` of phase 13) and prints the kernel table rows it
returns; then the device time (the profiler's, ``chip_smoke.device_ms``)
of ``sparse_expand`` and of the engines' whole windowed probe
(``core.common.probe_first_live_windowed``) on the same inputs in every
checkout (Gᵀ of RMAT scale 22, the auto frontier's caps; W = 16, 25% of
the rows scanning, half the vertices live); then it times the host side
of each wrapper, the microseconds one call takes to return (Python, the
ctypes call and the launch; the median of 5 runs of 2,000 calls) at a
small shape whose kernel takes a few microseconds, so the card never
holds the host back (``segment_sum`` also with the caller's index, where
the checkout's wrapper takes one); then it trains each of the four GNNs
at its published config on the molecule cell through the launcher's
``build`` and the Trainer, 20 steps, and keeps the median wall time of
steps 3 to 20.  The last line is one JSON object: kernel -> the kernel
times (CUDA events over back-to-back calls, wrapper host time included),
the plain versions' and the host microseconds of the four turns, the
device times, and the GNNs' step times.  Two versions are compared only
inside one such call, on one card.

--sweep, from this checkout in one process, each variant held against
its plain version first and timed by device time
(``chip_smoke.device_ms``), the settings in order, then reversed:
``scan``, ``prefix_positions`` at n = 4,194,304, int32 and bool, built
with scan tiles of 4,096, 8,192 and 16,384 elements
(``_build.use_scan_tile``), with ``torch.cumsum`` in every turn;
``segment``, ``segment_sum``'s merge-path split
(``kernels/segment_sum.py`` ``MIN_ITEMS`` and ``SM_THREADS``) at the
shapes the four GNNs launch on the molecule cell, recorded from one
training step of each, each shape weighted by its launches a step;
``expand``, ``sparse_expand`` at the phase-1 shape (Gᵀ of RMAT scale 22,
cap 65,536, ecap 4,194,304) built with row tiles of 256 to 2,048 ids and
slot tiles of 512 to 4,096 (``_build.use_expand_tiles``), with 4 or 8
slot CTAs an SM (``frontier_compact.EXPAND_SLOT_CTAS_PER_SM``), then its
real slots alone (ecap = total), its zero padding alone (every id the
sentinel) and a memset of as many bytes. No name: all three.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = (4096, 8192, 16384)
#: (EXPAND_ROW_TILE, EXPAND_SLOT_TILE, EXPAND_SLOT_CTAS_PER_SM) settings
#: of sparse_expand
EXPAND_TILES = ((256, 1024, 4), (256, 1024, 8), (256, 2048, 4),
                (512, 1024, 4), (256, 512, 4), (2048, 4096, 4))

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
flash = cs.flash_phase(dev)    # one row in older checkouts
rows.update(flash if "flash_attention" in flash else
            {"flash_attention": flash})
rows["segment_sum"] = cs.segment_phase(dev)
rows["mutant_copy"] = cs.mutant_copy_phase(dev)

# device times on the same inputs in every checkout
import numpy as np
from repro_torch.core.common import probe_first_live_windowed
from repro_torch.kernels import frontier_compact as fcm
rng = np.random.default_rng(1)
nt = gt.n
members = torch.zeros(nt, dtype=torch.bool, device=dev)
members[torch.as_tensor(rng.choice(nt, fp.cap - 7, replace=False),
                        device=dev)] = True
cids, _ = fcm.frontier_compact(members, fp.cap)
pdeg = gt.indptr[1:] - gt.indptr[:-1]
pstatus = torch.as_tensor(rng.random(nt) < 0.5, device=dev)
pscan = torch.as_tensor(rng.random(nt) < 0.25, device=dev)
pstart = (torch.as_tensor(rng.random(nt), device=dev)
          * (pdeg + 1).float()).floor().to(torch.int32)
device = {
    "sparse_expand": cs.device_ms(
        lambda: fcm.sparse_expand(gt.indptr, gt.indices, cids, fp.ecap),
        reps=50),
    "windowed_probe": cs.device_ms(
        lambda: probe_first_live_windowed(pstatus, gt.indptr, gt.indices,
                                          pstart, pscan, 16), reps=50)}
print("# device_ms " + json.dumps(device), flush=True)

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
if hasattr(first_live_scan, "first_live_probe"):
    st = torch.randint(0, 3, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    calls["first_live_probe"] = lambda: first_live_scan.first_live_probe(
        mask, ip, ix, st, mask, 16)
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
    rows.setdefault(name, {})["host_us"] = sorted(runs)[2]
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
                                                     device=dev)[:5]
    tr = Trainer(step, params, opt_state, stream,
                 TrainerConfig(num_steps=20, log_every=20), put_batch=put)
    tr.run()
    torch.cuda.synchronize()
    train[arch] = statistics.median(list(tr.monitor.times)[2:]) * 1e3
    del step, params, opt_state, tr
    torch.cuda.empty_cache()
print(json.dumps({"rows": rows, "device_ms": device, "train_ms": train}))
"""


#: how a checkout's chip_smoke.py reports a profile that held no device
#: item at all ("... ran []" in older checkouts): the one failure a turn is
#: run again for
EMPTY_PROFILE = re.compile(r"the profiler reported no device item|ran \[\]$")


def turn(root: Path) -> dict:
    """One turn of ``root``'s checkout.  A process whose last error line
    is an empty profile is run again, twice at most; any other failure
    ends the comparison."""
    for attempt in range(3):
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                             capture_output=True, text=True)
        if out.returncode == 0:
            print(out.stdout, flush=True)
            return json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{root}: attempt {attempt + 1} exit {out.returncode}\n"
              f"{out.stderr[-2000:]}", flush=True)
        last = (out.stderr.strip().splitlines() or [""])[-1]
        if not EMPTY_PROFILE.search(last):
            raise SystemExit(f"{root}: the turn failed")
    raise SystemExit(f"{root}: three attempts found an empty profile")


def ab(a: Path, b: Path, smi: str) -> None:
    runs = [turn(r) for r in (a, b, b, a)]
    names = list(dict.fromkeys(k for r in runs for k in r["rows"]))
    table = {k: {key: [r["rows"].get(k, {}).get(key) for r in runs]
                 for key in ("ms", "plain_ms", "host_us")} for k in names}
    device = {k: [r["device_ms"][k] for r in runs]
              for k in runs[0]["device_ms"]}
    train = {k: [r["train_ms"][k] for r in runs] for k in runs[0]["train_ms"]}

    def cells(xs, fmt):
        return " ".join("-" if x is None else format(x, fmt) for x in xs)
    print("kernel ms | host us a call, turns A B B A:")
    for k, v in table.items():
        print(f"  {k:18s} {cells(v['ms'], '.4f')} | "
              f"{cells(v['host_us'], '.1f')}")
    print("device ms, turns A B B A:")
    for k, v in device.items():
        print(f"  {k:18s} {cells(v, '.4f')}")
    print("molecule step ms, turns A B B A:")
    for k, v in train.items():
        print(f"  {k:18s} " + " ".join(f"{x:.1f}" for x in v))
    print(json.dumps({"card": smi, "order": ["A", "B", "B", "A"],
                      "A": str(a), "B": str(b), "rows": table,
                      "device_ms": device, "train_ms": train}))


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
            step, params, opt_state, stream, put, _ = cli.build(
                arch, smoke=False, device=dev)
            step(params, opt_state, put(stream.batch_at(0)))
            torch.cuda.synchronize()
    finally:
        ss.segment_sum = real
    return seen


def sweep(smi: str, which) -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": smi}
    for name in which:
        out[name] = SWEEPS[name](cs, _build, dev, gen)
    print(json.dumps(out))


def sweep_scan(cs, _build, dev, gen) -> dict:
    import torch

    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import ref
    n = 4_194_304
    xs = {"int32": torch.randint(0, 64, (n,), generator=gen, device=dev,
                                 dtype=torch.int32),
          "bool": torch.rand((n,), generator=gen, device=dev) < 0.4}
    out = {}
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
            out.setdefault(f"{name} tile {tile}", []).append(ms)
            out.setdefault(f"{name} cumsum", []).append(lib)
            print(f"# scan {name} tile {tile}: device_ms={ms:.4f} "
                  f"(torch.cumsum {lib:.4f})", flush=True)
    _build.use_scan_tile(shipped)
    return out


def sweep_segment(cs, _build, dev, gen) -> dict:
    import torch

    from repro_torch.kernels import segment_sum as ss
    out = {"segment": {}, "shapes": {}}
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
    return out


def sweep_expand(cs, _build, dev, gen) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.common import frontier_plan
    from repro_torch.graphs import generators as G
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import ref
    g = G.rmat(**cs.REAL, device=dev)
    gt = g.transpose()
    del g
    fp = frontier_plan("auto", gt.n, gt.m)
    rng = np.random.default_rng(1)
    members = torch.zeros(gt.n, dtype=torch.bool, device=dev)
    members[torch.as_tensor(rng.choice(gt.n, fp.cap - 7, replace=False),
                            device=dev)] = True
    ids, _ = ref.frontier_compact_ref(members, fp.cap)
    want = ref.sparse_expand_ref(gt.indptr, gt.indices, ids, fp.ecap)
    out = {}
    shipped = (_build.EXPAND_ROW_TILE, _build.EXPAND_SLOT_TILE,
               fc.EXPAND_SLOT_CTAS_PER_SM)

    def kern():
        return fc.sparse_expand(gt.indptr, gt.indices, ids, fp.ecap)
    for row, slot, per_sm in EXPAND_TILES + EXPAND_TILES[::-1]:
        _build.use_expand_tiles(row, slot)
        fc.EXPAND_SLOT_CTAS_PER_SM = per_sm
        cs.check(cs.max_abs_err(kern(), want) == 0,
                 f"sparse_expand tiles {row}/{slot}/{per_sm}")
        ms = cs.device_ms(kern, reps=50)
        out.setdefault(f"row {row} slot {slot} ctas/SM {per_sm}",
                       []).append(ms)
        print(f"# sparse_expand row tile {row} slot tile {slot}, {per_sm} "
              f"slot CTAs an SM: device_ms={ms:.4f}", flush=True)
    _build.use_expand_tiles(*shipped[:2])
    fc.EXPAND_SLOT_CTAS_PER_SM = shipped[2]
    # its two halves apart: the real slots alone (ecap = total), the zero
    # padding alone (every id the sentinel), and a memset of as many bytes
    total = int(want[3].sum())
    sentinels = torch.full_like(ids, gt.n)
    parts = {"real slots only (ecap = total)": (ids, total),
             "padding only (all sentinels)": (sentinels, fp.ecap)}
    zeros = 13 * fp.ecap
    for _ in range(2):
        for label, (part_ids, ecap) in parts.items():
            cs.check(cs.max_abs_err(
                fc.sparse_expand(gt.indptr, gt.indices, part_ids, ecap),
                ref.sparse_expand_ref(gt.indptr, gt.indices, part_ids,
                                      ecap)) == 0, f"sparse_expand {label}")
            ms = cs.device_ms(lambda: fc.sparse_expand(
                gt.indptr, gt.indices, part_ids, ecap), reps=50)
            out.setdefault(label, []).append(ms)
            print(f"# sparse_expand {label}: device_ms={ms:.4f}", flush=True)
        ms = cs.device_ms(lambda: torch.zeros(zeros, dtype=torch.uint8,
                                              device=dev), reps=50)
        out.setdefault("torch.zeros of 13 bytes a slot", []).append(ms)
        print(f"# torch.zeros of 13 bytes a slot ({zeros} bytes): "
              f"device_ms={ms:.4f}", flush=True)
    return out


SWEEPS = {"scan": sweep_scan, "segment": sweep_segment,
          "expand": sweep_expand}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[1:2] == ["--sweep"]:
        sweep(smi, sys.argv[2:] or list(SWEEPS))
    else:
        ab(*(Path(p).resolve() for p in sys.argv[1:3]), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
