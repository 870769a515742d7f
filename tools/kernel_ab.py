#!/usr/bin/env python3
"""Time the Hopper kernels of two checkouts of this repository on one card,
in turns: A, B, B, A, each in a process of its own.

    python3 tools/kernel_ab.py PATH_A PATH_B

Each process runs, from its own checkout, phase 1 of that checkout's
``chip_smoke.py`` (every kernel against its plain version at the main
paths' real shapes: ``kernel_phase``, ``flash_phase``, ``segment_phase``)
and prints the kernel table rows it returns; then it times the host side
of each wrapper, the microseconds one call takes to return (Python, the
ctypes call and the launch; the median of 5 runs of 2,000 calls) at a
small shape whose kernel takes a few microseconds, so the card never
holds the host back.  The last line is one JSON object: kernel -> the
kernel times (CUDA events over back-to-back calls, wrapper host time
included), the plain versions' and the host microseconds of the four
turns.  Two versions are compared only inside one such call, on one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

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

import time
from repro_torch.kernels import bucket_peel, counter_scatter, \
    first_live_scan, flash_attention, frontier_compact, frontier_expand, \
    segment_sum
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
print(json.dumps(rows))
"""


def turn(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"{root}: exit {out.returncode}\n{out.stderr}")
    print(out.stdout, flush=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    a, b = (Path(p).resolve() for p in sys.argv[1:3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = [turn(r) for r in (a, b, b, a)]
    table = {k: {key: [r[k][key] for r in runs]
                 for key in ("ms", "plain_ms", "host_us")}
             for k in runs[0]}
    print("kernel ms | host us a call, turns A B B A:")
    for k, v in table.items():
        print(f"  {k:18s} " + " ".join(f"{x:.4f}" for x in v["ms"])
              + " | " + " ".join(f"{x:.1f}" for x in v["host_us"]))
    print(json.dumps({"card": smi, "order": ["A", "B", "B", "A"],
                      "A": str(a), "B": str(b), "rows": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
