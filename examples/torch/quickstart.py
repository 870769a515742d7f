"""Quickstart on the PyTorch port: trim one graph with all four
arc-consistency methods through the plan-once engine API (the twin of
``examples/quickstart.py``).

    python examples/torch/quickstart.py                 # on the card
    python examples/torch/quickstart.py --device cpu

All methods reach the same fixpoint, but AC-6 traverses a fraction of the
edges (the paper's Theorem 12: at most m), and every engine reuses one
transpose built once.  The port compiles nothing, so its engines report
0 traces where the reference reports one per (method, shape).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import complete, peeling_alpha, plan, sound
from repro_torch.graphs import sink_heavy

#: the graph: the reference's sizes
N, M, SINK_FRAC = 200_000, 800_000, 0.8
METHODS = ("ac3", "ac4", "ac4*", "ac6")
KEEPS = (0.9, 0.6, 0.3)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    device = ap.parse_args(argv).device

    g = sink_heavy(n=N, m=M, sink_frac=SINK_FRAC, seed=0, device=device)
    print(f"graph: n={g.n:,} m={g.m:,} α={peeling_alpha(g)}")

    # one engine per method; every engine shares the same prebuilt transpose
    gt = g.transpose()
    engines = {m: plan(g, method=m, workers=16, transpose=gt, device=device)
               for m in METHODS}

    results = {}
    ip, ix = g.to_numpy()
    for method, engine in engines.items():
        res = engine.run()      # device-resident; counters materialize lazily
        results[method] = res
        status = res.status.cpu().numpy()
        assert sound(ip, ix, status) and complete(ip, ix, status)
        print(f"{method:5s}: trimmed {res.n_trimmed:,} "
              f"({res.trimmed_fraction*100:.1f}%) | edges traversed "
              f"{res.edges_traversed:,} | rounds {res.rounds} | "
              f"max|Qp| {res.max_frontier}")

    want = results["ac6"].status.cpu()
    assert all(torch.equal(r.status.cpu(), want) for r in results.values()), \
        "all methods reach the same fixpoint"
    r = results
    print(f"\nAC-6 traverses "
          f"{r['ac3'].edges_traversed/r['ac6'].edges_traversed:.1f}x "
          f"fewer edges than AC-3 and "
          f"{r['ac4'].edges_traversed/r['ac6'].edges_traversed:.1f}x fewer "
          f"than AC-4 — the paper's §9.3 result.")

    # a steady-state run with the counters off, after one warm-up run
    eng = engines["ac6"]
    eng.run(counters=False).materialize()
    _sync(device)
    t0 = time.perf_counter()
    eng.run(counters=False).materialize()
    _sync(device)
    t1 = time.perf_counter()
    print(f"\nsteady-state ac6 run (counters off): "
          f"{(t1-t0)*1e3:.1f} ms | engine traces: {eng.traces}")

    # batched serving: trim several induced subgraphs in ONE dispatch;
    # report trims *within* each region (outside-mask vertices are DEAD by
    # definition, not trimming work)
    rng = np.random.default_rng(0)
    masks = np.stack([rng.random(g.n) < keep for keep in KEEPS])
    batch = eng.run_batch(masks)
    print("run_batch over 3 masks:",
          [f"{int(m.sum() - (b.status.cpu().numpy().astype(bool) & m).sum()):,}"
           f" of {int(m.sum()):,} trimmed"
           for m, b in zip(masks, batch)])
    return results


if __name__ == "__main__":
    main()
