"""SCC decomposition with graph trimming on the PyTorch port (the twin of
``examples/scc_decomposition.py``, the paper's §1.1).

    python examples/torch/scc_decomposition.py                 # on the card
    python examples/torch/scc_decomposition.py --device cpu

The paper's Figure-1 scenario — two large SCCs joined by a chain of
trivial SCCs — then a random digraph, showing how much of the work
trimming removes before any FW-BW pivot search runs.  Per worklist
generation the driver issues one batched trim dispatch and two batched
reach dispatches over one shared transpose, and the labels reach the host
once.  ``stats`` reports the dispatch and transpose accounting
(``engine_traces`` is the port's 0: it compiles nothing).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.core import CSRGraph, plan, plan_reach
from repro_torch.core.scc import same_partition, scc_decompose, tarjan_oracle

#: SCC1 = {0,1,2}, SCC2 = {3,4,5}, trimmable chain 9->8->7->6->SCC2, and a
#: bridge between the big SCCs
FIGURE1 = [(0, 1), (1, 2), (2, 0),
           (3, 4), (4, 5), (5, 3),
           (6, 3), (7, 6), (8, 7), (9, 8),
           (2, 3)]
#: the random digraph: the reference's sizes
N, M = 20_000, 60_000
KEEPS = (0.8, 0.5, 0.2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    device = ap.parse_args(argv).device
    out = {}

    g = CSRGraph.from_edges(10, *map(np.array, zip(*FIGURE1)), device=device)
    labels, stats = scc_decompose(g, use_trim=True, trim_method="ac6",
                                  device=device)
    assert same_partition(labels, tarjan_oracle(*g.to_numpy()))
    print("figure-1 graph:", stats)
    out["figure1"] = stats

    rng = np.random.default_rng(0)
    g = CSRGraph.from_edges(N, rng.integers(0, N, M), rng.integers(0, N, M),
                            device=device)
    for use_trim in (True, False):
        labels, stats = scc_decompose(g, use_trim=use_trim,
                                      trim_method="ac6", counters=use_trim,
                                      device=device)
        out[use_trim] = (labels, stats)
        n_sccs = len(np.unique(labels))
        edges = stats["trim_edges_traversed"]
        print(f"use_trim={use_trim}: {n_sccs:,} SCCs, "
              f"generations={stats['generations']}, pivots={stats['pivots']}, "
              f"trimmed={stats['trimmed_total']:,}, "
              f"trim_edges={'off' if edges is None else f'{edges:,}'}, "
              f"dispatches={stats['trim_dispatches']}+"
              f"{stats['reach_dispatches']} (trim+reach), "
              f"traces={stats['engine_traces']}, "
              f"transpose_builds={stats['transpose_builds']}")

    assert same_partition(labels, tarjan_oracle(*g.to_numpy()))
    print("matches Tarjan oracle — trimming removed the trivial-SCC work "
          "before any reach pivot ran.")

    # the same engines serve ad-hoc queries (an interactive client
    # re-trimming subsets or asking reachability questions)
    engine = plan(g, method="ac6", device=device)
    reach = plan_reach(g, transpose=engine.transpose, device=device)
    out["regions"] = []
    for keep in KEEPS:
        mask = rng.random(N) < keep
        res = engine.run(active=mask)
        live = res.status.cpu().numpy().astype(bool)
        in_region = int(mask.sum() - (live & mask).sum())
        r = reach.run(seeds=int(np.argmax(mask)), active=mask)
        out["regions"].append((in_region, int(mask.sum()), r.n_reached))
        print(f"re-trim {keep:.0%} region: {in_region:,} of "
              f"{int(mask.sum()):,} trimmed; {r.n_reached:,} reachable from "
              f"its first vertex (traces so far: trim={engine.traces} "
              f"reach={reach.traces})")
    return out


if __name__ == "__main__":
    main()
