"""The PyTorch port alone against the committed ``BENCH_trim.json``: its
five integer keys (rounds, edges_total, max_per_worker, trimmed, max_qp)
at the benchmark's own sizes, for 4 methods x {dense, windowed}, on the
CPU.  The counters are deterministic integers, so they must be equal."""
import json
import os

import pytest
import torch

from repro_torch.core import plan
from repro_torch.graphs import generators as G

# the tensors here are tiny: intra-op threads only add overhead, and the
# suite runs several test files side by side
torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_trim.json")
KEYS = ("rounds", "edges_total", "max_per_worker", "trimmed", "max_qp")
# benchmarks/bench_trim.py JSON_SIZES
JSON_SIZES = {
    "ER": dict(n=30_000, m=36_000, seed=1),
    "BA": dict(n=20_000, deg=3, seed=1),
    "RMAT": dict(n_log2=14, m=20_480, seed=1, a=0.4, b=0.1, c=0.1),
    "chain": dict(n=5_000),
    "layered": dict(n=30_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=30_000, m=120_000, sink_frac=0.9, seed=1),
}


@pytest.mark.parametrize("family", sorted(JSON_SIZES))
def test_bench_trim_json_keys(family):
    with open(BENCH) as f:
        bench = json.load(f)["families"][family]
    g = G.BENCHMARK_GRAPHS[family][0](**JSON_SIZES[family], device="cpu")
    assert (g.n, g.m) == (bench["n"], bench["m"])
    gt = g.transpose()
    for method in ("ac3", "ac4", "ac4*", "ac6"):
        want = {k: bench["methods"][method][k] for k in KEYS}
        for backend in ("dense", "windowed"):
            res = plan(g, method=method, backend=backend, workers=16,
                       chunk=1, transpose=gt, device="cpu").run()
            pw = res.per_worker_edges
            got = dict(rounds=res.rounds, edges_total=int(pw.sum()),
                       max_per_worker=int(pw.max()), trimmed=res.n_trimmed,
                       max_qp=res.max_frontier)
            assert got == want, (family, method, backend)
