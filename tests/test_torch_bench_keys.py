"""The PyTorch port alone against the committed benchmark files, at each
benchmark's own sizes, on the CPU:

* ``BENCH_trim.json``: its five integer keys (rounds, edges_total,
  max_per_worker, trimmed, max_qp) for 4 methods x {dense, windowed};
* ``BENCH_scc.json``: ``sccs`` of ``scc_decompose`` with default
  arguments, the AC-6 trim ``rounds``, and ``frontier_path_taken`` from
  the instrumented AC-6 run's ``r_sparse`` total (``bench_scc.py``'s
  rule);
* ``BENCH_peel.json``: its eight integer keys (generations, pivots,
  trim-2 removals and SCCs, ``max_core``, ``one_core``) on the fringe
  graphs;
* ``BENCH_stream.json``: ``n``, ``m``, ``batch_edges``,
  ``median_incr_rounds`` and ``trimmed`` under ``bench_family``'s feed;
* ``BENCH_obs.json``: per family, the 4 methods' ``edges_total``,
  ``max_per_worker``, ``imbalance`` (3 places), ``rounds`` and
  ``trimmed`` from instrumented runs at 16 workers, chunk 1, the eight
  ``scc`` keys (span counts included) and ``ordering_ok``.

The counters are deterministic integers, so they must be equal."""
import json
import os

import pytest
import torch

import numpy as np

from repro_torch import obs
from repro_torch.core import plan, plan_peel, plan_stream
from repro_torch.core.scc import scc_decompose
from repro_torch.graphs import generators as G

# the tensors here are tiny: intra-op threads only add overhead, and the
# suite runs several test files side by side
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
BENCH = os.path.join(ROOT, "BENCH_trim.json")
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


# benchmarks/bench_scc.py SIZES
SCC_SIZES = {
    "ER": dict(n=50_000, m=400_000, seed=1),
    "BA": dict(n=20_000, deg=8, seed=1),
    "RMAT": dict(n_log2=14, m=131_072, seed=1),
    "chain": dict(n=5_000),
    "layered": dict(n=50_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=50_000, m=200_000, sink_frac=0.9, seed=1),
}
# benchmarks/bench_peel.py SIZES and FRINGE
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


def _bench(name, family):
    with open(os.path.join(ROOT, f"BENCH_{name}.json")) as f:
        return json.load(f)["families"][family]


@pytest.mark.parametrize("family", sorted(SCC_SIZES))
def test_bench_scc_json_keys(family):
    bench = _bench("scc", family)
    g = G.BENCHMARK_GRAPHS[family][0](**SCC_SIZES[family], device="cpu")
    assert (g.n, g.m) == (bench["n"], bench["m"])
    labels, _ = scc_decompose(g, device="cpu")
    rs = plan(g, method="ac6", instrument=True,
              device="cpu").run(counters=False).round_stats
    rounds = int(rs.rounds)
    # bench_scc.py's rule: the r_sparse total decides the path
    sparse = int(rs.total("r_sparse")) if "r_sparse" in rs.names else 0
    path = ("dense" if sparse == 0 else "sparse" if sparse >= rounds
            else "mixed")
    assert (len(np.unique(labels)), rounds, path) == (
        bench["sccs"], bench["rounds"], bench["frontier_path_taken"])


@pytest.mark.parametrize("family", sorted(PEEL_SIZES))
def test_bench_peel_json_keys(family):
    bench = _bench("peel", family)
    g = G.with_tiny_scc_fringe(
        G.BENCHMARK_GRAPHS[family][0](**PEEL_SIZES[family], device="cpu"),
        **FRINGE)
    assert (g.n, g.m) == (bench["n"], bench["m"])
    _, base = scc_decompose(g, trim2=False, device="cpu")
    _, t2 = scc_decompose(g, trim2=True, device="cpu")
    res = plan_peel(g, device="cpu").run()
    got = dict(generations_base=base["generations"],
               generations_trim2=t2["generations"],
               pivots_base=base["pivots"], pivots_trim2=t2["pivots"],
               trim2_removed=t2["trim2_removed"],
               trim2_sccs=t2["trim2_sccs"], max_core=res.max_core,
               one_core=int((res.coreness >= 1).sum()))
    assert got == {k: bench[k] for k in PEEL_KEYS}
    assert (bench["fringe_pairs"], bench["fringe_loops"]) == (
        FRINGE["pairs"], FRINGE["loops"])


# benchmarks/bench_stream.py SIZES
STREAM_SIZES = {
    "ER": dict(n=50_000, m=400_000, seed=1, simple=True),
    "BA": dict(n=20_000, deg=8, seed=1),
    "RMAT": dict(n_log2=14, m=131_072, seed=1),
    "chain": dict(n=5_000),
    "layered": dict(n=50_000, layers=37, deg=4, seed=1),
    "sink_heavy": dict(n=50_000, m=200_000, sink_frac=0.9, seed=1),
}
STREAM_KEYS = ("n", "m", "batch_edges", "median_incr_rounds", "trimmed")


@pytest.mark.parametrize("family", sorted(STREAM_SIZES))
def test_bench_stream_json_keys(family):
    """``benchmarks/bench_stream.py`` ``bench_family``'s feed, timing left
    out: seed 0, batches of m // 100 random live edges; a check batch
    (``retrim()`` equals a fresh AC-4 run on the snapshot), a settle
    batch, then 5 measured batches, with ``retrim(full=True)`` where the
    benchmark calls it."""
    bench = _bench("stream", family)
    g = G.BENCHMARK_GRAPHS[family][0](**STREAM_SIZES[family], device="cpu")
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
    want = plan(engine.snapshot(), method="ac4", device="cpu").run().status
    assert torch.equal(engine.retrim().status, want)
    engine.retrim(full=True)
    engine.apply(deletions=next_batch())
    engine.retrim(full=True)
    rounds = []
    for _ in range(bench["batches"]):
        rounds.append(engine.apply(deletions=next_batch()).rounds)
        engine.retrim(full=True)
    got = dict(n=g.n, m=g.m, batch_edges=k,
               median_incr_rounds=int(np.median(rounds)),
               trimmed=engine.retrim().n_trimmed)
    assert got == {key: bench[key] for key in STREAM_KEYS}


# benchmarks/bench_obs.py SIZES, WORKERS and CHUNK
OBS_SIZES = JSON_SIZES
OBS_WORKERS, OBS_CHUNK = 16, 1


@pytest.mark.parametrize("family", sorted(OBS_SIZES))
def test_bench_obs_json_keys(family):
    """``benchmarks/bench_obs.py`` ``bench_family``: the paper's per-worker
    traversed edges (Table 7 / Fig. 4) from the instrumented engines, the
    round totals held against the per-worker counters on every run, and
    one instrumented ``scc_decompose`` under a recorder.  Every family
    runs here (chain, the slowest, in ~7 s: its 5,001 host-driven AC-3
    rounds)."""
    bench = _bench("obs", family)
    g = G.BENCHMARK_GRAPHS[family][0](**OBS_SIZES[family], device="cpu")
    assert (g.n, g.m) == (bench["n"], bench["m"])
    methods = {}
    for method in ("ac3", "ac4", "ac4*", "ac6"):
        res = plan(g, method=method, workers=OBS_WORKERS, chunk=OBS_CHUNK,
                   instrument=True, device="cpu").run(counters=True)
        pw = np.asarray(res.per_worker_edges).astype(np.int64)
        assert int(res.round_stats.total("r_edges")) == int(pw.sum())
        methods[method] = {
            "edges_total": int(pw.sum()), "max_per_worker": int(pw.max()),
            "imbalance": round(float(pw.max() / max(pw.mean(), 1e-9)), 3),
            "rounds": int(res.rounds), "trimmed": int(res.n_trimmed)}
    with obs.recording() as rec:
        _, stats = scc_decompose(g, counters=True, workers=OBS_WORKERS,
                                 chunk=OBS_CHUNK, instrument=True,
                                 device="cpu")
    pw = stats["per_worker_edges"]
    scc = {"generations": stats["generations"],
           "trim_rounds": stats["trim_rounds"],
           "reach_rounds": stats["reach_rounds"],
           "trim_edges_total": int(pw.sum()),
           "trim_max_per_worker": int(pw.max()),
           "trim_imbalance": round(float(pw.max() / max(pw.mean(), 1e-9)),
                                   3),
           "dispatch_spans": len(rec.select("dispatch", cat="engine")),
           "generation_spans": len(rec.select("generation", cat="scc"))}
    mx = {m: methods[m]["max_per_worker"] for m in methods}
    ordering = bool(mx["ac3"] > mx["ac4"] >= mx["ac6"])
    assert (methods, scc, ordering) == (bench["methods"], bench["scc"],
                                        bench["ordering_ok"])
