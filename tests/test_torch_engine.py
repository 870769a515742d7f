"""The PyTorch port's trimming engine against the JAX reference, on the CPU.

Graphs come from both packages' generators with the same seeds (their edge
arrays are byte-identical, tested here), run through ``repro.core.plan``
and ``repro_torch.core.plan(..., device="cpu")``, and are compared as
numpy arrays.  Status masks, rounds, per-worker traversed edges and
max_frontier are integers, so they must agree bit for bit.  The reference
returns identical results on every backend and frontier (its own tests
hold it to that), so each port configuration is held against the
reference's dense-backend run of the same frontier; on two families the
reference's windowed backend also runs its Pallas kernels (interpret mode).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.graphs import generators as jgen
from repro_torch import core as tcore
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import ops

# the tensors here are tiny: intra-op threads only add overhead, and the
# suite runs several test files side by side
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = "cpu"
METHODS = ("ac3", "ac4", "ac4*", "ac6")
FAMILIES = ("ER", "BA", "RMAT", "chain", "layered", "sink_heavy")
# benchmarks/bench_trim.py JSON_SMOKE_SIZES
SMOKE_SIZES = {
    "ER": dict(n=2_000, m=2_400, seed=1),
    "BA": dict(n=2_000, deg=3, seed=1),
    "RMAT": dict(n_log2=10, m=1_280, seed=1, a=0.4, b=0.1, c=0.1),
    "chain": dict(n=500),
    "layered": dict(n=2_000, layers=21, deg=4, seed=1),
    "sink_heavy": dict(n=2_000, m=8_000, sink_frac=0.9, seed=1),
}
KERNEL_FAMILIES = ("RMAT", "sink_heavy")   # reference runs Pallas here


def _frontiers(method):
    return ("dense", "auto") if method == "ac3" else ("dense", "sparse",
                                                      "auto")


def _graphs(family, sizes=SMOKE_SIZES):
    jg = jgen.BENCHMARK_GRAPHS[family][0](**sizes[family])
    tg = tgen.BENCHMARK_GRAPHS[family][0](**sizes[family], device=CPU)
    return jg, tg


def _host(res):
    """(status, rounds, per_worker, max_frontier) of a materialized
    result of either package."""
    res = res.materialize()
    return (np.asarray(res.status).astype(np.int32), res.rounds,
            None if res.per_worker_edges is None
            else np.asarray(res.per_worker_edges).astype(np.int64),
            res.max_frontier)


def _assert_same(got, want, what):
    assert np.array_equal(got[0], want[0]), f"{what}: status"
    assert got[1] == want[1], f"{what}: rounds {got[1]} != {want[1]}"
    if want[2] is None:
        assert got[2] is None and got[3] is None, what
    else:
        assert np.array_equal(got[2], want[2]), f"{what}: per-worker edges"
        assert got[3] == want[3], f"{what}: max_frontier"


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_engine_matches_reference(family, method):
    """Every (backend, frontier) the reference allows, bit for bit."""
    jg, tg = _graphs(family)
    jgt, tgt = jg.transpose(), tg.transpose()
    for frontier in _frontiers(method):
        want = _host(jcore.plan(jg, method=method, workers=16, chunk=1,
                                transpose=jgt, frontier=frontier).run())
        for backend in ("dense", "windowed"):
            eng = tcore.plan(tg, method=method, backend=backend, workers=16,
                             chunk=1, transpose=tgt, frontier=frontier,
                             device=CPU)
            _assert_same(_host(eng.run()), want,
                         f"{family}/{method}/{backend}/{frontier}")
            assert eng.dispatches == 1 and eng.traces == 0


@pytest.mark.parametrize("family", KERNEL_FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_engine_matches_reference_pallas_path(family, method):
    """The reference's windowed backend with its Pallas kernels (interpret
    mode): first_live_scan for AC-3/AC-6, the compaction kernels in the
    sparse rounds of AC-4/AC-4*/AC-6."""
    jg, tg = _graphs(family)
    frontier = "auto" if method == "ac3" else "sparse"
    want = _host(jcore.plan(jg, method=method, backend="windowed",
                            workers=16, chunk=1, use_kernel=True,
                            frontier=frontier).run())
    got = _host(tcore.plan(tg, method=method, backend="windowed", workers=16,
                           chunk=1, frontier=frontier, device=CPU).run())
    _assert_same(got, want, f"{family}/{method}/pallas")


@pytest.mark.parametrize("method", METHODS)
def test_active_masks_and_batches(method):
    """Induced subgraphs match the reference; run_batch equals sequential
    run() calls, counters included, in one dispatch."""
    jg, tg = _graphs("sink_heavy")
    rng = np.random.default_rng(7)
    # a partial mask, the empty mask, the full mask
    masks = rng.random((3, jg.n)) < np.array([[0.3], [0.0], [1.0]])
    jeng = jcore.plan(jg, method=method, workers=16, chunk=1)
    teng = tcore.plan(tg, method=method, backend="windowed", workers=16,
                      chunk=1, device=CPU)
    seq = [_host(teng.run(active=mk)) for mk in masks]
    for mk, got in zip(masks, seq):
        _assert_same(got, _host(jeng.run(active=mk)), f"{method} masked")
    before = teng.dispatches
    batch = teng.run_batch(torch.as_tensor(masks))
    assert teng.dispatches == before + 1
    for got, want in zip(batch, seq):
        _assert_same(_host(got), want, f"{method} batch")
    status, pw, rounds, max_qp, stats = teng.run_batch_stacked(
        masks, counters=False)
    assert status.dtype == rounds.dtype == torch.int32
    assert pw is None and max_qp is None and stats is None
    assert np.array_equal(status.numpy(), np.stack([s[0] for s in seq]))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [0, 7])
def test_degenerate_graphs(method, n):
    """n = 0 and edgeless graphs take no dispatch and follow the
    reference's conventions (edgeless: rounds = 2)."""
    empty = np.zeros(0, np.int64)
    jg = jcore.CSRGraph.from_edges(n, empty, empty)
    tg = tcore.CSRGraph.from_edges(n, empty, empty, device=CPU)
    mask = np.arange(n) % 2 == 0
    for active in (None, mask):
        want = _host(jcore.plan(jg, method=method, workers=4).run(
            active=active))
        eng = tcore.plan(tg, method=method, workers=4, device=CPU)
        res = eng.run(active=active)
        assert res.status.dtype == torch.int32
        _assert_same(_host(res), want, f"degenerate n={n}")
        assert eng.dispatches == 0
    jb = jcore.plan(jg, method=method, workers=4).run_batch_stacked(
        np.stack([mask, ~mask]))
    tb = tcore.plan(tg, method=method, workers=4,
                    device=CPU).run_batch_stacked(np.stack([mask, ~mask]))
    for g, w in zip(tb[:4], jb[:4]):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("family", FAMILIES)
def test_generators_byte_identical(family, monkeypatch):
    """Same arguments -> byte-identical edge arrays (and CSR arrays)."""
    seen = {}

    def capture(tag, original):
        def from_edges(n, src, dst, *args, **kwargs):
            seen[tag] = (n, np.asarray(src), np.asarray(dst))
            return original(n, src, dst, *args, **kwargs)
        return staticmethod(from_edges)

    monkeypatch.setattr(jgen.CSRGraph, "from_edges",
                        capture("jax", jgen.CSRGraph.from_edges))
    monkeypatch.setattr(tgen.CSRGraph, "from_edges",
                        capture("torch", tgen.CSRGraph.from_edges))
    jg, tg = _graphs(family)
    (jn, js, jd), (tn, ts, td) = seen["jax"], seen["torch"]
    assert jn == tn
    for a, b in ((js, ts), (jd, td)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(jg.to_numpy(), tg.to_numpy()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tgen.BENCHMARK_GRAPHS.keys() == jgen.BENCHMARK_GRAPHS.keys()
    for name, (fn, kw) in tgen.BENCHMARK_GRAPHS.items():
        assert fn.__name__ == jgen.BENCHMARK_GRAPHS[name][0].__name__
        assert kw == jgen.BENCHMARK_GRAPHS[name][1]
    assert tgen.edge_dtype(10) == jgen.edge_dtype(10) == np.int32


def test_cycle_and_transpose_match_reference():
    jg, tg = jgen.cycle(257), tgen.cycle(257, device=CPU)
    for a, b in zip(jg.transpose().to_numpy(), tg.transpose().to_numpy()):
        assert np.array_equal(a, b)
    jg, tg = _graphs("ER")
    assert np.array_equal(np.asarray(jcore.graph.row_ids(jg.indptr, jg.m)),
                          tcore.graph.row_ids(tg.indptr, tg.m).numpy())
    assert np.array_equal(jcore.worker_of(1000, 16, 7),
                          tcore.worker_of(1000, 16, 7))


def test_from_numpy_round_trip():
    jg, _ = _graphs("layered")
    ip, ix = jg.to_numpy()
    tg = tcore.CSRGraph.from_numpy(ip, ix, device=CPU)
    assert tg.indptr.dtype == tg.indices.dtype == torch.int32
    assert (tg.n, tg.m) == (jg.n, jg.m)
    back = tg.to_numpy()
    assert np.array_equal(back[0], ip) and np.array_equal(back[1], ix)
    want = _host(jcore.plan(jg, method="ac6", workers=16).run())
    got = _host(tcore.plan(tg, method="ac6", workers=16, device=CPU).run())
    _assert_same(got, want, "from_numpy")


def test_oracles_and_shims_match_reference():
    for family in FAMILIES:
        jg, tg = _graphs(family)
        ip, ix = tg.to_numpy()
        want = jcore.trim_oracle(ip, ix)
        assert np.array_equal(tcore.trim_oracle(ip, ix), want)
        status = tcore.trim(tg, method="ac6", workers=16).status
        assert tcore.sound(ip, ix, status) and tcore.complete(ip, ix, status)
        assert tcore.peeling_alpha_oracle(ip, ix) == \
            jcore.peeling_alpha_oracle(ip, ix)
    jg, tg = _graphs("ER")
    assert tcore.peeling_alpha(tg) == jcore.peeling_alpha(jg)
    from repro.core import sequential as jseq
    from repro_torch.core import sequential as tseq
    ip, ix = tg.to_numpy()
    assert np.array_equal(tseq.seq_ac3(tseq.ExplicitAdapter(ip, ix))[0],
                          jseq.seq_ac3(jseq.ExplicitAdapter(ip, ix))[0])


def test_cpu_engine_launches_no_kernel():
    """On the CPU the dispatcher takes the plain path: no launch counts."""
    ops.reset_launches()
    _, tg = _graphs("RMAT")
    for method in METHODS:
        for backend in ("dense", "windowed"):
            frontier = "auto" if method == "ac3" else "sparse"
            tcore.plan(tg, method=method, backend=backend, frontier=frontier,
                       device=CPU).run()
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def test_plan_validation(monkeypatch):
    _, tg = _graphs("RMAT")
    with pytest.raises(NotImplementedError, match="A6"):
        tcore.plan(tg, backend="sharded", device=CPU)
    with pytest.raises(NotImplementedError, match="A7"):
        tcore.plan(tg, instrument=True, device=CPU)
    eng = tcore.plan(tg, device=CPU)
    with pytest.raises(NotImplementedError, match="A8"):
        eng.state_dict()
    with pytest.raises(NotImplementedError, match="A7"):
        eng.nbytes()
    with pytest.raises(ValueError, match="sparse-frontier"):
        tcore.plan(tg, method="ac3", frontier="sparse", device=CPU)
    with pytest.raises(ValueError, match="unknown method"):
        tcore.plan(tg, method="ac5", device=CPU)
    with pytest.raises(ValueError, match="unmasked"):
        tcore.plan(tg, unmasked=True, device=CPU).run(
            active=np.ones(tg.n, bool))
    with pytest.raises(ValueError, match="shape"):
        tcore.plan(tg, device=CPU).run(active=np.ones(3, bool))
    # the default device is the card; without one, entry points raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.plan(tg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.chain(10)


def test_port_imports_no_jax():
    """repro_torch and chip_smoke.py never import jax or the JAX package."""
    code = (
        "import pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
