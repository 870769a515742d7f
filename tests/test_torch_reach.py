"""The PyTorch port's reachability engine against the JAX reference, on
the CPU.

Graphs come from both packages' generators with the same seeds (their CSR
arrays are byte-identical); seeds and active masks are made once with
numpy.  Masks and rounds are bool and int, so they must agree bit for
bit.  The reference's batched sweep vmaps its rows (whole-row OR on
overflowing graphs, dense frontier); the port runs each row with the
single-run body, and the rows must still equal the reference's.
"""
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

CPU = "cpu"
# benchmarks/bench_scc.py SMOKE_SIZES
SMOKE_SIZES = {
    "ER": dict(n=2_000, m=16_000, seed=1),
    "BA": dict(n=2_000, deg=8, seed=1),
    "RMAT": dict(n_log2=10, m=8_192, seed=1),
    "chain": dict(n=500),
    "layered": dict(n=2_000, layers=21, deg=4, seed=1),
    "sink_heavy": dict(n=2_000, m=8_000, sink_frac=0.9, seed=1),
}
FRONTIERS = ("dense", "sparse", "auto")


def _graphs(family):
    jg = jgen.BENCHMARK_GRAPHS[family][0](**SMOKE_SIZES[family])
    tg = tgen.BENCHMARK_GRAPHS[family][0](**SMOKE_SIZES[family], device=CPU)
    return jg, tg


def _both(n, src, dst):
    return (jcore.CSRGraph.from_edges(n, np.asarray(src), np.asarray(dst)),
            tcore.CSRGraph.from_edges(n, np.asarray(src), np.asarray(dst),
                                      device=CPU))


def _queries(n, seed):
    """(seed, active) pairs: a single vertex over the whole graph, a
    vertex inside a random half, a seed mask inside a random 80%."""
    rng = np.random.default_rng(seed)
    half = rng.random(n) < 0.5
    wide = rng.random(n) < 0.8
    mask = rng.random(n) < 0.02
    v = int(np.flatnonzero(half)[0]) if half.any() else 0
    return [(0, None), (v, half), (mask, wide)]


def _same_result(got, want, what):
    got, want = got.materialize(), want.materialize()
    assert np.array_equal(np.asarray(got.mask), np.asarray(want.mask)), \
        f"{what}: mask"
    assert np.array_equal(np.asarray(got.rounds), np.asarray(want.rounds)), \
        f"{what}: rounds {got.rounds} != {want.rounds}"


@pytest.mark.parametrize("family", sorted(SMOKE_SIZES))
@pytest.mark.parametrize("backend", ("dense", "windowed"))
def test_reach_matches_reference(family, backend):
    """Every (window, frontier) on both backends, single queries and a
    batch, bit for bit."""
    jg, tg = _graphs(family)
    jgt, tgt = jg.transpose(), tg.transpose()
    queries = _queries(jg.n, len(family))
    seeds = np.zeros((4, jg.n), bool)
    seeds[[0, 1, 2, 3], [0, 5, jg.n // 2, jg.n - 1]] = True
    acts = np.random.default_rng(3).random((4, jg.n)) < \
        np.array([[1.0], [0.5], [0.9], [0.0]])
    for window in (2, 16):
        for frontier in FRONTIERS:
            jeng = jcore.plan_reach(jg, backend=backend, window=window,
                                    transpose=jgt, frontier=frontier)
            teng = tcore.plan_reach(tg, backend=backend, window=window,
                                    transpose=tgt, frontier=frontier,
                                    device=CPU)
            what = f"{family}/{backend}/W={window}/{frontier}"
            for s, a in queries:
                _same_result(teng.run(s, a), jeng.run(s, a), what)
            _same_result(teng.run_batch(seeds, acts),
                         jeng.run_batch(seeds, acts), what + "/batch")
            assert teng.dispatches == len(queries) + 1
            assert teng.traces == 0
            assert teng._has_overflow() == jeng._has_overflow()


def test_reach_reference_pallas_path():
    """The reference's windowed pull through its Pallas kernels
    (interpret mode) on a graph that overflows the window (RMAT) and one
    that does not (a ring): single runs and batches."""
    jr, tr = _graphs("RMAT")
    n = 17
    jring, tring = _both(n, np.arange(n), (np.arange(n) + 1) % n)
    for (jg, tg), overflow in (((jr, tr), True), ((jring, tring), False)):
        jeng = jcore.plan_reach(jg, backend="windowed", window=4,
                                use_kernel=True, frontier="sparse")
        teng = tcore.plan_reach(tg, backend="windowed", window=4,
                                frontier="sparse", device=CPU)
        assert teng._has_overflow() is overflow
        _same_result(teng.run(5), jeng.run(5), f"pallas overflow={overflow}")
        seeds = np.zeros((2, tg.n), bool)
        seeds[0, 5] = seeds[1, 11] = True
        _same_result(teng.run_batch(seeds), jeng.run_batch(seeds),
                     f"pallas batch overflow={overflow}")


def test_windowed_continuation_beyond_window():
    """A hub whose frontier in-neighbor sits past the window takes the
    whole-row continuation (the reference's tests/test_reach.py hub)."""
    n = 40
    src = list(range(1, 31)) + [31]
    dst = [0] * 30 + [30]
    jg, tg = _both(n, src, dst)
    for backend in ("dense", "windowed"):
        for frontier in FRONTIERS:
            jeng = jcore.plan_reach(jg, backend=backend, window=2,
                                    frontier=frontier)
            teng = tcore.plan_reach(tg, backend=backend, window=2,
                                    frontier=frontier, device=CPU)
            _same_result(teng.run(30), jeng.run(30), f"hub {backend}")
            assert bool(teng.run(30).mask[0])


def test_degenerate_and_validation(monkeypatch):
    """n = 0 / m = 0 give rounds 0 and no dispatch; bad seeds and masks
    raise as in the reference."""
    for n in (0, 6):
        jg, tg = _both(n, [], [])
        for backend in ("dense", "windowed"):
            teng = tcore.plan_reach(tg, backend=backend, device=CPU)
            jeng = jcore.plan_reach(jg, backend=backend)
            seeds = np.arange(n) % 2 == 0
            _same_result(teng.run(seeds), jeng.run(seeds), "degenerate")
            b = np.stack([seeds, ~seeds])
            _same_result(teng.run_batch(b), jeng.run_batch(b), "degenerate")
            assert teng.dispatches == 0
            assert teng.run(seeds).rounds == 0
    _, tg = _graphs("ER")
    eng = tcore.plan_reach(tg, device=CPU)
    with pytest.raises(ValueError, match="scalar bool"):
        eng.run(True)
    with pytest.raises(ValueError, match="out of range"):
        eng.run(tg.n)
    with pytest.raises(ValueError, match="shape"):
        eng.run(np.ones(3, bool))
    with pytest.raises(ValueError, match="shape"):
        eng.run(0, active=np.ones(3, bool))
    with pytest.raises(ValueError, match="seed_masks"):
        eng.run_batch(np.ones(tg.n, bool))
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.plan_reach(tg, backend="carrier-pigeon", device=CPU)
    assert tcore.plan_reach(tg, instrument=True,
                            device=CPU).run(0).round_stats is not None
    assert set(tcore.available_methods("reach")) == {"push", "pull"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.plan_reach(tg)


def test_transpose_cache_and_tile_built_once():
    _, tg = _graphs("RMAT")
    pull = tcore.plan_reach(tg, backend="windowed", device=CPU)
    pull.run(0)
    tile = pull._window_tile()
    pull.run_batch(np.eye(4, tg.n, dtype=bool))
    assert pull._window_tile() is tile
    assert pull.transpose_builds == 1 and pull.dispatches == 2
    seeded = tcore.plan_reach(tg, backend="windowed",
                              transpose=pull.transpose, device=CPU)
    seeded.run(0)
    assert seeded.transpose_builds == 0
    push = tcore.plan_reach(tg, backend="dense", device=CPU)
    push.run(0)
    assert push.transpose_builds == 0 and push._window_tile() is None


def test_cpu_reach_launches_no_kernel():
    ops.reset_launches()
    _, tg = _graphs("RMAT")
    for backend in ("dense", "windowed"):
        tcore.plan_reach(tg, backend=backend, frontier="auto",
                         device=CPU).run(0)
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
