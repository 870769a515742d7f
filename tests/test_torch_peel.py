"""The PyTorch port's k-core peel engine against the JAX reference, on the
CPU.

``coreness``, ``peel_round`` and ``rounds`` are ints, so they must agree
bit for bit with the reference for full runs, bounded runs ``run(k=j)``,
batches and active masks, on every frontier.  The port's own oracles and
its ``k = 1`` equivalence with AC-4 are checked too.
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
# benchmarks/bench_peel.py SMOKE_SIZES
SMOKE_SIZES = {
    "ER": dict(n=1_500, m=12_000, seed=1),
    "BA": dict(n=1_500, deg=8, seed=1),
    "RMAT": dict(n_log2=10, m=8_192, seed=1),
    "chain": dict(n=400),
    "layered": dict(n=1_500, layers=21, deg=4, seed=1),
    "sink_heavy": dict(n=1_500, m=6_000, sink_frac=0.9, seed=1),
}


def _graphs(family):
    jg = jgen.BENCHMARK_GRAPHS[family][0](**SMOKE_SIZES[family])
    tg = tgen.BENCHMARK_GRAPHS[family][0](**SMOKE_SIZES[family], device=CPU)
    return jg, tg


def _both(n, src, dst):
    return (jcore.CSRGraph.from_edges(n, np.asarray(src), np.asarray(dst)),
            tcore.CSRGraph.from_edges(n, np.asarray(src), np.asarray(dst),
                                      device=CPU))


def _same(got, want, what):
    got, want = got.materialize(), want.materialize()
    for name in ("coreness", "peel_round"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.int32 and np.array_equal(g, w), \
            f"{what}: {name}"
    assert np.array_equal(np.asarray(got.rounds), np.asarray(want.rounds)), \
        f"{what}: rounds {got.rounds} != {want.rounds}"
    assert got.k_stop == want.k_stop


@pytest.mark.parametrize("family", sorted(SMOKE_SIZES))
def test_peel_matches_reference(family):
    """run() and run(k=j), j in {0, 1, 3}, on every frontier; an active
    mask; the numpy coreness oracle; k = 1 against the port's AC-4."""
    jg, tg = _graphs(family)
    jgt, tgt = jg.transpose(), tg.transpose()
    rng = np.random.default_rng(len(family))
    active = rng.random(tg.n) < 0.7
    for frontier in ("dense", "sparse", "auto"):
        jeng = jcore.plan_peel(jg, transpose=jgt, frontier=frontier)
        teng = tcore.plan_peel(tg, transpose=tgt, frontier=frontier,
                               device=CPU)
        for k in (None, 0, 1, 3):
            _same(teng.run(k=k), jeng.run(k=k), f"{family}/{frontier}/k={k}")
        _same(teng.run(active=active), jeng.run(active=active),
              f"{family}/{frontier}/active")
        assert teng.dispatches == 5 and teng.traces == 0
        assert teng.transpose_builds == 0
    res = teng.run()
    ip, ix = tg.to_numpy()
    assert np.array_equal(res.coreness.numpy(),
                          tcore.coreness_oracle(ip, ix))
    assert res.max_core == jeng.run().max_core
    ac4 = tcore.plan(tg, method="ac4", device=CPU).run()
    assert torch.equal(teng.run(k=1).status, ac4.status)
    assert torch.equal(res.status, ac4.status)


@pytest.mark.parametrize("k", [None, 0, 1, 3])
def test_run_batch_matches_reference(k):
    """Batched rows (the full mask, a partial one, the empty one) equal
    the reference's run_batch, in one counted dispatch."""
    jg, tg = _graphs("RMAT")
    masks = np.random.default_rng(2).random((3, tg.n)) < \
        np.array([[1.0], [0.6], [0.0]])
    jeng = jcore.plan_peel(jg)
    teng = tcore.plan_peel(tg, device=CPU)
    got = teng.run_batch(masks, k=k)
    _same(got, jeng.run_batch(masks, k=k), f"batch k={k}")
    assert teng.dispatches == 1
    assert np.array_equal(got.max_core, jeng.run_batch(masks, k=k).max_core)
    for i in range(3):
        single = teng.run(k=k, active=masks[i]).materialize()
        assert np.array_equal(got.coreness[i], single.coreness)
        assert got.rounds[i] == single.rounds
    with pytest.raises(ValueError, match="per-graph"):
        got.degeneracy_order()


@pytest.mark.parametrize("n", [0, 4])
def test_degenerate_graphs(n):
    """n = 0 and m = 0: no dispatch, the reference's conventions (k = 0
    gives peel_round -1 and rounds 0; otherwise rounds 1)."""
    jg, tg = _both(n, [], [])
    mask = np.arange(n) % 2 == 0
    for k in (None, 0, 2):
        jeng, teng = jcore.plan_peel(jg), tcore.plan_peel(tg, device=CPU)
        for active in (None, mask):
            _same(teng.run(k=k, active=active), jeng.run(k=k, active=active),
                  f"n={n} k={k}")
        b = np.stack([mask, ~mask])
        _same(teng.run_batch(b, k=k), jeng.run_batch(b, k=k), f"batch k={k}")
        assert teng.dispatches == 0
    res = tcore.plan_peel(tg, device=CPU).run()
    assert np.array_equal(res.coreness.numpy(),
                          tcore.coreness_oracle(*tg.to_numpy()))
    assert res.max_core == 0


def test_degeneracy_order_certificate():
    """Every vertex has at most coreness(v) out-neighbors peeled in its own
    round or later; the order equals the reference's."""
    rng = np.random.default_rng(5)
    for trial in range(6):
        n = int(rng.integers(2, 50))
        m = int(rng.integers(0, 5 * n))
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        jg, tg = _both(n, src, dst)
        res = tcore.plan_peel(tg, device=CPU).run().materialize()
        order = res.degeneracy_order()
        assert np.array_equal(order,
                              jcore.plan_peel(jg).run().degeneracy_order())
        assert sorted(order.tolist()) == list(range(n))
        indptr, indices = tg.to_numpy()
        for v in range(n):
            succs = indices[indptr[v]:indptr[v + 1]]
            later = (res.peel_round[succs] >= res.peel_round[v]).sum()
            assert later <= res.coreness[v], (trial, v)
        bounded = tcore.plan_peel(tg, device=CPU).run(k=1)
        assert set(bounded.degeneracy_order().tolist()) == \
            set(np.flatnonzero(bounded.peel_round.numpy() >= 0).tolist())


def test_bounded_run_clamps_and_refuses_higher_cores():
    jg, tg = _graphs("RMAT")
    eng = tcore.plan_peel(tg, device=CPU)
    full = eng.run()
    res = eng.run(k=2)
    assert int(res.coreness.max()) == 2
    assert torch.equal(res.k_core(2), full.k_core(2))
    assert torch.equal(res.k_core(1), full.k_core(1))
    with pytest.raises(ValueError, match="were not computed"):
        res.k_core(3)
    assert res.rounds <= full.rounds
    assert torch.equal(eng.run(k=0).status,
                       torch.ones(tg.n, dtype=torch.int32))


def test_validation(monkeypatch):
    _, tg = _graphs("RMAT")
    eng = tcore.plan_peel(tg, device=CPU)
    with pytest.raises(ValueError, match="k must be"):
        eng.run(k=-1)
    with pytest.raises(ValueError, match="k must be"):
        eng.run(k=True)
    with pytest.raises(ValueError, match="active mask"):
        eng.run(active=np.ones(3, bool))
    with pytest.raises(ValueError, match="active_masks"):
        eng.run_batch(np.ones(tg.n, bool))
    with pytest.raises(ValueError, match="unknown method"):
        tcore.plan_peel(tg, method="nope", device=CPU)
    assert tcore.plan_peel(tg, instrument=True,
                           device=CPU).run().round_stats is not None
    # checkpoints: tests/test_torch_fault.py holds them against the reference
    assert eng.state_meta()["family"] == "peel"
    assert {"graph_indptr", "graph_indices"} <= set(eng.state_dict())
    assert tcore.available_methods("peel") == ("bucket",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.plan_peel(tg)


def test_cpu_peel_launches_no_kernel():
    ops.reset_launches()
    _, tg = _graphs("RMAT")
    tcore.plan_peel(tg, frontier="auto", device=CPU).run()
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
