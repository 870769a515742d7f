"""The PyTorch port's FW-BW SCC driver against the JAX reference, on the
CPU.

Labels must be bit-identical to the reference's (the same int64 array,
not only the same partition), and the stats equal on every key but
``engine_traces`` (the port traces nothing).  Graphs come from both
packages' generators with the same seeds, plus the peel benchmark's
size-≤2 SCC fringe.  The driver's dispatch contract (one trim, one trim-2
and two reach dispatches per generation) is ported from
``tests/test_scc.py``.
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import scc as jscc
from repro.graphs import generators as jgen
from repro_torch import core as tcore
from repro_torch.core import scc as tscc
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import ops

# the tensors here are tiny: intra-op threads only add overhead, and the
# suite runs several test files side by side
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
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
# benchmarks/bench_peel.py SMOKE_SIZES and SMOKE_FRINGE
PEEL_SMOKE_SIZES = {
    "ER": dict(n=1_500, m=12_000, seed=1),
    "BA": dict(n=1_500, deg=8, seed=1),
    "RMAT": dict(n_log2=10, m=8_192, seed=1),
    "chain": dict(n=400),
    "layered": dict(n=1_500, layers=21, deg=4, seed=1),
    "sink_heavy": dict(n=1_500, m=6_000, sink_frac=0.9, seed=1),
}
SMOKE_FRINGE = dict(pairs=8, loops=4)


def _graphs(family, sizes=SMOKE_SIZES):
    jg = jgen.BENCHMARK_GRAPHS[family][0](**sizes[family])
    tg = tgen.BENCHMARK_GRAPHS[family][0](**sizes[family], device=CPU)
    return jg, tg


def _fringe(family):
    """The same fringe graph in both packages (byte-identical CSR; the
    port's generator equals the benchmark's, see below)."""
    _, tg = _graphs(family, PEEL_SMOKE_SIZES)
    tg = tgen.with_tiny_scc_fringe(tg, **SMOKE_FRINGE)
    return jcore.CSRGraph(*map(jnp.asarray, tg.to_numpy())), tg


def test_fringe_generator_matches_benchmark(monkeypatch):
    """``with_tiny_scc_fringe`` is a copy of the peel benchmark's."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "benchmarks"))
    bench_peel = importlib.import_module("bench_peel")
    for family in ("RMAT", "chain"):
        jg, tg = _graphs(family, PEEL_SMOKE_SIZES)
        want = bench_peel.with_tiny_scc_fringe(jg, **bench_peel.FRINGE)
        got = tgen.with_tiny_scc_fringe(tg, **bench_peel.FRINGE)
        for a, b in zip(got.to_numpy(), want.to_numpy()):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert SMOKE_FRINGE == bench_peel.SMOKE_FRINGE


def _both(n, src, dst):
    return (jcore.CSRGraph.from_edges(n, np.asarray(src), np.asarray(dst)),
            tcore.CSRGraph.from_edges(n, np.asarray(src), np.asarray(dst),
                                      device=CPU))


def _assert_same(jg, tg, what, **kw):
    want_l, want_s = jscc.scc_decompose(jg, **kw)
    got_l, got_s = tscc.scc_decompose(tg, device=CPU, **kw)
    assert got_l.dtype == np.int64 and np.array_equal(got_l, want_l), \
        f"{what}: labels"
    assert got_s.keys() == want_s.keys()
    for key in want_s:
        if key == "engine_traces":
            continue
        g, w = got_s[key], want_s[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), \
                f"{what}: {key}"
        else:
            assert g == w, f"{what}: {key} {g} != {w}"
    assert got_s["engine_traces"] == 0
    return got_l, got_s


@pytest.mark.parametrize("family", sorted(SMOKE_SIZES))
def test_scc_matches_reference(family):
    """Default arguments (AC-6 dense trim, windowed reach, trim-2) and
    trim-2 off, on the bench_scc smoke families."""
    jg, tg = _graphs(family)
    labels, _ = _assert_same(jg, tg, family)
    assert tscc.same_partition(labels, tscc.tarjan_oracle(*tg.to_numpy()))
    _assert_same(jg, tg, family + "/no-trim2", trim2=False)


@pytest.mark.parametrize("family", sorted(PEEL_SMOKE_SIZES))
def test_scc_fringe_matches_reference(family):
    """The peel benchmark's fringe graphs: trim-2 on and off (off drains
    the captive pairs one pivot per generation, the multi-region
    worklist)."""
    jg, tg = _fringe(family)
    for trim2 in (True, False):
        _assert_same(jg, tg, f"{family}/trim2={trim2}", trim2=trim2)


@pytest.mark.parametrize("config", [
    dict(use_trim=False),
    dict(trim_method="ac4"),
    dict(trim_method="ac6", trim_backend="windowed"),
    dict(reach_backend="dense"),
    dict(counters=True, workers=4, chunk=1),
    dict(max_batch=2, trim2=False),
    dict(trim_transpose=False, frontier="dense"),
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_scc_configurations_match_reference(config):
    jg, tg = _fringe("RMAT")
    _assert_same(jg, tg, str(config), **config)


def test_scc_active_mask_matches_reference():
    jg, tg = _fringe("sink_heavy")
    active = np.random.default_rng(4).random(tg.n) < 0.7
    labels, _ = _assert_same(jg, tg, "active", active=active)
    assert (labels[~active] == -1).all() and (labels[active] >= 0).all()
    _assert_same(jg, tg, "active/counters", active=active, counters=True,
                 workers=4, chunk=1, max_batch=2)


def test_incremental_matches_reference():
    """A deletion batch that splits a component and an insertion batch
    that merges components, on graphs built with ``from_edges``."""
    _, tg = _graphs("RMAT")
    ip, ix = tg.to_numpy()
    src = np.repeat(np.arange(tg.n), np.diff(ip)).astype(np.int64)
    dst = ix.astype(np.int64)
    prev, _ = tscc.scc_decompose(tg, device=CPU)
    rng = np.random.default_rng(9)
    # deletions: edges inside the largest component
    big = np.bincount(prev).argmax()
    inside = np.flatnonzero((prev[src] == big) & (prev[dst] == big))
    drop = rng.choice(inside, 40, replace=False)
    keep = np.ones(src.size, bool)
    keep[drop] = False
    dels = (src[drop], dst[drop])
    # insertions: edges between vertices of different components, in
    # both directions so some components merge
    a = rng.choice(tg.n, 6, replace=False)
    b = rng.choice(tg.n, 6, replace=False)
    ins = (np.concatenate([a, b]), np.concatenate([b, a]))
    for (s, d), deletions, insertions in (
            ((src[keep], dst[keep]), dels, None),
            ((np.concatenate([src, ins[0]]), np.concatenate([dst, ins[1]])),
             None, ins)):
        jg, tg2 = _both(tg.n, s, d)
        want_l, want_s = jscc.scc_decompose_incremental(
            jg, prev, deletions=deletions, insertions=insertions)
        got_l, got_s = tscc.scc_decompose_incremental(
            tg2, prev, deletions=deletions, insertions=insertions,
            device=CPU)
        assert np.array_equal(got_l, want_l)
        for key in ("dirty_vertices", "dirty_components",
                    "reach_dispatches"):
            assert got_s[key] == want_s[key], key
        assert got_s["dirty_vertices"] > 0
        assert tscc.same_partition(got_l,
                                   tscc.tarjan_oracle(*tg2.to_numpy()))


def test_oracles_match_reference():
    for family in ("RMAT", "sink_heavy"):
        _, tg = _graphs(family)
        ip, ix = tg.to_numpy()
        comp = tscc.tarjan_oracle(ip, ix)
        assert np.array_equal(comp, jscc.tarjan_oracle(ip, ix))
        rng = np.random.default_rng(1)
        relabel = rng.permutation(comp.max() + 1)[comp]
        merged = np.where(comp == comp[0], comp[1], comp)
        for other in (relabel, merged, comp[::-1]):
            assert tscc.same_partition(comp, other) == \
                jscc.same_partition(comp, other)
    assert tscc.same_partition(np.zeros(0), np.zeros(0))


# -- the dispatch contract (ported from tests/test_scc.py) ---------------------

def four_cycle_star():
    """Four disjoint cycles joined by one-way bridges in a star: 4 SCCs
    whose worklist branches, so one generation carries several regions."""
    blocks, srcs, dsts = [], [], []
    offset = 0
    for size in (11, 7, 5, 13):
        v = np.arange(size) + offset
        srcs.append(v)
        dsts.append(np.roll(v, -1))
        blocks.append(v)
        offset += size
    for a, b in ((0, 1), (0, 2), (3, 0)):
        srcs.append(blocks[a][:1])
        dsts.append(blocks[b][:1])
    return tcore.CSRGraph.from_edges(offset, np.concatenate(srcs),
                                     np.concatenate(dsts), device=CPU)


def _scc(g, **kw):
    labels, stats = tscc.scc_decompose(g, device=CPU, **kw)
    assert tscc.same_partition(labels, tscc.tarjan_oracle(*g.to_numpy()))
    return labels, stats


def test_one_generation_one_trim_two_reach_dispatches():
    n = 9
    g = tcore.CSRGraph.from_edges(n, np.arange(n), (np.arange(n) + 1) % n,
                                  device=CPU)
    _, stats = _scc(g)
    assert stats["generations"] == 1
    assert stats["trim_dispatches"] == 1
    assert stats["trim2_dispatches"] == 1
    assert stats["reach_dispatches"] == 2
    assert stats["pivots"] == 1


def test_dispatches_scale_with_generations_not_regions():
    labels, stats = _scc(four_cycle_star())
    assert len(np.unique(labels)) == 4
    assert stats["trim_dispatches"] == stats["generations"]
    assert stats["reach_dispatches"] == 2 * stats["generations"]
    assert stats["pivots"] == 4
    assert stats["generations"] < stats["pivots"]


def test_no_reach_dispatch_when_trim_clears_everything():
    n = 50
    g = tcore.CSRGraph.from_edges(n, np.arange(n - 1), np.arange(1, n),
                                  device=CPU)
    labels, stats = _scc(g)
    assert stats["trimmed_total"] == n
    assert stats["reach_dispatches"] == 0 and stats["pivots"] == 0
    assert stats["trim2_dispatches"] == 0
    assert stats["trim_dispatches"] == stats["generations"] == 1
    assert len(np.unique(labels)) == n


def test_trimming_reduces_generations():
    rng = np.random.default_rng(0)
    n = 300
    src = rng.integers(0, n - 1, 900)
    dst = src + rng.integers(1, 20, 900).clip(max=n - 1 - src)
    g = tcore.CSRGraph.from_edges(
        n, np.concatenate([src, [n - 3, n - 2, n - 1]]),
        np.concatenate([dst, [n - 2, n - 1, n - 3]]), device=CPU)
    labels_t, stats_t = _scc(g, use_trim=True)
    labels_n, stats_n = _scc(g, use_trim=False)
    assert tscc.same_partition(labels_t, labels_n)
    assert stats_t["pivots"] < stats_n["pivots"]
    assert stats_t["trimmed_total"] > 0


def test_max_batch_chunks_wide_worklists():
    g = four_cycle_star()
    wide, stats_wide = _scc(g, trim2=False)
    narrow, stats_narrow = _scc(g, max_batch=1, counters=True, trim2=False)
    assert tscc.same_partition(wide, narrow)
    assert stats_narrow["pivots"] == stats_wide["pivots"] == 4
    assert stats_narrow["trim_dispatches"] > stats_wide["trim_dispatches"]
    assert stats_narrow["reach_dispatches"] > stats_wide["reach_dispatches"]
    with pytest.raises(ValueError, match="power of two"):
        tscc.scc_decompose(g, max_batch=3, device=CPU)


def test_rejections(monkeypatch, tmp_path):
    g = tcore.CSRGraph.from_edges(3, [0, 1, 2], [1, 2, 0], device=CPU)
    with pytest.raises(ValueError, match="batchable trim backend"):
        tscc.scc_decompose(g, trim_backend="sharded", device=CPU)
    _, inst = tscc.scc_decompose(g, instrument=True, device=CPU)
    assert inst["trim_rounds"] > 0 and inst["reach_rounds"] >= 0
    # checkpoint/resume: tests/test_torch_fault.py holds it against the
    # reference; resume without a checkpoint directory is a plain run
    d = str(tmp_path / "ckpt")
    labels, _ = tscc.scc_decompose(g, checkpoint_dir=d, checkpoint_every=1,
                                   device=CPU)
    assert sorted(os.listdir(d)) == ["step_00000001"]
    assert np.array_equal(tscc.scc_decompose(g, resume=True, device=CPU)[0],
                          labels)
    with pytest.raises(ValueError, match="shape"):
        tscc.scc_decompose(g, active=np.ones(2, bool), device=CPU)
    _, fast = tscc.scc_decompose(g, device=CPU)
    assert fast["trim_edges_traversed"] is None
    _, full = tscc.scc_decompose(g, counters=True, device=CPU)
    assert full["trim_edges_traversed"] >= g.m
    labels, stats = tscc.scc_decompose(
        tcore.CSRGraph.from_edges(0, [], [], device=CPU), device=CPU)
    assert labels.shape == (0,) and stats["generations"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscc.scc_decompose(g)


def test_cpu_scc_launches_no_kernel():
    ops.reset_launches()
    _, tg = _graphs("RMAT")
    tscc.scc_decompose(tg, device=CPU)
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
