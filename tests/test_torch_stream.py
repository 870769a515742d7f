"""The PyTorch port's stream engine against the JAX reference, on the CPU.

Every case of ``tests/test_stream.py`` runs on both packages with the same
numpy inputs, in lockstep, and after every step the two engines must agree
bit for bit on everything they expose: the fixpoint ``status`` and the
AC-4 ``counters`` (path-dependent on dead vertices), each batch's
``rounds`` and ``dirty``, ``retrim()`` and its rounds total, compactions,
capacity, ``n_ins``/``n_tomb``, the host mirrors, the device overlay, the
base CSR, the ``snapshot()`` CSR arrays and the dispatch accounting.  A
seeded random feed (numpy RNG) of deletions, insertions, mixed batches and
compactions over the six generator families adds the spirit of
``tests/test_stream_property.py``.  All compared values are integers or
bools: the tolerance is exact.
"""
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

CPU = "cpu"
HOST_MIRRORS = ("_src_np", "_dst_np", "_key_order", "_keys_sorted",
                "_tomb_np", "_ins_src_np", "_ins_dst_np", "_ins_alive_np")
OVERLAY = ("tomb", "ins_src", "ins_dst", "ins_alive")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _graphs(n, src, dst):
    return (jcore.CSRGraph.from_edges(n, src, dst),
            tcore.CSRGraph.from_edges(n, src, dst, device=CPU))


def _random_graph(n=40, m=120, seed=0):
    rng = np.random.default_rng(seed)
    return _graphs(n, rng.integers(0, n, m), rng.integers(0, n, m))


def _plan(graphs, **kw):
    jg, tg = graphs
    return jcore.plan_stream(jg, **kw), tcore.plan_stream(tg, **kw)


def _scratch_status(te):
    """The acceptance oracle: a from-scratch AC-4 run on the port's
    materialized graph."""
    return tcore.plan(te.snapshot(), method="ac4",
                      device=CPU).run().status.numpy()


def _assert_same(je, te):
    jd, td = je.delta, te.delta
    assert (jd.n, jd.m_base, jd.n_ins, jd.n_tomb, jd.capacity) == \
        (td.n, td.m_base, td.n_ins, td.n_tomb, td.capacity)
    assert jd.m_live == td.m_live and jd.needs_compact == td.needs_compact
    assert (je.compactions, je.dispatches, je.transpose_builds) == \
        (te.compactions, te.dispatches, te.transpose_builds)
    for name in HOST_MIRRORS:
        assert _eq(getattr(jd, name), getattr(td, name)), name
    for name in OVERLAY:
        assert _eq(getattr(jd, name), getattr(td, name)), name
    for a, b in zip(jd.base.to_numpy(), td.base.to_numpy()):
        assert _eq(a, b)
    for a, b in zip(je.snapshot().to_numpy(), te.snapshot().to_numpy()):
        assert _eq(a, b)
    assert _eq(je._state[0], te._state[0])          # status, bool
    assert _eq(je._state[1], te._state[1])          # counters, int32
    jr, tr = je.retrim(), te.retrim()
    assert _eq(jr.status, tr.status) and jr.rounds == tr.rounds
    assert tr.status.dtype == torch.int32
    assert jr.n_trimmed == tr.n_trimmed


def _apply(engines, **batch):
    je, te = engines
    a, b = je.apply(**batch), te.apply(**batch)
    assert (a.rounds, a.dirty, a.n_trimmed) == (b.rounds, b.dirty,
                                                b.n_trimmed)
    assert _eq(a.status, b.status)
    _assert_same(je, te)
    return b


def _edges(te):
    d = te.delta
    live = ~d._tomb_np
    return d._src_np[live], d._dst_np[live]


# -- retrim() equals a from-scratch run, on both packages ---------------------

@pytest.mark.parametrize("frontier", ["auto", "dense", "sparse"])
def test_retrim_matches_scratch_over_deletions(frontier):
    engines = _plan(_random_graph(seed=1), capacity=16, frontier=frontier)
    _assert_same(*engines)
    rng = np.random.default_rng(2)
    for _ in range(4):
        src, dst = _edges(engines[1])
        ids = rng.choice(src.size, 6, replace=False)
        _apply(engines, deletions=(src[ids], dst[ids]))
        assert np.array_equal(engines[1].retrim().status.numpy(),
                              _scratch_status(engines[1]))


@pytest.mark.parametrize("frontier", ["auto", "dense", "sparse"])
def test_retrim_matches_scratch_with_insertions(frontier):
    engines = _plan(_random_graph(seed=3), capacity=64, frontier=frontier)
    rng = np.random.default_rng(4)
    n = engines[1].delta.n
    for _ in range(4):
        ins = (rng.integers(0, n, 3), rng.integers(0, n, 3))
        src, dst = _edges(engines[1])
        ids = rng.choice(src.size, 3, replace=False)
        _apply(engines, deletions=(src[ids], dst[ids]), insertions=ins)
        assert np.array_equal(engines[1].retrim().status.numpy(),
                              _scratch_status(engines[1]))


def test_retrim_full_resets_to_same_fixpoint():
    je, te = engines = _plan(_random_graph(seed=5))
    src, dst = _edges(te)
    _apply(engines, deletions=(src[:5], dst[:5]))
    incr = te.retrim().status.clone()
    jf, tf = je.retrim(full=True), te.retrim(full=True)
    assert torch.equal(tf.status, incr)
    assert _eq(jf.status, tf.status) and jf.rounds == tf.rounds
    _assert_same(je, te)


def test_identity_across_compact_boundary():
    engines = _plan(_random_graph(n=30, m=90, seed=6), capacity=16,
                    load_factor=0.05)
    rng = np.random.default_rng(7)
    for _ in range(3):
        src, dst = _edges(engines[1])
        ids = rng.choice(src.size, 4, replace=False)
        _apply(engines, deletions=(src[ids], dst[ids]),
               insertions=(rng.integers(0, 30, 2), rng.integers(0, 30, 2)))
        assert np.array_equal(engines[1].retrim().status.numpy(),
                              _scratch_status(engines[1]))
    te = engines[1]
    assert te.compactions >= 2
    assert te.delta.n_tomb == 0 and te.delta.n_ins == 0


def test_revival_via_dead_source_insertion():
    engines = _plan((jgen.chain(10), tgen.chain(10, device=CPU)), capacity=8)
    assert engines[1].retrim().n_trimmed == 10
    res = _apply(engines, insertions=([5], [2]))      # 2->..->5->2 cycle
    assert res.dirty
    status = engines[1].retrim().status.numpy()
    assert np.array_equal(status, _scratch_status(engines[1]))
    assert status[:6].all() and status.sum() == 6


def test_live_insertions_stay_incremental():
    engines = _plan((jgen.cycle(8), tgen.cycle(8, device=CPU)), capacity=8)
    res = _apply(engines, insertions=([0], [4]))      # live -> live
    assert not res.dirty


def test_empty_base_with_insertions():
    z = np.zeros(0, np.int64)
    engines = _plan(_graphs(4, z, z), capacity=8)
    res = _apply(engines, insertions=([1, 2], [2, 1]))
    assert res.dirty
    status = engines[1].retrim().status.numpy().astype(bool)
    assert (status == np.array([False, True, True, False])).all()
    # deletion-only and insertion batches on the edgeless base after it
    _apply(engines, deletions=([1], [2]))
    _apply(engines, insertions=([3], [3]))


def test_empty_graph():
    z = np.zeros(0, np.int64)
    je, te = _plan(_graphs(0, z, z))
    assert te.dispatches == 0 and te.retrim().status.shape == (0,)
    res = te.apply()
    assert (res.rounds, res.dirty, res.status.shape) == (0, False, (0,))
    with pytest.raises(ValueError, match="empty"):
        te.apply(insertions=([0], [0]))
    _assert_same(je, te)


# -- overlay bookkeeping -------------------------------------------------------

def test_delete_missing_edge_raises_and_rolls_back():
    engines = _plan(_graphs(4, [0, 1, 2], [1, 2, 3]), capacity=8)
    for e in engines:
        with pytest.raises(ValueError, match="not present"):
            e.apply(deletions=([0, 3], [1, 0]))      # (3, 0) does not exist
    _assert_same(*engines)
    assert engines[1].delta.n_tomb == 0
    _apply(engines, deletions=([0], [1]))


def test_duplicate_arcs_are_distinct_instances():
    engines = _plan(_graphs(3, [0, 0, 1], [1, 1, 2]), capacity=8)
    _apply(engines, deletions=([0], [1]))
    _apply(engines, deletions=([0], [1]))
    for e in engines:
        with pytest.raises(ValueError, match="not present"):
            e.apply(deletions=([0], [1]))
    _assert_same(*engines)


def test_duplicates_in_base_and_buffer():
    """A batch deleting more copies of an arc than the base holds claims
    live insert slots for the rest (the multiset path of
    ``resolve_deletions``)."""
    engines = _plan(_graphs(3, [0, 0, 1, 2], [1, 1, 2, 0]), capacity=8,
                    load_factor=100.0)
    _apply(engines, insertions=([0, 0], [1, 1]))
    _apply(engines, deletions=([0, 0, 0], [1, 1, 1]))
    d = engines[1].delta
    assert d.n_tomb == 2 and d._ins_alive_np.sum() == 1
    _apply(engines, deletions=([0], [1]))
    for e in engines:
        with pytest.raises(ValueError, match="not present"):
            e.apply(deletions=([0], [1]))
    _assert_same(*engines)


def test_delete_inserted_edge():
    engines = _plan((jgen.cycle(4), tgen.cycle(4, device=CPU)), capacity=8)
    _apply(engines, insertions=([0], [2]))
    _apply(engines, deletions=([0], [2]))             # resolves to the slot
    assert engines[1].delta.n_tomb == 0


def test_insert_buffer_growth():
    engines = _plan((jgen.cycle(8), tgen.cycle(8, device=CPU)), capacity=2,
                    load_factor=100.0)
    _apply(engines, insertions=(np.zeros(5, np.int64),
                                np.full(5, 1, np.int64)))
    te = engines[1]
    assert te.delta.capacity >= 5 and te.snapshot().m == 8 + 5
    assert np.array_equal(te.retrim().status.numpy(), _scratch_status(te))


def test_update_out_of_range_raises():
    for e in _plan((jgen.cycle(4), tgen.cycle(4, device=CPU)), capacity=8):
        with pytest.raises(ValueError, match="out of range"):
            e.apply(insertions=([0], [4]))
        with pytest.raises(ValueError, match="out of range"):
            e.apply(deletions=([-1], [0]))


def test_failed_batch_applies_nothing():
    engines = _plan((jgen.cycle(4), tgen.cycle(4, device=CPU)), capacity=8)
    for e in engines:
        with pytest.raises(ValueError, match="out of range"):
            e.apply(deletions=([0], [1]), insertions=([99], [0]))
    _assert_same(*engines)
    te = engines[1]
    assert te.delta.n_tomb == 0 and te.delta.n_ins == 0
    assert te.snapshot().m == 4
    _apply(engines, deletions=([0], [1]))


def test_host_device_overlay_never_diverge():
    engines = _plan(_random_graph(n=20, m=60, seed=8), capacity=16)
    rng = np.random.default_rng(9)
    for _ in range(3):
        src, dst = _edges(engines[1])
        ids = rng.choice(src.size, 3, replace=False)
        _apply(engines, deletions=(src[ids], dst[ids]),
               insertions=(rng.integers(0, 20, 2), rng.integers(0, 20, 2)))
        d = engines[1].delta
        assert np.array_equal(d.tomb.numpy(), d._tomb_np)
        assert np.array_equal(d.ins_alive.numpy(), d._ins_alive_np)
        assert np.array_equal(d.ins_src.numpy()[d._ins_alive_np],
                              d._ins_src_np[d._ins_alive_np])


# -- engine contracts ----------------------------------------------------------

def test_stream_dispatch_accounting():
    je, te = engines = _plan(_random_graph(seed=10))
    assert te.dispatches == 1 and te.transpose_builds == 1
    src, dst = _edges(te)
    _apply(engines, deletions=(src[:2], dst[:2]))
    assert te.dispatches == 2
    te.retrim()                                    # fixpoint read: free
    assert te.dispatches == 2
    te.retrim(full=True)
    je.retrim(full=True)
    assert te.dispatches == 3 and te.traces == 0
    te.compact()
    je.compact()
    _apply(engines, deletions=(src[2:4], dst[2:4]))
    assert te.transpose_builds == 2                # rebuilt after compact


def test_rounds_total_accumulates_and_full_resets():
    engines = _plan(_random_graph(n=50, m=110, seed=21), capacity=16)
    te = engines[1]
    total = te.retrim().rounds
    rng = np.random.default_rng(22)
    for _ in range(3):
        src, dst = _edges(te)
        ids = rng.choice(src.size, 8, replace=False)
        total += _apply(engines, deletions=(src[ids], dst[ids])).rounds
        assert te.retrim().rounds == total
    for e in engines:
        e.retrim(full=True)
    _assert_same(*engines)


def test_plan_stream_rejects_unknown_and_unported_configs():
    _, g = _graphs(4, [0, 1], [1, 2])
    with pytest.raises(ValueError, match="unknown method"):
        tcore.plan_stream(g, method="ac9000")
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.plan_stream(g, backend="sharded")
    assert tcore.plan_stream(g, instrument=True).retrim().round_stats \
        is not None
    # max_rounds sizes the stats only: uninstrumented, it is ignored
    assert tcore.plan_stream(g, max_rounds=8).max_rounds == 0
    engine = tcore.plan_stream(g)
    assert engine.nbytes() == sum(engine.nbytes_breakdown().values()) > 0
    assert engine.delta.nbytes() == sum(
        engine.delta.nbytes_breakdown().values()) > 0
    # checkpoints: tests/test_torch_fault.py holds them against the
    # reference
    assert set(engine.state_dict()) == set(engine.delta.state_dict()) | {
        "status", "counters", "rounds_total"}
    assert engine.state_meta()["delta"] == engine.delta.state_meta()
    with pytest.raises(ValueError, match="family"):
        engine.load_state({}, {})
    with pytest.raises(KeyError):
        engine.delta.load_state({}, {})
    assert engine.plan_signature() == \
        "stream[ac4/dense](n=4,m=2,cap=256)+frontier[auto]"


def test_delta_csr_standalone():
    jg, tg = _random_graph(n=10, m=30, seed=12)
    jd, td = jcore.DeltaCSR(jg, capacity=4), tcore.DeltaCSR(tg, capacity=4)
    assert td.m_live == 30 and not td.needs_compact
    src, dst = td._src_np.copy(), td._dst_np.copy()
    for d in (jd, td):
        d.resolve_deletions(src[:2], dst[:2])
    assert td.m_live == 28 and td.n_tomb == 2
    snap = td.materialize()
    assert snap.m == 28 and snap.device == torch.device(CPU)
    for d in (jd, td):
        d.compact()
    assert td.m_base == 28 and td.n_tomb == 0
    for name in HOST_MIRRORS + OVERLAY:
        assert _eq(getattr(jd, name), getattr(td, name)), name
    engines = jcore.plan_stream(jd), tcore.plan_stream(td)
    _assert_same(*engines)
    assert np.array_equal(engines[1].retrim().status.numpy().astype(bool),
                          tcore.trim_oracle(*snap.to_numpy()))
    with pytest.raises(ValueError, match="fixed by the DeltaCSR"):
        tcore.plan_stream(td, capacity=64)
    with pytest.raises(ValueError):
        tcore.DeltaCSR(tg, capacity=0)


# -- incremental SCC on the stream engine's snapshots --------------------------

def _stream_snapshots(n, src, dst, batch):
    """Apply one batch on a stream engine of each package; returns both
    snapshots (their CSR arrays must be equal)."""
    engines = _plan(_graphs(n, src, dst), capacity=8)
    _apply(engines, **batch)
    js, ts = (e.snapshot() for e in engines)
    for a, b in zip(js.to_numpy(), ts.to_numpy()):
        assert _eq(a, b)
    return js, ts


def test_scc_incremental_split_and_merge():
    src = [0, 1, 2, 3, 4, 5, 0]
    dst = [1, 2, 0, 4, 5, 3, 3]
    jg, tg = _graphs(6, src, dst)
    labels, _ = tscc.scc_decompose(tg, window=4, device=CPU)
    assert tscc.same_partition(labels, tscc.tarjan_oracle(*tg.to_numpy()))
    for batch, check in (
            (dict(deletions=([0], [1])), ("dirty_vertices", 3)),
            (dict(insertions=([3], [0])), ("reach_dispatches", 2)),
            (dict(deletions=([0], [3])), ("dirty_vertices", 0))):
        js, ts = _stream_snapshots(6, src, dst, batch)
        got_l, got_s = tscc.scc_decompose_incremental(ts, labels, window=4,
                                                      device=CPU, **batch)
        want_l, want_s = jscc.scc_decompose_incremental(js, labels,
                                                        window=4, **batch)
        assert np.array_equal(got_l, want_l)
        assert tscc.same_partition(got_l, tscc.tarjan_oracle(*ts.to_numpy()))
        assert got_s[check[0]] == want_s[check[0]] == check[1]
        if check == ("dirty_vertices", 0):
            assert np.array_equal(got_l, labels)


def test_scc_incremental_random_batches():
    rng = np.random.default_rng(13)
    n, m = 25, 70
    jg, tg = _graphs(n, rng.integers(0, n, m), rng.integers(0, n, m))
    engines = _plan((jg, tg), capacity=8)
    labels, _ = tscc.scc_decompose(tg, window=4, device=CPU)
    for _ in range(3):
        src, dst = _edges(engines[1])
        ids = rng.choice(src.size, 4, replace=False)
        batch = dict(deletions=(src[ids], dst[ids]),
                     insertions=(rng.integers(0, n, 2),
                                 rng.integers(0, n, 2)))
        _apply(engines, **batch)
        ts = engines[1].snapshot()
        new, _ = tscc.scc_decompose_incremental(ts, labels, window=4,
                                                device=CPU, **batch)
        want, _ = jscc.scc_decompose_incremental(engines[0].snapshot(),
                                                 labels, window=4, **batch)
        assert np.array_equal(new, want)
        assert tscc.same_partition(new, tscc.tarjan_oracle(*ts.to_numpy()))
        labels = new


# -- a seeded random feed over the six families --------------------------------

FAMILIES = {   # tests/test_stream_property.py's tiny instances
    "ER": lambda G, s, **d: G.erdos_renyi(16, 48, seed=s, simple=True, **d),
    "BA": lambda G, s, **d: G.barabasi_albert(16, deg=2, seed=s, **d),
    "RMAT": lambda G, s, **d: G.rmat(4, 48, seed=s, **d),
    "chain": lambda G, s, **d: G.chain(12, **d),
    "layered": lambda G, s, **d: G.layered_dag(16, layers=4, deg=2, seed=s,
                                               **d),
    "sink_heavy": lambda G, s, **d: G.sink_heavy(16, 40, sink_frac=0.5,
                                                 seed=s, **d),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_random_feed_matches_reference(family):
    """Deletions, insertions (revivals included), mixed batches and
    explicit compactions, drawn from a numpy RNG; small capacity, so the
    buffer also compacts and grows on its own."""
    make = FAMILIES[family]
    engines = _plan((make(jgen, 3), make(tgen, 3, device=CPU)), capacity=4,
                    load_factor=0.5)
    te = engines[1]
    n = te.delta.n
    rng = np.random.default_rng(sum(map(ord, family)))
    for step in range(8):
        op = ("delete", "insert", "mixed", "compact")[rng.integers(0, 4)]
        if op == "compact":
            for e in engines:
                e.compact()
            _assert_same(*engines)
            continue
        batch = {}
        if op in ("delete", "mixed"):
            src, dst = te.delta._live_edges()
            k = min(int(rng.integers(1, 4)), src.size)
            ids = rng.choice(src.size, k, replace=False)
            batch["deletions"] = (src[ids], dst[ids])
        if op in ("insert", "mixed"):
            k = int(rng.integers(1, 6))
            batch["insertions"] = (rng.integers(0, n, k),
                                   rng.integers(0, n, k))
        _apply(engines, **batch)
        assert np.array_equal(te.retrim().status.numpy().astype(bool),
                              tcore.trim_oracle(*te.snapshot().to_numpy()))


def test_cpu_stream_launches_no_kernel():
    ops.reset_launches()
    engines = _plan(_random_graph(seed=30), capacity=4)
    src, dst = _edges(engines[1])
    _apply(engines, deletions=(src[:3], dst[:3]), insertions=([0], [1]))
    assert all(v == 0 for v in ops.LAUNCHES.values())
