"""Card-only tests of the PyTorch port: every Hopper kernel against its
plain PyTorch version on the same CUDA tensors (bit for bit where the
outputs are int32 or bool; the flash attention kernel to a stated float
tolerance; the segment sum, which adds in another order, to 1e-5 of each
segment's sum of absolute values), the engines on the card
against the engines on the CPU, the LM's prefill (through the flash
kernel) against its decode, the attention gradient with the kernel's
forward against autograd through the plain version, LM training with
and without remat, a GNN and an LM (dense and MoE) training step and the
MoE FFN on the card against the same on the CPU, the sharded LM as one
NCCL rank against the unsharded, the static checks' copy kernel against
``x.clone()``, and every captured launch record against the grid and
block the profiler sees.  They skip where no CUDA device is present; on a machine with one
run them with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no ``jax``, so it runs where only PyTorch is installed.
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from repro_torch.core import plan, plan_peel, plan_reach, plan_stream
from repro_torch.core.scc import scc_decompose
from repro_torch.graphs import generators as G
from repro_torch.kernels import _build
from repro_torch.kernels import bucket_peel as bpl
from repro_torch.kernels import counter_scatter as cs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import first_live_scan as fls
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import frontier_compact as fc
from repro_torch.kernels import frontier_expand as fex
from repro_torch.kernels import segment_sum as ss

pytestmark = pytest.mark.gpu
ST = _build.SCAN_TILE      # elements a tile of scan_lookback


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _eq(a, b):
    return torch.equal(a.cpu(), b.cpu())


@contextlib.contextmanager
def _profiled():
    """A profile of the CPU and the card that records from the first item
    of the block: the profiler has been seen to lose the first device
    items after it starts, so the card runs 64 spin kernels and idles
    20 ms first (:func:`_device_names` leaves them out)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        yield prof


def _device_names(prof):
    """Names of a :func:`_profiled` block's device items (kernels and
    copies), without its spin kernels."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


@pytest.mark.parametrize("n,W", [(1, 16), (333, 16), (4097, 16), (64, 8),
                                 (1000, 5)])
@pytest.mark.parametrize("fill", ["some", "none_active"])
def test_first_live_scan_kernel(cuda, n, W, fill):
    rng = np.random.default_rng(n * 31 + W)
    flags = torch.as_tensor(rng.random((n, W)) < 0.3, device=cuda)
    valid = torch.as_tensor(rng.random((n, W)) < 0.8, device=cuda)
    active = torch.as_tensor(rng.random(n) < 0.5, device=cuda)
    if fill == "none_active":
        active = torch.zeros_like(active)
    got = fls.first_live_scan(flags, valid, active)
    want = ref.first_live_ref(flags, valid, active)
    torch.cuda.synchronize()
    assert all(_eq(g, w) for g, w in zip(got, want))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 3 * 4096 + 7,
                               5_000_000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_prefix_positions_kernel(cuda, n, dtype):
    rng = np.random.default_rng(n)
    x = (torch.as_tensor(rng.integers(0, 5, n), device=cuda).to(dtype)
         if dtype == torch.int32
         else torch.as_tensor(rng.random(n) < 0.4, device=cuda))
    pos, total = fc.prefix_positions(x)
    wpos, wtotal = ref.prefix_positions_ref(x)
    torch.cuda.synchronize()
    assert _eq(pos, wpos) and int(total) == int(wtotal)
    assert pos.dtype == torch.int32 and total.dtype == torch.int32


@pytest.mark.parametrize("n", [1, ST - 1, ST, ST + 1, 3 * ST + 7, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_prefix_positions_lookback_edge_cases(cuda, n, dtype):
    """The single-pass scan at one tile, a ragged tail and on an
    unaligned x[1:], twice in a row (the second call meets the first's
    status words) and interleaved with frontier_compact on one stream
    (the two share one scratch buffer): bit for bit, one launch a call."""
    rng = np.random.default_rng(n + 7)
    base = (torch.as_tensor(rng.integers(-3, 1000, n + 1), device=cuda)
            .to(torch.int32) if dtype == torch.int32 else
            torch.as_tensor(rng.random(n + 1) < 0.4, device=cuda))
    mask = torch.as_tensor(rng.random(n) < 0.3, device=cuda)
    before = dict(ops.LAUNCHES)
    for x in (base[:n], base[1:], base[:n], base[1:]):
        pos, total = fc.prefix_positions(x)
        ids, count = fc.frontier_compact(mask, 512)
        wpos, wtotal = ref.prefix_positions_ref(x)
        wids, wcount = ref.frontier_compact_ref(mask, 512)
        torch.cuda.synchronize()
        assert _eq(pos, wpos) and int(total) == int(wtotal)
        assert _eq(ids, wids) and int(count) == int(wcount)
    assert ops.LAUNCHES["prefix_positions"] == \
        before["prefix_positions"] + 4


T = 16384      # _build.COMPACT_TILE: bytes a tile of compact_lookback


@pytest.mark.parametrize("n,cap", [
    (1, 1), (700, 16), (4097, 64), (4097, 8192), (100_000, 1024),
    (T - 1, 512), (T, 512), (T + 1, 512),          # tile boundaries
    (37 * T + 5, 70_000),                          # many tiles, ragged tail
    (37 * T + 5, 9_000)])                          # count > capacity
@pytest.mark.parametrize("fill", ["none", "some", "all"])
@pytest.mark.parametrize("offset", [0, 1])         # 1: unaligned mask[1:]
def test_frontier_compact_kernel(cuda, n, cap, fill, offset):
    """The single-pass compaction equals its plain version bit for bit
    (ids, sentinels, the full count), in one launch of compact_lookback
    that leaves prefix_positions' count alone; twice in a row, so the
    second call reads the first call's status words as stale."""
    rng = np.random.default_rng(n + cap)
    mask = {"none": np.zeros(n + offset, bool),
            "all": np.ones(n + offset, bool),
            "some": rng.random(n + offset) < 0.01}[fill]
    mask = torch.as_tensor(mask, device=cuda)[offset:]
    before = dict(ops.LAUNCHES)
    for _ in range(2):
        ids, count = fc.frontier_compact(mask, cap)
        wids, wcount = ref.frontier_compact_ref(mask, cap)
        torch.cuda.synchronize()
        assert _eq(ids, wids) and int(count) == int(wcount)
        assert ids.dtype == torch.int32 and count.shape == ()
    assert ops.LAUNCHES["frontier_compact"] == before["frontier_compact"] + 2
    assert ops.LAUNCHES["prefix_positions"] == before["prefix_positions"]


@pytest.mark.parametrize("n,m,cap,ecap,p", [
    (64, 256, 16, 512, 0.2), (333, 1000, 64, 2048, 0.2),
    (333, 1000, 512, 64, 0.9),            # ecap overflow: tails lost
    (5000, 4000, 8192, 8192, 1.0),        # many zero-degree rows
    (1, 3, 1, 4, 1.0)])
def test_sparse_expand_kernel(cuda, n, m, cap, ecap, p):
    rng = np.random.default_rng(n + m)
    g = G.erdos_renyi(n, m, seed=int(n), device=cuda)
    mask = torch.as_tensor(rng.random(n) < p, device=cuda)
    ids, _ = ref.frontier_compact_ref(mask, cap)
    got = fc.sparse_expand(g.indptr, g.indices, ids, ecap)
    want = ref.sparse_expand_ref(g.indptr, g.indices, ids, ecap)
    torch.cuda.synchronize()
    assert all(_eq(a, b) for a, b in zip(got, want))


def _expand_case(kind, dev, slot_tile):
    """(indptr, indices, ids, ecap) on ``dev``: a hub over 9 slot tiles,
    half sentinel ids, a run of zero-degree rows, total 0, total = ecap,
    or total > ecap."""
    rng = np.random.default_rng(len(kind))
    n = 5000
    deg = rng.integers(1, 12, n)
    deg[rng.random(n) < 0.3] = 0
    if kind == "hub":
        deg[17] = 9 * slot_tile + 11
    if kind == "zero_run":
        deg[100:3000] = 0
    if kind == "total0":
        deg[:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)])
    m = max(int(indptr[-1]), 1)
    ids = np.sort(rng.choice(n, 3000, replace=False))
    C = 4096 if kind != "hub" else 3000
    ids = np.concatenate([ids, np.full(C - ids.size, n)])
    if kind == "sentinels":
        ids = np.sort(np.where(rng.random(C) < 0.5, n, ids))
    total = int(deg[ids[ids < n]].sum())
    ecap = {"total_eq": total, "total_gt": total // 3}.get(
        kind, total + 2 * slot_tile + 5)
    t = [torch.as_tensor(a.astype(np.int32), device=dev)
         for a in (indptr, rng.integers(0, n, m), ids)]
    return (*t, max(ecap, 1))


@pytest.mark.parametrize("kind", ["hub", "sentinels", "zero_run", "total0",
                                  "total_eq", "total_gt"])
def test_sparse_expand_lookback_edge_cases(cuda, kind):
    """The one-launch expansion at its edge cases, bit for bit, twice and
    interleaved on one stream with frontier_compact, prefix_positions and
    segment_sum, which share its scratch: one launch a call, no host
    sync."""
    indptr, indices, ids, ecap = _expand_case(kind, cuda,
                                              _build.EXPAND_SLOT_TILE)
    want = ref.sparse_expand_ref(indptr, indices, ids, ecap)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.integers(0, 9, 3 * ST + 5), dtype=torch.int32,
                        device=cuda)
    mask = torch.as_tensor(rng.random(3 * T + 9) < 0.3, device=cuda)
    vals = torch.ones((5000, 4), device=cuda)
    seg = torch.as_tensor(rng.integers(0, 40, 5000), dtype=torch.int32,
                          device=cuda)
    before = ops.LAUNCHES["sparse_expand"]
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fc.sparse_expand(indptr, indices, ids, ecap)
            pos, _ = fc.prefix_positions(x)
            cids, _ = fc.frontier_compact(mask, 4096)
            sums = ss.segment_sum(vals, seg, 40)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert all(_eq(a, b) for a, b in zip(got, want))
        assert _eq(pos, ref.prefix_positions_ref(x)[0])
        assert _eq(cids, ref.frontier_compact_ref(mask, 4096)[0])
        assert _eq(sums, ref.segment_sum_ref(vals, seg, 40))
    assert ops.LAUNCHES["sparse_expand"] == before + 2


def _kernel_items(fn):
    fn()
    torch.cuda.synchronize()
    with _profiled() as prof:
        fn()
        torch.cuda.synchronize()
    return _device_names(prof)


def test_sparse_expand_is_one_launch(cuda):
    """A profiled call holds one device item, expand_lookback."""
    indptr, indices, ids, ecap = _expand_case("hub", cuda,
                                              _build.EXPAND_SLOT_TILE)
    items = _kernel_items(lambda: fc.sparse_expand(indptr, indices, ids,
                                                   ecap))
    assert len(items) == 1 and "expand_lookback" in items[0], items


def _probe_case(kind, n, dev):
    """(status, indptr, indices, start, scanning) on ``dev``: random
    degrees with zero-degree rows; "start_ge_deg" every pointer at or past
    its row's end, "zero_degree" most rows empty, "no_scanning" none
    scanning, "m0" no edges."""
    rng = np.random.default_rng(n + len(kind))
    deg = rng.integers(0, 40, n)
    deg[rng.random(n) < 0.2] = 0
    if kind == "zero_degree":
        deg[rng.random(n) < 0.75] = 0
    if kind == "m0":
        deg[:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, max(n, 1), int(indptr[-1])).astype(np.int32)
    start = (deg + rng.integers(0, 3, n) if kind == "start_ge_deg"
             else rng.integers(0, 45, n)).astype(np.int32)
    scanning = rng.random(n) < (0.0 if kind == "no_scanning" else 0.3)
    status = rng.random(n) < 0.5
    return [torch.as_tensor(a, device=dev)
            for a in (status, indptr, indices, start, scanning)]


@pytest.mark.parametrize("n", [0, 1, 333, 4097])
@pytest.mark.parametrize("window", [4, 8, 16, 17, 32])
@pytest.mark.parametrize("kind", ["random", "start_ge_deg", "zero_degree",
                                  "no_scanning", "m0"])
def test_first_live_probe_kernel(cuda, n, window, kind):
    """The probe kernel equals the plain gather + row scan bit for bit,
    call after call, with no host sync."""
    args = _probe_case(kind, n, cuda)
    want = ref.first_live_probe_ref(*args, window)
    before = ops.LAUNCHES["first_live_probe"]
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fls.first_live_probe(*args, window)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert all(_eq(a, b) for a, b in zip(got, want))
    assert ops.LAUNCHES["first_live_probe"] == before + 2 * (n > 0)


def test_windowed_probe_builds_no_tile(cuda):
    """The engines' windowed probe launches first_live_probe once and
    never first_live_scan, its one port kernel item is the probe, no
    operation in it makes a tensor larger than (n + 1,), and it equals the
    probe on the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.core.common import probe_first_live_windowed
    n, window = 1 << 20, 16
    args = _probe_case("random", n, cuda)

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    def probe():
        return probe_first_live_windowed(*args, window)
    items = _kernel_items(probe)
    assert sum("first_live_probe" in k for k in items) == 1, items
    assert not any("first_live_w16" in k or "first_live_any" in k
                   for k in items)
    before = dict(ops.LAUNCHES)
    with Largest() as mode:
        got = probe()
    torch.cuda.synchronize()
    assert mode.numel <= n + 1, mode.numel
    assert ops.LAUNCHES["first_live_probe"] == before["first_live_probe"] + 1
    assert ops.LAUNCHES["first_live_scan"] == before["first_live_scan"]
    cpu = probe_first_live_windowed(*(a.cpu() for a in args), window)
    assert all(_eq(a, b) for a, b in zip(got, cpu))


@pytest.mark.parametrize("n,W", [(1, 16), (333, 16), (4097, 16), (64, 8),
                                 (1000, 17), (513, 32), (77, 4)])
@pytest.mark.parametrize("fill", ["some", "none_pending", "all_pending"])
def test_frontier_expand_kernel(cuda, n, W, fill):
    rng = np.random.default_rng(n * 17 + W)
    flags = torch.as_tensor(rng.random((n, W)) < 0.1, device=cuda)
    valid = torch.as_tensor(rng.random((n, W)) < 0.8, device=cuda)
    pending = torch.as_tensor({"some": rng.random(n) < 0.5,
                               "none_pending": np.zeros(n, bool),
                               "all_pending": np.ones(n, bool)}[fill],
                              device=cuda)
    got = fex.frontier_expand(flags, valid, pending)
    want = ref.frontier_expand_ref(flags, valid, pending)
    torch.cuda.synchronize()
    assert _eq(got, want) and got.dtype == torch.bool
    # non-contiguous input: every other row of a wider tile
    wide = torch.as_tensor(rng.random((2 * n, W)) < 0.1, device=cuda)
    got = fex.frontier_expand(wide[::2], valid, pending)
    torch.cuda.synchronize()
    assert _eq(got, ref.frontier_expand_ref(wide[::2], valid, pending))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 333, 4096, 4099, 1_000_003])
@pytest.mark.parametrize("k", [0, 1, 7])
def test_bucket_peel_kernel(cuda, n, k):
    rng = np.random.default_rng(n + k)
    counters = torch.as_tensor(rng.integers(-3, 9, n).astype(np.int32),
                               device=cuda)
    alive = torch.as_tensor(rng.random(n) < 0.6, device=cuda)
    kt = torch.tensor([k], dtype=torch.int32, device=cuda)
    for a in (alive, torch.zeros_like(alive)):
        got = bpl.bucket_peel(counters, a, kt)
        torch.cuda.synchronize()
        assert _eq(got, ref.bucket_peel_ref(counters, a, kt))
    # unaligned (offset views) take the scalar kernel
    got = bpl.bucket_peel(counters[1:], alive[1:], kt)
    torch.cuda.synchronize()
    assert _eq(got, ref.bucket_peel_ref(counters[1:], alive[1:], kt))


def test_new_kernels_skip_empty_inputs(cuda):
    before = dict(ops.LAUNCHES)
    e = torch.zeros((0, 16), dtype=torch.bool, device=cuda)
    assert fex.frontier_expand(e, e, e[:, 0]).shape == (0,)
    z = torch.zeros((0,), dtype=torch.int32, device=cuda)
    assert bpl.bucket_peel(z, z.bool(), torch.zeros(
        1, dtype=torch.int32, device=cuda)).shape == (0,)
    assert ops.LAUNCHES == before


def test_kernels_raise_on_cpu_tensors():
    with pytest.raises(ValueError):
        fc.prefix_positions(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("family", ["ER", "RMAT", "chain", "sink_heavy"])
def test_engine_on_card_matches_cpu(cuda, family):
    sizes = {"ER": dict(n=2_000, m=2_400, seed=1),
             "RMAT": dict(n_log2=10, m=1_280, seed=1, a=0.4, b=0.1, c=0.1),
             "chain": dict(n=500),
             "sink_heavy": dict(n=2_000, m=8_000, sink_frac=0.9, seed=1)}
    fn = G.BENCHMARK_GRAPHS[family][0]
    g_cpu = fn(**sizes[family], device="cpu")
    g_gpu = fn(**sizes[family], device=cuda)
    before = dict(ops.LAUNCHES)
    for method in ("ac3", "ac4", "ac4*", "ac6"):
        for backend in ("dense", "windowed"):
            frontiers = ("auto",) if method == "ac3" else ("auto", "sparse")
            for frontier in frontiers:
                kw = dict(method=method, backend=backend, workers=16,
                          chunk=1, frontier=frontier)
                a = plan(g_cpu, device="cpu", **kw).run().materialize()
                b = plan(g_gpu, device=cuda, **kw).run().materialize()
                assert np.array_equal(a.status, b.status)
                assert (a.rounds, a.max_frontier) == (b.rounds,
                                                      b.max_frontier)
                assert np.array_equal(a.per_worker_edges, b.per_worker_edges)
    for name in ("first_live_probe", "frontier_compact", "sparse_expand"):
        assert ops.LAUNCHES[name] > before[name], name
    # the probe gathers itself and sparse_expand scans its own degrees
    for name in ("first_live_scan", "prefix_positions"):
        assert ops.LAUNCHES[name] == before[name], name


@pytest.mark.parametrize("family", ["ER", "RMAT", "chain", "sink_heavy"])
def test_scc_reach_peel_on_card_match_cpu(cuda, family):
    """The SCC driver, both reach backends and the peel engine on the card
    equal the CPU runs, through frontier_expand and bucket_peel."""
    sizes = {"ER": dict(n=2_000, m=16_000, seed=1),
             "RMAT": dict(n_log2=10, m=8_192, seed=1),
             "chain": dict(n=500),
             "sink_heavy": dict(n=2_000, m=8_000, sink_frac=0.9, seed=1)}
    fn = G.BENCHMARK_GRAPHS[family][0]
    g_cpu = G.with_tiny_scc_fringe(fn(**sizes[family], device="cpu"),
                                   pairs=8, loops=4)
    g_gpu = g_cpu.to(cuda)
    before = dict(ops.LAUNCHES)
    for trim2 in (True, False):
        a_l, a_s = scc_decompose(g_cpu, trim2=trim2, device="cpu")
        b_l, b_s = scc_decompose(g_gpu, trim2=trim2, device=cuda)
        assert np.array_equal(a_l, b_l) and a_s == b_s
    for backend in ("dense", "windowed"):
        for frontier in ("dense", "sparse", "auto"):
            a = plan_reach(g_cpu, backend=backend, frontier=frontier,
                           device="cpu").run(0).materialize()
            b = plan_reach(g_gpu, backend=backend, frontier=frontier,
                           device=cuda).run(0).materialize()
            assert np.array_equal(a.mask, b.mask) and a.rounds == b.rounds
    for frontier in ("dense", "sparse", "auto"):
        for k in (None, 1):
            a = plan_peel(g_cpu, frontier=frontier,
                          device="cpu").run(k=k).materialize()
            b = plan_peel(g_gpu, frontier=frontier,
                          device=cuda).run(k=k).materialize()
            assert np.array_equal(a.coreness, b.coreness)
            assert np.array_equal(a.peel_round, b.peel_round)
            assert a.rounds == b.rounds
    for name in ("frontier_expand", "bucket_peel"):
        assert ops.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("n", [1, 3, 4, 5, 333, 4096, 4099, 1_000_003])
@pytest.mark.parametrize("b", [0, 1, 7, 4096, 100_000])
def test_counter_scatter_kernel(cuda, n, b):
    """Sources in [-2, n] (negatives and the sentinel n add nothing),
    deltas in {-1, 0, 1} plus a few large ones, half the batch on one
    source; the inputs stay untouched; offset views take the scalar death
    pass."""
    rng = np.random.default_rng(n * 7 + b)
    counters = torch.as_tensor(rng.integers(-2, 6, n).astype(np.int32),
                               device=cuda)
    status = torch.as_tensor(rng.random(n) < 0.7, device=cuda)
    src = rng.integers(-2, n + 1, b).astype(np.int32)
    src[::2] = rng.integers(0, n)
    delta = rng.integers(-1, 2, b).astype(np.int32)
    delta[::97] = rng.integers(-1 << 16, 1 << 16, delta[::97].size)
    src, delta = torch.as_tensor(src, device=cuda), torch.as_tensor(
        delta, device=cuda)
    before = counters.clone()
    for args in ((counters, status, src, delta),
                 (counters[1:], status[1:], src, delta),
                 (counters, status, src[::2], delta[::2])):
        got = cs.counter_scatter(*args)
        torch.cuda.synchronize()
        want = ref.counter_scatter_ref(*args)
        assert _eq(got[0], want[0]) and _eq(got[1], want[1])
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert _eq(counters, before)


def test_counter_scatter_empty_inputs(cuda):
    before = dict(ops.LAUNCHES)
    z = torch.zeros((0,), dtype=torch.int32, device=cuda)
    new, dead = cs.counter_scatter(z, z.bool(), torch.tensor(
        [0, 1], dtype=torch.int32, device=cuda), torch.ones(
        2, dtype=torch.int32, device=cuda))
    assert new.shape == dead.shape == (0,)
    assert ops.LAUNCHES == before
    c = torch.tensor([0, 1, -1], dtype=torch.int32, device=cuda)
    st = torch.tensor([True, True, False], device=cuda)
    new, dead = cs.counter_scatter(c, st, z, z)      # B = 0
    assert _eq(new, c) and _eq(dead, st & (c <= 0))
    with pytest.raises(TypeError):
        cs.counter_scatter(c.long(), st, z, z)


@pytest.mark.parametrize("family", ["ER", "RMAT", "chain", "sink_heavy"])
def test_stream_on_card_matches_cpu(cuda, family):
    """A small mixed feed (deletions, re-insertions that revive, a
    compaction and a buffer growth) on the card and on the CPU: equal
    status, counters, rounds and dirty flags, and retrim() equals AC-4 on
    the snapshot, through counter_scatter."""
    sizes = {"ER": dict(n=2_000, m=16_000, seed=1, simple=True),
             "RMAT": dict(n_log2=10, m=8_192, seed=1),
             "chain": dict(n=500),
             "sink_heavy": dict(n=2_000, m=8_000, sink_frac=0.9, seed=1)}
    fn = G.BENCHMARK_GRAPHS[family][0]
    g_cpu = fn(**sizes[family], device="cpu")
    engines = [plan_stream(g, capacity=64, load_factor=0.05)
               for g in (g_cpu, g_cpu.to(cuda))]
    before = ops.LAUNCHES["counter_scatter"]
    rng = np.random.default_rng(5)
    src, dst = engines[0].delta._src_np.copy(), engines[0].delta._dst_np.copy()
    alive = np.ones(src.size, bool)
    pending = []
    for tick in range(6):
        k = min(max(1, src.size // 50), int(alive.sum()))
        ids = rng.choice(np.nonzero(alive)[0], k, replace=False)
        alive[ids] = False
        ins = pending.pop(0) if len(pending) >= 2 else None
        batch = dict(deletions=(src[ids], dst[ids]),
                     insertions=None if ins is None else (src[ins],
                                                          dst[ins]))
        a, b = (e.apply(**batch) for e in engines)
        assert (a.rounds, a.dirty) == (b.rounds, b.dirty)
        assert _eq(engines[0]._state[1], engines[1]._state[1])
        if ins is not None:
            alive[ins] = True
        pending.append(ids)
        got = engines[1].retrim().status
        want = plan(engines[1].snapshot(), method="ac4",
                    device=cuda).run().status
        assert _eq(got, want) and _eq(got, engines[0].retrim().status)
    assert engines[1].compactions == engines[0].compactions >= 1
    assert ops.LAUNCHES["counter_scatter"] > before


@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,dtype",
    [(2, 4, 2, 256, 256, 128, True, torch.float32),
     (2, 4, 2, 256, 256, 128, True, torch.bfloat16),
     (1, 8, 2, 128, 256, 64, False, torch.float32),
     (1, 2, 1, 256, 512, 64, True, torch.float32),   # Sk > Sq
     (1, 3, 1, 256, 128, 16, True, torch.float32),   # Sq > Sk: 0 and mean
     (1, 2, 2, 128, 64, 32, True, torch.bfloat16),   # Sq > Sk
     (2, 6, 2, 48, 48, 32, True, torch.float32),     # one block, group 3
     (1, 4, 4, 16, 80, 16, True, torch.bfloat16)])
def test_flash_attention_kernel(cuda, b, hq, hkv, sq, sk, d, causal, dtype):
    """The kernel against its plain version on the same tensors: f32 to
    2e-5 (both sum in f32, in other orders), bf16 outputs to 1e-2 (one
    bf16 rounding of values of size ~1 is 4e-3)."""
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = (torch.as_tensor(rng.normal(size=shape), device=cuda).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                             (b, hkv, sk, d)))
    before = ops.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_strided_and_errors(cuda):
    """Transposed (B, S, H, D) views are read by strides, and the output
    keeps their layout; unsupported shapes and dtypes raise."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 256, h, 64)),
                               dtype=torch.float32, device=cuda)
               for h in (4, 2, 2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = fa.flash_attention(qt, kt, vt)
    want = ref.flash_attention_ref(qt, kt, vt)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert got.transpose(1, 2).is_contiguous()
    with pytest.raises(ValueError):
        fa.flash_attention(qt[:, :, :200], kt[:, :, :200], vt[:, :, :200])
    with pytest.raises(ValueError):
        fa.flash_attention(qt[..., :48], kt[..., :48], vt[..., :48])
    with pytest.raises(TypeError):
        fa.flash_attention(qt.half(), kt.half(), vt.half())


def _flash_once(q, k, v, causal=True, tol=1e-2):
    """One wrapper call: exactly one launch counted, on the kernel that
    (dtype, D) selects, within ``tol`` of the plain version (1e-2 in bf16:
    one rounding of the output; 1e-4 in f32, chip_smoke.py's FLASH_TOL:
    3xTF32 keeps ~2^-19 of each product); a rerun gives the same bits."""
    before = ops.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal))
    return got


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 2)])  # groups 1-3
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 384), (384, 128),
                                   (48, 96), (128, 64)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wgmma_kernel(cuda, hq, hkv, sq, sk, d, causal):
    """bf16 at every D runs flash_fwd_wgmma (128-, 64- and 32-byte
    swizzled tiles): GQA groups 1-3, Sq < Sk, Sq > Sk (zero rows and mean
    rows when causal), short single tiles."""
    assert fa.kernel_for(torch.bfloat16, d) == "flash_fwd_wgmma"
    rng = np.random.default_rng(sq * 7 + sk + d + hq)
    q, k, v = (torch.as_tensor(rng.normal(size=shape), device=cuda)
               .to(torch.bfloat16)
               for shape in ((2, hq, sq, d), (2, hkv, sk, d),
                             (2, hkv, sk, d)))
    _flash_once(q, k, v, causal)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 2)])  # groups 1-3
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 384), (384, 128),
                                   (48, 96), (128, 64)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tf32x3_kernel(cuda, hq, hkv, sq, sk, d, causal):
    """f32 at every D runs flash_fwd_tf32x3 (3xTF32 on the tensor cores):
    GQA groups 1-3, Sq < Sk, Sq > Sk (zero rows and mean rows when
    causal), short single tiles, within 1e-4 of the plain version."""
    assert fa.kernel_for(torch.float32, d) == "flash_fwd_tf32x3"
    rng = np.random.default_rng(sq * 7 + sk + d + hq)
    q, k, v = (torch.as_tensor(rng.normal(size=shape), device=cuda)
               .to(torch.float32)
               for shape in ((2, hq, sq, d), (2, hkv, sk, d),
                             (2, hkv, sk, d)))
    _flash_once(q, k, v, causal, tol=1e-4)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_tf32x3_views_and_unaligned(cuda, d):
    """f32: the model's transposed (B, S, H, D) views and a strided slice
    of the keys go to TMA as they are and the output keeps the views'
    layout; an input with a 4-byte offset, or with rows that are not a
    multiple of 16 bytes, takes the wrapper's copy."""
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 256, h, d)),
                               dtype=torch.float32, device=cuda)
               for h in (8, 4, 4))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert all(fa.tma_ready(t) for t in views)
    got = _flash_once(*views, tol=1e-4)
    assert got.transpose(1, 2).is_contiguous()
    kk, vv = (torch.as_tensor(rng.normal(size=(2, 4, 512, d)),
                              dtype=torch.float32, device=cuda)[:, :, ::2]
              for _ in range(2))
    assert fa.tma_ready(kk)
    _flash_once(views[0], kk, vv, tol=1e-4)
    flat = torch.as_tensor(rng.normal(size=2 * 8 * 256 * d + 1),
                           dtype=torch.float32, device=cuda)
    shifted = flat[1:].view(2, 8, 256, d)               # 4-byte offset
    wide = torch.as_tensor(rng.normal(size=(2, 4, 256, d + 2)),
                           dtype=torch.float32, device=cuda)[..., :d]
    assert not fa.tma_ready(shifted) and not fa.tma_ready(wide)
    _flash_once(shifted, views[1], wide, tol=1e-4)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_wgmma_views_and_unaligned(cuda, d):
    """The model's transposed (B, S, H, D) views go to TMA as they are and
    the output keeps their layout; an input with a 2-byte offset, or with
    rows that are not a multiple of 16 bytes, takes the wrapper's copy."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 256, h, d)),
                               device=cuda).to(torch.bfloat16)
               for h in (8, 4, 4))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert all(fa.tma_ready(t) for t in views)
    assert _flash_once(*views).transpose(1, 2).is_contiguous()
    flat = torch.as_tensor(rng.normal(size=2 * 8 * 256 * d + 1),
                           device=cuda).to(torch.bfloat16)
    shifted = flat[1:].view(2, 8, 256, d)               # 2-byte offset
    wide = torch.as_tensor(rng.normal(size=(2, 4, 256, d + 4)),
                           device=cuda).to(torch.bfloat16)[..., :d]
    assert not fa.tma_ready(shifted) and not fa.tma_ready(wide)
    _flash_once(shifted, views[1], wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_prefill_decode_on_card(cuda, dtype):
    """The reduced qwen3 on the card: decode_step(pos=P) after
    prefill(tokens[:, :P]) equals forward(tokens)[:, P], the prefill
    through the flash kernel and the decode through plain attention;
    and the card's logits equal the CPU's."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import LM
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").make_reduced(),
                              compute_dtype=dtype)
    lm = LM(cfg, device=cuda)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 256)), device=cuda)
    before = ops.LAUNCHES["flash_attention"]
    full, _, _ = lm(toks)
    _, cache = lm.prefill(toks[:, :128], cache_len=256)
    assert ops.LAUNCHES["flash_attention"] == before + 2 * cfg.n_layers
    got, _ = lm.decode_step(cache, toks[:, 128:129], 128)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(got, full[:, 128], atol=tol, rtol=tol)
    lm_cpu = LM(cfg, device="cpu", init=False)
    lm_cpu.load_state_dict({k_: t.cpu() for k_, t in lm.state_dict().items()})
    cpu, _, _ = lm_cpu(toks.cpu())
    torch.testing.assert_close(full.cpu(), cpu, atol=tol, rtol=tol)


def _attn_grads(fn, q, k, v, dout):
    """Gradients of ``fn(q, k, v) . dout`` with respect to q, k, v."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 16), (torch.float32, 32),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 32)])
def test_flash_attention_fn_grad_on_card(cuda, dtype, d):
    """``FlashAttentionFn`` with the kernel's forward (flash_fwd_wgmma in
    bf16, flash_fwd_tf32x3 in f32) against autograd through the
    plain version on the same card tensors: the gradient to 1e-4 of each
    largest entry in f32, to 2^-7 in bf16 (the same f32 math, rounded to
    bf16 once); one forward and one backward counted; a rerun gives the
    same bits."""
    rng = np.random.default_rng(d)
    q, k, v, dout = (torch.as_tensor(rng.normal(size=shape), device=cuda)
                     .to(dtype) for shape in ((2, 8, 256, d), (2, 4, 256, d),
                                              (2, 4, 256, d), (2, 8, 256, d)))
    before = dict(ops.LAUNCHES)
    out, grads = _attn_grads(ops.flash_attention, q, k, v, dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    _, plain = _attn_grads(ref.flash_attention_ref, q, k, v, dout)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for g, w, x in zip(grads, plain, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())
    assert all(torch.equal(a, b) for a, b in
               zip(grads, fa.flash_attention_bwd(q, k, v, dout)))
    again_out, again = _attn_grads(ops.flash_attention, q, k, v, dout)
    assert torch.equal(again_out, out)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


def _card_lm(cuda, d_head, dtype, remat):
    """The reduced qwen3 (2 layers) with ``d_head``, drawn on the card
    from seed 0."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import LM
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").make_reduced(),
                              d_head=d_head, compute_dtype=dtype,
                              remat=remat)
    return LM(cfg, device=cuda)


def _card_batch(cfg, cuda, s=256):
    from repro_torch.data import TokenStream
    return {k: torch.as_tensor(v, device=cuda).long() for k, v in
            TokenStream(2, s, cfg.vocab, seed=0).batch_at(0).items()}


@pytest.mark.parametrize("d_head", [16, 64])
def test_lm_remat_bit_identical_on_card(cuda, d_head):
    """remat on and off on the card (bf16, flash_fwd_wgmma at D 16 and
    64): the same loss and gradients bit for bit;
    with remat the forward kernel runs twice a layer, the backward once."""
    grads, counts = {}, {}
    for remat in (False, True):
        lm = _card_lm(cuda, d_head, torch.bfloat16, remat)
        batch = _card_batch(lm.cfg, cuda)
        before = dict(ops.LAUNCHES)
        loss, _ = lm.loss(batch)
        grads[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(lm.parameters())))
        torch.cuda.synchronize()
        counts[remat] = tuple(ops.LAUNCHES[n] - before[n] for n in
                              ("flash_attention", "flash_attention_bwd"))
    n = lm.cfg.n_layers
    assert counts == {False: (n, n), True: (2 * n, n)}
    assert torch.equal(grads[False][0], grads[True][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[False][1],
                                                  grads[True][1]))


def test_lm_train_step_card_vs_cpu(cuda):
    """One ``make_train_step`` of the reduced qwen3 (f32 compute, D = 64,
    remat on) on the card and on the CPU from the same weights: the loss
    to 1e-5 relative, the gradients (AdamW's first moments) to 1e-3 of
    each largest entry.  AdamW's first step moves an entry by ``lr g /
    |g|``, so an entry whose gradient is near 0 may move the other way on
    the other device: the parameters are within ``2 lr`` of the CPU's,
    and fewer than 0.1% of them by more than 1e-5."""
    from repro_torch.models import LM
    from repro_torch.models.transformer import make_train_step
    from repro_torch.optim import AdamW
    lm = _card_lm(cuda, 64, torch.float32, True)
    host = LM(lm.cfg, device="cpu", init=False)
    host.load_state_dict({k: t.cpu() for k, t in lm.state_dict().items()})
    batch = _card_batch(lm.cfg, cuda)
    out = []
    for model, b in ((lm, batch), (host, {k: t.cpu() for k, t in
                                          batch.items()})):
        opt = AdamW(lr=1e-3)
        ps = list(model.parameters())
        _, st, met = make_train_step(model, opt)(ps, opt.init(ps), b)
        out.append((ps, st, met))
    (ps, st, met), (hps, hst, hmet) = out
    assert abs(met["loss"].item() - hmet["loss"].item()) \
        <= 1e-5 * hmet["loss"].item()
    for m, hm in zip(st.mu, hst.mu):
        assert float((m.cpu() - hm).abs().max()) \
            <= 1e-3 * float(hm.abs().max())
    off = total = 0
    for p, hp in zip(ps, hps):
        diff = (p.detach().cpu() - hp.detach()).abs()
        assert float(diff.max()) <= 2e-3 * (1 + 1e-3)
        off += int((diff > 1e-5).sum())
        total += diff.numel()
    assert off < 1e-3 * total


@pytest.mark.parametrize("case", ["drops", "ties", "floor"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_card_vs_cpu(cuda, k, case):
    """``layers.moe_ffn`` (f32 compute, TF32 off) on the card and on the
    CPU on the same weights: the same routing and capacity drops (a
    zeroed router for "ties": every token to experts 0..k-1, lower index
    first; cf 0.5 for "drops"; T = 4 for "floor"), outputs to 1e-5 and
    the aux loss to 1e-6."""
    from repro_torch.models import layers
    e, d, f = 16, 64, 96
    t = 4 if case == "floor" else 512
    cfg = layers.LMConfig(
        name="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=1,
        d_head=32, d_ff=f, vocab=64, moe=True, n_experts=e, top_k=k,
        capacity_factor=0.5 if case == "drops" else 1.25,
        moe_dense_residual=True, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(k)
    p = {"router": torch.randn(d, e, generator=gen) / d ** 0.5,
         "w_gate": torch.randn(e, d, f, generator=gen) / d ** 0.5,
         "w_up": torch.randn(e, d, f, generator=gen) / d ** 0.5,
         "w_down": torch.randn(e, f, d, generator=gen) / f ** 0.5,
         "dense": {n: torch.randn(*s, generator=gen) / s[0] ** 0.5
                   for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                                ("w_down", (f, d)))}}
    if case == "ties":
        p["router"].zero_()
    x = torch.randn(2, t // 2, d, generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = layers.moe_ffn(
            {n: (v.to(cuda) if torch.is_tensor(v) else
                 {m: w.to(cuda) for m, w in v.items()})
             for n, v in p.items()}, cfg, x.to(cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want, want_aux = layers.moe_ffn(p, cfg, x)
    gates = torch.softmax(x.reshape(t, d) @ p["router"], -1)
    _, top = layers.moe_route(gates, k)
    _, top_card = layers.moe_route(gates.to(cuda), k)
    assert torch.equal(top_card.cpu(), top)
    if case == "ties":
        assert bool((top == torch.arange(k)).all())
    assert float((on_card[0].cpu() - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    assert abs(float(on_card[1]) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("arch", ["arctic-480b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_lm_train_step_card_vs_cpu(cuda, arch):
    """One ``make_train_step`` of a reduced MoE LM (f32 compute, remat
    on, TF32 off) on the card and on the CPU from the same weights: the
    loss and aux to 1e-5 relative, the gradients (AdamW's first moments)
    to 1e-3 of each largest entry."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.transformer import make_train_step
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(configs.get(arch).make_reduced(),
                              compute_dtype=torch.float32, remat=True)
    lm = LM(cfg, device=cuda)
    host = LM(cfg, device="cpu", init=False)
    host.load_state_dict({k: t.cpu() for k, t in lm.state_dict().items()})
    batch = _card_batch(cfg, cuda, s=64)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        for model, b in ((lm, batch), (host, {k: t.cpu() for k, t in
                                              batch.items()})):
            opt = AdamW(lr=1e-3)
            ps = list(model.parameters())
            _, st, met = make_train_step(model, opt)(ps, opt.init(ps), b)
            out.append((st, met))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (st, met), (hst, hmet) = out
    for key in ("loss", "aux"):
        assert abs(met[key].item() - hmet[key].item()) \
            <= 1e-5 * abs(hmet[key].item()), key
    for m, hm in zip(st.mu, hst.mu):
        assert float((m.cpu() - hm).abs().max()) \
            <= 1e-3 * float(hm.abs().max())


def _segment_close(got, values, ids, n):
    """|kernel - plain| <= 1e-5 * (sum of |v| in the segment) + 1e-6: the
    kernel sums a segment's rows in sorted order plus its carries, the
    plain version in index_add_'s order."""
    want = ref.segment_sum_ref(values, ids, n)
    absum = ref.segment_sum_ref(values.abs(), ids, n)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * absum + 1e-6).all())


@pytest.mark.parametrize("m,d,n", [(0, 4, 1), (1, 4, 1), (5, 1, 3),
                                   (1000, 3, 177), (1000, 4, 177),
                                   (513, 16, 37), (333, 6272, 50),
                                   (8192, 128, 3840)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids_kind", ["in_range", "out_of_range", "int64"])
def test_segment_sum_kernel(cuda, m, d, n, dtype, ids_kind):
    rng = np.random.default_rng(m * 13 + d)
    vals = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                           device=cuda).to(dtype)
    lo, hi = (-2, n + 2) if ids_kind == "out_of_range" else (0, n)
    ids = torch.as_tensor(rng.integers(lo, hi, m), device=cuda,
                          dtype=torch.int64 if ids_kind == "int64"
                          else torch.int32)
    before = ops.LAUNCHES["segment_sum"]
    _segment_close(ss.segment_sum(vals, ids, n), vals, ids, n)
    # no rows: zeros, and no kernel to launch
    assert ops.LAUNCHES["segment_sum"] == before + (m > 0)


def test_segment_sum_kernel_views_and_3d(cuda):
    rng = np.random.default_rng(3)
    wide = torch.as_tensor(rng.normal(size=(700, 134)), dtype=torch.float32,
                           device=cuda)
    ids = torch.as_tensor(rng.integers(0, 90, 700), device=cuda)
    for cols in (slice(0, 128), slice(1, 129), slice(3, 9)):
        _segment_close(ss.segment_sum(wide[:, cols], ids, 90),
                       wide[:, cols], ids, 90)
    v3 = wide[:, :120].reshape(700, 15, 8)
    got = ops.segment_sum(v3, ids, 90)
    assert got.shape == (90, 15, 8)
    _segment_close(got, v3, ids, 90)
    with pytest.raises(TypeError):
        ss.segment_sum(wide.half(), ids, 90)


@pytest.mark.parametrize("case", ["empty", "hub", "d3", "d1", "d300",
                                  "bf16", "slice", "int64"])
def test_segment_sum_sorted_edge_cases(cuda, case):
    """The sorted kernel against its plain version where its split
    matters: mostly empty segments, a hub holding most rows (carried
    across many workers), d % 4 != 0, d = 1 (a thread a worker), d = 300
    (three column chunks), bf16, a column slice and int64 ids.  Two calls,
    and a call with the caller's index, give the same bits; building the
    index and summing never sync with the host."""
    rng = np.random.default_rng(len(case))
    m, n, d = 20_000, 3_000, 128
    ids = rng.integers(0, n, m)
    if case == "empty":
        ids = rng.integers(0, 40, m) * 71
    elif case == "hub":
        ids = np.where(rng.random(m) < 0.9, 5, ids)
    d = {"d3": 3, "d1": 1, "d300": 300}.get(case, d)
    wide = torch.as_tensor(rng.normal(size=(m, d + 5)), dtype=torch.float32,
                           device=cuda)
    vals = wide[:, 1:d + 1] if case == "slice" else wide[:, :d].contiguous()
    if case == "bf16":
        vals = vals.bfloat16()
    ti = torch.as_tensor(ids, device=cuda,
                         dtype=torch.int64 if case == "int64" else
                         torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        index = ops.segment_index(ti, n)
        first = ss.segment_sum(vals, ti, n)
        again = ss.segment_sum(vals, ti, n, index)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _segment_close(first, vals, ti, n)
    assert _eq(first, again)


def test_segment_sum_sass_has_no_atomics(cuda):
    """segment_rows writes with plain stores: the only atomic in the
    library's SASS is the integer increment that takes a CTA's ticket
    from the scratch; no reduction, no atomic add."""
    import re

    from repro_torch.kernels import _build
    _build.load("segment_sum")
    sass = _build.sass("segment_sum")
    assert "segment_rows" in sass
    atomics = re.findall(r"\b(?:REDG?|ATOMG?)\.[\w.]*", sass)
    assert atomics and all(a.startswith("ATOMG.") and ".INC" in a
                           for a in atomics), atomics


@pytest.mark.parametrize("m,n,d", [(8192, 3840, 128), (20_000, 3_000, 1),
                                   (50_000, 7, 300)])
def test_segment_sum_shares_the_lookback_scratch(cuda, m, n, d):
    """segment_rows takes its tickets and status words from the scratch
    that prefix_positions and frontier_compact use on the same stream:
    interleaved with them, call after call, every result holds (the
    scans bit for bit, the sums to their tolerance and bit-identical to
    the first call), with segments cut across many CTAs (n = 7: each
    segment spans thousands of rows)."""
    rng = np.random.default_rng(m + d)
    vals = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                           device=cuda)
    ids = torch.as_tensor(rng.integers(0, n, m), dtype=torch.int32,
                          device=cuda)
    x = torch.as_tensor(rng.integers(0, 9, 3 * ST + 5), dtype=torch.int32,
                        device=cuda)
    mask = torch.as_tensor(rng.random(3 * T + 9) < 0.3, device=cuda)
    index = ops.segment_index(ids, n)
    first = ss.segment_sum(vals, ids, n, index)
    _segment_close(first, vals, ids, n)
    wpos, wtotal = ref.prefix_positions_ref(x)
    wids, wcount = ref.frontier_compact_ref(mask, 4096)
    for _ in range(3):
        pos, total = fc.prefix_positions(x)
        got = ss.segment_sum(vals, ids, n, index)
        ids_, count = fc.frontier_compact(mask, 4096)
        torch.cuda.synchronize()
        assert _eq(got, first)
        assert _eq(pos, wpos) and int(total) == int(wtotal)
        assert _eq(ids_, wids) and int(count) == int(wcount)


@pytest.mark.parametrize("arch", ["meshgraphnet", "schnet", "mace",
                                  "equiformer-v2"])
def test_gnn_train_step_on_card_matches_cpu(cuda, arch):
    """One molecule step at the reduced config: loss and gradients on the
    card (through the segment_sum kernel) equal the CPU's (its plain
    version), loss to 1e-4 relative and every gradient to 1e-3 of its
    tensor's largest entry; the kernel runs once per aggregation."""
    from repro_torch import configs
    from repro_torch.data import GraphBatchStream
    from repro_torch.models import convert
    from repro_torch.models.gnn import MODELS
    from repro_torch.models.gnn.common import molecule_loss, molecule_union
    cfg = configs.get(arch).make_reduced()
    model = MODELS[type(cfg)](cfg, device=cuda,
                              generator=torch.Generator(cuda).manual_seed(0))
    cpu = convert.gnn_from_numpy(cfg, convert.gnn_to_numpy(model),
                                 device="cpu")
    batch = GraphBatchStream(4, 16, 48, seed=0).batch_at(0)
    before = ops.LAUNCHES["segment_sum"]
    loss = molecule_loss(model, molecule_union(batch, cuda))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    per_step = {"meshgraphnet": lambda c: c.n_layers,
                "schnet": lambda c: c.n_interactions,
                "mace": lambda c: 15 * c.n_layers,       # 15 CG paths
                "equiformer-v2": lambda c: 2 * c.n_layers}[arch](cfg)
    assert ops.LAUNCHES["segment_sum"] == before + per_step
    closs = molecule_loss(cpu, molecule_union(batch, "cpu"))
    cgrads = torch.autograd.grad(closs, list(cpu.parameters()))
    torch.testing.assert_close(loss.cpu(), closs, rtol=1e-4, atol=0)
    for g, c in zip(grads, cgrads):
        tol = 1e-3 * max(float(c.abs().max()), 1e-12)
        torch.testing.assert_close(g.cpu(), c, atol=tol, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 255, 1000, 4097, 4099,
                               1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("block", [16, 256, 1024])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("offset", [0, 1])         # 1: unaligned x[1:]
def test_mutant_copy_kernel(cuda, n, block, carry, offset):
    """The static checks' copy kernel equals x.clone() (x + the carry
    word) bit for bit: n % 4 in {0, 1, 2, 3}, ragged blocks, and an
    unaligned slice (the scalar kernel)."""
    from repro_torch.kernels import mutant_copy as mc
    x = torch.as_tensor(np.random.default_rng(n).integers(
        -2**31, 2**31 - 1, n + offset), dtype=torch.int32,
        device=cuda)[offset:]
    c = torch.tensor([-5], dtype=torch.int32, device=cuda) if carry else None
    before = ops.LAUNCHES["mutant_copy"]
    got = mc.mutant_copy(x, c, block=block)
    want = x.clone() if c is None else x - 5
    torch.cuda.synchronize()
    assert _eq(got, want) and got.dtype == torch.int32
    assert ops.LAUNCHES["mutant_copy"] == before + (n > 0)


def test_captured_launches_are_the_cards(cuda, tmp_path):
    """Every kernel catalog point: the launch records captured on meta
    tensors equal the kernels, grids and blocks the profiler sees on the
    card, in order."""
    import json


    from repro_torch.analysis.capture import profiled_launches
    from repro_torch.analysis.catalog import (KERNEL_CATALOG,
                                              LAUNCH_DECLARATIONS)
    want, points = [], []
    for entry in KERNEL_CATALOG:
        for point in entry.points:
            want += [(w.kernel, tuple(w.grid), tuple(w.block))
                     for w in entry.build(point)]
            points.append((entry, point))
    with _profiled() as prof:
        for entry, point in points:
            entry.run(point, cuda)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    got = profiled_launches(json.loads((tmp_path / "trace.json")
                                       .read_text()),
                            {k for _, k in LAUNCH_DECLARATIONS})
    assert got == want
    assert {k for k, _, _ in got} == {k for _, k in LAUNCH_DECLARATIONS}


# -- observability on the card (chip_smoke.py phase 14) --------------------

#: device items instrument=True may add a round on the auto frontier (the
#: stat sums the host does not already read: a reduction is a memset and a
#: reduce, plus a cast for a bool input), and a run to fold them
INSTRUMENT_ITEMS = {"ac3": 3, "ac4": 3, "ac4*": 3, "ac6": 5}
INSTRUMENT_FOLD_ITEMS = 6


def _card_syncs(fn):
    """Host syncs of one call of ``fn`` under torch's sync debug mode."""
    import warnings
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in rec)


def _card_items(*fns, reps=3):
    """Device items (kernels and copies) of one call of each of ``fns``:
    the largest count of ``reps`` profiles in turns, since the profiler
    has been seen to lose items of a profile (all of them, or some) and
    never to report one that did not run."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    counts = [0] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            with _profiled() as prof:
                fn()
                torch.cuda.synchronize()
            counts[i] = max(counts[i], len(_device_names(prof)))
    assert all(counts), "the profiler reported no device item"
    return counts


@pytest.mark.parametrize("method", ["ac3", "ac4", "ac4*", "ac6"])
@pytest.mark.parametrize("backend", ["dense", "windowed"])
def test_instrumented_trim_on_card(cuda, method, backend):
    """Status, counters and rounds equal the plain run bit for bit, the
    round totals the per-worker counters, the stats the CPU's; no host
    sync is added, and at most ``INSTRUMENT_ITEMS`` device items a
    round plus the fold."""
    g = G.rmat(n_log2=14, m=131_072, seed=1, device=cuda)
    kw = dict(method=method, backend=backend, workers=16)
    plain = plan(g, device=cuda, **kw)
    inst = plan(g, instrument=True, device=cuda, **kw)
    a, b = plain.run(), inst.run()
    assert _eq(a.status, b.status) and a.rounds == b.rounds
    assert np.array_equal(a.per_worker_edges, b.per_worker_edges)
    assert a.max_frontier == b.max_frontier
    rs = b.round_stats
    assert int(rs.total("r_edges")) == int(b.per_worker_edges.sum())
    assert int(rs.total("r_frontier")) == b.n_trimmed
    cpu = plan(G.rmat(n_log2=14, m=131_072, seed=1, device="cpu"),
               instrument=True, device="cpu", **kw).run().round_stats
    assert rs.to_dict() == cpu.to_dict()
    assert _card_syncs(inst.run) == _card_syncs(plain.run)
    n0, n1 = _card_items(plain.run, inst.run)
    extra = n1 - n0
    assert 0 <= extra <= INSTRUMENT_ITEMS[method] * b.rounds \
        + INSTRUMENT_FOLD_ITEMS


def test_instrumented_reach_peel_stream_scc_on_card(cuda):
    from repro_torch import obs
    g = G.rmat(n_log2=12, m=32_768, seed=1, device=cuda)
    gc = G.rmat(n_log2=12, m=32_768, seed=1, device="cpu")
    for backend in ("dense", "windowed"):
        r0 = plan_reach(g, backend=backend, device=cuda).run(0)
        r1 = plan_reach(g, backend=backend, instrument=True,
                        device=cuda).run(0)
        assert _eq(r0.mask, r1.mask) and r0.rounds == r1.rounds
        assert int(r1.round_stats.total("r_frontier")) == r1.n_reached
        assert r1.round_stats.to_dict() == plan_reach(
            gc, backend=backend, instrument=True,
            device="cpu").run(0).round_stats.to_dict()
    p0 = plan_peel(g, device=cuda).run()
    p1 = plan_peel(g, instrument=True, device=cuda).run()
    assert _eq(p0.coreness, p1.coreness) and p0.rounds == p1.rounds
    assert p1.round_stats.to_dict() == plan_peel(
        gc, instrument=True, device="cpu").run().round_stats.to_dict()
    s0, s1 = plan_stream(g), plan_stream(g, instrument=True)
    src, dst = s0.delta._src_np.copy(), s0.delta._dst_np.copy()
    rng = np.random.default_rng(0)
    alive = np.ones(src.size, bool)
    for _ in range(3):
        ids = rng.choice(np.flatnonzero(alive), 300, replace=False)
        alive[ids[20:]] = False          # the first 20 come straight back
        batch = dict(deletions=(src[ids], dst[ids]),
                     insertions=(src[ids[:20]], dst[ids[:20]]))
        a, b = s0.apply(**batch), s1.apply(**batch)
        assert _eq(a.status, b.status)
        assert (a.rounds, a.dirty) == (b.rounds, b.dirty)
        assert b.round_stats is not None
    with obs.recording() as rec:
        labels1, st1 = scc_decompose(g, instrument=True, device=cuda)
    labels0, st0 = scc_decompose(g, device=cuda)
    assert np.array_equal(labels0, labels1)
    assert st1["trim_rounds"] > 0
    assert len(rec.select("dispatch", cat="engine")) == \
        st1["trim_dispatches"] + st1["reach_dispatches"]
    assert len(rec.select("generation", cat="scc")) == st1["generations"]


def test_engine_nbytes_against_the_allocator(cuda):
    """``nbytes_breakdown()`` of the cached resources equals what caching
    them added to ``torch.cuda.memory_allocated()``, up to the
    allocator's rounding of each of the 4 tensors to 512 bytes (all are
    under 1 MiB, so they come from its small pool, whose blocks split at
    any remainder of 512 bytes or more)."""
    from repro_torch import obs
    g = G.rmat(n_log2=14, m=131_072, seed=1, device=cuda)
    eng = plan(g, method="ac4", workers=16, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # fresh segments: only the rounding left
    before = torch.cuda.memory_allocated()
    eng._transpose_arrays()
    eng._ids()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    cached = sum(v for k, v in eng.nbytes_breakdown().items()
                 if k != "graph")
    assert 0 <= grown - cached < 512 * 4
    stats = obs.device_memory_stats()
    assert stats["cuda:0"]["allocated_bytes.all.current"] > 0


@pytest.mark.parametrize("family", ["trim", "trim_windowed", "reach", "peel",
                                    "stream"])
def test_checkpoint_roundtrip_on_card(cuda, family, tmp_path):
    """An engine of each family at 2^14 vertices, saved and restored onto
    the card, runs as the original does, bit for bit, through the
    kernels; a stream engine replays a deletion and an insertion tick."""
    from repro_torch import fault as flt
    g = G.rmat(n_log2=14, m=131_072, seed=1, device=cuda)
    make = {"trim": lambda: plan(g, method="ac4", workers=16, device=cuda),
            "trim_windowed": lambda: plan(g, method="ac6",
                                          backend="windowed", workers=16,
                                          device=cuda),
            "reach": lambda: plan_reach(g, backend="windowed", device=cuda),
            "peel": lambda: plan_peel(g, device=cuda),
            "stream": lambda: plan_stream(g, capacity=1024)}[family]

    def run(e):
        if family == "stream":
            d = e.delta
            ids = np.arange(0, d.m_base, 97)[:400]
            ids = ids[~d._tomb_np[ids]]
            e.apply(deletions=(d._src_np[ids], d._dst_np[ids]))
            e.apply(insertions=(d._src_np[ids[:50]], d._dst_np[ids[:50]]))
            return torch.stack([e._state[0].to(torch.int32), e._state[1]])
        if family == "reach":
            return e.run(0).mask
        if family == "peel":
            return e.run().coreness
        r = e.run()
        return torch.cat([r.status, torch.as_tensor(
            r.per_worker_edges, device=cuda).to(torch.int32)])

    engine = make()
    run(engine)                               # builds Gᵀ where needed
    d = str(tmp_path / "ck")
    flt.save_engine(d, engine, step=1)
    before = dict(ops.LAUNCHES)
    want = run(engine)
    restored, _, _, _ = flt.restore_engine(d, device=cuda)
    assert restored.device.type == "cuda"
    got = run(restored)
    assert _eq(got, want)
    assert restored.dispatches == engine.dispatches
    kernel = {"trim": "sparse_expand", "trim_windowed": "first_live_probe",
              "reach": "frontier_expand", "peel": "bucket_peel",
              "stream": "counter_scatter"}[family]
    assert ops.LAUNCHES[kernel] > before[kernel], kernel


def test_trim_stream_server_on_card_matches_cpu(cuda, tmp_path):
    """The trim-stream server on ``chain`` (8 ticks of 32 updates) ends in
    the CPU run's checkpoint, bit for bit, and its ticks run the stream's
    kernels."""
    from repro_torch.launch import serve
    from repro_torch.train import checkpoint as ckpt_lib

    dirs = {}
    for dev in ("cpu", "cuda"):
        dirs[dev] = str(tmp_path / dev)
        ops.reset_launches()
        serve.serve_trim_stream("chain", ticks=8, batch=32, seed=0,
                                checkpoint_dir=dirs[dev],
                                checkpoint_every=100, device=dev)
        if dev == "cuda":
            for name in ("counter_scatter", "frontier_compact",
                         "sparse_expand"):
                assert ops.LAUNCHES[name] > 0, name
    want, _, wmeta = ckpt_lib.load_flat(dirs["cpu"])
    got, _, meta = ckpt_lib.load_flat(dirs["cuda"])
    for key in ("status", "counters", "tomb", "ins_alive", "feed_alive",
                "feed_pending", "feed_pending_lens"):
        assert np.array_equal(got[key], want[key]), key
    assert meta["feed"] == wmeta["feed"]


def test_recsys_forward_on_card_matches_cpu(cuda):
    """Wide & Deep at the published widths (vocabs cut to 2^12): the card's
    forward, tower and loss equal the CPU's on the same weights to 1e-5,
    and the embedding's backward gives the same bits on a rerun."""
    from repro_torch.models import convert, recsys

    cfg = recsys.WideDeepConfig(vocab_sizes=(1 << 12,) * 40)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = recsys.WideDeep(cfg, device=cuda, generator=gen)
    host = convert.widedeep_from_numpy(cfg, convert.widedeep_to_numpy(model),
                                       device="cpu")
    rng = np.random.default_rng(0)
    b = {"dense": rng.normal(size=(512, 13)).astype(np.float32),
         "sparse_ids": rng.integers(0, 1 << 12, (512, 40, 2)).astype(np.int32),
         "labels": rng.integers(0, 2, 512).astype(np.float32)}
    assert not torch.backends.cuda.matmul.allow_tf32     # torch's default
    dev_b = {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}
    cpu_b = {k: torch.as_tensor(v) for k, v in b.items()}
    with torch.no_grad():
        got, want = model(dev_b).cpu(), host(cpu_b)
        tol = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol
        got, want = model.user_tower(dev_b).cpu(), host.user_tower(cpu_b)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    grads = []
    for _ in range(2):
        loss = model.loss(dev_b)
        grads.append(torch.autograd.grad(loss, [model.tables["t0"]])[0])
    assert torch.equal(grads[0], grads[1])
    assert abs(float(loss) - float(host.loss(cpu_b))) <= 1e-5 * float(loss)


# -- the example twins and the dry-run's captured launches ---------------------


def _example(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "torch" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(out: str) -> list:
    """Printed lines without the ones that hold timings."""
    return [ln for ln in out.strip().splitlines()
            if not ln.startswith(("steady-state", "CTR scoring", "[trainer]"))
            and "candidates in" not in ln]


@pytest.mark.parametrize("name,sizes", [
    ("quickstart", dict(N=20_000, M=80_000)),
    ("scc_decomposition", dict(N=2_000, M=6_000)),
    ("train_gnn_trimmed", dict(GRAPH_N=5_000, GRAPH_M=20_000, STEPS=6,
                               CKPT_EVERY=3, LOG_EVERY=3)),
])
def test_example_twin_on_card_matches_cpu(cuda, name, sizes, monkeypatch,
                                          capsys):
    """A twin's own asserts hold on the card, and its printed counts (and
    the SchNet losses, to 1e-3 relative, from the same weights: drawn on
    the CPU, the card's generator draws others) equal the CPU run's."""
    ex = _example(name)
    for k, v in sizes.items():
        monkeypatch.setattr(ex, k, v)
    if hasattr(ex, "build_model"):
        build = ex.build_model
        monkeypatch.setattr(ex, "build_model",
                            lambda cfg, device: build(cfg, "cpu").to(device))
    on_card = ex.main([])
    card = capsys.readouterr().out
    on_cpu = ex.main(["--device", "cpu"])
    cpu = capsys.readouterr().out
    if name == "train_gnn_trimmed":
        got = np.array([h["loss"] for h in on_card[2]])
        want = np.array([h["loss"] for h in on_cpu[2]])
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert _lines(card)[:2] == _lines(cpu)[:2]
    else:
        assert _lines(card) == _lines(cpu)


def test_serve_recsys_twin_on_card_matches_cpu(cuda, monkeypatch, capsys):
    ex = _example("serve_recsys")
    monkeypatch.setattr(ex, "CANDIDATES", 20_000)
    weights = {}

    def build(cfg, device):
        # one set of weights, drawn on the CPU, for both runs
        if not weights:
            weights["m"] = ex.WideDeep(cfg, device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(0))
        return weights["m"].to(device)

    monkeypatch.setattr(ex, "build_model", build)
    scores, vals, idx = ex.main([])
    cpu_scores, cpu_vals, cpu_idx = ex.main(["--device", "cpu"])
    scale = float(cpu_scores.abs().max())
    assert float((scores.cpu() - cpu_scores).abs().max()) <= 1e-5 * scale
    assert float((vals.cpu() - cpu_vals).abs().max()) <= \
        1e-5 * float(cpu_vals.abs().max())


def test_meta_flash_launch_equals_the_cards(cuda):
    """The flash launch the dry-run captures on meta tensors at the
    prefill shape (qwen3-1.7b, 8 x 2048, the (B, S, H, D) -> (B, H, S, D)
    views) is the launch the wrapper makes on the card."""
    from repro_torch.analysis.capture import capture_kernel
    b, s, hq, hkv, d = 8, 2048, 16, 8, 128

    def qkv(device):
        return [torch.zeros(b, s, h, d, dtype=torch.bfloat16,
                            device=device).transpose(1, 2)
                for h in (hq, hkv, hkv)]

    meta = capture_kernel(fa.flash_attention, *qkv("meta"), causal=True)
    seen, real = [], _build.launch

    def spy(spec, entry, *args):
        seen.append(spec)
        return real(spec, entry, *args)

    _build.launch = spy
    try:
        fa.flash_attention(*qkv(cuda), causal=True)
        torch.cuda.synchronize()
    finally:
        _build.launch = real

    def key(spec):
        return (spec.library, spec.kernel, spec.grid, spec.block, spec.smem)

    assert [key(x) for x in meta] == [key(x) for x in seen]
    assert meta[0].kernel == "flash_fwd_wgmma"


def test_sharded_backend_one_nccl_rank(cuda):
    """The sharded backend as one NCCL rank on the card (NCCL takes one
    rank a card): every method's status and rounds equal the dense
    backend's on the card; AC-3's and AC-6's rank edges equal the dense
    totals, AC-4's the in-degrees of the trimmed vertices (the Gᵀ entries
    its body scans); only the rank's block is on the card; every
    collective ran on the card."""
    from repro_torch.core import distributed as dist
    g = G.rmat(14, 131_072, seed=1, device=cuda)
    deg_in = torch.bincount(g.indices.long(), minlength=g.n)
    with dist.process_group(cuda) as dev:
        assert "nccl" in str(torch.distributed.get_backend()).lower()
        for method, kw in (("ac3", {}), ("ac4", dict(unmasked=True)),
                           ("ac4*", dict(unmasked=True)), ("ac6", {}),
                           ("ac6", dict(packed=True))):
            eng = plan(g, method=method, backend="sharded", device=dev, **kw)
            got = eng.run()
            want = plan(g, method=method, device=dev).run()
            assert got.status.device.type == "cuda"
            # the graph stays on the host; only the rank's block is here
            assert eng.graph.indices.device.type == "cpu"
            assert all(t.device.type == "cuda"
                       for t in eng._shard["operands"])
            assert _eq(got.status, want.status), (method, kw)
            assert got.rounds == want.rounds
            assert got.per_worker_edges.shape == (1,)
            if method.startswith("ac4"):
                dead = want.status.cpu() == 0
                assert got.edges_traversed == int(deg_in.cpu()[dead].sum())
            else:
                assert got.edges_traversed == want.edges_traversed
            calls = eng.last_collectives
            assert calls["all_gather"][0] >= 2 and calls["any"][0] >= 1


def test_lm_sharded_step_one_nccl_rank(cuda):
    """The sharded LM as one NCCL rank on a (1, 1) ("data", "model")
    mesh: the reduced qwen3 (f32 compute, D = 64, remat on) places its
    parameters as DTensors on the card; one ``make_train_step`` gives the
    unsharded step's loss to 1e-5 relative, the flash kernel launching
    twice a layer (forward and remat recompute), both moments to 1e-4 of
    each largest entry and the parameters after it to 2e-5 where the
    clipped |g| is at least 100 x AdamW's eps; AdamW on the same
    gradients gives the parameters and moments to 1e-6 of each largest
    entry; prefill and 4 decode steps on a cache placed by the decode
    spec give the unsharded logits to 1e-4; ``compressed_psum``
    at world 1 is ``dequantize(quantize(g))`` and ``gpipe_apply`` at
    S = 1 is the plain stage."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM, sharding
    from repro_torch.models.transformer import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.train import compression, pipeline
    lm = _card_lm(cuda, 64, torch.float32, True)
    batch = _card_batch(lm.cfg, cuda)
    with dist.process_group(cuda):
        mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
        sharded = LM(lm.cfg, device=cuda, init=False)
        sharded.load_state_dict({k: t.clone() for k, t in
                                 lm.state_dict().items()})
        sharding.shard_lm(sharded, mesh)
        toks = batch["tokens"][:, :128]
        with torch.no_grad():
            want_p, want_c = lm.prefill(toks, cache_len=136)
            got_p, got_c = sharded.prefill(toks, cache_len=136)
            assert tuple(got_c[0].placements) == tuple(
                sharding.placements(sharded.decode_cache_spec(2), mesh))
            outs = [(got_p.full_tensor(), want_p)]
            for i in range(4):
                tok = want_p.argmax(-1, keepdim=True)
                want_p, want_c = lm.decode_step(want_c, tok, 128 + i)
                got_p, got_c = sharded.decode_step(got_c, tok, 128 + i)
                outs.append((got_p.full_tensor(), want_p))
        for got, want in outs:
            assert float((got - want).abs().max()) \
                <= 1e-4 * float(want.abs().max())
        opt = AdamW(lr=1e-3)
        # AdamW on the same gradients: the sharded update, written through
        # the DTensors' local blocks, is the plain one but for the order in
        # which the clip's global norm sums
        grads = torch.autograd.grad(lm.loss(batch)[0], list(lm.parameters()))
        same = []
        for model, gs in ((lm, grads), (sharded, [
                sharding.local_block(g, p.device_mesh, p.placements)
                for g, p in zip(grads, sharded.parameters())])):
            ps = [p.detach().clone() for p in model.parameters()]
            st = opt.step(ps, gs, opt.init(ps))
            same.append(ps + st.mu + st.nu)
        for a, b in zip(*same):
            assert float((b.full_tensor() - a).abs().max()) \
                <= 1e-6 * float(a.abs().max())
        del grads, same
        res = []
        for model in (lm, sharded):
            ps = list(model.parameters())
            before = ops.LAUNCHES["flash_attention"]
            _, st, met = make_train_step(model, opt)(ps, opt.init(ps), batch)
            torch.cuda.synchronize()
            res.append((met["loss"].item(), st,
                        ops.LAUNCHES["flash_attention"] - before))
        (loss, st, n), (sloss, sst, sn) = res
        assert n == sn == 2 * lm.cfg.n_layers
        assert abs(sloss - loss) <= 1e-5 * loss
        for a, b in zip(sst.mu + sst.nu, st.mu + st.nu):
            assert float((a.full_tensor() - b).abs().max()) \
                <= 1e-4 * float(b.abs().max())
        # each step's own update: the parameters to 2e-5 where the clipped
        # |g| is at least 100 eps (a first Adam step moves an entry by
        # lr g / (|g| + eps): nearer eps a last-bit difference of the
        # gradients moves it by up to 2 lr)
        for a, b, m in zip(sharded.parameters(), lm.parameters(), st.mu):
            far = m.abs() / (1 - opt.b1) >= 100 * opt.eps
            diff = (a.full_tensor() - b.detach()).abs()[far]
            assert diff.numel() == 0 or float(diff.max()) <= 2e-5
        g = st.mu[0] * 10
        assert torch.equal(compression.compressed_psum(g),
                           compression.dequantize(*compression.quantize(g)))
        x = torch.randn(4, 2, 8, device=cuda)
        w = torch.randn(1, 8, 8, device=cuda)
        assert torch.equal(pipeline.gpipe_apply(
            lambda w, x: torch.tanh(x @ w), w, x), torch.tanh(x @ w[0]))


def test_moe_sharded_one_nccl_rank(cuda):
    """The reduced arctic-480b (f32 compute) as one NCCL rank on a (1, 1)
    ("data", "model") mesh: the experts placed on tp and D on dp; the
    loss, aux and gradients equal the unsharded model's to 1e-5 / 1e-4 of
    each largest entry, the routing (top experts, kept assignments) is
    the same, and prefill plus 4 decode steps give its logits to 1e-4."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM, layers, sharding
    cfg = dataclasses.replace(configs.get("arctic-480b").make_reduced(),
                              compute_dtype=torch.float32,
                              capacity_factor=0.5)
    lm = LM(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 32), device=cuda,
                           generator=gen)
    batch = {"tokens": tokens, "targets": tokens.roll(1, 1)}
    routes = []
    real = layers._moe_dispatch

    def keep(xf, router, c):
        out = real(xf, router, c)
        routes.append(out[1].clone())
        return out
    with dist.process_group(cuda):
        mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
        sharded = LM(cfg, device=cuda, init=False)
        sharded.load_state_dict({k: t.clone() for k, t in
                                 lm.state_dict().items()})
        sharding.shard_lm(sharded, mesh)
        assert sharded.blocks[0].moe.w_up.placements == tuple(
            sharding.placements(("model", ("data",), None), mesh))
        res = []
        layers._moe_dispatch = keep
        try:
            for model in (lm, sharded):
                loss, met = model.loss(batch)
                grads = torch.autograd.grad(loss, list(model.parameters()))
                res.append((loss.item(), met["aux"].item(), grads))
        finally:
            layers._moe_dispatch = real
        (loss, aux, grads), (sloss, saux, sgrads) = res
        assert abs(sloss - loss) <= 1e-5 * loss
        assert abs(saux - aux) <= 1e-5 * aux
        for a, b in zip(sgrads, grads):
            assert float((a.full_tensor() - b).abs().max()) \
                <= 1e-4 * float(b.abs().max())
        half = len(routes) // 2
        assert half == cfg.n_layers and not all(bool(k.all())
                                                for k in routes)
        for a, b in zip(routes[:half], routes[half:]):
            assert torch.equal(a, b)
        with torch.no_grad():
            want, wc = lm.prefill(tokens[:, :16], cache_len=24)
            got, gc = sharded.prefill(tokens[:, :16], cache_len=24)
            outs = [(got.full_tensor(), want)]
            for i in range(4):
                tok = tokens[:, 16 + i:17 + i]
                want, wc = lm.decode_step(wc, tok, 16 + i)
                got, gc = sharded.decode_step(gc, tok, 16 + i)
                outs.append((got.full_tensor(), want))
        for got, want in outs:
            assert float((got - want).abs().max()) \
                <= 1e-4 * float(want.abs().max())


def test_recsys_collective_one_nccl_rank(cuda):
    """The reduced wide-deep with the collective lookup as one NCCL rank
    on a (1, 1) mesh: the tables row-sharded over "model"; the logits,
    one HybridAdamW step and the retrieval top-100 equal the unsharded
    model's (1e-6 relative, 2e-5 absolute, indices equal)."""
    from repro_torch import configs
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recsys
    from repro_torch.optim import AdamW, HybridAdamW
    cfg = configs.get("wide-deep").make_reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    plain = recsys.WideDeep(cfg, device=cuda, generator=gen)
    ids = torch.stack([torch.randint(0, v, (64, cfg.ids_per_field),
                                     device=cuda) for v in cfg.vocab_sizes],
                      1).to(torch.int32)
    batch = {"dense": torch.randn(64, cfg.n_dense, device=cuda),
             "sparse_ids": ids,
             "labels": torch.randint(0, 2, (64,), device=cuda).float()}
    query = {"dense": batch["dense"][:1], "sparse_ids": ids[:1],
             "candidates": torch.randn(4096, cfg.retrieval_dim,
                                       device=cuda)}
    with dist.process_group(cuda):
        mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
        sharded = recsys.WideDeep(cfg, "collective", device=cuda,
                                  init=False)
        sharded.load_state_dict({k: t.clone() for k, t in
                                 plain.state_dict().items()})
        sharded.shard(mesh)
        with torch.no_grad():
            want, got = plain(batch), sharded(batch).full_tensor()
            assert float((got - want).abs().max()) \
                <= 1e-6 * float(want.abs().max())
            wv, wi = plain.retrieval_scores(query)
            gv, gi = sharded.retrieval_scores(query)
            assert torch.equal(gi, wi)
            assert float((gv - wv).abs().max()) <= 1e-6 * float(
                wv.abs().max())
        opt = HybridAdamW(adamw=AdamW(lr=1e-3))
        for model in (plain, sharded):
            params = model.params()
            recsys.make_recsys_train_step(model, opt)(
                params, opt.init(params), batch)
        for (n, a), b in zip(sharded.params().items(),
                             plain.params().values()):
            assert float((a.full_tensor() - b.detach()).abs().max()) \
                <= 2e-5, n


def test_gnn_edge_sharded_one_nccl_rank(cuda):
    """MeshGraphNet's reduced config on a large graph as one NCCL rank on
    a (1, 1) mesh with ``gnn_edge_dp`` ("data", "model"): the sharded
    cell's step launches ``segment_rows`` on the rank's edge block and
    gives the unsharded cell's loss (1e-5) and parameters (2e-5)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import distributed as dist
    from repro_torch.launch import cells, perf_flags
    from repro_torch.launch.mesh import make_mesh
    spec = configs.get("meshgraphnet")
    cfg = spec.make_reduced()
    cell = ShapeCell("minibatch", "train", dict(n_nodes=3000, n_edges=9000,
                                                d_feat=16, classes=5))
    gen = torch.Generator(device=cuda).manual_seed(2)
    n, m = 3072, 9216
    batch = {"feats": torch.randn(n, 16, device=cuda, generator=gen),
             "pos": torch.randn(n, 3, device=cuda, generator=gen),
             "edge_src": torch.randint(0, 3000, (m,), device=cuda,
                                       generator=gen).to(torch.int32),
             "edge_dst": torch.randint(0, 3000, (m,), device=cuda,
                                       generator=gen).to(torch.int32),
             "labels": torch.randint(0, 5, (n,), device=cuda,
                                     generator=gen).to(torch.int32)}
    perf_flags.reset()
    perf_flags.FLAGS.gnn_edge_dp = ("data", "model")
    try:
        res = []
        with dist.process_group(cuda):
            mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
            for msh in (None, mesh):
                build = cells._build_gnn(spec, dataclasses.replace(cfg),
                                         cell, cuda, msh)
                params, st, _ = build.abstract_args
                before = ops.LAUNCHES["segment_sum"]
                _, _, met = build.fn(params, st, batch)
                torch.cuda.synchronize()
                res.append((met["loss"].item(), params,
                            ops.LAUNCHES["segment_sum"] - before))
    finally:
        perf_flags.reset()
    (loss, ps, n_plain), (sloss, sps, n_sharded) = res
    assert n_sharded == n_plain == cfg.n_layers
    assert abs(sloss - loss) <= 1e-5 * loss
    for a, b in zip(sps, ps):
        assert float((a - b).abs().max()) <= 2e-5
