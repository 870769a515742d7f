"""Card-only tests of the PyTorch port: every Hopper kernel against its
plain PyTorch version on the same CUDA tensors (bit for bit where the
outputs are int32 or bool; the flash attention kernel to a stated float
tolerance; the segment sum, whose float atomics add in another order, to
1e-5 of each segment's sum of absolute values), the engines on the card
against the engines on the CPU, the LM's prefill (through the flash
kernel) against its decode, a GNN training step on the card against
the same step on the CPU, the static checks' copy kernel against
``x.clone()``, and every captured launch record against the grid and
block the profiler sees.  They skip where no CUDA device is present; on a machine with one
run them with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no ``jax``, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan, plan_peel, plan_reach, plan_stream
from repro_torch.core.scc import scc_decompose
from repro_torch.graphs import generators as G
from repro_torch.kernels import bucket_peel as bpl
from repro_torch.kernels import counter_scatter as cs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import first_live_scan as fls
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import frontier_compact as fc
from repro_torch.kernels import frontier_expand as fex
from repro_torch.kernels import segment_sum as ss

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _eq(a, b):
    return torch.equal(a.cpu(), b.cpu())


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


@pytest.mark.parametrize("n,cap", [(1, 1), (700, 16), (4097, 64),
                                   (4097, 8192), (100_000, 1024)])
@pytest.mark.parametrize("fill", ["none", "some", "all"])
def test_frontier_compact_kernel(cuda, n, cap, fill):
    rng = np.random.default_rng(n + cap)
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "some": rng.random(n) < 0.01}[fill]
    mask = torch.as_tensor(mask, device=cuda)
    ids, count = fc.frontier_compact(mask, cap)
    wids, wcount = ref.frontier_compact_ref(mask, cap)
    torch.cuda.synchronize()
    assert _eq(ids, wids) and int(count) == int(wcount)


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
    for name in ("first_live_scan", "frontier_compact", "sparse_expand",
                 "prefix_positions"):
        assert ops.LAUNCHES[name] > before[name], name


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


def _segment_close(got, values, ids, n):
    """|kernel - plain| <= 1e-5 * (sum of |v| in the segment) + 1e-6: f32
    atomics add in an order that changes from run to run."""
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


@pytest.mark.parametrize("n", [0, 1, 255, 1000, 4097, 1 << 20])
@pytest.mark.parametrize("block", [16, 256, 1024])
@pytest.mark.parametrize("carry", [False, True])
def test_mutant_copy_kernel(cuda, n, block, carry):
    """The static checks' copy kernel equals x.clone() (x + the carry
    word) bit for bit, ragged tails included."""
    from repro_torch.kernels import mutant_copy as mc
    x = torch.as_tensor(np.random.default_rng(n).integers(
        -2**31, 2**31 - 1, n), dtype=torch.int32, device=cuda)
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

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.capture import profiled_launches
    from repro_torch.analysis.catalog import (KERNEL_CATALOG,
                                              LAUNCH_DECLARATIONS)
    want, points = [], []
    for entry in KERNEL_CATALOG:
        for point in entry.points:
            want += [(w.kernel, tuple(w.grid), tuple(w.block))
                     for w in entry.build(point)]
            points.append((entry, point))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for entry, point in points:
            entry.run(point, cuda)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    got = profiled_launches(json.loads((tmp_path / "trace.json")
                                       .read_text()),
                            {k for _, k in LAUNCH_DECLARATIONS})
    assert got == want
    assert {k for k, _, _ in got} == {k for _, k in LAUNCH_DECLARATIONS}
