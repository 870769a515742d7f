"""Card-only tests of the PyTorch port: every Hopper kernel against its
plain PyTorch version on the same CUDA tensors (bit for bit: all outputs
are int32 or bool), and the engine on the card against the engine on the
CPU.  They skip where no CUDA device is present; on a machine with one
run them with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no ``jax``, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan
from repro_torch.graphs import generators as G
from repro_torch.kernels import ops, ref
from repro_torch.kernels import first_live_scan as fls
from repro_torch.kernels import frontier_compact as fc

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
