"""Deterministic synthetic graph generators (paper §9.1 benchmark families)
— numpy copy of ``src/repro/graphs/generators.py`` for the port: for the
same arguments every family gives byte-identical edge arrays.  Each
builder takes ``device`` (default ``"cuda"``) for the CSR it returns.

The paper evaluates on model-checking graphs (BEEM), real social/communication
networks, and three synthetic families generated with SNAP: Erdős-Rényi (ER),
Barabási-Albert (BA), and R-MAT.  We reproduce the synthetic families plus
structural analogues of the paper's other categories:

  chain          α = n (worst case for AC-3, paper §2.4)
  layered_dag    100%-trimmable with controllable α (leader-filters-like)
  sink_heavy     high trim fraction, small α (wikitalk-like)
  er / ba / rmat as in the paper (§9.1, avg degree 8)
"""
from __future__ import annotations

import numpy as np

from ..core.graph import CSRGraph


def edge_dtype(n: int) -> type:
    """int32 when every vertex id fits, int64 otherwise — CSR storage is
    int32 anyway (``CSRGraph.from_edges``), so building edge lists wider
    than needed just doubles host-side memory on every generator family.
    """
    return np.int32 if n <= np.iinfo(np.int32).max else np.int64


def erdos_renyi(n: int, m: int, seed: int = 0,
                simple: bool = False, device="cuda") -> CSRGraph:
    """``simple=True`` strips self-loops and duplicate arcs (so the graph
    is a simple digraph, possibly with fewer than ``m`` edges).  Off by
    default to preserve the historical benchmark baselines; the stream
    benchmark turns it on so deletion batches can never target phantom
    duplicate instances."""
    rng = np.random.default_rng(seed)
    dt = edge_dtype(n)
    src = rng.integers(0, n, m, dtype=dt)
    dst = rng.integers(0, n, m, dtype=dt)
    if simple:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        # first occurrence of each (u, v) key, original order preserved
        # (the key itself needs the full int64 range: n * n overflows int32)
        _, first = np.unique(src.astype(np.int64) * n + dst,
                             return_index=True)
        first.sort()
        src, dst = src[first], dst[first]
    return CSRGraph.from_edges(n, src, dst, device=device)


def barabasi_albert(n: int, deg: int = 8, seed: int = 0,
                    device="cuda") -> CSRGraph:
    """Directed BA: each new vertex sends ``deg`` edges to earlier vertices,
    preferentially by degree (repeated-endpoint trick).  Vertex 0 has no
    outgoing edges, so the whole graph unravels: 100% trimmable (paper
    Table 6, BA row) with α ~ O(n/deg) peeling chains."""
    rng = np.random.default_rng(seed)
    dt = edge_dtype(n)
    # preallocated endpoint pool (list-backed rng.choice is O(n^2) overall)
    pool = np.empty(2 * n * deg + n, dtype=dt)
    pool[0] = 0
    pool_size = 1
    src = np.empty(n * deg, dtype=dt)
    dst = np.empty(n * deg, dtype=dt)
    e = 0
    for v in range(1, n):
        k = min(deg, v)
        targets = pool[rng.integers(0, pool_size, k)]
        src[e:e + k] = v
        dst[e:e + k] = targets
        e += k
        pool[pool_size:pool_size + k] = targets
        pool[pool_size + k] = v
        pool_size += k + 1
    return CSRGraph.from_edges(n, src[:e], dst[:e], device=device)


def rmat(n_log2: int, m: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         device="cuda") -> CSRGraph:
    """R-MAT recursive generator (vectorized bit sampling)."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    dt = edge_dtype(n)
    src = np.zeros(m, dt)
    dst = np.zeros(m, dt)
    for bit in range(n_log2):
        r = rng.random(m)
        quad_b = (r >= a) & (r < a + b)
        quad_c = (r >= a + b) & (r < a + b + c)
        quad_d = r >= a + b + c
        src = src * 2 + (quad_c | quad_d)
        dst = dst * 2 + (quad_b | quad_d)
    return CSRGraph.from_edges(n, src, dst, device=device)


def chain(n: int, device="cuda") -> CSRGraph:
    """v0 -> v1 -> ... -> v_{n-1}: all trimmable, α = n (AC-3 worst case)."""
    dt = edge_dtype(n)
    return CSRGraph.from_edges(n, np.arange(n - 1, dtype=dt),
                               np.arange(1, n, dtype=dt), device=device)


def cycle(n: int, device="cuda") -> CSRGraph:
    """Single n-cycle: nothing trimmable."""
    ids = np.arange(n, dtype=edge_dtype(n))
    return CSRGraph.from_edges(n, ids, (ids + 1) % n, device=device)


def layered_dag(n: int, layers: int, deg: int = 4, seed: int = 0,
                device="cuda") -> CSRGraph:
    """Layered random DAG, edges only layer i -> i+1.  The last layer has no
    outgoing edges, so 100% of vertices are trimmable and α = layers —
    structurally like the paper's BEEM model-checking graphs."""
    rng = np.random.default_rng(seed)
    per = max(n // layers, 1)
    n = per * layers
    dt = edge_dtype(n)
    src, dst = [], []
    for layer in range(layers - 1):
        lo, hi = layer * per, (layer + 1) * per
        s = rng.integers(lo, hi, per * deg, dtype=dt)
        d = rng.integers(hi, hi + per, per * deg, dtype=dt)
        src.append(s)
        dst.append(d)
    return CSRGraph.from_edges(n, np.concatenate(src), np.concatenate(dst),
                               device=device)


def sink_heavy(n: int, m: int, sink_frac: float = 0.5, seed: int = 0,
               device="cuda") -> CSRGraph:
    """A strongly-cyclic core plus a large fringe of (recursive) sinks —
    high trimmable fraction with small α (wikitalk-like, paper Table 6)."""
    rng = np.random.default_rng(seed)
    dt = edge_dtype(n)
    n_core = max(int(n * (1 - sink_frac)), 2)
    # core cycle guarantees the core survives trimming
    core_src = np.arange(n_core, dtype=dt)
    core_dst = (core_src + 1) % n_core
    # fringe edges: from anywhere to anywhere, but fringe vertices only get
    # out-edges with probability ~0.5 (leaving true sinks)
    src = rng.integers(0, n, m, dtype=dt)
    dst = rng.integers(0, n, m, dtype=dt)
    keep = (src < n_core) | (rng.random(m) < 0.5)
    return CSRGraph.from_edges(
        n, np.concatenate([core_src, src[keep]]),
        np.concatenate([core_dst, dst[keep]]), device=device)


BENCHMARK_GRAPHS = {
    # name: (factory, kwargs) — sized for a 1-core CPU container while
    # preserving each family's structural signature from paper Table 6.
    "ER": (erdos_renyi, dict(n=1_000_000, m=8_000_000, seed=1)),
    "BA": (barabasi_albert, dict(n=100_000, deg=8, seed=1)),
    "RMAT": (rmat, dict(n_log2=17, m=1_048_576, seed=1)),
    "chain": (chain, dict(n=20_000)),
    "layered": (layered_dag, dict(n=1_000_000, layers=73, deg=4, seed=1)),
    "sink_heavy": (sink_heavy, dict(n=1_000_000, m=4_000_000,
                                    sink_frac=0.9, seed=1)),
}


def make(name: str, device="cuda") -> CSRGraph:
    fn, kw = BENCHMARK_GRAPHS[name]
    return fn(**kw, device=device)
