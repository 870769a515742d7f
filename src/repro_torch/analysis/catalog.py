"""The port's analysis subjects: which kernels and plans exist, at which
pinned shapes they are checked, and what each CUDA kernel declares about
the output it writes.

**Shape lattice.**  The race detector sweeps each launch's blocks
concretely, so its guarantee is per lattice point, not universal.  The
points exercise every structural regime of each wrapper: one block, many
blocks, padded grids (a size that is not a multiple of a block's
extent), the aligned and unaligned (or W != 16) kernel variants, and for
flash attention GQA, both causal modes and Sq != Sk.

**Declarations.**  ``LAUNCH_DECLARATIONS`` maps each ``__global__``
kernel, keyed by ``(library, kernel)``, to what it writes: per output, the
map from a CUDA block index to the output block it writes and that
block's extent, and how it writes it —

* ``owned``: each block writes its own slice.  Every rule applies:
  bounds, no revisit, injectivity, coverage.
* ``atomic``: blocks add into shared addresses with atomics; revisits are
  legal and injectivity is skipped, bounds and coverage still hold.
* ``data-dependent``: the slot a thread writes comes from a scan; the
  capacity guard that keeps it in bounds is declared (``guard``).

and whether the launch uses cross-block scratch.  CUDA blocks run in no
order, so scratch shared across a launch's blocks is sound only under an
ordered protocol, which none of the port's kernels has: the reference's
sequential SMEM carry (``frontier_compact._scan_kernel``) became three
launches (``tile_reduce``, ``scan_tile_sums``, ``tile_scan``).  The
detector trusts declarations only structurally, and a launched kernel
without one is an error (``unregistered-kernel``).

**Plans.**  ``PLAN_CATALOG`` holds the reference's 23 ``family/variant``
runner configurations (``src/repro/analysis/catalog.py``).  Each
``build()`` plans the port's engine on a tiny CPU graph, warms it (its
caches built), and returns ``(thunk, arrays)``: one call of the thunk is
one run to the fixpoint, and ``arrays`` are the graph arrays handed to the
plan.  Each entry states its host-sync budget: ``per_round`` syncs a
round plus the probe loops' tests plus ``constant`` (``analysis.syncs``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

from ..kernels import _build
from .capture import capture_kernel

# Pinned plan shapes: small enough to run every variant in well under a
# second, large enough that the sparse rounds, the window overflow and
# several peel buckets occur.
PLAN_N = 64
PLAN_M = 256
PLAN_WORKERS = 4
PLAN_WINDOW = 16
PLAN_UPDATE_W = 8
PLAN_INS_CAP = 64

#: csrc/flash_attention.cu TQ: q rows per block
FLASH_ROWS = 64

class OutputDecl(NamedTuple):
    """How a kernel writes one output.

    mode:   "owned", "atomic" or "data-dependent".
    extent: ``(launch, shape) -> block extent per dimension``.
    index:  ``(launch, shape, (bx, by, bz)) -> output block index``.
    guard:  for ``data-dependent``: the guard that keeps each write in
            bounds.
    """

    mode: str
    extent: Callable
    index: Callable
    guard: str = ""


class LaunchDecl(NamedTuple):
    """What a ``__global__`` kernel declares: its outputs by name, whether
    it uses cross-block scratch, and the ordered protocol that would make
    such scratch sound (none of the port's kernels has one)."""

    outputs: dict
    scratch: bool = False
    ordered: str = ""


def rows(per_thread: int = 1) -> OutputDecl:
    """A 1-D output whose thread ``t`` of block ``b`` writes element(s)
    ``(b * threads + t) * per_thread + j``: block b owns ``per_thread *
    threads`` consecutive elements."""
    return OutputDecl("owned", lambda launch, shape: (per_thread
                                                      * launch.block[0],),
                      lambda launch, shape, b: (b[0],))


def tile(elems: int) -> OutputDecl:
    """A 1-D output of which block b owns elements ``[b * elems, (b + 1) *
    elems)`` whatever its thread count."""
    return OutputDecl("owned", lambda launch, shape: (elems,),
                      lambda launch, shape, b: (b[0],))


def whole(mode: str = "owned", guard: str = "") -> OutputDecl:
    """Every block writes anywhere in the output: one block for ``owned``
    (a one-block launch), any number for ``atomic`` or ``data-dependent``."""
    return OutputDecl(mode, lambda launch, shape: tuple(shape) or (1,),
                      lambda launch, shape, b: (0,) * max(len(shape), 1),
                      guard)


def _flash_extent(launch, shape):
    return (1, 1, FLASH_ROWS, shape[3])


def _flash_index(launch, shape, b):
    # flash_fwd decodes its 1-D grid: bh = x % (B Hq), q tile = nqt - 1 -
    # x / (B Hq) (heaviest causal tiles first)
    bh_count = shape[0] * shape[1]
    nqt = -(-shape[2] // FLASH_ROWS)
    bh = b[0] % bh_count
    return (bh // shape[1], bh % shape[1], nqt - 1 - b[0] // bh_count, 0)


LAUNCH_DECLARATIONS: dict[tuple[str, str], LaunchDecl] = {
    # one thread per row
    ("first_live_scan", "first_live_w16"): LaunchDecl(
        {"first": rows(), "found": rows()}),
    ("first_live_scan", "first_live_any"): LaunchDecl(
        {"first": rows(), "found": rows()}),
    ("frontier_expand", "frontier_expand_vec16"): LaunchDecl(
        {"hit": rows()}),
    ("frontier_expand", "frontier_expand_any"): LaunchDecl({"hit": rows()}),
    # one thread per quad of vertices (the n % 4 tail in the thread after
    # the last quad), or per vertex unaligned
    ("bucket_peel", "bucket_peel_vec4"): LaunchDecl({"out": rows(4)}),
    ("bucket_peel", "bucket_peel_scalar"): LaunchDecl({"out": rows()}),
    ("counter_scatter", "deaths_vec4"): LaunchDecl({"dead": rows(4)}),
    ("counter_scatter", "deaths_scalar"): LaunchDecl({"dead": rows()}),
    # sound: int32 atomicAdd into a copy of the counters is exact in any
    # order, and out-of-range sources add nothing
    ("counter_scatter", "scatter_updates"): LaunchDecl(
        {"out": whole("atomic")}),
    # the prefix scan: every tile sums itself, one block scans the sums in
    # place, every tile scans itself from its offset
    ("frontier_compact", "tile_reduce"): LaunchDecl({"sums": tile(1)}),
    ("frontier_compact", "scan_tile_sums"): LaunchDecl(
        {"sums": whole(), "total": whole()}),
    ("frontier_compact", "tile_scan"): LaunchDecl(
        {"out": tile(_build.SCAN_TILE)}),
    # sound: member i writes slot pos[i], an exclusive prefix sum, so the
    # member slots are distinct, and the sentinel fill writes only slots
    # t >= count, which no member takes
    ("frontier_compact", "compact_fill"): LaunchDecl(
        {"ids": whole("data-dependent",
                      guard="a member writes ids[pos[i]] only where "
                            "pos[i] < capacity; thread t < capacity fills "
                            "slot t only where t >= count")}),
    ("frontier_compact", "expand_rows"): LaunchDecl(
        {"row_base": rows(), "deg": rows()}),
    # thread e writes slot e; only the values come from the scan
    ("frontier_compact", "expand_slots"): LaunchDecl(
        {"src": rows(), "tgt": rows(), "pos": rows(), "valid": rows()}),
    ("flash_attention", "flash_fwd"): LaunchDecl(
        {"out": OutputDecl("owned", _flash_extent, _flash_index)}),
    # sound: float atomicAdd into an output the entry point zeroes first;
    # out-of-range ids add nothing
    ("segment_sum", "scatter_rows"): LaunchDecl({"out": whole("atomic")}),
}


@dataclass
class KernelEntry:
    """One kernel wrapper plus its shape lattice.

    call(point, device) gives ``(wrapper, args, kwargs)`` for that lattice
    point: meta tensors on ``"meta"``, zero-filled ones elsewhere (zeros
    are valid input to every wrapper).  ``build(point)`` runs the real
    wrapper on the meta tensors and returns every launch record it made
    (``analysis.capture``); ``run(point, device)`` launches it for real.
    """

    name: str
    points: tuple
    call: Callable[[dict, str], tuple]

    def build(self, point: dict) -> list:
        fn, args, kwargs = self.call(point, "meta")
        return capture_kernel(fn, *args, **kwargs)

    def run(self, point: dict, device):
        fn, args, kwargs = self.call(point, device)
        return fn(*args, **kwargs)


def tensor(shape, dtype: str = "bool", offset: int = 0, device="meta"):
    """A tensor of ``shape`` on ``device``: empty on "meta", zeros
    elsewhere; ``offset`` > 0 makes it a view that many elements into a
    larger one (an unaligned ``data_ptr()``)."""
    import torch
    dt = getattr(torch, dtype)
    if isinstance(shape, int):
        shape = (shape,)
    make = torch.empty if str(device) == "meta" else torch.zeros
    flat = make((math.prod(shape) + offset,), dtype=dt, device=device)
    return flat[offset:].view(shape)


def _counter_scatter(p: dict, dev) -> tuple:
    from ..kernels.counter_scatter import counter_scatter
    n, b, off = p["n"], p["b"], p.get("offset", 0)
    return counter_scatter, (tensor(n, "int32", off, dev),
                             tensor(n, "bool", off, dev),
                             tensor(b, "int32", 0, dev),
                             tensor(b, "int32", 0, dev)), {}


def _segment_sum(p: dict, dev) -> tuple:
    from ..kernels.segment_sum import segment_sum
    return segment_sum, (tensor((p["m"], p["d"]), "float32", 0, dev),
                         tensor(p["m"], "int32", 0, dev), p["segs"]), {}


def _flash(p: dict, dev) -> tuple:
    from ..kernels.flash_attention import flash_attention
    b, hq, hkv, sq, sk, d = (p[k] for k in ("b", "hq", "hkv", "sq", "sk",
                                            "d"))
    dt = p.get("dtype", "float32")
    return flash_attention, (tensor((b, hq, sq, d), dt, 0, dev),
                             tensor((b, hkv, sk, d), dt, 0, dev),
                             tensor((b, hkv, sk, d), dt, 0, dev)), \
        {"causal": p["causal"]}


def _first_live(p: dict, dev) -> tuple:
    from ..kernels.first_live_scan import first_live_scan
    n, w = p["n"], p["w"]
    return first_live_scan, (tensor((n, w), "bool", 0, dev),
                             tensor((n, w), "bool", 0, dev),
                             tensor(n, "bool", 0, dev)), {}


def _frontier_expand(p: dict, dev) -> tuple:
    from ..kernels.frontier_expand import frontier_expand
    n, w = p["n"], p["w"]
    return frontier_expand, (tensor((n, w), "bool", 0, dev),
                             tensor((n, w), "bool", 0, dev),
                             tensor(n, "bool", 0, dev)), {}


def _bucket_peel(p: dict, dev) -> tuple:
    from ..kernels.bucket_peel import bucket_peel
    n, off = p["n"], p.get("offset", 0)
    return bucket_peel, (tensor(n, "int32", off, dev),
                         tensor(n, "bool", off, dev),
                         tensor(1, "int32", 0, dev)), {}


def _prefix_positions(p: dict, dev) -> tuple:
    from ..kernels.frontier_compact import prefix_positions
    return prefix_positions, (tensor(p["n"], p["dtype"], 0, dev),), {}


def _frontier_compact(p: dict, dev) -> tuple:
    from ..kernels.frontier_compact import frontier_compact
    return frontier_compact, (tensor(p["n"], "bool", 0, dev), p["cap"]), {}


def _sparse_expand(p: dict, dev) -> tuple:
    from ..kernels.frontier_compact import sparse_expand
    n, m, c = p["n"], p["m"], p["c"]
    return sparse_expand, (tensor(n + 1, "int32", 0, dev),
                           tensor(m, "int32", 0, dev),
                           tensor(c, "int32", 0, dev), p["ecap"]), {}


# The reference's nine entry names; the port's segment_sum stands in for
# segment_reduce's segment_sum_pallas.
KERNEL_CATALOG: tuple[KernelEntry, ...] = (
    KernelEntry("counter_scatter", (
        {"n": 200, "b": 8},                   # one block each
        {"n": 2048, "b": 300},                # 2 x 2 blocks, no tail
        {"n": 4099, "b": 600},                # padded, ragged tail
        {"n": 700, "b": 0},                   # empty batch: deaths only
        {"n": 1000, "b": 40, "offset": 1},    # unaligned: deaths_scalar
    ), _counter_scatter),
    KernelEntry("segment_reduce", (
        {"m": 64, "d": 8, "segs": 48},        # one block
        {"m": 512, "d": 4, "segs": 100},      # 2 blocks exactly
        {"m": 1000, "d": 6, "segs": 300},     # padded, d % 4 != 0
    ), _segment_sum),
    KernelEntry("flash_attention", (
        {"b": 2, "hq": 4, "hkv": 2, "sq": 256, "sk": 256, "d": 64,
         "causal": True},                     # GQA, 32 blocks
        {"b": 1, "hq": 2, "hkv": 2, "sq": 32, "sk": 64, "d": 16,
         "causal": False},                    # MHA, sq != sk, one tile
        {"b": 1, "hq": 4, "hkv": 2, "sq": 96, "sk": 96, "d": 32,
         "causal": True},                     # padded q tiles
        {"b": 1, "hq": 2, "hkv": 1, "sq": 256, "sk": 128, "d": 16,
         "causal": True},                     # sq > sk
    ), _flash),
    KernelEntry("first_live_scan", (
        {"n": 200, "w": 16},                  # one block, padded
        {"n": 512, "w": 16},                  # 2 blocks exactly
        {"n": 700, "w": 16},                  # padded
        {"n": 300, "w": 8},                   # first_live_any
    ), _first_live),
    KernelEntry("frontier_expand", (
        {"n": 200, "w": 16},
        {"n": 700, "w": 32},                  # 2 chunks a row
        {"n": 300, "w": 8},                   # frontier_expand_any
        {"n": 513, "w": 17},
    ), _frontier_expand),
    KernelEntry("bucket_peel", (
        {"n": 1001},                          # one block, ragged tail
        {"n": 2048},                          # 2 blocks, no tail
        {"n": 4099},                          # padded, ragged tail
        {"n": 777, "offset": 1},              # unaligned: scalar
    ), _bucket_peel),
    KernelEntry("prefix_positions", (
        {"n": 100, "dtype": "int32"},         # one tile
        {"n": 8192, "dtype": "bool"},         # 2 tiles exactly
        {"n": 10000, "dtype": "int32"},       # padded
    ), _prefix_positions),
    KernelEntry("frontier_compact", (
        {"n": 100, "cap": 32},
        {"n": 5000, "cap": 64},               # n > capacity, 20 blocks
        {"n": 50, "cap": 600},                # capacity > n
    ), _frontier_compact),
    KernelEntry("sparse_expand", (
        {"n": 32, "m": 64, "c": 16, "ecap": 64},
        {"n": 1000, "m": 4000, "c": 300, "ecap": 1000},
    ), _sparse_expand),
)


# -- plan catalog ----------------------------------------------------------

@dataclass
class PlanEntry:
    """One (family x method x probe x frontier) runner configuration.

    build() returns ``(thunk, arrays)``: the warmed engine's run to the
    fixpoint (its result has ``rounds``) and the arrays handed to it.
    Host-sync budget of one thunk call: ``per_round * rounds`` + the probe
    loops' tests + ``constant``.
    """

    family: str
    variant: str
    build: Callable[[], tuple]
    constant: int
    per_round: int = 1
    tags: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return f"{self.family}/{self.variant}"


def plan_graph(kind: str = "rmat"):
    """The plans' tiny CPU graph.  ``"rmat"``: PLAN_M RMAT edges over
    PLAN_N vertices, of which the last PLAN_N // 4 keep no out-edge of
    their own and form a path instead, so trimming takes a round per path
    vertex and probes run several steps (its hub's in-degree overflows the
    window).  ``"er"``: PLAN_M Erdős-Rényi edges, no in-degree beyond the
    window."""
    import numpy as np

    from ..core.graph import CSRGraph
    from ..graphs import generators as G
    if kind == "er":
        return G.erdos_renyi(n=PLAN_N, m=PLAN_M, seed=1, device="cpu")
    indptr, indices = G.rmat(n_log2=int(math.log2(PLAN_N)), m=PLAN_M,
                             seed=1, device="cpu").to_numpy()
    src = np.repeat(np.arange(PLAN_N), np.diff(indptr))
    tail = PLAN_N - PLAN_N // 4
    keep = src < tail
    path = np.arange(tail, PLAN_N - 1)
    return CSRGraph.from_edges(
        PLAN_N, np.concatenate([src[keep], path]).astype(np.int32),
        np.concatenate([indices[keep], path + 1]).astype(np.int32),
        device="cpu")


def _arrays(engine):
    g = engine.graph
    out = [g.indptr, g.indices]
    if engine._transpose is not None:
        out += [engine._transpose.indptr, engine._transpose.indices]
    return tuple(out)


def _build_trim(method: str, probe: str, fmode: str):
    def build():
        from ..core.engine import plan
        eng = plan(plan_graph(), method=method, backend=probe,
                   workers=PLAN_WORKERS, window=PLAN_WINDOW,
                   frontier=fmode, device="cpu")
        eng.run()
        return eng.run, _arrays(eng)
    return build


def _build_reach(method: str, fmode: str, overflow: bool):
    def build():
        from ..core.reach import plan_reach
        g = plan_graph("rmat" if overflow or method == "push" else "er")
        eng = plan_reach(g, backend="windowed" if method == "pull"
                         else "dense", window=PLAN_WINDOW, frontier=fmode,
                         device="cpu")
        eng.run(seeds=0)
        if method == "pull" and eng._overflow != overflow:
            raise ValueError(f"the plan graph gives overflow="
                             f"{eng._overflow}, the entry needs {overflow}")
        return (lambda: eng.run(seeds=0)), _arrays(eng)
    return build


def _build_peel(k_stop, fmode: str):
    def build():
        from ..core.peel import plan_peel
        eng = plan_peel(plan_graph(), frontier=fmode, device="cpu")
        eng.run(k=k_stop)
        return (lambda: eng.run(k=k_stop)), _arrays(eng)
    return build


def _build_stream(full: bool, revivable: bool, fmode: str):
    def build():
        import numpy as np

        from ..core.stream import plan_stream
        g = plan_graph()
        eng = plan_stream(g, capacity=PLAN_INS_CAP, frontier=fmode)
        if full:
            return (lambda: eng.retrim(full=True)), _arrays(eng)
        src, dst = eng.delta._src_np, eng.delta._dst_np
        live = eng.status.numpy()
        counters = eng._state[1].numpy()
        # deletions: the one live out-arc of PLAN_UPDATE_W live vertices,
        # so each batch kills and propagates
        sole = np.nonzero(live[src] & live[dst] & (counters[src] == 1))[0]
        dele = sole[:PLAN_UPDATE_W]
        batch = {"deletions": (src[dele], dst[dele])}
        if revivable:
            # insertions: arcs from dead vertices to a live one revive them
            dead = np.nonzero(~live)[0][:PLAN_UPDATE_W]
            target = int(np.nonzero(live)[0][0])
            batch["insertions"] = (dead, np.full(dead.size, target))
        return (lambda: eng.apply(**batch)), _arrays(eng)
    return build


# host syncs of one warmed run beyond ``per_round`` a round and the probe
# loops' tests: the loop test that ends the fixpoint (1), the rounds
# count copied to the device (1), and the stream's revival test (1)
_END = 2


def _plan_catalog() -> tuple[PlanEntry, ...]:
    entries: list[PlanEntry] = []
    trim_axes = [
        ("ac3", "dense", "dense"),
        ("ac3", "windowed", "dense"),
        ("ac4", "dense", "dense"),
        ("ac4", "dense", "sparse"),
        ("ac4*", "dense", "dense"),
        ("ac4*", "dense", "sparse"),
        ("ac6", "dense", "dense"),
        ("ac6", "dense", "sparse"),
        ("ac6", "windowed", "dense"),
    ]
    for method, probe, fmode in trim_axes:
        # AC-3's last round is its loop test: no extra test
        entries.append(PlanEntry(
            "trim", f"{method}[probe={probe},frontier={fmode}]",
            _build_trim(method, probe, fmode),
            constant=_END - (method == "ac3"), tags={"method": method}))
    for fmode in ("dense", "sparse"):
        entries.append(PlanEntry(
            "reach", f"push[frontier={fmode}]",
            _build_reach("push", fmode, overflow=False), constant=_END))
    for overflow in (False, True):
        # the pull body tests the window's overflow once a round
        entries.append(PlanEntry(
            "reach", f"pull[overflow={overflow}]",
            _build_reach("pull", "dense", overflow=overflow),
            constant=_END, per_round=1 + overflow))
    for k_stop in (None, 1):
        for fmode in ("dense", "sparse"):
            entries.append(PlanEntry(
                "peel", f"bucket[k_stop={k_stop},frontier={fmode}]",
                _build_peel(k_stop, fmode), constant=_END))
    for full, revivable in ((True, False), (False, False), (False, True)):
        for fmode in ("dense", "sparse"):
            # apply's rounds are a Python int (no copy); an insertion
            # batch adds the revival test
            entries.append(PlanEntry(
                "stream",
                f"ac4[full={full},revivable={revivable},frontier={fmode}]",
                _build_stream(full, revivable, fmode),
                constant=_END - 1 + revivable))
    return tuple(entries)


PLAN_CATALOG: tuple[PlanEntry, ...] = _plan_catalog()
