"""The port's analysis subjects: which kernels and plans exist, at which
pinned shapes they are checked, and what each CUDA kernel declares about
the output it writes.

**Shape lattice.**  The race detector sweeps each launch's blocks
concretely, so its guarantee is per lattice point, not universal.  The
points exercise every structural regime of each wrapper: one block, many
blocks, padded grids (a size that is not a multiple of a block's
extent), the aligned and unaligned (or W != 16) kernel variants, and for
flash attention both kernels (f32 reaches ``flash_fwd_tf32x3``, bf16
``flash_fwd_wgmma``) at every head width, GQA, both causal modes and
Sq != Sk.

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
ordered protocol, which the declaration names (``ordered``).  Three
kernels have one.  The single-pass forms of the reference's sequential
SMEM carry (``frontier_compact._scan_kernel``), ``scan_lookback``
(``prefix_positions``) and ``compact_lookback`` (``frontier_compact``),
order their blocks by tile tickets and pass the carry by decoupled
look-back; ``expand_lookback`` (``sparse_expand``) scans its degrees in
the same way, and its slot CTAs read the rows its row CTAs published;
``segment_rows`` (``segment_sum``) takes tickets in the same way and
passes a segment's partial sums from CTA to CTA.  All four use one
scratch buffer.  The detector
trusts declarations only structurally, and a launched kernel without one
is an error (``unregistered-kernel``).

**Plans.**  ``PLAN_CATALOG`` holds the reference's 23 ``family/variant``
runner configurations (``src/repro/analysis/catalog.py``).  Each
``build(instrument=False, max_rounds=None)`` plans the port's engine on a
tiny CPU graph, warms it (its caches built), and returns ``(thunk,
arrays)``: one call of the thunk is one run to the fixpoint, and
``arrays`` are the graph arrays handed to the plan.  Each entry states its host-sync budget: ``per_round`` syncs a
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
# several peel buckets occur.  PLAN_MAX_ROUNDS: the round capacity the
# instrument checks plan with (the reference's).
PLAN_N = 64
PLAN_M = 256
PLAN_WORKERS = 4
PLAN_WINDOW = 16
PLAN_UPDATE_W = 8
PLAN_INS_CAP = 64
PLAN_MAX_ROUNDS = 64

#: csrc/flash_attention.cu: q rows per CTA of both flash kernels (WG_ROWS)
FLASH_CTA_ROWS = 128

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
    it uses cross-block scratch, and the ordered protocol that makes such
    scratch sound (``compact_lookback``'s tickets and look-back)."""

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


def flash_out(rows: int) -> OutputDecl:
    """The (B, Hq, Sq, D) output of a flash kernel with ``rows`` q rows a
    block: both kernels decode their 1-D grid as bh = x % (B Hq), q tile =
    nqt - 1 - x / (B Hq) (heaviest causal tiles first), and a block owns
    that tile's rows of one (batch, q head)."""
    def extent(launch, shape):
        return (1, 1, rows, shape[3])

    def index(launch, shape, b):
        bh_count = shape[0] * shape[1]
        nqt = -(-shape[2] // rows)
        bh = b[0] % bh_count
        return (bh // shape[1], bh % shape[1], nqt - 1 - b[0] // bh_count, 0)
    return OutputDecl("owned", extent, index)


def segment_carry() -> OutputDecl:
    """segment_rows' (tickets, 4 lanes) carries: the CTA that takes ticket
    t = y * grid x + x (column chunk y, CTA x of it) owns row t.  Sound
    over block indices for the reason the scan's tiles are: the tickets
    are a permutation of the blocks."""
    return OutputDecl("owned", lambda launch, shape: (1, shape[1]),
                      lambda launch, shape, b: (
                          b[1] * launch.grid[0] + b[0], 0))


LAUNCH_DECLARATIONS: dict[tuple[str, str], LaunchDecl] = {
    # one thread per row
    ("first_live_scan", "first_live_w16"): LaunchDecl(
        {"first": rows(), "found": rows()}),
    ("first_live_scan", "first_live_any"): LaunchDecl(
        {"first": rows(), "found": rows()}),
    ("first_live_scan", "first_live_probe"): LaunchDecl(
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
    # sound: the CTA that takes ticket t scans tile t, and the tickets are
    # a permutation of the blocks, so the sweep over block indices checks
    # the set of tiles written; the carry between tiles passes by
    # look-back as in compact_lookback
    ("frontier_compact", "scan_lookback"): LaunchDecl(
        {"out": tile(_build.SCAN_TILE),
         "total": whole("data-dependent",
                        guard="only the last tile's CTA writes total[0]")},
        scratch=True,
        ordered="tile tickets from an atomic counter (atomicInc, clear "
                "again after the last ticket), then decoupled look-back "
                "over epoch-tagged 64-bit status words (st.relaxed.gpu / "
                "ld.relaxed.gpu), in compact_lookback's scratch buffer: "
                "launches on one stream run in order and each call has its "
                "own epoch"),
    # sound: a CTA takes its tile from a ticket counter, so every tile's
    # predecessors are resident; it writes its members to the slots after
    # their exclusive prefix (distinct across tiles); the sentinel fill
    # writes only slots at or past count, which no member takes
    ("frontier_compact", "compact_lookback"): LaunchDecl(
        {"ids": whole("data-dependent",
                      guard="a member writes ids[excl + rank] only where "
                            "excl + rank < capacity; the fill writes slot s "
                            "only where count <= s < capacity"),
         "count": whole("data-dependent",
                        guard="only the last tile's CTA writes count[0]")},
        scratch=True,
        ordered="tile tickets from an atomic counter (atomicInc, clear "
                "again after the last ticket), then decoupled look-back: "
                "each tile publishes its aggregate and its inclusive prefix "
                "as one self-contained 64-bit epoch-tagged word "
                "(st.relaxed.gpu) and reads its predecessors' words "
                "(ld.relaxed.gpu); fill CTAs hold the tickets after the "
                "last tile and wait for its prefix"),
    # sound: tickets [0, R) are row tiles, each writing its own rows of
    # the call's (C, 2) buffer; the slot CTAs after them take slot tiles of
    # [0, ecap) from an atomic counter, each tile once
    ("frontier_compact", "expand_lookback"): LaunchDecl(
        {**{name: whole("data-dependent",
                        guard="a slot tile k is handed out once, by an "
                              "atomicInc counter (the ticket word's high "
                              "half, clear again after the last grab), and "
                              "only the CTA that takes it writes slots [k "
                              "EXPAND_SLOT_TILE, (k + 1) EXPAND_SLOT_TILE), "
                              "only below ecap; row tickets (< R = ceil(C "
                              "/ EXPAND_ROW_TILE)) write none")
            for name in ("src", "tgt", "pos", "valid")},
         "rows": whole("data-dependent",
                       guard="only the CTA with ticket t < R writes rows "
                             "[t EXPAND_ROW_TILE, (t + 1) EXPAND_ROW_TILE) "
                             "and only below C; slot tickets write none")},
        scratch=True,
        ordered="tickets from an atomic counter (atomicInc, clear again "
                "after the last ticket); row tiles publish their aggregate "
                "and inclusive prefix (st.relaxed.gpu) as scan_lookback "
                "does, the last one the total, then write their rows, "
                "fence, and publish a done word after a barrier (a "
                "release); slot CTAs hold the tickets after every row "
                "tile, poll the total, the prefixes and the done words "
                "they need (ld.relaxed.gpu), fence (an acquire) and read "
                "the rows through L2 (ld.global.cg); compact_lookback's "
                "scratch "
                "buffer: launches on one stream run in order and each call "
                "has its own epoch"),
    ("flash_attention", "flash_fwd_tf32x3"): LaunchDecl(
        {"out": flash_out(FLASH_CTA_ROWS)}),
    ("flash_attention", "flash_fwd_wgmma"): LaunchDecl(
        {"out": flash_out(FLASH_CTA_ROWS)}),
    # a worker of segment_rows writes the output row of each segment whose
    # end lies in its merge-path range (every row once, no atomic), after
    # adding the partial sums of the workers and CTAs before it where the
    # segment began there; its CTA's carry goes to the row of its ticket
    ("segment_sum", "segment_rows"): LaunchDecl(
        {"out": whole("data-dependent",
                      guard="the worker whose range holds segment s's end "
                            "writes out[s] (s < num_segments: the merge "
                            "path has one end per segment), one worker per "
                            "segment and column chunk"),
         "carry": segment_carry()},
        scratch=True,
        ordered="tickets from an atomic counter (atomicInc, clear again "
                "after the last ticket), a CTA per ticket; each CTA writes "
                "its trailing segment's partial sum to carry[ticket], "
                "fences and publishes an epoch-tagged 64-bit status word "
                "(st.relaxed.gpu) before it waits; a worker whose segment "
                "began in an earlier CTA polls the lower tickets' words "
                "(ld.relaxed.gpu), fences and reads their carries "
                "(ld.global.cg), nearest first, in the scratch buffer of "
                "frontier_compact's kernels: launches on one stream run in "
                "order and each call has its own epoch"),
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
    from ..kernels.first_live_scan import first_live_probe, first_live_scan
    n, w = p["n"], p["w"]
    if "m" not in p:
        return first_live_scan, (tensor((n, w), "bool", 0, dev),
                                 tensor((n, w), "bool", 0, dev),
                                 tensor(n, "bool", 0, dev)), {}
    # first_live_probe: zero degrees on "meta", on a card m / n a row
    indptr = tensor(n + 1, "int32", 0, dev)
    if str(dev) != "meta":
        import torch
        indptr = (torch.arange(n + 1, dtype=torch.int32, device=dev)
                  * (p["m"] // n))
    return first_live_probe, (tensor(n, "bool", 0, dev), indptr,
                              tensor(p["m"], "int32", 0, dev),
                              tensor(n, "int32", 0, dev),
                              tensor(n, "bool", 0, dev), w), {}


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
    return prefix_positions, (tensor(p["n"], p["dtype"], p.get("offset", 0),
                                     dev),), {}


def _frontier_compact(p: dict, dev) -> tuple:
    from ..kernels.frontier_compact import frontier_compact
    return frontier_compact, (tensor(p["n"], "bool", p.get("offset", 0),
                                     dev), p["cap"]), {}


def _sparse_expand(p: dict, dev) -> tuple:
    """On a card the degrees follow ``p["deg"]``: "zero" (total 0),
    "even" (m / n a row: total > ecap where the point says so) or "hub"
    (row 0 holds every edge, spread over many slot tiles); ids run over
    the rows and the sentinel n."""
    from ..kernels.frontier_compact import sparse_expand
    n, m, c = p["n"], p["m"], p["c"]
    indptr = tensor(n + 1, "int32", 0, dev)
    ids = tensor(c, "int32", 0, dev)
    if str(dev) != "meta":
        import torch
        rows = torch.arange(n + 1, dtype=torch.int64, device=dev)
        indptr = {"zero": rows * 0, "even": rows * (m // n),
                  "hub": (rows > 0) * m}[p["deg"]].to(torch.int32)
        ids = (torch.arange(c, dtype=torch.int32, device=dev) % (n + 1))
    return sparse_expand, (indptr, tensor(m, "int32", 0, dev), ids,
                           p["ecap"]), {}


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
        {"m": 64, "d": 8, "segs": 48},        # one block, 2 lanes a worker
        {"m": 512, "d": 4, "segs": 100},      # one thread a worker
        {"m": 1000, "d": 6, "segs": 300},     # d % 4 != 0
        # a warp a worker, 33 blocks: each segment's rows cut across
        # blocks, so carries from CTA to CTA
        {"m": 4096, "d": 128, "segs": 3},
        {"m": 300, "d": 1, "segs": 20_000},   # 5 blocks, mostly empty segs
        {"m": 700, "d": 300, "segs": 90},     # 3 column chunks, padded
    ), _segment_sum),
    KernelEntry("flash_attention", (
        # f32: flash_fwd_tf32x3; bf16: flash_fwd_wgmma (128-row tiles each)
        {"b": 2, "hq": 4, "hkv": 2, "sq": 256, "sk": 256, "d": 64,
         "causal": True},                     # GQA, 16 blocks
        {"b": 1, "hq": 2, "hkv": 2, "sq": 32, "sk": 64, "d": 16,
         "causal": False},                    # MHA, sq != sk, one tile
        {"b": 1, "hq": 4, "hkv": 2, "sq": 96, "sk": 96, "d": 32,
         "causal": True},                     # one padded tile
        {"b": 1, "hq": 2, "hkv": 1, "sq": 256, "sk": 128, "d": 16,
         "causal": True},                     # sq > sk
        {"b": 2, "hq": 4, "hkv": 2, "sq": 256, "sk": 256, "d": 128,
         "causal": True, "dtype": "bfloat16"},  # GQA, 16 blocks
        {"b": 1, "hq": 3, "hkv": 1, "sq": 48, "sk": 96, "d": 64,
         "causal": False, "dtype": "bfloat16"},  # one short tile, group 3
        {"b": 1, "hq": 2, "hkv": 1, "sq": 384, "sk": 128, "d": 64,
         "causal": True, "dtype": "bfloat16"},  # sq > sk
        {"b": 1, "hq": 4, "hkv": 2, "sq": 96, "sk": 96, "d": 32,
         "causal": True, "dtype": "bfloat16"},  # one padded tile
        {"b": 2, "hq": 2, "hkv": 1, "sq": 256, "sk": 128, "d": 16,
         "causal": True, "dtype": "bfloat16"},  # sq > sk, 8 blocks
    ), _flash),
    KernelEntry("first_live_scan", (
        {"n": 200, "w": 16},                  # one block, padded
        {"n": 512, "w": 16},                  # 2 blocks exactly
        {"n": 700, "w": 16},                  # padded
        {"n": 300, "w": 8},                   # first_live_any
        # first_live_probe: a thread per row; W < 16, W > 16
        {"n": 700, "w": 16, "m": 2800},
        {"n": 256, "w": 4, "m": 1024},
        {"n": 513, "w": 17, "m": 513 * 20},
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
        {"n": 2 * _build.SCAN_TILE, "dtype": "bool"},  # 2 tiles exactly
        {"n": 20_000, "dtype": "int32"},      # 3 tiles, padded
        {"n": 5000, "dtype": "int32", "offset": 1},  # unaligned: x[1:]
        {"n": _build.SCAN_TILE + 1, "dtype": "bool", "offset": 1},
    ), _prefix_positions),
    KernelEntry("frontier_compact", (
        {"n": 100, "cap": 32},
        {"n": 5000, "cap": 64},               # n > capacity
        {"n": 50, "cap": 600},                # capacity > n
        # 5 tiles, a ragged tail, 2 fill CTAs
        {"n": 4 * _build.COMPACT_TILE + 9, "cap": 9000},
        {"n": 5000, "cap": 64, "offset": 1},  # unaligned: byte loads
    ), _frontier_compact),
    KernelEntry("sparse_expand", (
        # one row tile, one slot tile; total 0
        {"n": 32, "m": 64, "c": 16, "ecap": 64, "deg": "zero"},
        # one row tile, 2 slot tiles, total > ecap
        {"n": 1000, "m": 40_000, "c": 300, "ecap": 5000, "deg": "even"},
        # 3 row tiles, ragged, 2 slot tiles
        {"n": 9000, "m": 9000, "c": 5000, "ecap": 8000, "deg": "even"},
        # a hub row over many slot tiles, a ragged last tile
        {"n": 64, "m": 40_000, "c": 64, "ecap": 36_000, "deg": "hub"},
        # more slot tiles than slot CTAs: each CTA takes several
        {"n": 64, "m": 64, "c": 64, "ecap": 1_100_000, "deg": "even"},
    ), _sparse_expand),
)


# -- plan catalog ----------------------------------------------------------

@dataclass
class PlanEntry:
    """One (family x method x probe x frontier) runner configuration.

    build(instrument=False, max_rounds=None) returns ``(thunk, arrays)``:
    the warmed engine's run to the fixpoint (its result has ``rounds``,
    and ``round_stats`` when instrumented) and the arrays handed to it.
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
    def build(instrument=False, max_rounds=None):
        from ..core.engine import plan
        eng = plan(plan_graph(), method=method, backend=probe,
                   workers=PLAN_WORKERS, window=PLAN_WINDOW,
                   frontier=fmode, instrument=instrument,
                   max_rounds=max_rounds, device="cpu")
        eng.run()
        return eng.run, _arrays(eng)
    return build


def _build_reach(method: str, fmode: str, overflow: bool):
    def build(instrument=False, max_rounds=None):
        from ..core.reach import plan_reach
        g = plan_graph("rmat" if overflow or method == "push" else "er")
        eng = plan_reach(g, backend="windowed" if method == "pull"
                         else "dense", window=PLAN_WINDOW, frontier=fmode,
                         instrument=instrument, max_rounds=max_rounds,
                         device="cpu")
        eng.run(seeds=0)
        if method == "pull" and eng._overflow != overflow:
            raise ValueError(f"the plan graph gives overflow="
                             f"{eng._overflow}, the entry needs {overflow}")
        return (lambda: eng.run(seeds=0)), _arrays(eng)
    return build


def _build_peel(k_stop, fmode: str):
    def build(instrument=False, max_rounds=None):
        from ..core.peel import plan_peel
        eng = plan_peel(plan_graph(), frontier=fmode, instrument=instrument,
                        max_rounds=max_rounds, device="cpu")
        eng.run(k=k_stop)
        return (lambda: eng.run(k=k_stop)), _arrays(eng)
    return build


def _build_stream(full: bool, revivable: bool, fmode: str):
    def build(instrument=False, max_rounds=None):
        import numpy as np

        from ..core.stream import plan_stream
        g = plan_graph()
        eng = plan_stream(g, capacity=PLAN_INS_CAP, frontier=fmode,
                          instrument=instrument, max_rounds=max_rounds)
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
