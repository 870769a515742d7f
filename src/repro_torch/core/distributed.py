"""Sharded graph trimming over ``torch.distributed`` — PyTorch port of
``src/repro/core/distributed.py``.

The paper's P workers become P ranks of a process group, one device
each; its shared status array becomes a status vector that every rank
re-assembles once per BSP round: an all-gather of each rank's block of
``n/P`` status bytes (AC-3 and AC-6; packed AC-6 gathers ``n/32`` words
of a bitmap), or a reduce-scatter of an (n,) int32 decrement vector
(AC-4's counter decrement).  Per-rank state (scan pointers, affected
sets, traversal counters) never leaves the rank; the collectives play
the role of the paper's atomics.

**The tensor's device decides the transport.**  A rank on
``cuda:LOCAL_RANK`` runs in an NCCL group, a rank on the CPU in a gloo
group (:class:`ShardComm` refuses any other pairing); nothing falls back.
NCCL refuses two ranks on one card, so a machine with one card runs the
sharded backend as one NCCL rank.

Each rank body (:func:`ac3_rank`, :func:`ac6_rank`, :func:`ac4_rank`) is
the reference's ``shard_map`` body as a round loop driven from the host
on this rank's block: one ``ShardComm.any`` a round (an all-reduce of a
flag and its read-back, the loop test, as the dense backend syncs once a
round) plus the probe's micro-step syncs.  The bodies probe with the
plain ``common.probe_first_live``, as the reference's do; AC-4's
per-round decrement is an ``index_add_`` then ``reduce_scatter_sum``
(the reference's ``jax.ops.segment_sum`` then ``psum_scatter``).  At the
end one all-gather of the status blocks and one of the per-rank counters
(and the (R,) stat rows when instrumented) give every rank the
reference's whole result.

Callers go through the engine (``plan(graph, backend="sharded")``, in a
process that has initialised a group: :func:`process_group`, or
``torchrun``) or :func:`trim_distributed`.  :func:`spawn` runs a function
on P gloo ranks of spawned CPU processes (the tests, the example's
``--device cpu``), and :class:`MetaComm` runs one rank's body on the meta
device for the dry-run (``launch.trim --dryrun --backend sharded``).
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode

from .common import probe_first_live, segment_sum

#: the collectives a :class:`ShardComm` counts
OPS = ("all_gather", "reduce_scatter", "any")
#: the stat rows a sharded run records (per rank and round)
STAT_NAMES = ("r_frontier", "r_edges")
#: the process-group backend each device type runs on
BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}
#: seconds :func:`spawn` waits for its ranks, in all
SPAWN_TIMEOUT = 120.0

_I32 = torch.int32


def _collective(new: str, old: str):
    """torch 2.13's name of a collective (``all_gather_single``,
    ``reduce_scatter_single``), or the older one where it is missing;
    both take ``(output, input)``."""
    return getattr(tdist, new, None) or getattr(tdist, old)


# -- the comm layer -------------------------------------------------------------

class ShardComm:
    """The collectives the rank bodies need, over a ``torch.distributed``
    group (the default group unless one is passed), with a count of calls
    and bytes per collective (``counts()``).

    ``all_gather(x)`` concatenates every rank's ``x`` along dim 0 in rank
    order (``jax.lax.all_gather(..., tiled=True)``);
    ``reduce_scatter_sum(x)`` sums ``x`` over the ranks and returns this
    rank's slice of dim 0 (``psum_scatter(..., tiled=True)``); ``any(x)``
    is True when ``x`` has a True on any rank (``pmax`` of a bool), read
    back to the host.  Bytes counted: the gathered buffer of an
    all-gather, the input buffer of a reduce-scatter, 4 for an ``any``.

    ``device`` is where the rank's tensors lie: a CUDA device needs an
    NCCL group, the CPU a gloo group; any other pairing raises.
    """

    def __init__(self, group=None, device=None):
        if not tdist.is_available() or not tdist.is_initialized():
            raise RuntimeError(
                "backend='sharded' needs an initialised torch.distributed "
                "process group: run under torchrun, or enter "
                "repro_torch.core.distributed.process_group(device)")
        self.group = group
        self.size = tdist.get_world_size(group)
        self.rank = tdist.get_rank(group)
        if device is not None:
            dev = torch.device(device)
            want = BACKEND_OF.get(dev.type)
            have = str(tdist.get_backend(group)).lower()
            if want is None or want not in have:
                raise ValueError(
                    f"tensors on {dev} need a {want or 'cuda/cpu'} process "
                    f"group; the group's backend is {have!r}")
        self._reset()

    def _reset(self) -> None:
        self.calls = dict.fromkeys(OPS, 0)
        self.nbytes = dict.fromkeys(OPS, 0)

    def counts(self) -> dict:
        """``{op: (calls, bytes)}`` since the comm was made."""
        return {op: (self.calls[op], self.nbytes[op]) for op in OPS}

    def _count(self, op: str, nbytes: int) -> None:
        self.calls[op] += 1
        self.nbytes[op] += int(nbytes)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = self._all_gather(x.contiguous())
        self._count("all_gather", out.numel() * out.element_size())
        return out

    def reduce_scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.size:
            raise ValueError(f"dim 0 ({x.shape[0]}) is not a multiple of "
                             f"the {self.size} ranks")
        self._count("reduce_scatter", x.numel() * x.element_size())
        return self._reduce_scatter(x.contiguous())

    def any(self, x: torch.Tensor) -> bool:
        self._count("any", 4)
        return self._any(x)

    # -- transport (overridden by MetaComm) ---------------------------------
    def _all_gather(self, x):
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x, group=self.group)
        return out

    def _reduce_scatter(self, x):
        out = torch.empty((x.shape[0] // self.size, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out, x, op=tdist.ReduceOp.SUM, group=self.group)
        return out

    def _any(self, x) -> bool:
        flag = x.any().to(_I32).reshape(1)
        tdist.all_reduce(flag, op=tdist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())                    # host sync: loop test


class MetaComm(ShardComm):
    """Rank 0 of ``size`` on the meta device, for the dry-run: an
    all-gather or reduce-scatter returns an empty meta tensor of the
    right shape, and ``any`` answers from ``go`` (then False), so a body
    runs as many rounds as ``go`` lets it.  Counts as :class:`ShardComm`
    does.  Run the body under :class:`MetaScalars`, which answers the
    probe loop's scalar reads."""

    def __init__(self, size: int, go=()):
        self.group, self.size, self.rank = None, int(size), 0
        self._go = list(go)
        self._reset()

    def _all_gather(self, x):
        return x.new_empty((self.size * x.shape[0], *x.shape[1:]))

    def _reduce_scatter(self, x):
        return x.new_empty((x.shape[0] // self.size, *x.shape[1:]))

    def _any(self, x) -> bool:
        return bool(self._go.pop(0)) if self._go else False


class MetaScalars(TorchDispatchMode):
    """Answers a meta tensor's scalar read (``bool(t)``, ``t.item()``)
    True, False, True, ...: a probe loop on meta tensors takes one
    micro-step."""

    reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten._local_scalar_dense.default
                and args[0].device.type == "meta"):
            self.reads += 1
            return self.reads % 2 == 1
        return func(*args, **(kwargs or {}))


# -- process groups -------------------------------------------------------------

def _bind(device) -> torch.device:
    """``device`` with the local rank's card for CUDA (``LOCAL_RANK``,
    set by torchrun; 0 otherwise), made current."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from .graph import resolve_device
        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def process_group(device="cuda"):
    """The default process group for ranks on ``device``, for the block.

    An already initialised group is used as it is (and kept).  Under
    ``torchrun`` (``WORLD_SIZE`` in the environment) the group is made
    from its ``env://`` rendezvous; otherwise it is a world of one rank
    over a ``FileStore`` in a temporary directory (no network).  The
    backend is NCCL for a CUDA device, bound to ``cuda:LOCAL_RANK`` and
    initialised eagerly, so a card NCCL cannot use raises here; gloo for
    the CPU.  A group made here is destroyed on exit.  Yields the
    device the rank's tensors go on."""
    if tdist.is_initialized():
        yield _bind(device)
        return
    dev = _bind(device)
    backend = BACKEND_OF.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {dev}")
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    tmp = None
    try:
        if "WORLD_SIZE" in os.environ:
            tdist.init_process_group(backend, init_method="env://", **kw)
        else:
            tmp = tempfile.mkdtemp(prefix="repro_pg_")
            store = tdist.FileStore(os.path.join(tmp, "store"), 1)
            tdist.init_process_group(backend, store=store, rank=0,
                                     world_size=1, **kw)
        yield dev
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _spawned(rank, fn, world_size, store_path, args):
    """A spawned rank: join the gloo group, run ``fn``, leave.  The ranks
    share the host's cores, so each takes ``cores // world_size``
    intra-op threads."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    store = tdist.FileStore(store_path, world_size)
    tdist.init_process_group("gloo", store=store, rank=rank,
                             world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        tdist.destroy_process_group()


def spawn(fn, world_size: int, args=(), *,
          store_dir: str | None = None) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` CPU ranks:
    spawned processes in one gloo group over a ``FileStore`` (in
    ``store_dir``, else a temporary directory).  ``fn`` must be importable
    by name.  Joined with :data:`SPAWN_TIMEOUT` seconds in all: a rank
    that raises or a hung collective fails the call, and every rank still
    running is killed."""
    import torch.multiprocessing as mp
    tmp = None
    if store_dir is None:
        store_dir = tmp = tempfile.mkdtemp(prefix="repro_spawn_")
    path = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.start_processes(_spawned, args=(fn, world_size, path, args),
                             nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world_size} spawned ranks did not finish within "
                    f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


# -- partitions -----------------------------------------------------------------

def block_rows(n: int, num_parts: int) -> int:
    """Rows a block: ``ceil(max(n, 1) / P)``, 32-aligned (the packed
    bitmap's word)."""
    nl = math.ceil(max(n, 1) / num_parts)
    return -(-nl // 32) * 32


def _ml_max(indptr: np.ndarray, n: int, nl: int, num_parts: int) -> int:
    """The longest block's edge count (at least 1)."""
    out = 1
    for d in range(num_parts):
        lo, hi = d * nl, min((d + 1) * nl, n)
        if lo < n:
            out = max(out, int(indptr[hi] - indptr[lo]))
    return out


def _block(indptr, indices, n: int, nl: int, ml_max: int, d: int):
    """Block ``d``: (lip (nl+1,), lix (ml_max,)) int32; ``lix`` keeps
    global target ids, ``lip`` is rebased; padded rows have degree 0."""
    lo, hi = d * nl, min((d + 1) * nl, n)
    lip = np.zeros(nl + 1, np.int32)
    lix = np.zeros(ml_max, np.int32)
    if lo < n:
        base = indptr[lo]
        lip[: hi - lo + 1] = indptr[lo: hi + 1] - base
        lip[hi - lo + 1:] = lip[hi - lo]        # padded rows: degree 0
        seg = indices[indptr[lo]: indptr[hi]]
        lix[: len(seg)] = seg
    return lip, lix


def _csr(graph):
    indptr, indices = graph.to_numpy()
    return np.asarray(indptr, np.int64), np.asarray(indices, np.int32)


def build_partition(graph, num_parts: int):
    """Contiguous row partition of a CSR graph, the reference's arrays:
    ``(local_indptr (P, nl+1), local_indices (P, ml_max), n_pad)``, numpy
    int32.  ``nl`` is 32-aligned; ``local_indices`` keeps global vertex
    ids (the status vector is global); padded rows have degree 0."""
    indptr, indices = _csr(graph)
    n = graph.n
    nl = block_rows(n, num_parts)
    ml = _ml_max(indptr, n, nl, num_parts)
    parts = [_block(indptr, indices, n, nl, ml, d) for d in range(num_parts)]
    return (np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts]),
            nl * num_parts)


def rank_partition(graph, num_parts: int, rank: int):
    """Rank ``rank``'s row of :func:`build_partition`: ``(lip, lix,
    n_pad)``, built without the other blocks."""
    indptr, indices = _csr(graph)
    n = graph.n
    nl = block_rows(n, num_parts)
    lip, lix = _block(indptr, indices, n, nl,
                      _ml_max(indptr, n, nl, num_parts), rank)
    return lip, lix, nl * num_parts


def build_ac4_sharded(graph, num_parts: int, transpose=None,
                      rank: int | None = None):
    """AC-4's sharded operands, the reference's arrays: the Gᵀ partition
    and the out-degree counters of each block, ``((ltip, ltix, deg_out),
    n_pad)``, numpy int32 of shapes (P, nl+1), (P, ml_max), (P, nl) — or
    rank ``rank``'s rows only.  ``transpose`` is Gᵀ when the caller holds
    it (the reference builds it here)."""
    gt = graph.transpose() if transpose is None else transpose
    indptr = np.asarray(graph.to_numpy()[0], np.int64)
    n = graph.n
    nl = block_rows(n, num_parts)
    n_pad = nl * num_parts
    deg_out = np.zeros(n_pad, np.int32)
    deg_out[:n] = np.diff(indptr)
    deg_out = deg_out.reshape(num_parts, nl)
    if rank is None:
        ltip, ltix, _ = build_partition(gt, num_parts)
        return (ltip, ltix, deg_out), n_pad
    ltip, ltix, _ = rank_partition(gt, num_parts, rank)
    return (ltip, ltix, deg_out[rank].copy()), n_pad


# -- packed status words -------------------------------------------------------

_SHIFTS = {}


def _shifts(device) -> torch.Tensor:
    key = str(device)
    if key not in _SHIFTS:
        _SHIFTS[key] = torch.arange(32, dtype=torch.int64, device=device)
    return _SHIFTS[key]


def _pack_bits(status: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (n/32,) int32 words, bit j of word w = status[32w + j]:
    the reference's uint32 bitmap bit for bit (``.view(np.uint32)``).
    Built in int64 and bit-cast to int32, the type gloo carries."""
    b = status.reshape(-1, 32).to(torch.int64)
    words = (b << _shifts(status.device)).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(_I32)


def _unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_bits`: (w,) int32 words -> (32 w,) bool."""
    w = packed.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, None] >> _shifts(packed.device)) & 1).ne(0).reshape(-1)


# -- the rank bodies ------------------------------------------------------------

def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=_I32, device=device)


def ac6_rank(comm: ShardComm, lip, lix, act, *, packed: bool = False,
             stats=None):
    """AC-6 on this rank's block (the reference's ``_ac6_body``, or with
    ``packed`` its ``_ac6_body_packed``, which exchanges the bitmap).
    ``stats``: a :class:`~repro_torch.obs.RoundBuffers` over
    :data:`STAT_NAMES`, or None.  Returns ``(status_l, edges, rounds,
    max_qp)``: (nl,) bool, 0-d int32, int, 0-d int32."""
    dev = lip.device
    nl = lip.shape[0] - 1
    deg = lip[1:] - lip[:-1]
    has_deg = deg > 0
    last = max(lix.shape[0] - 1, 0)
    if packed:
        def exchange(s):
            return _unpack_bits(comm.all_gather(_pack_bits(s)))
    else:
        exchange = comm.all_gather
    status_l, status_g, affected = act, exchange(act), act
    ptr = torch.full((nl,), -1, dtype=_I32, device=dev)
    edges, max_qp, rounds, go = _zero(dev), _zero(dev), 0, True
    while go:
        found, pos, probes = probe_first_live(status_g, lip, lix, ptr + 1,
                                              affected)
        frontier = affected & ~found
        status_l = status_l & ~frontier
        ptr = torch.where(affected, torch.where(found, pos, deg), ptr)
        status_g = exchange(status_l)
        supp = lix[(lip[:-1] + ptr).clamp_(0, last)]
        affected = status_l & ~status_g[supp] & has_deg
        go = comm.any(affected)
        r_frontier = frontier.sum(dtype=_I32)
        r_edges = probes.sum(dtype=_I32)
        if stats is not None:
            stats.record(rounds, r_frontier=r_frontier, r_edges=r_edges)
        rounds += 1
        edges = edges + r_edges
        max_qp = torch.maximum(max_qp, r_frontier)
    return status_l, edges, rounds, max_qp


def ac3_rank(comm: ShardComm, lip, lix, act, *, stats=None):
    """AC-3 on this rank's block (the reference's ``_ac3_body``): every
    live row re-probes from its pointer each round.  Returns as
    :func:`ac6_rank`."""
    dev = lip.device
    nl = lip.shape[0] - 1
    deg = lip[1:] - lip[:-1]
    status_l, status_g = act, comm.all_gather(act)
    ptr = torch.zeros((nl,), dtype=_I32, device=dev)
    edges, max_qp, rounds, go = _zero(dev), _zero(dev), 0, True
    while go:
        found, pos, probes = probe_first_live(status_g, lip, lix, ptr,
                                              status_l)
        frontier = status_l & ~found
        ptr = torch.where(status_l, torch.where(found, pos, deg), ptr)
        status_l = status_l & found
        status_g = comm.all_gather(status_l)
        go = comm.any(frontier)
        r_frontier = frontier.sum(dtype=_I32)
        r_edges = probes.sum(dtype=_I32)
        if stats is not None:
            stats.record(rounds, r_frontier=r_frontier, r_edges=r_edges)
        rounds += 1
        edges = edges + r_edges
        max_qp = torch.maximum(max_qp, r_frontier)
    return status_l, edges, rounds, max_qp


def ac4_rank(comm: ShardComm, ltip, ltix, deg_out_l, *, stats=None):
    """AC-4 on this rank's block of Gᵀ (the reference's
    ``build_ac4_sharded`` body): each round the dying vertices' Gᵀ edges
    are summed per target into an (n_pad,) int32 vector (``index_add_``)
    that a reduce-scatter hands back block by block.  ``edges`` counts
    the Gᵀ entries the frontier scanned (its in-degrees), as the
    reference's body does.  Returns as :func:`ac6_rank`."""
    dev = ltip.device
    nl = ltip.shape[0] - 1
    deg_in = ltip[1:] - ltip[:-1]
    n_pad = nl * comm.size
    mlt = ltix.shape[0]
    # each local edge's row: +1 at every row start, cumsum; a start at
    # mlt (empty trailing rows) lands in a dropped extra slot
    starts = ltip[1:-1].to(torch.int64)
    marks = torch.zeros((mlt + 1,), dtype=_I32, device=dev).index_add_(
        0, starts, torch.ones_like(starts, dtype=_I32))[:mlt]
    lrows = torch.cumsum(marks, dim=0)
    valid = torch.arange(mlt, device=dev) < ltip[nl]
    # padding vertices have deg_out 0 -> they die in round 0 but have no
    # Gᵀ edges, so they are inert
    frontier = deg_out_l == 0
    status_l = ~frontier
    counters = deg_out_l.to(_I32)
    go = comm.any(frontier)
    edges, rounds = _zero(dev), 0
    max_qp = frontier.sum(dtype=_I32)
    while go:
        contrib = torch.where(valid, frontier[lrows].to(_I32), 0)
        dec_local = comm.reduce_scatter_sum(segment_sum(contrib, ltix, n_pad))
        counters = counters - dec_local
        newly = status_l & (counters <= 0)
        status_l = status_l & ~newly
        go = comm.any(newly)
        round_edges = torch.where(frontier, deg_in, 0).sum(dtype=_I32)
        if stats is not None:
            stats.record(rounds, r_frontier=frontier.sum(dtype=_I32),
                         r_edges=round_edges)
        rounds += 1
        edges = edges + round_edges
        max_qp = torch.maximum(max_qp, newly.sum(dtype=_I32))
        frontier = newly
    return status_l, edges, rounds, max_qp


def _stat_rows(stats, device) -> torch.Tensor:
    """A finished run's (len(STAT_NAMES), R) int32 rows on ``device``."""
    dev, host = stats.finish()
    return torch.stack([
        (dev[k] if k in dev else torch.zeros(stats.max_rounds, dtype=_I32,
                                             device=device))
        + torch.as_tensor(host[k], device=device).to(_I32)
        for k in STAT_NAMES])


def run_rank(kind: str, comm: ShardComm, operands, *, packed: bool = False,
             stats=None):
    """Run one rank's body (``kind`` in ``"ac3"``, ``"ac4"``, ``"ac6"``) on
    its ``operands`` — ``(lip, lix, act)``, or AC-4's ``(ltip, ltix,
    deg_out)`` — then gather the whole result onto every rank: ``(status
    (n_pad,) bool, edges (P,) int32, rounds 0-d, max_qp 0-d, stats)``,
    ``stats`` ``{name: (P, R) int32}`` or None."""
    if kind == "ac4":
        status_l, edges, rounds, max_qp = ac4_rank(comm, *operands,
                                                   stats=stats)
    elif kind == "ac6":
        status_l, edges, rounds, max_qp = ac6_rank(
            comm, *operands, packed=packed, stats=stats)
    elif kind == "ac3":
        status_l, edges, rounds, max_qp = ac3_rank(comm, *operands,
                                                   stats=stats)
    else:
        raise ValueError(f"unknown sharded method {kind!r}")
    dev = status_l.device
    ints = [edges.reshape(1), torch.full((1,), rounds, dtype=_I32,
                                         device=dev), max_qp.reshape(1)]
    if stats is not None:
        ints.append(_stat_rows(stats, dev).reshape(-1))
    status = comm.all_gather(status_l)
    rows = comm.all_gather(torch.cat(ints)).reshape(comm.size, -1)
    out_stats = None
    if stats is not None:
        r = stats.max_rounds
        out_stats = {k: rows[:, 3 + i * r: 3 + (i + 1) * r]
                     for i, k in enumerate(STAT_NAMES)}
    return (status, rows[:, 0].contiguous(), rows[:, 1].max(),
            rows[:, 2].max(), out_stats)


def trim_distributed(graph, method: str = "ac6", group=None,
                     device="cuda"):
    """Sharded trimming over ``group`` (default: the default group),
    materialized.  Compatibility shim over a throwaway sharded engine
    (``ac6_packed`` is AC-6 with ``packed=True``); long-lived callers
    hold ``plan(graph, method=..., backend="sharded")`` and reuse it."""
    from .engine import plan
    packed = method == "ac6_packed"
    eng = plan(graph, method="ac6" if packed else method, backend="sharded",
               group=group, packed=packed, unmasked=True, device=device)
    return eng.run().materialize()


__all__ = ["ShardComm", "MetaComm", "MetaScalars", "process_group", "spawn",
           "block_rows", "build_partition", "rank_partition",
           "build_ac4_sharded",
           "ac3_rank", "ac4_rank", "ac6_rank", "run_rank",
           "trim_distributed", "OPS", "STAT_NAMES"]
