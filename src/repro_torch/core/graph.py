"""CSR graph container used by all trimming algorithms (PyTorch port of
``src/repro/core/graph.py``).

``indptr`` (n+1,) and ``indices`` (m,) are int32 torch tensors on one
device.  Construction and transposition are O(n + m) stable counting sorts
on the host (numpy/scipy), the same as the reference, so a graph built
here has byte-identical CSR arrays to the reference's.  ``from_numpy`` /
``to_numpy`` carry a graph across from the JAX package's arrays.
:class:`DeltaCSR` is the stream engine's mutable overlay over a base CSR.

Entry points run on the card unless the caller asks for the CPU:
``device`` defaults to ``"cuda"`` and raises when no card is found.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising if a CUDA device is asked for and
    none is present (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return dev


def check_edge_ids(n: int, src: np.ndarray, dst: np.ndarray):
    """Validate an edge batch: matching lengths, endpoints in [0, n).
    Returns int32 views whenever ``n`` fits (int64 otherwise)."""
    src = np.asarray(src).reshape(-1)
    dst = np.asarray(dst).reshape(-1)
    if not np.issubdtype(src.dtype, np.integer):
        src = src.astype(np.int64)
    if not np.issubdtype(dst.dtype, np.integer):
        dst = dst.astype(np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst length mismatch: {src.shape} vs "
                         f"{dst.shape}")
    bad = int(((src < 0) | (src >= n)).sum() + ((dst < 0) | (dst >= n)).sum())
    if bad:
        raise ValueError(f"{bad} edge endpoint(s) out of range [0, {n})")
    dt = np.int32 if n <= np.iinfo(np.int32).max else np.int64
    return src.astype(dt, copy=False), dst.astype(dt, copy=False)


def _stable_counting_order(src: np.ndarray, n: int) -> np.ndarray:
    """Permutation that stably groups edge ids by source vertex, O(n + m):
    scipy's coo->csr conversion is a counting sort, and the edge id as the
    column key keeps the within-row order the stable input order."""
    m = src.shape[0]
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    try:
        from scipy import sparse
    except ImportError:
        return np.argsort(src, kind="stable")
    csr = sparse.coo_matrix(
        (np.arange(1, m + 1, dtype=np.int64),
         (src, np.arange(m, dtype=np.int64))),
        shape=(n, m)).tocsr()
    return csr.data - 1


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Directed graph in CSR form. ``indptr``: (n+1,), ``indices``: (m,),
    both int32 on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_numpy(indptr, indices, device="cuda") -> "CSRGraph":
        """Carry CSR arrays (e.g. the JAX package's ``to_numpy()``) onto
        ``device`` unchanged."""
        dev = resolve_device(device)

        def tensor(a):
            return torch.from_numpy(np.require(a, np.int32, ["C", "W"]))

        return CSRGraph(tensor(indptr).to(dev), tensor(indices).to(dev))

    @staticmethod
    def from_edges(n: int, src, dst, device="cuda") -> "CSRGraph":
        src, dst = check_edge_ids(n, src, dst)
        m = src.shape[0]
        counts = np.bincount(src, minlength=n) if m else np.zeros(n, np.int64)
        indptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        if m:
            dst = dst[_stable_counting_order(src, n)]
        return CSRGraph.from_numpy(indptr, dst, device)

    def transpose(self) -> "CSRGraph":
        """Counting-sort transpose on the host: Gᵀ, O(n + m), on the same
        device as G."""
        indptr, indices = self.to_numpy()
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(indptr))
        return CSRGraph.from_edges(self.n, indices.astype(np.int64), src,
                                   device=self.device)

    def to_numpy(self):
        return self.indptr.cpu().numpy(), self.indices.cpu().numpy()

    def nbytes(self) -> int:
        """Bytes of ``indptr`` and ``indices`` (no device sync)."""
        return (self.indptr.numel() * self.indptr.element_size()
                + self.indices.numel() * self.indices.element_size())

    def to(self, device) -> "CSRGraph":
        """This graph on ``device`` (itself when it already lies there)."""
        if self.device == torch.device(device):
            return self
        return CSRGraph(self.indptr.to(device), self.indices.to(device))


def row_ids(indptr: torch.Tensor, m: int) -> torch.Tensor:
    """Edge -> source-vertex map (m,) int32, computed on indptr's device."""
    n = indptr.shape[0] - 1
    deg = (indptr[1:] - indptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=indptr.device), deg,
        output_size=m)


class TrimResult:
    """Output of a trimming run — device-resident, lazily materialized.

    status:        (n,) int32, LIVE=1 / DEAD=0 at fixpoint
    rounds:        BSP rounds executed
    edges_traversed: total adjacency entries examined (the paper's key
                   metric); None when the run disabled counters
    max_frontier:  max per-round per-worker frontier size (|Qp| analogue);
                   None when the run disabled counters
    per_worker_edges: (P,) traversed-edge counts of P static vertex
                   partitions; None when the run disabled counters
    round_stats:   per-round :class:`repro_torch.obs.RoundStats`; None
                   unless the plan had ``instrument=True``

    Scalar counters move to the host on first attribute access and are
    cached, so a chain of engine runs never syncs for values it does not
    read.
    """

    __slots__ = ("_status", "_rounds", "_edges", "_max_frontier", "_pw",
                 "_round_stats")

    def __init__(self, status, rounds, edges_traversed=None,
                 max_frontier=None, per_worker_edges=None, round_stats=None):
        self._status = status
        self._round_stats = round_stats
        self._rounds = rounds
        self._edges = edges_traversed
        self._max_frontier = max_frontier
        self._pw = per_worker_edges

    @property
    def status(self):
        return self._status

    @property
    def round_stats(self):
        return self._round_stats

    @property
    def rounds(self) -> int:
        if self._rounds is not None and not isinstance(self._rounds, int):
            self._rounds = int(self._rounds)
        return self._rounds

    @property
    def edges_traversed(self):
        if self._edges is None and self._pw is not None:
            self._edges = int(self.per_worker_edges.sum())
        elif self._edges is not None and not isinstance(self._edges, int):
            self._edges = int(self._edges)
        return self._edges

    @property
    def max_frontier(self):
        if self._max_frontier is not None \
                and not isinstance(self._max_frontier, int):
            self._max_frontier = int(self._max_frontier)
        return self._max_frontier

    @property
    def per_worker_edges(self):
        if self._pw is not None and not isinstance(self._pw, np.ndarray):
            self._pw = self._pw.cpu().numpy().astype(np.int64)
        return self._pw

    def materialize(self) -> "TrimResult":
        """Force every field to the host (numpy status, python ints)."""
        if isinstance(self._status, torch.Tensor):
            self._status = self._status.cpu().numpy().astype(np.int32)
        _ = (self.rounds, self.edges_traversed, self.max_frontier,
             self.per_worker_edges)
        return self

    @property
    def n_trimmed(self) -> int:
        return int((self.status == 0).sum())

    @property
    def trimmed_fraction(self) -> float:
        n = self.status.shape[0]
        return self.n_trimmed / n if n else 0.0

    def __repr__(self):
        kind = "numpy" if isinstance(self._status, np.ndarray) else "device"
        return (f"TrimResult(n={self._status.shape[0]}, {kind}, "
                f"counters={'on' if self._pw is not None else 'off'})")


def worker_of(n: int, workers: int, chunk: int = 4096) -> np.ndarray:
    """Static chunked round-robin partition of vertices onto P workers:
    chunk c goes to worker c mod P."""
    v = np.arange(n, dtype=np.int64)
    return ((v // chunk) % workers).astype(np.int32)


def _pow2(x: int) -> int:
    """The least power of two >= x (1 for x <= 1)."""
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


class DeltaCSR:
    """Mutable edge-update overlay over an immutable base CSR (PyTorch port
    of the reference's ``DeltaCSR``).

    The device overlay, on the base graph's device, is a tombstone mask
    over base edges (``tomb`` (m,) bool) plus a fixed-capacity append
    buffer for inserted edges (``ins_src``/``ins_dst`` (capacity,) int32,
    sentinel ``n`` in empty slots; ``ins_alive`` (capacity,) bool).  Host
    numpy mirrors of the same state give the edge lookup for deletions
    (multiset semantics: duplicate arcs are distinct instances) and the
    compaction path; the stream engine writes the same updates into the
    device copies in each ``apply``, so the two views never diverge.

    ``compact()`` folds the overlay into a fresh base CSR through the
    O(n+m) counting-sort constructor; the engine calls it once
    ``overlay_fraction`` crosses ``load_factor``.
    """

    def __init__(self, base: CSRGraph, *, capacity: int = 256,
                 load_factor: float = 0.5):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 0.0 < load_factor:
            raise ValueError(f"load_factor must be > 0, got {load_factor}")
        self.capacity = _pow2(capacity)
        self.load_factor = float(load_factor)
        self._rebase(base)

    # -- (re)initialization ------------------------------------------------
    def _rebase(self, base: CSRGraph):
        self.base = base
        n, m = base.n, base.m
        indptr, indices = base.to_numpy()
        self._src_np = np.repeat(np.arange(n, dtype=np.int64),
                                 np.diff(indptr))
        self._dst_np = indices.astype(np.int64)
        # O(m log m) one-time index for (u, v) -> edge-id lookup; duplicate
        # arcs occupy a contiguous key range and are resolved instance-wise
        keys = self._src_np * max(n, 1) + self._dst_np
        self._key_order = np.argsort(keys, kind="stable")
        self._keys_sorted = keys[self._key_order]
        self._tomb_np = np.zeros(m, bool)
        cap = self.capacity
        self._ins_src_np = np.full(cap, n, np.int64)   # n = empty sentinel
        self._ins_dst_np = np.full(cap, n, np.int64)
        self._ins_alive_np = np.zeros(cap, bool)
        self.n_ins = 0          # append high-water mark (slots consumed)
        self.n_tomb = 0         # tombstoned base edges
        # device overlay (the engine's apply writes each batch into it)
        dev = base.device
        self.tomb = torch.zeros((m,), dtype=torch.bool, device=dev)
        self.ins_src = torch.full((cap,), n, dtype=torch.int32, device=dev)
        self.ins_dst = torch.full((cap,), n, dtype=torch.int32, device=dev)
        self.ins_alive = torch.zeros((cap,), dtype=torch.bool, device=dev)

    # -- basic properties --------------------------------------------------
    @property
    def n(self) -> int:
        return self.base.n

    @property
    def m_base(self) -> int:
        return self.base.m

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def m_live(self) -> int:
        """Edges in the materialized graph right now."""
        return (self.m_base - self.n_tomb
                + int(self._ins_alive_np[:self.n_ins].sum()))

    @property
    def overlay_fraction(self) -> float:
        """Overlay load: (tombstones + consumed insert slots) / base m."""
        return (self.n_tomb + self.n_ins) / max(self.m_base, 1)

    @property
    def needs_compact(self) -> bool:
        return self.overlay_fraction > self.load_factor

    # -- memory accounting (DESIGN.md §13) ---------------------------------
    def nbytes_breakdown(self) -> dict:
        """Overlay bytes by component (device overlay, insert buffers, and
        the host mirrors that drive resolution), excluding the base graph
        — the owning engine accounts that as its ``graph`` component."""
        from ..obs.memory import array_nbytes
        return {
            "tombstones": array_nbytes((self.tomb, self._tomb_np)),
            "insert_buffers": array_nbytes((
                self.ins_src, self.ins_dst, self.ins_alive,
                self._ins_src_np, self._ins_dst_np, self._ins_alive_np)),
            "host_index": array_nbytes((self._src_np, self._dst_np,
                                        self._key_order, self._keys_sorted)),
        }

    def nbytes(self) -> int:
        """Total overlay bytes (base graph excluded)."""
        return sum(self.nbytes_breakdown().values())

    # -- checkpoint/resume (DESIGN.md §14) ---------------------------------
    def state_dict(self) -> dict:
        """The overlay's checkpointable arrays: the base CSR, the tombstone
        mask and the insert buffers (the device copies; the host mirrors
        equal them by construction and are rebuilt from them on
        :meth:`load_state`)."""
        return {"base_indptr": self.base.indptr,
                "base_indices": self.base.indices,
                "tomb": self.tomb, "ins_src": self.ins_src,
                "ins_dst": self.ins_dst, "ins_alive": self.ins_alive}

    def state_meta(self) -> dict:
        """JSON side of :meth:`state_dict` (sizing and slot accounting)."""
        return {"capacity": self.capacity, "load_factor": self.load_factor,
                "n_ins": self.n_ins, "n_tomb": self.n_tomb}

    def load_state(self, tree: dict, meta: dict) -> None:
        """Overwrite this overlay with a checkpoint's exact state, on the
        current base's device.  The base is rebuilt from the saved CSR
        arrays without a re-sort (edge order, and so every derived
        permutation and the instance ``resolve_deletions`` picks, is
        kept); the host mirrors come from the saved device arrays, the
        slot accounting from ``meta``.  The host index is a function of
        the base alone: it is kept when the saved base equals the current
        one (a freshly planned engine over the checkpoint's base)."""
        indptr = np.asarray(tree["base_indptr"])
        indices = np.asarray(tree["base_indices"])
        cur_indptr, cur_indices = self.base.to_numpy()
        same = (np.array_equal(cur_indptr, indptr)
                and np.array_equal(cur_indices, indices))
        base = (self.base if same else
                CSRGraph.from_numpy(indptr, indices, self.device))
        capacity = int(meta["capacity"])
        tomb = np.asarray(tree["tomb"], bool)
        ins_src = np.asarray(tree["ins_src"])
        ins_dst = np.asarray(tree["ins_dst"])
        ins_alive = np.asarray(tree["ins_alive"], bool)
        if tomb.shape != (base.m,) or ins_src.shape != (capacity,):
            raise ValueError("checkpoint overlay shapes do not match the "
                             "saved base/capacity")
        self.capacity = capacity
        self.load_factor = float(meta["load_factor"])
        if not same:
            self._rebase(base)
        self._tomb_np = tomb.copy()
        self._ins_src_np = ins_src.astype(np.int64)
        self._ins_dst_np = ins_dst.astype(np.int64)
        self._ins_alive_np = ins_alive.copy()
        self.n_ins = int(meta["n_ins"])
        self.n_tomb = int(meta["n_tomb"])
        dev = self.device
        self.tomb = torch.from_numpy(self._tomb_np.copy()).to(dev)
        self.ins_src = torch.from_numpy(ins_src.astype(np.int32)).to(dev)
        self.ins_dst = torch.from_numpy(ins_dst.astype(np.int32)).to(dev)
        self.ins_alive = torch.from_numpy(self._ins_alive_np.copy()).to(dev)

    # -- host-side bookkeeping (the engine drives these) -------------------
    def resolve_deletions(self, src, dst):
        """Resolve a deletion batch to concrete edge instances and mark the
        host mirrors.  Returns ``(eids, slots)``: per deletion either a base
        edge id (``slots`` holds the sentinel ``capacity``) or an insert
        slot (``eids`` holds the sentinel ``m_base``).  Duplicate arcs are
        a multiset: each deletion claims a distinct not-yet-deleted
        instance.  Atomic: assignments are validated before anything is
        marked, so a phantom deletion raises ``ValueError`` with the batch
        unapplied."""
        src, dst = check_edge_ids(self.n, src, dst)
        b = src.shape[0]
        eids = np.full(b, self.m_base, np.int64)
        slots = np.full(b, self.capacity, np.int64)
        # key arithmetic needs the full int64 range (n * n overflows the
        # int32 the validated batch arrives in)
        keys = src.astype(np.int64) * max(self.n, 1) + dst
        lo = np.searchsorted(self._keys_sorted, keys, "left")
        hi = np.searchsorted(self._keys_sorted, keys, "right")
        # group the batch by key; within a group, claim untombed base
        # instances first, then live insert slots -- all without mutating,
        # so failure needs no rollback
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        starts = (np.nonzero(np.r_[True, ks[1:] != ks[:-1]])[0] if b
                  else np.zeros(0, np.int64))
        ins_live = self._ins_alive_np[:self.n_ins]
        ins_keys = (self._ins_src_np[:self.n_ins] * max(self.n, 1)
                    + self._ins_dst_np[:self.n_ins])
        # vectorized fast path: singleton groups whose key matches exactly
        # one untombed base instance assign without the per-group loop
        pending = np.ones(len(starts), bool)
        if self.m_base and b:
            sizes = np.diff(np.r_[starts, b])
            g0 = order[starts]                 # one member per group
            rng1 = (hi[g0] - lo[g0]) == 1
            cand0 = self._key_order[np.where(rng1, lo[g0], 0)]
            easy = (sizes == 1) & rng1 & ~self._tomb_np[cand0]
            eids[g0[easy]] = cand0[easy]
            pending &= ~easy
        for gi in np.nonzero(pending)[0]:
            s0 = starts[gi]
            s1 = starts[gi + 1] if gi + 1 < len(starts) else b
            members = order[s0:s1]
            i0 = members[0]
            cand = self._key_order[lo[i0]:hi[i0]]
            avail = cand[~self._tomb_np[cand]]
            t = min(members.size, avail.size)
            eids[members[:t]] = avail[:t]
            extra = members[t:]
            if extra.size:
                cand2 = np.nonzero(ins_live & (ins_keys == keys[i0]))[0]
                if cand2.size < extra.size:
                    raise ValueError(
                        f"cannot delete edge ({src[i0]}, {dst[i0]}): "
                        "not present in the graph")
                slots[extra] = cand2[:extra.size]
        # commit
        from_base = eids < self.m_base
        self._tomb_np[eids[from_base]] = True
        self.n_tomb += int(from_base.sum())
        self._ins_alive_np[slots[slots < self.capacity]] = False
        return eids, slots

    def stage_inserts(self, src, dst):
        """Claim contiguous insert-buffer slots for a batch and mark the
        host mirrors.  The caller (engine) guarantees capacity."""
        src, dst = check_edge_ids(self.n, src, dst)
        k = src.shape[0]
        if self.n_ins + k > self.capacity:
            raise RuntimeError(
                f"insert buffer overflow: {self.n_ins} + {k} > "
                f"{self.capacity} (the engine compacts/grows first)")
        slots = np.arange(self.n_ins, self.n_ins + k, dtype=np.int64)
        self._ins_src_np[slots] = src
        self._ins_dst_np[slots] = dst
        self._ins_alive_np[slots] = True
        self.n_ins += k
        return slots

    def grow(self, min_capacity: int):
        """Double the insert buffer to a pow2 >= min_capacity."""
        new_cap = _pow2(max(2 * self.capacity, min_capacity))
        pad = new_cap - self.capacity
        n, dev = self.n, self.device
        self._ins_src_np = np.concatenate(
            [self._ins_src_np, np.full(pad, n, np.int64)])
        self._ins_dst_np = np.concatenate(
            [self._ins_dst_np, np.full(pad, n, np.int64)])
        self._ins_alive_np = np.concatenate(
            [self._ins_alive_np, np.zeros(pad, bool)])
        self.ins_src = torch.cat([self.ins_src, torch.full(
            (pad,), n, dtype=torch.int32, device=dev)])
        self.ins_dst = torch.cat([self.ins_dst, torch.full(
            (pad,), n, dtype=torch.int32, device=dev)])
        self.ins_alive = torch.cat([self.ins_alive, torch.zeros(
            (pad,), dtype=torch.bool, device=dev)])
        self.capacity = new_cap

    # -- materialization ---------------------------------------------------
    def _live_edges(self):
        live_base = ~self._tomb_np
        ins_live = self._ins_alive_np[:self.n_ins]
        src = np.concatenate([self._src_np[live_base],
                              self._ins_src_np[:self.n_ins][ins_live]])
        dst = np.concatenate([self._dst_np[live_base],
                              self._ins_dst_np[:self.n_ins][ins_live]])
        return src, dst

    def materialize(self) -> CSRGraph:
        """Fold the overlay into a standalone CSR on the base's device (the
        overlay is kept)."""
        src, dst = self._live_edges()
        return CSRGraph.from_edges(self.n, src, dst, device=self.device)

    def compact(self) -> CSRGraph:
        """Fold the overlay into a fresh base CSR (O(n+m) counting sort)
        and reset the overlay to empty.  Returns the new base."""
        base = self.materialize()
        self._rebase(base)
        return base

    def __repr__(self):
        return (f"DeltaCSR(n={self.n}, m_base={self.m_base}, "
                f"tomb={self.n_tomb}, ins={self.n_ins}/{self.capacity}, "
                f"load={self.overlay_fraction:.2f})")
