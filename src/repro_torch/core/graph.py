"""CSR graph container used by all trimming algorithms (PyTorch port of
``src/repro/core/graph.py``).

``indptr`` (n+1,) and ``indices`` (m,) are int32 torch tensors on one
device.  Construction and transposition are O(n + m) stable counting sorts
on the host (numpy/scipy), the same as the reference, so a graph built
here has byte-identical CSR arrays to the reference's.  ``from_numpy`` /
``to_numpy`` carry a graph across from the JAX package's arrays.

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

    Scalar counters move to the host on first attribute access and are
    cached, so a chain of engine runs never syncs for values it does not
    read.
    """

    __slots__ = ("_status", "_rounds", "_edges", "_max_frontier", "_pw")

    def __init__(self, status, rounds, edges_traversed=None,
                 max_frontier=None, per_worker_edges=None):
        self._status = status
        self._rounds = rounds
        self._edges = edges_traversed
        self._max_frontier = max_frontier
        self._pw = per_worker_edges

    @property
    def status(self):
        return self._status

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

    def __repr__(self):
        kind = "numpy" if isinstance(self._status, np.ndarray) else "device"
        return (f"TrimResult(n={self._status.shape[0]}, {kind}, "
                f"counters={'on' if self._pw is not None else 'off'})")


def worker_of(n: int, workers: int, chunk: int = 4096) -> np.ndarray:
    """Static chunked round-robin partition of vertices onto P workers:
    chunk c goes to worker c mod P."""
    v = np.arange(n, dtype=np.int64)
    return ((v // chunk) % workers).astype(np.int32)
