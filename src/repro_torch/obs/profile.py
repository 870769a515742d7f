"""Kernel cost of a plan for the MetricsPlane — the port's counterpart of
``src/repro/obs/profile.py`` (DESIGN.md §13).

The reference publishes XLA's cost model of a compiled plan.  PyTorch has
none, so the port counts what its own kernels must do: for each call of
a hand-written kernel's wrapper (``kernels/ops.py``), the bytes the
function must move (each input read once, each output written once) and,
for ``flash_attention``, its floating-point operations — the formulas of
the bound column of PERF.md §6, which ``chip_smoke.py`` computes with the
same functions (:func:`kernel_cost`, :func:`bound_ms`).  Where the work
depends on the data (a frontier's members, a probe's windows) the formula
counts what the call's inputs need.

:func:`capturing` records the wrapper calls made inside its block;
``EngineBase._dispatch`` opens it around the first dispatch of each plan
while a plane is enabled and publishes the sum as
``repro_plan_kernel_flops`` / ``repro_plan_kernel_bytes`` (the
reference's ``repro_plan_cost_flops`` / ``repro_plan_cost_bytes``).  The
PyTorch operations between the kernels (segment sums, gathers, the loop
tests) are not counted.  Each call's cost is summed as it is made: the
terms that depend on the data stay one 0-d tensor on the card, read once
after that dispatch has ended, so no call's tensors outlive it.
"""
from __future__ import annotations

import contextlib
from typing import Dict

#: H100 SXM data sheet: HBM3 bytes per second and dense peak FLOP/s
#: (float32 on the CUDA cores; tensorfloat32 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              "tensorfloat32": 494.7e12}
#: bytes of a DRAM sector (the windowed probe's bound counts sectors)
SECTOR = 32


def _count(mask):
    return mask.sum()


def _hits(size: int, at, mask):
    """Distinct entries of ``at`` where ``mask`` holds, as a 0-d tensor:
    the count of marks in a ``(size,)`` bitmap (no host sync)."""
    import torch
    bm = torch.zeros(size, dtype=torch.int32, device=at.device)
    bm.index_add_(0, at.long(), mask.to(torch.int32))
    return (bm > 0).sum()


def probe_bytes(status, indptr, indices, start, scanning, window,
                first, found):
    """The bytes the windowed probe must move, by 32-byte sectors: every
    row's scanning byte and its 5 output bytes; the sectors of start and
    of indptr that the scanning rows touch; the sectors of indices that
    their windows span up to the first live target (or the row's end);
    and each sector of status that those targets touch, once.  A 0-d
    tensor: the sectors are marked in bitmaps on the inputs' device."""
    import torch
    n, m = scanning.shape[0], indices.shape[0]
    rows = torch.arange(n, device=scanning.device)
    deg = (indptr[1:] - indptr[:-1]).long()
    s = torch.minimum(start.long(), deg)
    need = torch.where(found, first.long() + 1,
                       (deg - s).clamp(0, window))
    keep = scanning & (need > 0)
    lo = (indptr[:-1].long() + s).clamp(0, max(m - 1, 0))
    span = -(-window * 4 // SECTOR) + 1
    base, last = (lo * 4) // SECTOR, ((lo + need - 1) * 4) // SECTOR
    idx = torch.cat([base + k for k in range(span)])
    idx_sectors = _hits((4 * m) // SECTOR + span + 1, idx,
                        keep.repeat(span) & (idx <= last.repeat(span)))
    status_sectors = 0
    if m:
        tgt = torch.cat([indices[(lo + j).clamp(max=m - 1)].long()
                         for j in range(window)]) // SECTOR
        hit = torch.cat([keep & (need > j) for j in range(window)])
        status_sectors = _hits(status.shape[0] // SECTOR + 1, tgt, hit)
    meta = (_hits(n * 4 // SECTOR + 1, rows * 4 // SECTOR, scanning)
            + _hits((n + 1) * 4 // SECTOR + 1,
                    torch.cat([rows, rows + 1]) * 4 // SECTOR,
                    scanning.repeat(2)))
    return 6 * n + SECTOR * (meta + idx_sectors + status_sectors)


def _expand_bytes(indptr, indices, ids, ecap):
    # ids, two indptr entries per real id, one index per expanded edge;
    # the (ecap,) src/tgt/pos int32 + valid bool outputs
    n = indptr.shape[0] - 1
    if n == 0:
        return 4 * ids.shape[0] + 13 * ecap
    real = ids < n
    at = ids.clamp(max=n - 1).long()
    total = ((indptr[at + 1] - indptr[at]).long() * real).sum().clamp(
        max=ecap)
    return 4 * ids.shape[0] + 8 * real.sum() + 4 * total + 13 * ecap


def _causal_pairs(sq: int, sk: int) -> int:
    # queries aligned to the end of the keys: query i sees keys
    # [0, sk - sq + i]
    first = sk - sq + 1
    lo = max(0, -first + 1)
    if lo >= sq:
        return 0
    a, b = first + lo, first + sq - 1
    full = max(0, b - sk)             # queries that see all sk keys
    b_c = b - full
    return (a + b_c) * (b_c - a + 1) // 2 + full * sk


def _flash_cost(q, k, v, causal=True, sm_scale=None):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    pairs = _causal_pairs(sq, sk) if causal else sq * sk
    flops = 4 * b * hq * pairs * d            # QK^T and PV
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * q.element_size()
    return flops, nbytes


def flash_bound_ms(q, k, v, causal=True, sm_scale=None) -> tuple:
    """The least time one ``flash_attention`` call could take on the
    card, and what bounds it (``"operations"`` or ``"bytes"``): its
    products at the bf16 peak in bfloat16, or three times over at the TF32
    peak in float32 (3xTF32, the f32 contract on the tensor cores), against
    its bytes at the memory rate.  The softmax's exponentials (one an
    unmasked score) are not counted: the data sheet gives no rate for
    them, and exp2 runs on the SFU and, as a polynomial, on the FMA pipes
    at once, so no rate of one unit bounds them."""
    flops, nbytes = _flash_cost(q, k, v, causal)
    if q.element_size() == 4:
        ops_s = 3 * flops / PEAK_FLOPS["tensorfloat32"]
    else:
        ops_s = flops / PEAK_FLOPS["bfloat16"]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def _segment_bytes(values, seg_ids, num_segments, index=None) -> int:
    m = values.shape[0]
    d = values[0].numel() if m else 0
    return (values.numel() * values.element_size()
            + m * seg_ids.element_size() + 4 * num_segments * d)


#: kernel -> (wrapper args, outputs) -> (flops, bytes)
_COSTS = {
    # active byte of every row, both tiles of active rows, outputs
    "first_live_scan": lambda a, o: (
        0, a[0].shape[0] + 2 * a[0].shape[1] * _count(a[2])
        + 5 * a[0].shape[0]),
    "first_live_probe": lambda a, o: (0, probe_bytes(*a, *o)),
    "prefix_positions": lambda a, o: (
        0, (a[0].element_size() + 4) * a[0].shape[0] + 4),
    "frontier_compact": lambda a, o: (0, a[0].shape[0] + 4 * a[1] + 4),
    "sparse_expand": lambda a, o: (0, _expand_bytes(*a)),
    # the pending byte, both tiles of pending rows, the hit byte
    "frontier_expand": lambda a, o: (
        0, 2 * a[0].shape[0] + 2 * a[0].shape[1] * _count(a[2])),
    # int32 counter, alive byte, frontier byte a vertex
    "bucket_peel": lambda a, o: (0, 6 * a[0].shape[0]),
    "counter_scatter": lambda a, o: (
        0, 10 * a[0].shape[0] + 8 * a[2].shape[0]),
    "flash_attention": lambda a, o: _flash_cost(*a),
    "segment_sum": lambda a, o: (0, _segment_bytes(*a)),
    "mutant_copy": lambda a, o: (0, 8 * a[0].shape[0]),
}


def _cost(kernel: str, args, out):
    """``_COSTS[kernel]`` of one call; raises where the formula reads the
    data and the call's tensors lie on the meta device, which holds
    none."""
    flops, nbytes = _COSTS[kernel](tuple(args), out)
    for term in (flops, nbytes):
        if getattr(term, "device", None) is not None \
                and term.device.type == "meta":
            raise ValueError(
                f"{kernel}: its cost depends on the data, and meta tensors "
                "hold none; the graph kernels are sized analytically "
                "(python -m repro_torch.launch.trim --dryrun)")
    return flops, nbytes


def kernel_cost(kernel: str, args, out=None):
    """``(flops, bytes)`` one call of ``kernel``'s wrapper must do on
    these arguments (and outputs, where the formula reads them).  On meta
    tensors only the kernels whose cost follows from the shapes
    (``flash_attention``, ``segment_sum``, ...) are costed; the others
    raise."""
    flops, nbytes = _cost(kernel, args, out)
    return int(flops), int(nbytes)


def bound_ms(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for
    ``dtype``."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S) * 1e3


class _CostSum:
    """A running :func:`kernel_cost` over wrapper calls, kept as each call
    is noted: the terms known from shapes as Python ints, the terms that
    depend on the data as one 0-d tensor on the card, so no call's
    arguments outlive it and nothing is read back until :meth:`total`."""

    def __init__(self):
        self.flops = self.nbytes = self.calls = 0
        self.device = None

    def append(self, call) -> None:
        kernel, args, out = call
        flops, nbytes = _cost(kernel, args, out)
        self.flops += flops
        if isinstance(nbytes, int):
            self.nbytes += nbytes
        else:
            nbytes = nbytes.long()
            self.device = (nbytes if self.device is None
                           else self.device + nbytes)
        self.calls += 1

    def total(self) -> Dict[str, float]:
        """``{"flops", "bytes_accessed", "kernel_calls"}``: one read of
        the card."""
        nbytes = self.nbytes + (0 if self.device is None
                                else int(self.device))
        return {"flops": float(self.flops), "bytes_accessed": float(nbytes),
                "kernel_calls": float(self.calls)}


_SINKS: list = []


@contextlib.contextmanager
def capturing(sink=None):
    """Record ``(kernel, args, out)`` of every wrapper call inside the
    block into ``sink`` (a new list by default), which it yields; nested
    blocks each see every call."""
    calls = [] if sink is None else sink
    _SINKS.append(calls)
    try:
        yield calls
    finally:
        del _SINKS[next(i for i, c in enumerate(_SINKS) if c is calls)]


def note_call(kernel: str, args, out) -> None:
    """Called by each wrapper; records only inside :func:`capturing`."""
    for calls in _SINKS:
        calls.append((kernel, args, out))


def plan_cost(calls) -> Dict[str, float]:
    """Sum :func:`kernel_cost` over captured calls:
    ``{"flops", "bytes_accessed", "kernel_calls"}``."""
    acc = _CostSum()
    for call in calls:
        acc.append(call)
    return acc.total()


def plan_cost_of(fn, *args, **kwargs):
    """Run ``fn`` once, summing the cost of its wrapper calls as they are
    made; returns ``(result, cost)`` with cost ``None`` when it made no
    kernel call."""
    with capturing(_CostSum()) as acc:
        out = fn(*args, **kwargs)
    return out, (acc.total() if acc.calls else None)


def record_plan_cost(plane, family: str, plan: str,
                     cost: Dict[str, float]) -> None:
    """Publish one plan's kernel cost as labeled gauges."""
    flops = plane.gauge(
        "repro_plan_kernel_flops",
        "floating-point operations of the hand-written kernels' calls in "
        "a plan's first dispatch (PERF.md bound formulas; PyTorch ops are "
        "not counted)")
    nbytes = plane.gauge(
        "repro_plan_kernel_bytes",
        "bytes the hand-written kernels' calls in a plan's first dispatch "
        "must move (PERF.md bound formulas; PyTorch ops are not counted)")
    flops.set(cost["flops"], family=family, plan=plan)
    nbytes.set(cost["bytes_accessed"], family=family, plan=plan)


__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "SECTOR",
           "flash_bound_ms", "kernel_cost",
           "bound_ms", "probe_bytes", "capturing", "note_call",
           "plan_cost", "plan_cost_of", "record_plan_cost"]
