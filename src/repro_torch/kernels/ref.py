"""Plain PyTorch versions of the four Hopper kernels (the ``ref.py``
contract).

``kernels.ops`` takes these for tensors that lie on the CPU; on the card
``chip_smoke.py`` holds each CUDA kernel against them on the same inputs.
They mirror ``src/repro/kernels/ref.py`` (``first_live_ref``,
``frontier_compact_ref``, ``sparse_expand_ref``) plus the plain scan that
stands beside ``prefix_positions``.  Every output is int32 or bool, so a
kernel and its plain version agree bit for bit.
"""
from __future__ import annotations

import torch


def first_live_ref(flags, valid, active):
    """flags, valid: (n, W) bool; active: (n,) bool -> (first, found):
    first (n,) int32 = least j with ``flags & valid`` (W when none, and W
    on inactive rows), found (n,) bool = ``active & first < W``."""
    window = flags.shape[1]
    offs = torch.arange(window, dtype=torch.int32, device=flags.device)
    first = torch.where(flags & valid, offs, window).amin(dim=1)
    first = torch.where(active, first, window).to(torch.int32)
    return first, active & (first < window)


def prefix_positions_ref(x):
    """(n,) int32 (or bool) -> (positions, total): the exclusive prefix sum
    as (n,) int32 and the 0-d int32 sum."""
    x = x.to(torch.int32)
    if x.numel() == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=x.device),
                torch.zeros((), dtype=torch.int32, device=x.device))
    csum = torch.cumsum(x, dim=0, dtype=torch.int32)
    return csum - x, csum[-1]


def frontier_compact_ref(mask, capacity: int):
    """(n,) bool -> (ids, count): the True positions packed into a
    (capacity,) int32 buffer in ascending order (sentinel ``n`` in unused
    slots, members past ``capacity`` dropped; all zeros when n = 0) and the
    0-d int32 member count."""
    n = mask.shape[0]
    dev = mask.device
    if n == 0:
        return (torch.zeros((capacity,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    csum = torch.cumsum(mask.to(torch.int64), dim=0)
    # rank search: ids[j] = index of the (j+1)-th member, n past the last
    q = torch.arange(1, capacity + 1, dtype=torch.int64, device=dev)
    ids = torch.searchsorted(csum, q, side="left").to(torch.int32)
    return ids, csum[-1].to(torch.int32)


def sparse_expand_ref(indptr, indices, ids, ecap: int):
    """CSR rows of the compacted ``ids`` (sentinel n) expanded into a
    static (ecap,) edge buffer ``(src, tgt, pos, valid)``: slot e < total
    (= Σ deg over ids) holds the e-th edge of the concatenated rows —
    owning row, endpoint, position in ``indices``; rows past ``ecap`` lose
    their tail.  Slots e >= total are ``src = tgt = pos = 0`` and
    ``valid = False``.  Ownership is a rank search over the inclusive
    degree sum (``side='right'`` skips zero-degree rows)."""
    n = indptr.shape[0] - 1
    m = indices.shape[0]
    C = ids.shape[0]
    dev = indptr.device
    z = torch.zeros((ecap,), dtype=torch.int32, device=dev)
    if n == 0 or m == 0 or C == 0:
        return z, z.clone(), z.clone(), torch.zeros((ecap,), dtype=torch.bool,
                                                    device=dev)
    ok = ids < n
    row = torch.where(ok, ids, 0).to(torch.int64)
    row_base = torch.where(ok, indptr[row], 0).to(torch.int64)
    deg = torch.where(ok, indptr[torch.clamp(row + 1, max=n)] - row_base, 0)
    csum = torch.cumsum(deg.to(torch.int64), dim=0)
    excl = csum - deg
    e = torch.arange(ecap, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(csum, e, right=True).clamp(0, C - 1)
    valid = e < csum[-1]
    pos = (row_base[owner] + (e - excl[owner])).clamp(0, m - 1)
    src = torch.where(valid, ids[owner], 0).to(torch.int32)
    tgt = torch.where(valid, indices[pos], 0).to(torch.int32)
    pos = torch.where(valid, pos, 0).to(torch.int32)
    return src, tgt, pos, valid
