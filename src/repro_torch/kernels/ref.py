"""Plain PyTorch versions of the Hopper kernels (the ``ref.py``
contract).

``kernels.ops`` takes these for tensors that lie on the CPU; on the card
``chip_smoke.py`` holds each CUDA kernel against them on the same inputs.
They mirror ``src/repro/kernels/ref.py`` (``first_live_ref``,
``frontier_compact_ref``, ``sparse_expand_ref``, ``frontier_expand_ref``,
``bucket_peel_ref``, ``counter_scatter_ref``) plus the plain scan that
stands beside ``prefix_positions``.  Those outputs are int32 or bool, so a
kernel and its plain version agree bit for bit.  ``segment_sum_ref`` is a
float sum: the kernel's atomics add in another order, so the two agree to
a tolerance stated relative to each segment's sum of absolute values.  ``flash_attention_ref``
repeats the flash kernel's float arithmetic (its blocks, its masking and
its online softmax, f32 inside) and ``attention_ref`` is the naive
softmax oracle; a float kernel agrees with them to a stated tolerance.
``mutant_copy_ref`` is the static checks' copy kernel's plain version.
"""
from __future__ import annotations

import math

import torch

#: the flash kernel's masking value (a finite "minus infinity") and its
#: block length, as in ``src/repro/kernels/flash_attention.py``
NEG_INF = -1e30
FLASH_BLOCK = 128


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


def frontier_expand_ref(flags, valid, pending):
    """flags, valid: (n, W) bool; pending: (n,) bool -> hit (n,) bool =
    ``pending & OR_j(flags & valid)``: a pending vertex with a frontier
    in-neighbor inside its window."""
    return pending & (flags & valid).any(dim=1)


def bucket_peel_ref(counters, alive, k):
    """counters: (n,) int32 (may be negative); alive: (n,) bool; k: the
    bucket level (a 1-element or 0-d int32 tensor, or an int) ->
    frontier (n,) bool = ``alive & (counters <= k)``."""
    k = torch.as_tensor(k, dtype=counters.dtype,
                        device=counters.device).reshape(())
    return alive & (counters <= k)


def counter_scatter_ref(counters, status, upd_src, upd_delta):
    """counters: (n,) int32; status: (n,) bool; upd_src, upd_delta: (B,)
    int32 -> (new, dead): new (n,) int32 = ``counters`` plus the sum of
    ``upd_delta[b]`` over the updates with ``upd_src[b] == v``, and dead
    (n,) bool = ``status & (new <= 0)``.  Out-of-range sources (negative
    or >= n, e.g. the sentinel n) add nothing.  The inputs are not
    modified."""
    n = counters.shape[0]
    if n == 0:
        return counters.clone(), torch.zeros((0,), dtype=torch.bool,
                                             device=counters.device)
    ok = (upd_src >= 0) & (upd_src < n)
    ids = torch.where(ok, upd_src, 0).to(torch.int64)
    delta = torch.where(ok, upd_delta, 0).to(counters.dtype)
    new = counters.clone().index_add_(0, ids, delta)
    return new, status & (new <= 0)


def segment_sum_ref(values, seg_ids, num_segments: int):
    """(m, *rest) float + (m,) int ids -> (num_segments, *rest) float32
    sums; ids outside ``[0, num_segments)``, negatives too, add nothing.
    Out-of-range rows are sent to one extra row that is cut off, so the
    values are not copied (``index_add_`` raises on such ids itself)."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.where(ok, seg_ids, num_segments).to(torch.int64)
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    out.index_add_(0, idx, values.to(torch.float32))
    return out[:num_segments]


def flash_blocks(sq: int, sk: int) -> tuple[int, int]:
    """The flash kernel's logical blocks: ``min(128, S)`` each, and both
    sequence lengths must be multiples of theirs (a prompt longer than
    128 tokens is a multiple of 128)."""
    bq, bk = min(FLASH_BLOCK, sq), min(FLASH_BLOCK, sk)
    if bq <= 0 or bk <= 0 or sq % bq or sk % bk:
        raise ValueError(f"flash_attention: Sq={sq} and Sk={sk} must be "
                         f"multiples of their blocks ({bq}, {bk})")
    return bq, bk


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0 -> (B, Hq,
    Sq, D) in q.dtype: the Pallas flash kernel's own arithmetic.

    Queries are aligned to the end of the keys (``q_offset = Sk - Sq``);
    q head h reads kv head ``h // (Hq // Hkv)``.  Per (q block, kv block)
    of :func:`flash_blocks`: a causal kv block entirely above the diagonal
    of its q block is skipped; in the others masked scores are ``-1e30``
    and an online softmax accumulates in f32.  So a row whose q block
    computes no kv block comes out 0 (``l == 0``), and a fully masked row
    of a computed block comes out as the mean of v over the computed kv
    blocks (Sq > Sk only; the naive oracle gives the mean over all keys).
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    g = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bq, bk = flash_blocks(sq, sk)
    q_offset = sk - sq
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for qi in range(sq // bq):
        qb = qf[:, :, :, qi * bq:(qi + 1) * bq]
        m = torch.full((b, hkv, g, bq, 1), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, bq, 1), device=dev)
        acc = torch.zeros((b, hkv, g, bq, d), device=dev)
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        for ki in range(sk // bk):
            if causal and q_offset + qi * bq + bq - 1 < ki * bk:
                continue                    # block above the diagonal
            kb = kf[:, :, ki * bk:(ki + 1) * bk]
            vb = vf[:, :, ki * bk:(ki + 1) * bk]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * sm_scale
            if causal:
                k_pos = ki * bk + torch.arange(bk, device=dev)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)    # fully-masked rows -> 0
        out[:, :, :, qi * bq:(qi + 1) * bq] = acc / l
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None):
    """Naive softmax attention with GQA, f32 math (the oracle of
    ``src/repro/kernels/ref.py``): masked scores are ``-1e30``, so a fully
    masked row is the mean of v over all keys."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def mutant_copy_ref(x, carry=None):
    """(n,) int32 -> ``x + carry[0]`` ((n,) int32; a copy without a
    carry)."""
    return x.clone() if carry is None else x + carry.reshape(())
