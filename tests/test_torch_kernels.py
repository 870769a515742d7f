"""The PyTorch port's kernel layer against the JAX reference, on the CPU.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held against
the JAX Pallas kernel (interpret mode) and the JAX ref twin on the same
numpy inputs.  All outputs are int32 or bool, so the tolerance is exact.
The flash attention twins are float: ``flash_attention_ref`` is held
against the Pallas kernel at ``tests/test_kernels.py``'s tolerances, and
against the naive oracle where the two agree (Sq <= Sk).  So is
``segment_sum_ref``: against the Pallas segment sum at that file's 1e-4
(the one-hot product and ``index_add_`` sum in other orders).
The CUDA kernels themselves run only on a card: ``tests/test_torch_gpu.py``
holds them against these plain versions there.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.bucket_peel import bucket_peel_pallas
from repro.kernels.counter_scatter import counter_scatter_pallas
from repro.kernels.first_live_scan import first_live_scan as pallas_first_live
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.frontier_compact import (frontier_compact_pallas,
                                            prefix_positions,
                                            sparse_expand_pallas)
from repro.kernels.frontier_expand import frontier_expand as pallas_expand
from repro.kernels.segment_reduce import segment_sum_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import bucket_peel as tbpl
from repro_torch.kernels import counter_scatter as tcs
from repro_torch.kernels import first_live_scan as tfls
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import frontier_compact as tfc
from repro_torch.kernels import frontier_expand as tfex
from repro_torch.kernels import segment_sum as tss

# the tensors here are tiny: intra-op threads only add overhead, and the
# suite runs several test files side by side
torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


@pytest.mark.parametrize("n,W,bv", [(333, 16, 128), (64, 8, 64),
                                    (1024, 32, 256), (1, 16, 256),
                                    (700, 16, 256)])
@pytest.mark.parametrize("active_kind", ["random", "none", "one_block"])
def test_first_live_ref_matches_pallas(n, W, bv, active_kind):
    rng = np.random.default_rng(n * 7 + W)
    flags = rng.random((n, W)) < 0.3
    valid = rng.random((n, W)) < 0.8
    active = {"random": rng.random(n) < 0.5, "none": np.zeros(n, bool),
              # every block but the first is all-inactive (block skipping)
              "one_block": np.arange(n) < min(bv, n) // 2}[active_kind]
    got = ref.first_live_ref(torch.as_tensor(flags), torch.as_tensor(valid),
                             torch.as_tensor(active))
    for want in (pallas_first_live(jnp.asarray(flags), jnp.asarray(valid),
                                   jnp.asarray(active), block_v=bv,
                                   interpret=True),
                 jref.first_live_ref(jnp.asarray(flags), jnp.asarray(valid),
                                     jnp.asarray(active))):
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


def test_first_live_ref_empty():
    f = torch.zeros((0, 16), dtype=torch.bool)
    first, found = ref.first_live_ref(f, f, torch.zeros(0, dtype=torch.bool))
    want = jref.first_live_ref(jnp.zeros((0, 16), bool),
                               jnp.zeros((0, 16), bool), jnp.zeros(0, bool))
    assert _same(first, want[0]) and _same(found, want[1])


def _probe_case(kind, seed):
    """(status, indptr, indices, start, scanning) as numpy arrays of one
    windowed-probe case: random degrees (with zero-degree runs) and
    pointers; "m0" has no edges, "n0" and "n1" no and one vertex,
    "start_ge_deg" every pointer at or past its row's end, "zero_degree"
    three rows in four without edges, "no_scanning" no scanning row, and
    "hub" one row of 300 edges with the rest."""
    rng = np.random.default_rng(seed)
    n = {"n0": 0, "n1": 1}.get(kind, 300)
    deg = rng.integers(0, 40, n)
    deg[rng.random(n) < 0.2] = 0
    if kind == "m0":
        deg[:] = 0
    if kind == "zero_degree":
        deg[rng.random(n) < 0.75] = 0
    if kind == "hub":
        deg[7] = 300
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    m = int(indptr[-1])
    indices = rng.integers(0, max(n, 1), m).astype(np.int32)
    start = (rng.integers(0, 45, n) if kind != "start_ge_deg"
             else deg + rng.integers(0, 3, n)).astype(np.int32)
    scanning = rng.random(n) < (0.0 if kind == "no_scanning" else 0.6)
    status = rng.random(n) < 0.3
    return status, indptr, indices, start, scanning


@pytest.mark.parametrize("window", [4, 16, 17])
@pytest.mark.parametrize("kind", ["random", "m0", "n0", "n1", "start_ge_deg",
                                  "zero_degree", "no_scanning", "hub"])
def test_first_live_probe_ref_matches_reference(kind, window):
    """The windowed probe's plain version (gather + row scan) equals the
    reference's: its XLA gather (``src/repro/core/common.py:204-209``)
    feeding the Pallas kernel in interpret mode, bit for bit.  With m = 0
    the reference's gather cannot run (JAX refuses to gather from an empty
    array): no window position is valid there, so the Pallas kernel gets
    all-False flags; with n = 0 the Pallas kernel takes no input, and the
    JAX ref twin stands in."""
    status, indptr, indices, start, scanning = _probe_case(
        kind, window * 13 + len(kind))
    n, m = indptr.shape[0] - 1, indices.shape[0]
    got = ref.first_live_probe_ref(
        *(torch.as_tensor(a) for a in (status, indptr, indices, start,
                                       scanning)), window)
    jstatus, jindptr, jindices = (jnp.asarray(a) for a in (status, indptr,
                                                           indices))
    deg = jindptr[1:] - jindptr[:-1]
    jstart = jnp.minimum(jnp.asarray(start), deg)
    pos = jstart[:, None] + jnp.arange(window, dtype=jnp.int32)[None, :]
    valid = pos < deg[:, None]
    if m:
        addr = jnp.clip(jindptr[:-1, None] + pos, 0, max(m - 1, 0))
        flags = jstatus[jindices[addr]]
    else:
        flags = jnp.zeros_like(valid)
    if n:
        want = pallas_first_live(flags, valid, jnp.asarray(scanning),
                                 interpret=True)
    else:
        want = jref.first_live_ref(flags, valid, jnp.asarray(scanning))
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[0].shape == (n,)


@pytest.mark.parametrize("n,block", [(0, 512), (1, 512), (333, 64),
                                     (1024, 512), (1500, 128)])
def test_prefix_positions_ref_matches_pallas(n, block):
    x = np.random.default_rng(n).integers(0, 9, n).astype(np.int32)
    got_pos, got_total = ref.prefix_positions_ref(torch.as_tensor(x))
    want_pos, want_total = prefix_positions(jnp.asarray(x), block=block,
                                            interpret=True)
    assert _same(got_pos, want_pos) and int(got_total) == int(want_total)
    assert got_pos.dtype == got_total.dtype == torch.int32
    # a bool mask scans the same as its int32 widening
    mask = torch.as_tensor(x % 2 == 0)
    assert _same(ref.prefix_positions_ref(mask)[0],
                 ref.prefix_positions_ref(mask.to(torch.int32))[0])


@pytest.mark.parametrize("n,cap,block", [(0, 8, 512), (1, 1, 512),
                                         (333, 64, 64), (1024, 1024, 512),
                                         (700, 16, 128)])
@pytest.mark.parametrize("fill", ["none", "some", "all"])
def test_frontier_compact_ref_matches_pallas(n, cap, block, fill):
    """Empty, partial and full masks; n=700/cap=16 overflows capacity."""
    rng = np.random.default_rng(n + cap)
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "some": rng.random(n) < 0.3}[fill]
    got_ids, got_cnt = ref.frontier_compact_ref(torch.as_tensor(mask), cap)
    for want_ids, want_cnt in (
            frontier_compact_pallas(jnp.asarray(mask), cap, block=block,
                                    interpret=True),
            jref.frontier_compact_ref(jnp.asarray(mask), cap)):
        assert _same(got_ids, want_ids) and int(got_cnt) == int(want_cnt)
    assert got_ids.dtype == got_cnt.dtype == torch.int32


def _csr(n, m, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, max(n, 1), m)
    dst = rng.integers(0, max(n, 1), m)
    order = np.argsort(src, kind="stable")
    indptr = np.searchsorted(src[order], np.arange(n + 1)).astype(np.int32)
    return indptr, dst[order].astype(np.int32)


@pytest.mark.parametrize("n,m,cap,ecap,p", [
    (0, 0, 8, 16, 0.2), (5, 0, 8, 16, 0.2), (64, 256, 16, 512, 0.2),
    (333, 1000, 64, 2048, 0.2),
    (333, 1000, 512, 64, 0.9),       # ecap overflow: tails lost
    (2000, 300, 4096, 512, 1.0)])    # mostly zero-degree rows
def test_sparse_expand_ref_matches_pallas(n, m, cap, ecap, p):
    """Valid slots equal the reference bit for bit; the port defines its
    invalid slots as zeros (every caller masks them)."""
    indptr, indices = _csr(n, m, n + m)
    mask = np.random.default_rng(n).random(n) < p
    ids = np.array(jref.frontier_compact_ref(jnp.asarray(mask), cap)[0])
    got = ref.sparse_expand_ref(torch.as_tensor(indptr),
                                torch.as_tensor(indices),
                                torch.as_tensor(ids), ecap)
    valid = _np(got[3])
    for want in (sparse_expand_pallas(jnp.asarray(indptr),
                                      jnp.asarray(indices), jnp.asarray(ids),
                                      ecap, interpret=True),
                 jref.sparse_expand_ref(jnp.asarray(indptr),
                                        jnp.asarray(indices),
                                        jnp.asarray(ids), ecap)):
        assert _same(valid, want[3])
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(_np(g)[valid], np.asarray(w)[valid])
    for g in got[:3]:
        assert g.dtype == torch.int32 and not _np(g)[~valid].any()
    rows = ids[ids < n]
    total = int((indptr[rows + 1] - indptr[rows]).sum()) if n else 0
    assert int(valid.sum()) == min(total, ecap)


def _lookback(status, t, rng):
    """``lookback()`` of ``csrc/frontier_compact.cu``: tile t's exclusive
    prefix from the words of tiles t - 1, t - 2, ... 32 at a time, summed
    back to the nearest inclusive prefix (before tile 0: an empty one).
    ``status[u]`` is (aggregate, inclusive); a tile before t shows its
    inclusive prefix only where ``rng`` says it has published it yet."""
    excl = 0
    for end in range(t, -32, -32):
        words = []
        for lane in range(32):
            idx = end - 1 - lane
            if idx < 0:
                words.append(("prefix", 0))
            else:
                agg, incl = status[idx]
                shown = incl is not None and rng.random() < 0.5
                words.append(("prefix", incl) if shown else ("agg", agg))
        prefix = [f == "prefix" for f, _ in words]
        stop = prefix.index(True) if any(prefix) else 31
        excl += sum(v for _, v in words[:stop + 1])
        if any(prefix):
            return excl
    raise AssertionError("the look-back ran past tile 0")


def _tile_of(incl, e):
    """``tile_of()``: the least row tile whose inclusive prefix exceeds e,
    by the 32-ary search of one warp (lane l probes lo + (l + 1) stride -
    1)."""
    lo, hi = 0, len(incl)
    while lo < hi:
        stride = -(-(hi - lo) // 32)
        above = [lo + (lane + 1) * stride - 1 < hi
                 and incl[lo + (lane + 1) * stride - 1] > e
                 for lane in range(32)]
        if any(above):
            lane = above.index(True)
            lo, hi = lo + lane * stride, lo + (lane + 1) * stride - 1
        else:
            lo += min((hi - lo) // stride, 32) * stride
    return lo


def _expand_lookback(indptr, indices, ids, ecap, row_tile, slot_tile,
                     stage, seed=0):
    """``csrc/frontier_compact.cu`` ``expand_lookback`` step for step in
    numpy, a CTA at a time in ticket order: the row tiles (degree gather,
    scan, look-back, inclusive prefix, rows), then the slot tiles in the
    order the counter hands them out (total, the owning row tiles by the
    32-ary search, staged chunks of at most ``stage`` rows, one binary
    search a slot in the chunk, zero padding)."""
    rng = np.random.default_rng(seed)
    n, m, C = indptr.shape[0] - 1, indices.shape[0], ids.shape[0]
    R = -(-C // row_tile)
    status = [None] * R
    rows = np.full((C, 2), -7, np.int64)      # unwritten rows show as -7
    for t in range(R):
        c = np.arange(t * row_tile, min((t + 1) * row_tile, C))
        ok = (ids[c] >= 0) & (ids[c] < n)
        row = np.where(ok, ids[c], 0)
        rb = np.where(ok, indptr[row], 0)
        deg = np.where(ok, indptr[np.minimum(row + 1, n)] - rb, 0)
        agg = int(deg.sum())
        status[t] = (agg, None)
        excl = 0 if t == 0 else _lookback(status, t, rng)
        rows[c, 0] = excl + np.cumsum(deg) - deg
        rows[c, 1] = rb
        status[t] = (agg, excl + agg)
    incl = [w[1] for w in status]
    total = incl[R - 1]
    out = np.full((4, ecap), -9, np.int64)    # unwritten slots show as -9
    for k in range(-(-ecap // slot_tile)):
        e0, e_end = k * slot_tile, min((k + 1) * slot_tile, ecap)
        real_end = min(e_end, total)
        if e0 < real_end:
            first, last = _tile_of(incl, e0), _tile_of(incl, real_end - 1)
            for tk in range(first, last + 1, stage // row_tile):
                tk_end = min(tk + stage // row_tile, last + 1)
                lo = incl[tk - 1] if tk else 0
                r_lo = tk * row_tile
                staged = rows[r_lo:min(tk_end * row_tile, C)]
                assert (staged >= 0).all() and len(staged) <= stage
                for e in range(max(lo, e0), min(incl[tk_end - 1], real_end)):
                    a, b = 0, len(staged)
                    while b - a > 1:
                        mid = (a + b) // 2
                        a, b = (mid, b) if staged[mid, 0] <= e else (a, mid)
                    p = min(max(staged[a, 1] + e - staged[a, 0], 0), m - 1)
                    assert (out[:, e] == -9).all(), "slot written twice"
                    out[:, e] = ids[r_lo + a], indices[p], p, 1
        pad = np.arange(max(e0, total), e_end)
        assert (out[:, pad] == -9).all(), "padding over a written slot"
        out[:, pad] = 0
    assert (out != -9).all(), "a slot was never written"
    return out


@pytest.mark.parametrize("kind", ["hub", "sentinels", "zero_runs", "total0",
                                  "total_eq_ecap", "total_gt_ecap", "many"])
@pytest.mark.parametrize("tiles", [(4, 8, 8), (8, 16, 8), (2, 32, 16)])
def test_expand_lookback_walk(kind, tiles):
    """The one-launch sparse_expand's walk, replayed in numpy at small
    tiles (row tiles of 2-8 ids, slot tiles of 8-32, stages of 1-8 row
    tiles), equals ``ref.sparse_expand_ref``: a hub that spans many slot
    tiles, sentinel ids, runs of zero-degree rows, total 0, total = ecap,
    total > ecap (rows past ecap lose their tail), and over 32 row tiles
    (a look-back past one window, a search of several steps); the
    look-back sees a random mix of published aggregates and prefixes."""
    row_tile, slot_tile, stage = tiles
    rng = np.random.default_rng(len(kind) * 7 + row_tile)
    n = 120
    deg = rng.integers(1, 6, n)
    deg[rng.random(n) < 0.3] = 0
    if kind == "hub":
        deg[5] = 7 * slot_tile + 3
    if kind == "zero_runs":
        deg[10:60] = 0
    if kind == "total0":
        deg[:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    m = max(int(indptr[-1]), 1)
    indices = rng.integers(0, n, m)
    C = {"many": 40 * row_tile}.get(kind, 48)
    ids = np.sort(rng.choice(n, min(C, n), replace=False))
    ids = np.concatenate([ids, np.full(C - ids.size, n)])   # sentinels
    if kind == "sentinels":
        ids[rng.random(C) < 0.5] = n
        ids = np.sort(ids)
    total = int((deg[ids[ids < n]]).sum())
    ecap = {"total_eq_ecap": total, "total_gt_ecap": max(total // 2, 1),
            "hub": 8 * slot_tile + 5}.get(kind, total + 2 * slot_tile + 3)
    ecap = max(ecap, 1)
    got = _expand_lookback(indptr, indices, ids, ecap, row_tile, slot_tile,
                           stage, seed=row_tile)
    want = ref.sparse_expand_ref(*(torch.as_tensor(a.astype(np.int32))
                                   for a in (indptr, indices, ids)), ecap)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy().astype(np.int64))
    if kind == "many":
        assert -(-C // row_tile) > 32


@pytest.mark.parametrize("n,W,bv", [(0, 16, 256), (1, 16, 256),
                                    (333, 16, 128), (64, 8, 64),
                                    (1024, 32, 256), (7, 4, 256),
                                    (700, 16, 256)])
@pytest.mark.parametrize("pending_kind", ["random", "none", "one_block"])
def test_frontier_expand_ref_matches_pallas(n, W, bv, pending_kind):
    """n = 0, ragged tails (333, 7, 700 against the block), W in
    {4, 8, 16, 32}, no row pending, and every block but the first with
    nothing pending (the Pallas block skip)."""
    rng = np.random.default_rng(n * 5 + W)
    flags = rng.random((n, W)) < 0.2
    valid = rng.random((n, W)) < 0.8
    pending = {"random": rng.random(n) < 0.5, "none": np.zeros(n, bool),
               "one_block": np.arange(n) < min(bv, n) // 2}[pending_kind]
    got = ref.frontier_expand_ref(torch.as_tensor(flags),
                                  torch.as_tensor(valid),
                                  torch.as_tensor(pending))
    want = [jref.frontier_expand_ref(jnp.asarray(flags), jnp.asarray(valid),
                                     jnp.asarray(pending))]
    if n:   # the Pallas kernel pads to a block; its n = 0 return is static
        want.append(pallas_expand(jnp.asarray(flags), jnp.asarray(valid),
                                  jnp.asarray(pending), block_v=bv,
                                  interpret=True))
    for w in want:
        assert _same(got, w)
    assert got.dtype == torch.bool and got.shape == (n,)
    if pending_kind == "none":
        assert not got.any()


@pytest.mark.parametrize("n,bv", [(0, 512), (1, 512), (333, 128), (64, 64),
                                  (1024, 256), (7, 512), (513, 512)])
@pytest.mark.parametrize("alive_kind", ["random", "dead"])
def test_bucket_peel_ref_matches_pallas(n, bv, alive_kind):
    """Negative counters, k in {0, 1, 3, 7}, n = 0, ragged tails and the
    all-dead bucket (the Pallas block skip); k as a 1-element int32
    tensor, the form the engine passes."""
    rng = np.random.default_rng(n + 11)
    counters = rng.integers(-2, 8, n).astype(np.int32)
    alive = (rng.random(n) < 0.6 if alive_kind == "random"
             else np.zeros(n, bool))
    for k in (0, 1, 3, 7):
        got = ref.bucket_peel_ref(torch.as_tensor(counters),
                                  torch.as_tensor(alive),
                                  torch.tensor([k], dtype=torch.int32))
        want = [jref.bucket_peel_ref(jnp.asarray(counters),
                                     jnp.asarray(alive), k)]
        if n:
            want.append(bucket_peel_pallas(jnp.asarray(counters),
                                           jnp.asarray(alive), jnp.int32(k),
                                           block_v=bv, interpret=True))
        for w in want:
            assert _same(got, w)
        assert got.dtype == torch.bool and got.shape == (n,)
        assert _same(got, ref.bucket_peel_ref(torch.as_tensor(counters),
                                              torch.as_tensor(alive), k))
    if alive_kind == "dead":
        assert not got.any()


def _counter_case(n, b, seed, kind):
    """Counters, status and a (B,) update batch: sources in [-2, n] (the
    negatives and the sentinel n add nothing), deltas in [-2, 2] (zeros
    included); ``kind`` "dup" puts half the batch on one vertex, "one" all
    of it."""
    rng = np.random.default_rng(seed)
    counters = rng.integers(0, 5, n).astype(np.int32)
    status = rng.random(n) < 0.7
    src = rng.integers(-2, n + 1, b).astype(np.int32)
    if n and kind == "dup":
        src[::2] = rng.integers(0, n)
    if n and kind == "one":
        src[:] = rng.integers(0, n)
    delta = rng.integers(-2, 3, b).astype(np.int32)
    return counters, status, src, delta


# the cases of tests/test_kernels.py test_counter_scatter and
# test_counter_scatter_duplicate_sources, plus n = 0, B = 0 and n = 1
@pytest.mark.parametrize("n,b,bv,bu", [
    (333, 16, 128, 8), (64, 4, 64, 4), (1024, 256, 256, 64),
    (7, 3, 512, 256), (50, 1, 512, 256), (64, 32, 64, 8), (333, 64, 128, 16),
    (1, 5, 512, 256), (100, 0, 512, 256), (0, 4, 512, 256), (0, 0, 512, 256)])
@pytest.mark.parametrize("kind", ["random", "dup", "one", "zero_delta"])
def test_counter_scatter_ref_matches_pallas(n, b, bv, bu, kind):
    counters, status, src, delta = _counter_case(n, b, n * 31 + b, kind)
    if kind == "zero_delta":
        delta[:] = 0
    tc = torch.as_tensor(counters)
    before = tc.clone()
    got = ref.counter_scatter_ref(tc, torch.as_tensor(status),
                                  torch.as_tensor(src), torch.as_tensor(delta))
    assert torch.equal(tc, before)                   # inputs untouched
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[0].shape == got[1].shape == (n,)
    args = (jnp.asarray(counters), jnp.asarray(status), jnp.asarray(src),
            jnp.asarray(delta))
    wants = [jref.counter_scatter_ref(*args)]
    if n:                    # the Pallas kernel's grid needs a vertex
        wants.append(counter_scatter_pallas(*args, block_v=bv, block_u=bu,
                                            interpret=True))
    for want in wants:
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    # an independent numpy oracle
    ok = (src >= 0) & (src < n)
    new = counters.astype(np.int64)
    np.add.at(new, src[ok], delta[ok])
    assert _same(got[0], new) and _same(got[1], status & (new <= 0))


def test_ops_take_the_plain_path_on_cpu():
    """CPU tensors go to the plain versions and never count a launch."""
    _build.reset_launches()
    rng = np.random.default_rng(3)
    flags = torch.as_tensor(rng.random((100, 16)) < 0.5)
    active = torch.as_tensor(rng.random(100) < 0.5)
    got = ops.first_live_scan(flags, flags, active)
    assert _same(got[0], ref.first_live_ref(flags, flags, active)[0])
    x = torch.as_tensor(rng.integers(0, 5, 100).astype(np.int32))
    assert _same(ops.prefix_positions(x)[0], ref.prefix_positions_ref(x)[0])
    ids, _ = ops.frontier_compact(active, 64)
    assert _same(ids, ref.frontier_compact_ref(active, 64)[0])
    indptr, indices = _csr(100, 400, 1)
    ip, ix = torch.as_tensor(indptr), torch.as_tensor(indices)
    for g, w in zip(ops.sparse_expand(ip, ix, ids, 512),
                    ref.sparse_expand_ref(ip, ix, ids, 512)):
        assert _same(g, w)
    assert _same(ops.frontier_expand(flags, flags, active),
                 ref.frontier_expand_ref(flags, flags, active))
    start = torch.as_tensor(rng.integers(0, 5, 100).astype(np.int32))
    for g, w in zip(ops.first_live_probe(active, ip, ix, start, active, 16),
                    ref.first_live_probe_ref(active, ip, ix, start, active,
                                             16)):
        assert _same(g, w)
    k = torch.tensor([2], dtype=torch.int32)
    assert _same(ops.bucket_peel(x, active, k),
                 ref.bucket_peel_ref(x, active, k))
    src = torch.as_tensor(rng.integers(-1, 101, 50).astype(np.int32))
    delta = torch.as_tensor(rng.integers(-1, 2, 50).astype(np.int32))
    for g, w in zip(ops.counter_scatter(x, active, src, delta),
                    ref.counter_scatter_ref(x, active, src, delta)):
        assert _same(g, w)
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on a CUDA device or raises; it never
    falls back to the plain version."""
    b = torch.zeros((4, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tfls.first_live_scan(b, b, torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        tfc.prefix_positions(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tfc.frontier_compact(torch.zeros(4, dtype=torch.bool), 4)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.sparse_expand(z, z, z, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfex.frontier_expand(b, b, torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        tfls.first_live_probe(b[:, 0], torch.zeros(5, dtype=torch.int32), z,
                              z, b[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        tbpl.bucket_peel(z, torch.zeros(4, dtype=torch.bool), z[:1])
    with pytest.raises(TypeError, match="host value"):
        tbpl.bucket_peel(z, torch.zeros(4, dtype=torch.bool), 3)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.counter_scatter(z, torch.zeros(4, dtype=torch.bool), z, z)
    assert all(v == 0 for v in ops.LAUNCHES.values())


FLASH_CASES = [
    # tests/test_kernels.py's five shapes
    (1, 2, 2, 128, 128, 64, True, "f32"),
    (2, 4, 2, 256, 256, 64, True, "f32"),
    (1, 8, 2, 128, 256, 128, False, "f32"),
    (1, 2, 1, 256, 512, 64, True, "f32"),      # sk > sq (prefix)
    (1, 4, 4, 128, 128, 64, True, "bf16"),
    # Sq > Sk: skipped q blocks give 0, fully masked rows of computed
    # blocks the mean of v over the computed kv blocks
    (1, 2, 1, 256, 128, 64, True, "f32"),
    (1, 4, 2, 128, 64, 32, True, "f32"),
    (1, 2, 1, 256, 128, 16, True, "bf16"),
    # D = 16 and 128, GQA group 3, one short block
    (1, 3, 1, 128, 128, 16, True, "f32"),
    (2, 2, 2, 48, 48, 128, True, "bf16"),
]


def _flash_inputs(b, hq, hkv, sq, sk, d, dt):
    rng = np.random.default_rng(sq * 3 + sk + d + hq)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.as_tensor(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,dt", FLASH_CASES)
def test_flash_attention_ref_matches_pallas(b, hq, hkv, sq, sk, d, causal,
                                            dt):
    """The plain version of the flash kernel against the Pallas kernel in
    interpret mode (and the naive oracles where Sq <= Sk), at
    tests/test_kernels.py's tolerances: 2e-5 in f32, 2e-2 in bf16."""
    jx, tx = _flash_inputs(b, hq, hkv, sq, sk, d, dt)
    got = ref.flash_attention_ref(*tx, causal=causal)
    assert got.dtype == tx[0].dtype and got.shape == (b, hq, sq, d)
    wants = [pallas_flash(*jx, causal=causal, interpret=True)]
    if sq <= sk:
        wants.append(jref.attention_ref(*jx, causal=causal))
        wants.append(ref.attention_ref(*tx, causal=causal).float())
    tol = 2e-5 if dt == "f32" else 2e-2
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    # ops takes the plain version for CPU tensors and counts no launch
    same = ops.flash_attention(*tx, causal=causal)
    assert torch.equal(same, got)
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("sq,sk", [(256, 128), (128, 64)])
def test_flash_attention_masked_rows(sq, sk):
    """Sq > Sk, rows that see no key: in a q block that computes no kv
    block the kernel gives 0 where the naive oracle averages v over all
    keys; in a computed block both give that mean (with the reference's
    blocks, such a block always spans every key).  The plain version
    keeps the kernel's rows."""
    jx, tx = _flash_inputs(1, 2, 1, sq, sk, 32, "f32")
    got = ref.flash_attention_ref(*tx).numpy()
    kernel = np.asarray(pallas_flash(*jx, interpret=True))
    oracle = ref.attention_ref(*tx).numpy()
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(oracle, np.asarray(jref.attention_ref(*jx)),
                               atol=2e-5, rtol=2e-5)
    seen = np.arange(sq) >= sq - sk          # q_pos = row - (sq - sk) >= 0
    np.testing.assert_allclose(got[:, :, seen], oracle[:, :, seen],
                               atol=2e-5, rtol=2e-5)
    skipped = np.arange(sq) < (sq - sk) // 128 * 128
    assert not got[:, :, skipped].any()
    if skipped.any():                        # the oracle's are not zero
        assert np.abs(oracle[:, :, skipped]).max() > 1e-3
    mean_v = tx[2].numpy().mean(axis=2, keepdims=True)
    rows = ~seen & ~skipped
    np.testing.assert_allclose(got[:, :, rows],
                               np.broadcast_to(mean_v, got[:, :, rows].shape),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_block_divisibility():
    """A sequence longer than one block must be a multiple of it: the
    reference asserts, the port raises ValueError on both paths."""
    jx, tx = _flash_inputs(1, 2, 2, 200, 200, 16, "f32")
    with pytest.raises(AssertionError):
        pallas_flash(*jx, interpret=True)
    with pytest.raises(ValueError, match="multiples"):
        ref.flash_attention_ref(*tx)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(*tx)


# chip_smoke.py's tolerances for the flash kernels against their plain
# version: one bf16 rounding of outputs of size ~1 (2^-8 relative), and f32
# sums in other orders
FLASH_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _split_p(p):
    """flash_fwd_wgmma's p on its way to PV: two bf16 halves, summed in
    the f32 accumulator."""
    hi = p.bfloat16().float()
    return hi + (p - hi).bfloat16().float()


def _flash_emulation(q, k, v, causal=True, p_round=_split_p,
                     dtype=torch.float32, mm=torch.einsum):
    """A plain emulation of flash_fwd_wgmma's rounding: q, k, v as given
    (bf16 values, exact in f32), products and the online softmax in
    ``dtype`` over the reference's blocks (128-key tiles, the causal skip,
    -1e30 inside computed blocks, ``l == 0`` -> 1), the denominator summing
    the unrounded p, and ``p_round(p)`` entering the PV product.  Both
    products are ``mm(equation, a, b)``: :func:`_x3` emulates
    flash_fwd_tf32x3's.  Returns (B, Hq, Sq, D) in ``dtype``."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    bq, bk = ref.flash_blocks(sq, sk)
    qf = q.to(dtype).reshape(b, hkv, g, sq, d)
    kf, vf = k.to(dtype), v.to(dtype)
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros((b, hkv, g, sq, d), dtype=dtype)
    for qi in range(sq // bq):
        qb = qf[:, :, :, qi * bq:(qi + 1) * bq]
        m = torch.full((b, hkv, g, bq, 1), ref.NEG_INF, dtype=dtype)
        l = torch.zeros((b, hkv, g, bq, 1), dtype=dtype)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=dtype)
        q_pos = sk - sq + qi * bq + torch.arange(bq)
        for ki in range(sk // bk):
            if causal and sk - sq + qi * bq + bq - 1 < ki * bk:
                continue
            s = mm("bhgqd,bhkd->bhgqk", qb,
                   kf[:, :, ki * bk:(ki + 1) * bk]) * scale
            if causal:
                k_pos = ki * bk + torch.arange(bk)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm(
                "bhgqk,bhkd->bhgqd", p_round(p),
                vf[:, :, ki * bk:(ki + 1) * bk])
            m = m_new
        out[:, :, :, qi * bq:(qi + 1) * bq] = acc / torch.where(l == 0, 1, l)
    return out.reshape(b, hq, sq, d)


WGMMA_CASES = [
    (1, 2, 1, 128, 256, 64, True),       # Sq < Sk, GQA group 2
    (1, 2, 2, 128, 128, 128, False),     # non-causal
    (1, 2, 1, 256, 128, 64, True),       # Sq > Sk: a zero block, mean rows
    (1, 3, 1, 128, 64, 128, True),       # Sq > Sk: mean rows, group 3
    (2, 4, 2, 256, 256, 128, True),      # causal, two tiles a row
    (1, 2, 1, 48, 96, 64, False),        # one short tile each
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", WGMMA_CASES)
def test_flash_wgmma_rounding_matches_pallas(b, hq, hkv, sq, sk, d, causal):
    """flash_fwd_wgmma's arithmetic (bf16 products exact in f32, p split
    into two bf16 halves for PV), emulated on the CPU, against the Pallas
    kernel in interpret mode: on bf16 inputs to FLASH_TOL["bfloat16"] after
    the output's bf16 rounding, and on the same values in f32 to
    FLASH_TOL["float32"] before it."""
    jx, tx = _flash_inputs(b, hq, hkv, sq, sk, d, "bf16")
    emu = _flash_emulation(*tx, causal=causal)
    want = np.asarray(pallas_flash(*jx, causal=causal, interpret=True),
                      np.float32)
    np.testing.assert_allclose(emu.bfloat16().float().numpy(), want,
                               atol=FLASH_TOL["bfloat16"], rtol=0)
    want32 = pallas_flash(*[jnp.asarray(t.float().numpy()) for t in tx],
                          causal=causal, interpret=True)
    np.testing.assert_allclose(emu.numpy(), np.asarray(want32),
                               atol=FLASH_TOL["float32"], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_split_beats_one_rounding(causal):
    """Why p is split: against an f64 run of the same blocks, the split's
    error is at least 10x below that of rounding p to bf16 once."""
    _, tx = _flash_inputs(1, 4, 1, 256, 256, 128, "bf16")
    exact = _flash_emulation(*tx, causal=causal, p_round=lambda p: p,
                             dtype=torch.float64)
    split = _flash_emulation(*tx, causal=causal)
    once = _flash_emulation(*tx, causal=causal,
                            p_round=lambda p: p.bfloat16().float())
    err_split = float((split.double() - exact).abs().max())
    err_once = float((once.double() - exact).abs().max())
    assert 10 * err_split <= err_once, (err_split, err_once)


def _tf32(x, mode="trunc"):
    """float32 -> TF32 (10 mantissa bits) through an int32 view: the low
    13 bits cut ("trunc": flash_fwd_tf32x3's split, and how a TF32 product
    reads an f32 operand), or rounded to nearest, ties to even ("rne")."""
    u = x.contiguous().view(torch.int32)
    if mode == "rne":
        u = u + 0xFFF + ((u >> 13) & 1)
    return (u & -8192).view(torch.float32)


def _x3(mode="trunc"):
    """flash_fwd_tf32x3's product as an ``mm(equation, a, b)``: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), the product
    taken as lo_a hi_b + hi_a lo_b + hi_a hi_b in f32, small terms
    first."""
    def mm(eq, a, b):
        ah, bh = _tf32(a, mode), _tf32(b, mode)
        al, bl = _tf32(a - ah, mode), _tf32(b - bh, mode)
        return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, ah, bh))
    return mm


def _one_pass(eq, a, b):
    """One TF32 product: both operands rounded once."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


@pytest.mark.parametrize("mode", ["trunc", "rne"])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_tf32x3_split_matches_pallas(d, mode):
    """flash_fwd_tf32x3's arithmetic (Q K^T and P V each as three TF32
    products of split operands, p split too), emulated on the CPU, against
    the Pallas kernel in interpret mode on the same f32 inputs within
    FLASH_TOL["float32"]: with the kernel's truncation, and with the split
    rounded to nearest, ties to even."""
    jx, tx = _flash_inputs(2, 4, 2, 256, 256, d, "f32")
    emu = _flash_emulation(*tx, p_round=lambda p: p, mm=_x3(mode))
    want = np.asarray(pallas_flash(*jx, causal=True, interpret=True))
    np.testing.assert_allclose(emu.numpy(), want,
                               atol=FLASH_TOL["float32"], rtol=0)


def test_flash_tf32x3_one_pass_breaks_the_contract():
    """Why each operand is split: one TF32 pass misses
    FLASH_TOL["float32"] against the Pallas kernel, and the 3xTF32 split
    comes in at least 100x closer."""
    jx, tx = _flash_inputs(2, 4, 2, 256, 256, 64, "f32")
    want = np.asarray(pallas_flash(*jx, causal=True, interpret=True))
    once = _flash_emulation(*tx, p_round=lambda p: p, mm=_one_pass)
    split = _flash_emulation(*tx, p_round=lambda p: p, mm=_x3())
    err_once = float(np.abs(once.numpy() - want).max())
    err_split = float(np.abs(split.numpy() - want).max())
    assert err_once > FLASH_TOL["float32"]
    assert 100 * err_split <= err_once, (err_split, err_once)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_wgmma_dispatch(dt, d):
    """The wrapper picks the kernel from (dtype, D) alone, and every D of
    both dtypes runs on the tensor cores: bf16 on flash_fwd_wgmma, f32 on
    flash_fwd_tf32x3, each instantiation within a block's 227 KB of
    shared memory; other dtypes and widths have no kernel."""
    want = ("flash_fwd_wgmma" if dt == torch.bfloat16
            else "flash_fwd_tf32x3")
    assert tfa.kernel_for(dt, d) == want
    smem = tfa.smem_bytes(dt, d)
    assert 0 < smem <= tfa.SMEM_LIMIT == 227 * 1024
    assert smem == (5 * 128 * d * 2 if dt == torch.bfloat16
                    else (128 + 5 * 64) * d * 4) + 64 + 1024
    with pytest.raises(ValueError, match="no kernel"):
        tfa.kernel_for(dt, d + 8)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.kernel_for(torch.float16, d)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_input_alignment_rule(dt):
    """Both kernels read their inputs by strides under TMA's rule: a
    16-byte aligned base, the last dimension contiguous, the other strides
    multiples of 16 bytes; an input that breaks it is copied by the
    wrapper."""
    step = 128 // torch.finfo(dt).bits              # elements in 16 bytes
    x = torch.zeros((2, 4, 128, 64 + step), dtype=dt)
    assert tfa.tma_ready(x[..., :64])
    assert tfa.tma_ready(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert tfa.tma_ready(x[:, :, ::2, :64])          # sliced keys
    one = torch.as_strided(torch.zeros(4 * 128 * 64, dtype=dt),
                           (1, 4, 128, 64), (3, 128 * 64, 64, 1))
    assert tfa.tma_ready(one)            # a length-1 dim is never stepped
    assert not tfa.tma_ready(x.view(-1)[1:1 + 2 * 4 * 128 * 64]
                             .view(2, 4, 128, 64))       # one-element offset
    y = torch.zeros((2, 4, 128, 64 + step // 2), dtype=dt)
    assert not tfa.tma_ready(y[..., :64])                # 8-byte row step
    assert not tfa.tma_ready(x[..., :64].transpose(2, 3))


def test_flash_attention_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on a CUDA device or raises, and an
    unsupported head dim or dtype raises before any device question."""
    _, tx = _flash_inputs(1, 2, 2, 16, 16, 16, "f32")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(*tx)
    _, t48 = _flash_inputs(1, 2, 2, 16, 16, 48, "f32")
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(*t48)
    with pytest.raises(TypeError, match="float32 or"):
        tfa.flash_attention(*(t.half() for t in tx))
    assert ops.LAUNCHES["flash_attention"] == 0


# the cases of tests/test_kernels.py's test_segment_sum (m, d, n, be, bn),
# its numpy-oracle cases with ids in [-2, n + 2), and 3-D values, m = 0,
# bf16 and a column slice
SEGMENT_CASES = [
    (1000, (32,), 177, 256, 128, "f32", False), (512, (8,), 64, 128, 64,
                                                 "f32", False),
    (77, (16,), 33, 512, 512, "f32", False),
    (513, (16,), 37, 128, 64, "f32", True), (128, (4,), 200, 128, 64, "f32",
                                             True),
    (300, (5, 8), 41, 128, 64, "f32", True), (96, (3,), 10, 128, 64, "bf16",
                                              True),
    (0, (6,), 9, 128, 64, "f32", False)]


@pytest.mark.parametrize("m,rest,n,be,bn,dt,oob", SEGMENT_CASES)
def test_segment_sum_ref_matches_pallas(m, rest, n, be, bn, dt, oob):
    rng = np.random.default_rng(m * 7 + n)
    vals = rng.normal(size=(m,) + rest).astype(np.float32)
    ids = rng.integers(-2 if oob else 0, n + 2 if oob else n,
                       m).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    tv = torch.as_tensor(vals).to(tdt)
    got = ops.segment_sum(tv, torch.as_tensor(ids), n)
    assert got.dtype == torch.float32 and got.shape == (n,) + rest
    assert torch.equal(got, ref.segment_sum_ref(tv, torch.as_tensor(ids), n))
    want64 = np.zeros((n,) + rest, np.float64)
    ok = (ids >= 0) & (ids < n)
    np.add.at(want64, ids[ok], tv.float().numpy()[ok].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want64, atol=1e-4, rtol=1e-4)
    if m == 0:       # the Pallas kernel takes no empty input
        return
    d = int(np.prod(rest))
    want = segment_sum_pallas(jnp.asarray(vals.reshape(m, d), jdt),
                              jnp.asarray(ids), n, block_e=be, block_n=bn,
                              interpret=True)
    np.testing.assert_allclose(got.numpy().reshape(n, d), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_segment_sum_column_slice_and_int64_ids():
    rng = np.random.default_rng(5)
    wide = torch.as_tensor(rng.normal(size=(200, 12)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 30, 200))
    got = ops.segment_sum(wide[:, 2:9], ids, 30)
    want = ops.segment_sum(wide[:, 2:9].contiguous(), ids.to(torch.int32),
                           30)
    assert torch.equal(got, want)


def test_segment_sum_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on a CUDA device or raises; bad dtypes
    and shapes raise before any device question."""
    v, ids = torch.zeros((4, 3)), torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tss.segment_sum(v, ids, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tss.segment_sum(v.half(), ids, 2)
    with pytest.raises(TypeError, match="int32 or int64"):
        tss.segment_sum(v, ids.to(torch.int16), 2)
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        tss.segment_sum(v[None], ids, 2)
    assert ops.LAUNCHES["segment_sum"] == 0


# segment_index: (m, n, id range, id dtype) — in range with empty
# segments, out of range and negative ids, one hub, no rows
INDEX_CASES = [(200, 50, (0, 50), np.int32), (200, 300, (0, 300), np.int64),
               (513, 37, (-3, 40), np.int32), (513, 37, (-3, 40), np.int64),
               (300, 7, (4, 5), np.int32), (0, 9, (0, 9), np.int32)]


@pytest.mark.parametrize("m,n,span,dt", INDEX_CASES)
def test_segment_index_matches_numpy_argsort(m, n, span, dt):
    """``order`` is numpy's stable argsort of the in-range ids, then the
    dropped rows in row order; ``offsets`` each segment's first slot, so
    segment s owns ``order[offsets[s]:offsets[s + 1]]``."""
    rng = np.random.default_rng(m + n)
    ids = rng.integers(*span, m).astype(dt)
    index = ops.segment_index(torch.as_tensor(ids), n)
    ok = (ids >= 0) & (ids < n)
    keys = np.where(ok, ids, n)
    assert index.order.dtype == index.offsets.dtype == torch.int32
    assert np.array_equal(index.order.numpy(),
                          np.argsort(keys, kind="stable"))
    want = np.concatenate([[0], np.cumsum(np.bincount(keys[ok],
                                                      minlength=n))])
    assert np.array_equal(index.offsets.numpy(), want)
    for s in range(n):
        rows = index.order[index.offsets[s]:index.offsets[s + 1]].numpy()
        assert np.array_equal(rows, np.flatnonzero(ids == s))


@pytest.mark.parametrize("m,rest,n,be,bn,dt,oob", SEGMENT_CASES)
def test_segment_sum_with_index_matches_pallas(m, rest, n, be, bn, dt,
                                               oob):
    """``ops.segment_sum`` with the caller's index equals the call without
    one, and the Pallas segment sum (interpret mode) at that file's
    1e-4."""
    rng = np.random.default_rng(m * 5 + n)
    vals = rng.normal(size=(m,) + rest).astype(np.float32)
    ids = rng.integers(-2 if oob else 0, n + 2 if oob else n,
                       m).astype(np.int32)
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    tv, ti = torch.as_tensor(vals).to(tdt), torch.as_tensor(ids)
    got = ops.segment_sum(tv, ti, n, ops.segment_index(ti, n))
    assert torch.equal(got, ops.segment_sum(tv, ti, n))
    if m == 0:       # the Pallas kernel takes no empty input
        return
    d = int(np.prod(rest))
    want = segment_sum_pallas(
        jnp.asarray(vals.reshape(m, d),
                    jnp.float32 if dt == "f32" else jnp.bfloat16),
        jnp.asarray(ids), n, block_e=be, block_n=bn, interpret=True)
    np.testing.assert_allclose(got.numpy().reshape(n, d), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def _merge_path_sum(vals, order, offsets, n, items, workers, groups):
    """``csrc/segment_sum.cu`` ``segment_rows`` step for step in numpy, a
    CTA of ``groups`` workers at a time in ticket order: the CTA's two
    path coordinates by the 16-ary warp search, each worker's by a binary
    search within them; each worker's rows in order, an output row at each
    segment end but its head, its tail left for the CTA; the CTA's carry;
    then each head with the tails before it and the carries of the CTAs
    before it, nearest first.  Asserts that every output row is written
    exactly once and that no CTA reads a carry that was never published."""
    d = vals.shape[1]
    rows = int(offsets[n])
    path = rows + n
    out = np.full((n, d), np.nan, np.float32)
    carries = {}                    # ticket -> (carry, runs further back)

    def below(diag, s):
        return offsets[s + 1] + s + 1 <= diag

    def check(diag, x):
        assert (x == 0 or below(diag, x - 1)) and (
            x == n or not below(diag, x)), "not the merge path"
        return x

    def search(diag, lo, hi):
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if below(diag, mid) else (lo, mid)
        return check(diag, lo)

    def search_warp(diag):
        lo, hi = max(0, diag - rows), min(diag, n)
        while lo < hi:
            span = hi - lo
            c = sum(below(diag, lo + (k + 1) * span // 17) for k in range(16))
            lo, hi = (lo + c * span // 17 + 1 if c else lo,
                      lo + (c + 1) * span // 17 if c < 16 else hi)
        return check(diag, lo)

    def emit(x, acc):
        assert np.isnan(out[x]).all(), f"row {x} written twice"
        out[x] = acc

    def through(flags):
        return flags[0] and flags[1]          # head cut and no end

    for t in range(-(-workers // groups)):
        c0 = min(t * groups * items, path)
        c1 = min(c0 + groups * items, path)
        xs = [search_warp(c0)] + [0] * (groups - 1) + [search_warp(c1)]
        for g in range(1, groups):
            d0 = min(c0 + g * items, path)
            xs[g] = search(d0, max(d0 - rows, xs[0]), min(d0, xs[groups]))
        tails, flags, heads = [], [], {}
        for g in range(groups):
            d0 = min(c0 + g * items, path)
            d1 = min(d0 + items, path)
            x, x1 = xs[g], xs[g + 1]
            head_cut = x < n and offsets[x] < d0 - x
            acc, first, partial = np.zeros(d, np.float32), True, False
            end = offsets[x + 1] if x < n else 0
            for r in range(d0 - x, d1 - x1):
                while end <= r:
                    if first and head_cut:
                        heads[g] = (x, acc)
                    else:
                        emit(x, acc)
                    acc, first, partial = np.zeros(d, np.float32), False, \
                        False
                    x += 1
                    end = offsets[x + 1]
                acc = acc + vals[order[r]]
                partial = True
            for x in range(x, x1):
                if first and head_cut:
                    heads[g] = (x, acc)
                else:
                    emit(x, acc)
                acc, first, partial = np.zeros(d, np.float32), False, False
            tails.append(acc)
            flags.append((head_cut, first, partial))
        if flags[-1][2]:
            j, acc = groups - 1, tails[-1]
            while j > 0 and through(flags[j]):
                j -= 1
                acc = acc + tails[j]
            carries[t] = (acc, through(flags[j]))
        for g, (x, acc) in heads.items():
            j, back = g, True
            while back and j > 0:
                j -= 1
                acc = acc + tails[j]
                back = through(flags[j])
            u = t - 1
            while back:
                assert u in carries, f"ticket {t} reads {u}'s unpublished carry"
                carry, back = carries[u]
                acc, u = acc + carry, u - 1
            emit(x, acc)
    assert not np.isnan(out).any(), "an output row was never written"
    return out


@pytest.mark.parametrize("kind", ["uniform", "hub", "empty", "oob"])
@pytest.mark.parametrize("items", [None, 1, 3, 7])
@pytest.mark.parametrize("groups", [None, 3])
def test_segment_sum_merge_path_walk(kind, items, groups):
    """The kernel's merge-path split and carries, replayed on the CPU, sum
    like ``np.add.at``: the wrapper's split (None) and short ranges that
    cut segments across many workers; CTAs of the kernel's 128 workers at
    d = 6 and of 3, so segments run across many CTAs; a hub over most
    rows, mostly empty segments, out-of-range and negative ids."""
    rng = np.random.default_rng(len(kind) * 11 + (items or 0))
    m, n, d = 400, 60, 6
    ids = {"uniform": rng.integers(0, n, m),
           "hub": np.where(rng.random(m) < 0.8, 17, rng.integers(0, n, m)),
           "empty": rng.integers(0, 4, m) * 15,
           "oob": rng.integers(-3, n + 3, m)}[kind].astype(np.int32)
    vals = rng.normal(size=(m, d)).astype(np.float32)
    lanes, chunks, split_items, workers = tss.split(m, n, d, tss.META_SMS)
    assert lanes == 2 and chunks == 1 and workers * split_items >= m + n
    if items is not None:
        workers = -(-(m + n) // items)
    index = ops.segment_index(torch.as_tensor(ids), n)
    got = _merge_path_sum(vals, index.order.numpy(), index.offsets.numpy(),
                          n, items or split_items, workers,
                          groups or tss.THREADS // lanes)
    want = np.zeros((n, d))
    ok = (ids >= 0) & (ids < n)
    np.add.at(want, ids[ok], vals[ok].astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,n,d", [(168_960, 169_984, 128), (8192, 3840, 1),
                                   (8192, 3840, 6272), (61_859_140,
                                                        2_449_029, 128),
                                   (1, 1, 3), (10, 5, 640)])
@pytest.mark.parametrize("sms", [132, 114])          # H100 SXM, H100 PCIe
def test_segment_sum_split_covers_the_path(m, n, d, sms):
    """Every split covers the m + n items and the d columns, with a
    power-of-two group of at most a warp, within the card's grid."""
    lanes, chunks, items, workers = tss.split(m, n, d, sms)
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes >= min(32, -(-d // 4))
    assert chunks * 4 * lanes >= d > (chunks - 1) * 4 * lanes
    assert items >= tss.MIN_ITEMS and workers * items >= m + n
    assert (workers - 1) * items < m + n and chunks <= 65_535
    assert -(-workers // (tss.THREADS // lanes)) * chunks < 2 ** 31
