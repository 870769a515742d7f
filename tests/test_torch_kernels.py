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
