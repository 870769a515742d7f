"""The PyTorch port's kernel layer against the JAX reference, on the CPU.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held against
the JAX Pallas kernel (interpret mode) and the JAX ref twin on the same
numpy inputs.  All outputs are int32 or bool, so the tolerance is exact.
The CUDA kernels themselves run only on a card: ``tests/test_torch_gpu.py``
holds them against these plain versions there.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.first_live_scan import first_live_scan as pallas_first_live
from repro.kernels.frontier_compact import (frontier_compact_pallas,
                                            prefix_positions,
                                            sparse_expand_pallas)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import first_live_scan as tfls
from repro_torch.kernels import frontier_compact as tfc

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
    assert all(v == 0 for v in ops.LAUNCHES.values())
