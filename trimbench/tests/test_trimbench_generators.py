"""The generators: sizes, determinism by seed, and what a seed may
change (the labels) and may not (the structure)."""
import pytest
import torch

from trimbench import csr, spec

CONFIGS = [("g500-kron-s24", 10), ("g500-kron-s24", 12),
           ("gap-urand-s26", 10), ("gap-urand-s26", 12)]


def make(name, scale, seed):
    cfg = dict(spec.load_json("configs", name), scale=scale)
    gen = spec.load_module("generators", cfg["generator"])
    return cfg, gen.make(cfg, seed, "cpu")


def canonical(indptr, indices):
    """The sorted arc list, labels included."""
    deg = (indptr[1:] - indptr[:-1]).long()
    src = torch.repeat_interleave(torch.arange(deg.numel()), deg)
    key = src * deg.numel() + indices.long()
    return torch.sort(key).values


def degree_profile(indptr, indices):
    n = indptr.numel() - 1
    out = torch.sort(indptr[1:] - indptr[:-1]).values
    inn = torch.sort(torch.bincount(indices.long(), minlength=n)).values
    return out, inn


@pytest.mark.parametrize("name,scale", CONFIGS)
def test_sizes_and_dtypes(name, scale):
    cfg, (indptr, indices) = make(name, scale, 3)
    n = 1 << scale
    assert indptr.dtype == indices.dtype == torch.int32
    assert indptr.numel() == n + 1 and int(indptr[0]) == 0
    assert int(indptr[-1]) == indices.numel()
    assert bool((indptr[1:] >= indptr[:-1]).all())
    assert bool((indices >= 0).all()) and bool((indices < n).all())
    per = cfg.get("edgefactor", cfg.get("degree"))
    if cfg["generator"] == "kronecker":
        assert indices.numel() == per * n
    else:      # self-loops and duplicates removed: a few fewer
        # about C(16, 2) + 16 arcs removed at any scale
        assert per * n - 400 <= indices.numel() < per * n


@pytest.mark.parametrize("name,scale", CONFIGS)
def test_same_seed_same_graph(name, scale):
    _, a = make(name, scale, 2**31 + 11)
    _, b = make(name, scale, 2**31 + 11)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name,scale", CONFIGS)
def test_seed_relabels_the_same_structure(name, scale):
    _, (p0, i0) = make(name, scale, 1)
    _, (p1, i1) = make(name, scale, 2)
    assert not torch.equal(i0, i1)
    d0, d1 = degree_profile(p0, i0), degree_profile(p1, i1)
    assert torch.equal(d0[0], d1[0]) and torch.equal(d0[1], d1[1])


@pytest.mark.parametrize("name,scale", CONFIGS)
def test_seed_keeps_each_rows_order(name, scale):
    """Relabelling keeps every row's order: each row, read as the
    sequence of its targets' in-degrees (which labels do not change), is
    found under every seed."""
    cfg, (p0, i0) = make(name, scale, 1)
    _, (p1, i1) = make(name, scale, 2)
    n = 1 << scale

    def rows(indptr, indices):
        din = torch.bincount(indices.long(), minlength=n)
        deg = (indptr[1:] - indptr[:-1]).tolist()
        ip = indptr.tolist()
        return sorted(tuple(din[indices[ip[v]:ip[v] + deg[v]].long()].tolist())
                      for v in range(n))
    assert rows(p0, i0) == rows(p1, i1)


def test_structure_seed_changes_the_graph():
    cfg, (p0, i0) = make("g500-kron-s24", 10, 1)
    gen = spec.load_module("generators", "kronecker")
    p1, i1 = gen.make(dict(cfg, structure_seed=2), 1, "cpu")
    assert not torch.equal(degree_profile(p0, i0)[0],
                           degree_profile(p1, i1)[0])


def test_kronecker_is_skewed_and_urand_is_not():
    _, (pk, _) = make("g500-kron-s24", 12, 5)
    _, (pu, _) = make("gap-urand-s26", 12, 5)
    dk, du = pk[1:] - pk[:-1], pu[1:] - pu[:-1]
    assert int(dk.max()) > 10 * 16 and float((dk == 0).float().mean()) > 0.2
    assert int(du.max()) < 4 * 16 and int((du == 0).sum()) == 0


def test_from_edges_keeps_row_order_or_squishes():
    src = torch.tensor([2, 0, 2, 0, 1, 1], dtype=torch.int32)
    dst = torch.tensor([1, 3, 0, 3, 1, 0], dtype=torch.int32)
    indptr, indices = csr.from_edges(4, src, dst)
    assert indptr.tolist() == [0, 2, 4, 6, 6]
    assert indices.tolist() == [3, 3, 1, 0, 1, 0]
    indptr, indices = csr.from_edges(4, *csr.squish(4, src, dst))
    assert indptr.tolist() == [0, 1, 2, 4, 4]
    assert indices.tolist() == [3, 0, 0, 1]


def test_large_seeds_are_taken():
    for seed in (0, 2**31, 2**40 + 3, -5):
        csr.generator(seed, "cpu")
