"""The least-bytes count on hand-made graphs (PERF.md gives the
formula)."""
import torch

from trimbench import csr, leastbytes, reference


def graph(n, arcs):
    src = torch.tensor([a for a, _ in arcs], dtype=torch.int32)
    dst = torch.tensor([b for _, b in arcs], dtype=torch.int32)
    return csr.from_edges(n, src, dst)


def count(method, n, arcs):
    g = graph(n, arcs)
    live, _ = reference.trim(*g)
    return leastbytes.least_bytes(method, *g, live)


def test_chain():
    arcs = [(0, 1), (1, 2)]
    # indptr 16; arcs 0-1 in one sector 32; targets {1, 2} 2; status 3
    assert count("ac6", 3, arcs) == 16 + 32 + 2 + 3
    # 2 indptrs 32; Gt in-rows of 1 and 2 in one sector 32; counters 12;
    # status 3
    assert count("ac4", 3, arcs) == 32 + 32 + 12 + 3


def test_cycle():
    arcs = [(0, 1), (1, 2), (2, 0)]
    # each kept vertex reads its first arc: one sector; 3 targets
    assert count("ac6", 3, arcs) == 16 + 32 + 3 + 3
    # nothing removed: no in-row read
    assert count("ac4", 3, arcs) == 32 + 0 + 12 + 3


def test_star_spans_sectors():
    arcs = [(0, t) for t in range(1, 21)]
    # 20 arcs = 80 bytes = sectors 0, 1, 2
    assert count("ac6", 21, arcs) == 4 * 22 + 96 + 20 + 21
    assert count("ac4*", 21, arcs) == 8 * 22 + 96 + 4 * 21 + 21


def test_kept_vertex_reads_up_to_its_first_kept_target():
    # 0 -> 1..9 (sinks), then 0 -> 10 <-> 11: 0 reads all ten arcs
    arcs = [(0, t) for t in range(1, 11)] + [(10, 11), (11, 10)]
    assert count("ac6", 12, arcs) == 4 * 13 + 64 + 11 + 12


def test_sector_union_counts_shared_sectors_once():
    starts = torch.tensor([0, 2, 7])
    lengths = torch.tensor([3, 3, 2])      # entries 0-4 and 7-8
    assert leastbytes.sector_bytes(starts, lengths, 16) == 64
    assert leastbytes.sector_bytes(starts[:1], lengths[:1] * 0, 16) == 0


def test_unknown_method_has_no_count():
    assert leastbytes.least_bytes("ac3", *graph(2, [(0, 1)]),
                                  torch.zeros(2, dtype=torch.bool)) is None
