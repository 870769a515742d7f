"""The plain reference against brute force on hand-made graphs, and its
closed-form counters against a step-by-step AC-6 and AC-4 and against
the port on the CPU."""
import random

import pytest
import torch

from trimbench import csr, reference, spec


def graph(n, arcs):
    src = torch.tensor([a for a, _ in arcs], dtype=torch.int32)
    dst = torch.tensor([b for _, b in arcs], dtype=torch.int32)
    return csr.from_edges(n, src, dst)


def rows(indptr, indices):
    ip, ix = indptr.tolist(), indices.tolist()
    return [ix[ip[v]:ip[v + 1]] for v in range(len(ip) - 1)]


def brute_live(indptr, indices):
    """v stays iff some vertex reachable from v lies on a cycle."""
    adj = rows(indptr, indices)
    n = len(adj)

    def reach(v):
        seen, todo = set(), list(adj[v])
        while todo:
            u = todo.pop()
            if u not in seen:
                seen.add(u)
                todo.extend(adj[u])
        return seen

    r = [reach(v) for v in range(n)]
    on_cycle = {v for v in range(n) if v in r[v]}
    return [bool(on_cycle & (r[v] | {v})) for v in range(n)]


def stepwise_ac6(indptr, indices):
    """AC-6 in BSP rounds, one vertex at a time: per-vertex probes."""
    adj = rows(indptr, indices)
    n = len(adj)
    status = [True] * n
    ptr = [-1] * n
    probes = [0] * n
    affected = set(range(n))
    while affected:
        snap = list(status)
        for v in affected:
            p = ptr[v] + 1
            while p < len(adj[v]) and not snap[adj[v][p]]:
                p += 1
            probes[v] += min(p + 1, len(adj[v])) - (ptr[v] + 1)
            ptr[v] = p
            if p >= len(adj[v]):
                status[v] = False
        affected = {v for v in range(n) if status[v] and adj[v]
                    and not status[adj[v][ptr[v]]]}
    return status, probes


HAND = {
    "chain": (4, [(0, 1), (1, 2), (2, 3)]),
    "cycle": (3, [(0, 1), (1, 2), (2, 0)]),
    "sink": (4, [(0, 3), (1, 3), (2, 3)]),
    "self_loop": (3, [(0, 1), (1, 1), (2, 0)]),
    "cycle_with_tail": (6, [(0, 1), (1, 2), (2, 0), (3, 0), (4, 3), (2, 5),
                            (5, 4), (1, 5)]),
    "two_paths": (5, [(0, 1), (0, 2), (1, 3), (2, 4), (4, 2)]),
    "duplicates": (3, [(0, 1), (0, 1), (1, 2), (0, 0)]),
}


def random_graph(seed, n=30, m=45):
    rng = random.Random(seed)
    return graph(n, [(rng.randrange(n), rng.randrange(n)) for _ in range(m)])


CASES = [graph(*g) for g in HAND.values()] + [random_graph(s)
                                                for s in range(12)]
IDS = list(HAND) + [f"random{s}" for s in range(12)]


@pytest.mark.parametrize("g", CASES, ids=IDS)
def test_trim_equals_brute_force(g):
    live, _ = reference.trim(*g)
    assert live.tolist() == brute_live(*g)


def test_hand_answers():
    assert reference.trim(*graph(*HAND["chain"]))[0].tolist() == [False] * 4
    assert reference.trim(*graph(*HAND["cycle"]))[0].tolist() == [True] * 3
    assert reference.trim(*graph(*HAND["sink"]))[0].tolist() == [False] * 4
    assert reference.trim(*graph(*HAND["chain"]))[1] == 4


@pytest.mark.parametrize("g", CASES, ids=IDS)
def test_ac6_counters_equal_stepwise(g):
    status, probes = stepwise_ac6(*g)
    live, _ = reference.trim(*g)
    assert live.tolist() == status
    assert reference.examined("ac6", *g, live).tolist() == probes


@pytest.mark.parametrize("g", CASES, ids=IDS)
def test_ac4_counters_by_hand(g):
    indptr, indices = g
    live, _ = reference.trim(*g)
    adj = rows(*g)
    deg_in = [0] * len(adj)
    for r in adj:
        for t in r:
            deg_in[t] += 1
    want = [len(adj[v]) + (0 if live[v] else deg_in[v])
            for v in range(len(adj))]
    assert reference.examined("ac4", *g, live).tolist() == want
    star = [w - len(adj[v]) for v, w in enumerate(want)]
    assert reference.examined("ac4*", *g, live).tolist() == star


def test_worker_sums():
    per = torch.arange(10, dtype=torch.int64)
    # chunk 2, 3 workers: chunks (0,1) (2,3) (4,5) (6,7) (8,9) -> 0 1 2 0 1
    assert reference.worker_sums(per, 3, 2).tolist() == [1 + 13, 5 + 17, 9]


@pytest.mark.parametrize("workload", ["kron26.ac6", "urand26.ac6",
                                      "kron24.ac4", "kron26.ac6.status"])
def test_port_on_the_cpu_agrees(workload):
    from trimbench import harness
    cell = spec.cell(workload)
    cfg = dict(cell.config, scale=13)
    mix = cell.mix
    indptr, indices = spec.load_module(
        "generators", cfg["generator"]).make(cfg, 9, "cpu")
    eng = harness.plan_engine(mix, indptr, indices, "cpu")
    res = eng.run(counters=mix["counters"])
    live, _ = reference.trim(indptr, indices)
    ref = (reference.counters(mix["method"], indptr, indices, live,
                              mix["workers"], mix["chunk"])
           if mix["counters"] else None)
    got = reference.judge(res.status, res.per_worker_edges, live, ref)
    assert reference.passes(got), got
