"""The port's sharded trimming backend (``repro_torch.core.distributed``,
``plan(..., backend="sharded")``) against the reference's own shard_map
bodies, bit for bit.

The reference's ``shard_map`` wrapper fails on jax 0.9.0, but its bodies
do not: here they run under ``jax.vmap(..., axis_name="w")``, which
supplies the axis the collectives name, over P shards.  The port runs P
gloo ranks, spawned CPU processes over a ``FileStore`` (one spawn per
world size, every case inside it; each rank saves its results with
``torch.save``).  For world sizes 2, 4 and 8 and every case, each of
ac3, ac4, ac4*, ac6 and packed ac6 gives the reference body's status,
per-shard edges, rounds, max frontier and instrumented (P, R) round
stats, and the status equals ``trim_oracle`` (masked runs: the dense
engine's).  Every rank holds the same whole result.  Also: the partition
and the packed words equal the reference's arrays, ``plan()`` refuses
what the reference refuses, a checkpoint saved at world size 2 restores
at world size 1, the CLI and the example run on gloo ranks, and the
sharded dry-run's per-rank bytes equal a count written out here.
"""
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import CSRGraph as TCSR
from repro_torch.core import distributed as TD
from repro_torch.core import plan as tplan
from repro_torch.graphs import generators as TG

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, 8)
METHODS = ("ac3", "ac4", "ac4*", "ac6", "ac6_packed")
MASKABLE = ("ac3", "ac6", "ac6_packed")
R = 64              # round capacity of the instrumented runs
#: the reference's edge blocks are zero-padded to this many columns (more
#: than any case's edges), so the cases of one world size share a few
#: compiles: a body never reads past a row's end as an edge (AC-3/AC-6
#: clip a dead row's pointer, AC-4 masks slots past its block's edges)
EDGE_SLOTS = 512


def _cases():
    """name -> (n, src, dst, active mask or None), numpy, the same in
    every process: the reference test's four seed-11 random graphs,
    chain(97), n < P, n not a multiple of 32, n = 0, m = 0 and a masked
    graph."""
    rng = np.random.default_rng(11)
    cases = {}
    for trial in range(4):
        n = int(rng.integers(5, 250))
        m = int(rng.integers(0, 5 * n))
        cases[f"random{trial}"] = (n, rng.integers(0, n, m),
                                   rng.integers(0, n, m), None)
    ip, ix = TG.chain(97, device="cpu").to_numpy()
    cases["chain97"] = (97, np.repeat(np.arange(97), np.diff(ip)), ix, None)
    cases["n3"] = (3, np.array([0, 1, 2]), np.array([1, 0, 0]), None)
    rng = np.random.default_rng(5)
    cases["n77"] = (77, rng.integers(0, 77, 300), rng.integers(0, 77, 300),
                    None)
    cases["n0"] = (0, np.zeros(0, np.int64), np.zeros(0, np.int64), None)
    cases["m0"] = (40, np.zeros(0, np.int64), np.zeros(0, np.int64), None)
    rng = np.random.default_rng(7)
    cases["masked"] = (150, rng.integers(0, 150, 500),
                       rng.integers(0, 150, 500), rng.random(150) < 0.7)
    return cases


CASES = _cases()


def _methods(case):
    return MASKABLE if CASES[case][3] is not None else METHODS


def _plan_kw(method):
    if method == "ac6_packed":
        return dict(method="ac6", packed=True)
    return dict(method=method, unmasked=method.startswith("ac4"))


def _port_graph(case):
    n, src, dst, _ = CASES[case]
    return TCSR.from_edges(n, src, dst, device="cpu")


def _rank_main(rank, world_size, out_dir):
    """One spawned rank: every case and method, instrumented; at world
    size 2, rank 0 also checkpoints a sharded AC-6 engine."""
    from repro_torch import fault
    torch.set_num_threads(1)    # the ranks share the cores
    out = {}
    for case, (n, _, _, mask) in CASES.items():
        g = _port_graph(case)
        act = None if mask is None else torch.as_tensor(mask)
        for method in _methods(case):
            eng = tplan(g, backend="sharded", instrument=True, max_rounds=R,
                        device="cpu", **_plan_kw(method))
            res = eng.run(active=act)
            rs = res.round_stats
            out[case, method] = dict(
                status=res.status.numpy().copy(),
                edges=res.per_worker_edges, rounds=res.rounds,
                max_frontier=res.max_frontier,
                r_frontier=rs.per_round("r_frontier"),
                r_edges=rs.per_round("r_edges"),
                collectives=eng.last_collectives)
            if case == "random1":       # counters off: the same status
                out[case, method]["plain"] = eng.run(
                    active=act, counters=False).status.numpy()
            if mask is not None:
                out[case, method]["dense"] = tplan(
                    g, method=_plan_kw(method)["method"],
                    device="cpu").run(active=act).status.numpy()
    if world_size == 2:
        eng = tplan(_port_graph("random1"), method="ac6", backend="sharded",
                    device="cpu")
        out["ckpt_status"] = eng.run().status.numpy()
        if rank == 0:
            fault.save_engine(os.path.join(out_dir, "ckpt"), eng, 3)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    return env


#: the subprocesses the tests read, started with the spawns
CLI = [sys.executable, "-m", "repro_torch.launch.trim", "--graph", "RMAT",
       "--method", "ac6", "--backend", "sharded", "--device", "cpu"]
EXAMPLE = [sys.executable, str(ROOT / "examples" / "torch" /
                               "distributed_trim.py"), "--device", "cpu"]


def _run(cmd):
    """A subprocess of the file, run to its end (killed after
    ``SPAWN_TIMEOUT`` seconds)."""
    return subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=TD.SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Everything that runs in other processes, started on first use in
    two streams, so that at most one world's ranks and one other process
    run at a time: the gloo worlds one after another (every case inside
    each, each world joined within ``TD.SPAWN_TIMEOUT``), then the CLI,
    then the example (8 ranks of its own); and beside them one worker
    process that runs the reference's bodies for every world size (one
    compile a body and shape, shared across worlds).  ``get(key)`` waits
    for one: a world size gives its directory and every rank's results,
    ``("ref", world)`` the reference's results by (case, method), a name
    the finished subprocess."""
    ranks = ThreadPoolExecutor(1)
    side = ThreadPoolExecutor(1)
    refs = ProcessPoolExecutor(1,
                               mp_context=multiprocessing.get_context("spawn"))
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    jobs = {w: ranks.submit(TD.spawn, _rank_main, w, args=(str(dirs[w]),),
                            store_dir=str(dirs[w]))
            for w in WORLDS}
    for w in WORLDS:
        jobs["ref", w] = side.submit(
            lambda w=w: refs.submit(_reference_world, w).result(
                timeout=TD.SPAWN_TIMEOUT))
    jobs.update({name: ranks.submit(_run, cmd)
                 for name, cmd in (("cli", CLI), ("example", EXAMPLE))})
    done = {}

    def get(key):
        if key not in done:
            out = jobs[key].result()
            if isinstance(key, int):
                out = (dirs[key], [
                    torch.load(dirs[key] / f"rank{r}.pt", weights_only=False)
                    for r in range(key)])
            done[key] = out
        return done[key]
    yield get
    ranks.shutdown(cancel_futures=True)
    side.shutdown(cancel_futures=True)
    refs.shutdown(cancel_futures=True)


# -- the reference's bodies under jax.vmap -------------------------------------

_REF = {}


def _ref_graph(case):
    from repro.core import CSRGraph as JCSR
    n, src, dst, _ = CASES[case]
    return JCSR.from_edges(n, src, dst)


_JITTED = {}


def _vmapped(key, body, *args):
    """``body`` over the leading (shard) axis under ``jax.vmap``, which
    supplies the axis name its collectives use; jitted once per ``key``
    (a body kind) and so compiled once per shape."""
    import jax
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax.vmap(
            lambda *a: tuple(x[0] for x in body(*(y[None] for y in a))),
            axis_name="w"))
    return [np.asarray(x) for x in _JITTED[key](*args)]


def reference(case, method, world):
    """The reference body's (status (n,), edges (P,), rounds, max_qp,
    r_frontier (P, R), r_edges (P, R)) on ``world`` shards."""
    kind = {"ac4*": "ac4", "ac6_packed": "ac6p"}.get(method, method)
    key = (case, kind, world)
    if key in _REF:
        return _REF[key]
    import jax.numpy as jnp

    from repro.core import distributed as JD
    g = _ref_graph(case)
    n, _, _, mask = CASES[case]
    def pad(ix):
        return jnp.pad(ix, ((0, 0), (0, EDGE_SLOTS - ix.shape[1])))
    if kind == "ac4":
        (ltip, ltix, deg_out), n_pad, body = JD.build_ac4_sharded(
            g, world, "w", instrument=True, max_rounds=R)
        operands = (ltip, pad(ltix), deg_out)
    else:
        lip, lix, n_pad = JD.build_partition(g, world)
        act = np.zeros(n_pad, bool)
        act[:n] = True if mask is None else mask
        operands = (lip, pad(lix), jnp.asarray(act.reshape(world, -1)))
        maker = {"ac3": JD._ac3_body, "ac6": JD._ac6_body,
                 "ac6p": JD._ac6_body_packed}[kind]
        body = maker("w", instrument=True, max_rounds=R)
    st, edges, rounds, qp, rf, re_ = _vmapped(kind, body, *operands)
    _REF[key] = (st.reshape(-1)[:n].astype(np.int32), edges,
                 int(rounds.max()), int(qp.max()), rf, re_)
    return _REF[key]


def _degenerate(case):
    n, src, _, _ = CASES[case]
    return n == 0 or src.size == 0


def _reference_world(world):
    """Every non-degenerate case's reference results at ``world`` shards
    (run in a worker process)."""
    return {(case, method): reference(case, method, world)
            for case in CASES if not _degenerate(case)
            for method in _methods(case)}


def _params():
    out = []
    for world in WORLDS:
        for case in CASES:
            for method in _methods(case):
                out.append((world, case, method))
    return out


@pytest.mark.parametrize("world,case,method", _params())
def test_sharded_matches_reference_body(background, world, case, method):
    n, _, _, mask = CASES[case]
    degenerate = _degenerate(case)
    _, ranks = background(world)
    got = ranks[0][case, method]
    for other in ranks[1:]:                 # every rank holds the result
        for k in ("status", "edges", "rounds", "max_frontier", "r_frontier",
                  "r_edges"):
            assert np.array_equal(np.asarray(other[case, method][k]),
                                  np.asarray(got[k])), (k, case, method)
    assert got["edges"].shape == (world,)
    if "plain" in got:
        assert np.array_equal(got["plain"], got["status"])
    if degenerate:
        # no dispatch: the reference's degenerate result, P zero counters
        assert not got["status"].any()
        assert got["rounds"] == (0 if n == 0 else 2)
        assert got["max_frontier"] == n
        assert not got["edges"].any()
        assert got["collectives"] is None         # no collective ran
        return
    st, edges, rounds, qp, rf, re_ = background(("ref", world))[
        case, method]
    assert np.array_equal(got["status"], st)
    assert np.array_equal(got["edges"], edges)
    assert got["rounds"] == rounds
    assert got["max_frontier"] == qp
    assert np.array_equal(got["r_frontier"], rf)
    assert np.array_equal(got["r_edges"], re_)
    if mask is None:
        from repro.core import trim_oracle
        oracle = trim_oracle(*_ref_graph(case).to_numpy())
        assert np.array_equal(got["status"].astype(bool), oracle)
    else:
        assert np.array_equal(got["status"], got["dense"])
    calls = {op: c for op, (c, _) in got["collectives"].items()}
    if method.startswith("ac4"):
        # one any before the loop and one a round; one reduce-scatter a
        # round; the final two all-gathers
        assert calls == {"all_gather": 2, "reduce_scatter": rounds,
                         "any": rounds + 1}
    else:
        assert calls == {"all_gather": rounds + 3, "reduce_scatter": 0,
                         "any": rounds}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["random0", "chain97", "n3", "n77", "n0"])
def test_partition_equals_reference(world, case):
    from repro.core import distributed as JD
    g = _ref_graph(case)
    want = JD.build_partition(g, world)
    got = TD.build_partition(_port_graph(case), world)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.int32 and np.array_equal(a, np.asarray(b))
    for r in range(world):
        lip, lix, n_pad = TD.rank_partition(_port_graph(case), world, r)
        assert n_pad == want[2]
        assert np.array_equal(lip, got[0][r]) and np.array_equal(
            lix, got[1][r])
    wt, wn, _ = JD.build_ac4_sharded(g, world, "w")
    pt, pn = TD.build_ac4_sharded(_port_graph(case), world)
    assert pn == wn
    for a, b in zip(pt, wt):
        assert np.array_equal(a, np.asarray(b))
    for r in range(world):
        rows, _ = TD.build_ac4_sharded(_port_graph(case), world, rank=r)
        for a, b in zip(rows, pt):
            assert np.array_equal(a, b[r])


@pytest.mark.parametrize("n", [32, 64, 4096])
def test_packed_words_equal_reference(n):
    import jax.numpy as jnp

    from repro.core import distributed as JD
    rng = np.random.default_rng(n)
    s = rng.random(n) < 0.5
    s[:32] = True                     # a word with bit 31 set
    want = np.asarray(JD._pack_bits(jnp.asarray(s)))
    got = TD._pack_bits(torch.as_tensor(s))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(TD._unpack_bits(got).numpy(),
                          np.asarray(JD._unpack_bits(jnp.asarray(want))))


REFUSALS = [
    dict(method="ac6", backend="sharded", frontier="sparse"),
    dict(method="ac4", backend="sharded"),
    dict(method="ac4*", backend="sharded"),
    dict(method="ac6", backend="dense", packed=True),
    dict(method="ac3", backend="sharded", packed=True),
    dict(method="ac4", backend="sharded", unmasked=True, packed=True),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_plan_refusals_match_reference(kw):
    from repro.core import plan as jplan
    with pytest.raises(ValueError) as want:
        jplan(_ref_graph("random0"), **kw)
    with pytest.raises(ValueError) as got:
        tplan(_port_graph("random0"), device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_sharded_batch_and_group_refusals():
    eng = tplan(_port_graph("random0"), method="ac6", backend="sharded",
                device="cpu")
    with pytest.raises(NotImplementedError, match="single-device"):
        eng.run_batch(np.ones((2, CASES["random0"][0]), bool))
    with pytest.raises(RuntimeError, match="process group"):
        eng.run()                       # no group in this process
    eng = tplan(_port_graph("random0"), method="ac6", backend="sharded",
                group=object(), device="cpu")
    with pytest.raises(ValueError, match="not checkpointable"):
        eng.state_meta()
    with TD.process_group("cpu"):
        # a CUDA tensor needs an NCCL group: no transport falls back
        with pytest.raises(ValueError, match="need a nccl process group"):
            TD.ShardComm(device="cuda")


def test_checkpoint_at_world_2_restores_at_world_1(background):
    from repro_torch import fault
    d, ranks = background(2)
    eng, step, _, meta = fault.restore_engine(str(d / "ckpt"), device="cpu")
    assert step == 3 and eng.backend == "sharded" and eng.method == "ac6"
    assert meta["engine"]["dispatches"] == 1
    with TD.process_group("cpu"):
        res = eng.run()
        assert res.per_worker_edges.shape == (1,)
        assert eng.dispatches == 2
    assert np.array_equal(res.status.numpy(), ranks[0]["ckpt_status"])
    assert np.array_equal(res.status.numpy(), ranks[1]["ckpt_status"])


def test_cli_sharded_world_1(background):
    out = background("cli")
    assert out.returncode == 0, out.stderr[-2000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("[trim]")]
    assert len(line) == 1 and "backend=sharded: trimmed " in line[0]
    res = tplan(TG.make("RMAT", device="cpu"), method="ac6",
                device="cpu").run()
    assert f"trimmed {res.n_trimmed} " in line[0]
    assert f"rounds={res.rounds} edges={res.edges_traversed} " in line[0]


def test_cli_refuses_sharded_scc(capsys):
    from repro_torch.launch import trim as tcli
    with pytest.raises(SystemExit) as e:
        tcli.main(["--app", "scc", "--backend", "sharded", "--device",
                   "cpu"])
    assert e.value.code == 2
    assert ("--app scc needs a batchable trim backend (--backend dense or "
            "windowed); shard at the region level") in capsys.readouterr().err


@pytest.mark.parametrize("method", ["ac3", "ac6"])
def test_sharded_dryrun_bytes(method):
    """512 ranks, n = 64,000,000, m = 512,000,000, the reference's
    graph, in the blocks the sharded engine cuts: 125,024 rows a rank
    (125,000 aligned up to 32) and 2 x 1,000,000 edge slots."""
    from repro_torch.launch import trim as tcli
    fp = tcli.run_dryrun(method, "sharded")
    nl, ml2 = 125_024, 2 * (512_000_000 // 512)
    held = 4 * (nl + 1) + 4 * ml2            # lip, lix
    assert held == 8_500_100
    assert fp["held"] == {"shard_operands": held}
    assert fp["args"] == held + nl           # and the active block
    assert fp["host"] == {"graph": 4 * (64_000_001 + 512_000_000)}
    assert fp["gather_sites_per_round"] == 1
    assert fp["gather_bytes_per_round"] == 512 * nl   # n_pad bool bytes
    assert fp["temps"] > 0
    assert fp["run"] == {"active_block": nl, "rank_body": fp["temps"]}


def test_example_twin_on_gloo_ranks(background):
    out = background("example")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "trimmed 20,000 vertices on 8 ranks" in out.stdout
    edges = [x for x in out.stdout.splitlines()
             if x.startswith("per-rank traversed edges:")]
    assert len(edges) == 1
    assert len(json.loads(edges[0].split(":", 1)[1])) == 8


@pytest.mark.parametrize("method", ["ac3", "ac4", "ac6_packed"])
def test_sharded_footprint_held_equals_engine(method):
    """trim_footprint's sharded case, one rank of one: the rank's block
    on the device and the CSR (Gᵀ for AC-4) on the host, component for
    component what the engine holds after a run."""
    from repro_torch import obs
    from repro_torch.launch import trim as tcli
    g = _port_graph("random2")
    with TD.process_group("cpu"):
        eng = tplan(g, backend="sharded", device="cpu", **_plan_kw(method))
        eng.run()
        got = obs.engine_nbytes(eng)
    fp = tcli.trim_footprint(g.n, g.m, _plan_kw(method)["method"],
                             "sharded", ranks=1)
    assert {**fp["held"], **fp["host"]} == got
    assert set(fp["host"]) == ({"graph", "transpose"}
                               if method == "ac4" else {"graph"})
    assert fp["run"]["rank_body"] > 0


def test_sharded_run_feeds_obs():
    """An instrumented sharded run: one dispatch span, the (P, R) stats
    and per-rank edges published as the reference publishes them, and
    the run's collective calls and bytes as counters."""
    from repro_torch import obs
    g = _port_graph("random0")
    with TD.process_group("cpu"), obs.collecting_metrics() as plane, \
            obs.recording() as rec:
        eng = tplan(g, method="ac6", backend="sharded", instrument=True,
                    device="cpu")
        res = eng.run()
    assert len(rec.select("dispatch", cat="engine")) == 1
    assert res.round_stats.per_round("r_edges").shape == (1, eng.max_rounds)
    assert int(res.round_stats.total("r_edges").sum()) == \
        res.edges_traversed
    busiest = plane.families["repro_busiest_worker_edges"]
    assert busiest.labels(family="trim").value == res.edges_traversed
    calls = plane.families["repro_collective_calls"]
    nbytes = plane.families["repro_collective_bytes"]
    for op, (c, b) in eng.last_collectives.items():
        assert calls.labels(family="trim", op=op).value == c
        assert nbytes.labels(family="trim", op=op).value == b
    assert eng.last_collectives["all_gather"][0] == res.rounds + 3


@pytest.mark.parametrize("method", ["ac3", "ac4", "ac6", "ac6_packed"])
def test_trim_distributed_shim(method):
    """The throwaway-engine shim (``ac6_packed`` is AC-6 with a packed
    exchange), materialized, at world size 1."""
    g = _port_graph("random3")
    with TD.process_group("cpu"):
        res = TD.trim_distributed(g, method=method, device="cpu")
    want = reference("random3", method, 1)
    assert isinstance(res.status, np.ndarray)
    assert np.array_equal(res.status, want[0])
    assert np.array_equal(res.per_worker_edges, want[1])
    assert (res.rounds, res.max_frontier) == want[2:4]
