"""The port's observability layer (``repro_torch.obs``) against the JAX
reference's (``repro.obs``), on the CPU.

Graphs come from the reference's seeded numpy generators and cross to
the port through ``CSRGraph.from_numpy``, so both packages run on the same
arrays.  The per-round stat buffers are integers and must be equal bit for
bit: ``RoundStats.to_dict()`` of every trim method on both backends and
every frontier, of reach, of the peel, of the stream engine's applies, the
overflow clamp and ``round_capacity``; ``scc_decompose``'s
``trim_rounds``/``reach_rounds`` and its dispatch and generation span
counts.  Then the port alone: that ``instrument=False`` is inert to
``max_rounds`` and ``instrument=True`` adds no host sync on each of the 23
plans, the recorder and its exporters, the MetricsPlane (percentiles
against numpy, the label cap, OpenMetrics and snapshot round trips,
``SLOTracker``, ``MetricsServer`` on localhost, a disabled plane that
changes nothing), memory accounting and the plan cost.  The reference's
sharded case (ROADMAP A6) and its regression-gate cases (A10) have no
twin here.
"""
import json
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import plan as jplan
from repro.core import plan_peel as jplan_peel
from repro.core import plan_reach as jplan_reach
from repro.core import plan_stream as jplan_stream
from repro.core.scc import scc_decompose as jscc
from repro.graphs import generators as jgen
from repro_torch import obs
from repro_torch.analysis import catalog, mutants, syncs
from repro_torch.core import (CSRGraph, plan, plan_peel, plan_reach,
                              plan_stream)
from repro_torch.core.common import segment_sum
from repro_torch.core.scc import same_partition, scc_decompose, tarjan_oracle
from repro_torch.kernels import _build
from repro_torch.kernels import ops

from repro.analysis import mutants as jmutants

torch.set_num_threads(1)

CPU = "cpu"
FAMILIES = {
    "ER": lambda: jgen.erdos_renyi(300, 360, seed=1),
    "BA": lambda: jgen.barabasi_albert(200, 3, seed=1),
    "RMAT": lambda: jgen.rmat(8, 320, seed=1),
    "chain": lambda: jgen.chain(50),
    "layered": lambda: jgen.layered_dag(200, 11, 4, seed=1),
    "sink_heavy": lambda: jgen.sink_heavy(200, 800, 0.9, seed=1),
}


def _pair(family):
    """The reference's graph and the same arrays as a port graph."""
    jg = FAMILIES[family]()
    return jg, CSRGraph.from_numpy(*jg.to_numpy(), device=CPU)


def _same(got, want, what):
    assert got.to_dict() == want.to_dict(), what
    for name in want.names:
        assert np.array_equal(got.per_round(name), want.per_round(name)), \
            (what, name)


def _trim_cases():
    out = []
    for family in ("ER", "RMAT", "chain"):
        for method in ("ac3", "ac4", "ac4*", "ac6"):
            for backend in ("dense", "windowed"):
                for fr in (("auto",) if method == "ac3"
                           else ("auto", "dense", "sparse")):
                    out.append((family, method, backend, fr))
    return out


# -- per-round stats against the reference -----------------------------------

@pytest.mark.parametrize("family,method,backend,frontier", _trim_cases())
def test_trim_round_stats_equal_reference(family, method, backend, frontier):
    jg, tg = _pair(family)
    kw = dict(method=method, backend=backend, frontier=frontier, workers=4,
              chunk=1, instrument=True)
    got = plan(tg, device=CPU, **kw).run()
    want = jplan(jg, **kw).run()
    _same(got.round_stats, want.round_stats, (family, method, backend))
    assert int(got.round_stats.total("r_edges")) == \
        int(np.asarray(got.per_worker_edges).sum())


@pytest.mark.parametrize("method", ["ac3", "ac4", "ac6"])
def test_counters_off_still_records_edges(method):
    """``counters=False`` skips the per-worker counters, not ``r_edges``
    (the reference computes the probe sums either way)."""
    jg, tg = _pair("sink_heavy")
    got = plan(tg, method=method, instrument=True,
               device=CPU).run(counters=False).round_stats
    want = jplan(jg, method=method,
                 instrument=True).run(counters=False).round_stats
    assert got.per_worker is None
    _same(got, want, method)


@pytest.mark.parametrize("method", ["ac4", "ac6"])
def test_masked_and_batched_round_stats(method):
    """Induced subgraphs: ``run(active)`` equals the reference, and each
    row of one ``run_batch`` equals its own ``run`` (the reference's
    batch pins dense rounds, so its rows lack ``r_sparse``)."""
    jg, tg = _pair("ER")
    rng = np.random.default_rng(3)
    masks = rng.random((3, tg.n)) < 0.7
    eng = plan(tg, method=method, instrument=True, device=CPU)
    jeng = jplan(jg, method=method, instrument=True)
    for row, got in zip(masks, eng.run_batch(masks)):
        single = eng.run(row).round_stats
        _same(single, jeng.run(row).round_stats, method)
        _same(got.round_stats, single, method)
    assert eng.dispatches == 1 + len(masks)


def test_degenerate_round_stats_equal_reference():
    """No edges: every active vertex dies in slot 0, no dispatch."""
    jg = jgen.chain(1)
    tg = CSRGraph.from_numpy(*jg.to_numpy(), device=CPU)
    for method in ("ac4", "ac6"):
        got = plan(tg, method=method, instrument=True, device=CPU)
        want = jplan(jg, method=method, instrument=True)
        _same(got.run().round_stats, want.run().round_stats, method)
        masks = np.ones((2, tg.n), bool)
        *_, rs = got.run_batch_stacked(masks)
        *_, jrs = want.run_batch_stacked(masks)
        for name in jrs:
            assert np.array_equal(rs.per_round(name), np.asarray(jrs[name]))
        assert got.dispatches == 0


@pytest.mark.parametrize("engine", ["ac4", "ac6", "peel", "stream"])
def test_overflow_clamp_keeps_totals_exact(engine):
    jg, tg = _pair("chain")                   # 50 rounds to the fixpoint
    if engine == "peel":
        got = plan_peel(tg, instrument=True, max_rounds=4,
                        device=CPU).run(k=1)
        want = jplan_peel(jg, instrument=True, max_rounds=4).run(k=1)
        full = plan_peel(tg, instrument=True, device=CPU).run(k=1)
    elif engine == "stream":
        got = plan_stream(tg, instrument=True, max_rounds=4).retrim()
        want = jplan_stream(jg, instrument=True, max_rounds=4).retrim()
        full = plan_stream(tg, instrument=True).retrim()
    else:
        got = plan(tg, method=engine, instrument=True, max_rounds=4,
                   device=CPU).run()
        want = jplan(jg, method=engine, instrument=True, max_rounds=4).run()
        full = plan(tg, method=engine, instrument=True, device=CPU).run()
    rs, rf = got.round_stats, full.round_stats
    _same(rs, want.round_stats, engine)
    assert rs.overflowed and not rf.overflowed and rs.max_rounds == 4
    for name in ("r_frontier", "r_edges"):
        assert int(rs.total(name)) == int(rf.total(name)), name
    assert rs.per_round("r_frontier")[-1] == \
        rf.per_round("r_frontier")[3:].sum()


@pytest.mark.parametrize("n,max_rounds", [(0, None), (1, None), (5, None),
                                          (1000, None), (5000, None),
                                          (10, 1), (10, 3), (10, 64),
                                          (10, 1000)])
def test_round_capacity(n, max_rounds):
    assert obs.round_capacity(n, max_rounds) == \
        jobs.round_capacity(n, max_rounds)
    assert obs.MAX_ROUND_SLOTS == 1024
    with pytest.raises(ValueError):
        obs.round_capacity(10, 0)


@pytest.mark.parametrize("family", ["RMAT", "chain", "BA"])
@pytest.mark.parametrize("backend", ["dense", "windowed"])
@pytest.mark.parametrize("frontier", ["auto", "dense", "sparse"])
def test_reach_round_stats_equal_reference(family, backend, frontier):
    """A single sweep's buffers, ``r_edges`` included: it charges the
    body each round took (the window tile, the whole-row OR, or the
    compacted push), as the reference's does."""
    jg, tg = _pair(family)
    kw = dict(backend=backend, frontier=frontier, instrument=True)
    got = plan_reach(tg, device=CPU, **kw).run(0)
    want = jplan_reach(jg, **kw).run(0)
    _same(got.round_stats, want.round_stats, (family, backend, frontier))
    assert int(got.round_stats.total("r_frontier")) == got.n_reached


def test_reach_batch_rows_equal_single_sweeps():
    jg, tg = _pair("RMAT")
    eng = plan_reach(tg, backend="windowed", instrument=True, device=CPU)
    seeds = np.zeros((2, tg.n), bool)
    seeds[0, 0] = seeds[1, 7] = True
    rs = eng.run_batch(seeds).round_stats
    for i in range(2):
        _same(rs.row(i), eng.run(seeds[i]).round_stats, i)
    assert list(rs.rounds) == [eng.run(seeds[i]).rounds for i in range(2)]


@pytest.mark.parametrize("family", ["RMAT", "BA", "chain"])
@pytest.mark.parametrize("frontier", ["auto", "dense", "sparse"])
@pytest.mark.parametrize("k", [None, 1, 2])
def test_peel_round_stats_equal_reference(family, frontier, k):
    jg, tg = _pair(family)
    got = plan_peel(tg, frontier=frontier, instrument=True,
                    device=CPU).run(k=k)
    want = jplan_peel(jg, frontier=frontier, instrument=True).run(k=k)
    _same(got.round_stats, want.round_stats, (family, frontier, k))


@pytest.mark.parametrize("frontier", ["auto", "dense", "sparse"])
def test_stream_round_stats_equal_reference(frontier):
    """The plan-time fixpoint, a deletion batch and a reviving insertion
    batch (the from-scratch scan charged to slot 0)."""
    jg, tg = _pair("RMAT")
    eng = plan_stream(tg, frontier=frontier, instrument=True)
    jeng = jplan_stream(jg, frontier=frontier, instrument=True)
    _same(eng.retrim().round_stats, jeng.retrim().round_stats, "init")
    rng = np.random.default_rng(0)
    src, dst = eng.delta._src_np.copy(), eng.delta._dst_np.copy()
    ids = rng.choice(src.size, 12, replace=False)
    for batch in ({"deletions": (src[ids], dst[ids])},
                  {"insertions": (src[ids], dst[ids])}):
        got, want = eng.apply(**batch), jeng.apply(**batch)
        assert got.dirty == bool(want.dirty)
        _same(got.round_stats, want.round_stats, (frontier, list(batch)))
    _same(eng.retrim().round_stats, jeng.retrim().round_stats, "retrim")


@pytest.mark.parametrize("family", ["sink_heavy", "ER"])
def test_scc_decompose_instrumented(family):
    jg, tg = _pair(family)
    kw = dict(counters=True, workers=4, chunk=1, instrument=True)
    with obs.recording() as rec:
        labels, stats = scc_decompose(tg, device=CPU, **kw)
    with jobs.recording() as jrec:
        _, jstats = jscc(jg, **kw)
    assert same_partition(labels, tarjan_oracle(*jg.to_numpy()))
    for key in ("generations", "trim_rounds", "reach_rounds",
                "trim_edges_traversed", "trim_dispatches",
                "reach_dispatches"):
        assert stats[key] == jstats[key], key
    assert np.array_equal(stats["per_worker_edges"],
                          jstats["per_worker_edges"])
    for name, cat in (("dispatch", "engine"), ("generation", "scc")):
        assert len(rec.select(name, cat=cat)) == \
            len(jrec.select(name, cat=cat)), name
    gens = rec.select("generation", cat="scc")
    assert len(gens) == stats["generations"]
    # a generation that reaches its pivots records their count
    assert [(sp.attrs["regions"], sp.attrs.get("pivots")) for sp in gens] \
        == [(sp.attrs["regions"], sp.attrs.get("pivots"))
            for sp in jrec.select("generation", cat="scc")]
    _, plain = scc_decompose(tg, device=CPU)
    assert plain["trim_rounds"] is None and plain["reach_rounds"] is None


# -- D11: the sparse decrement adds only the real edges -----------------------

def test_ac4_sparse_decrement_slice_is_exact():
    """The sliced add over slots [0, edges) gives the full buffer's
    decrement vector (padding slots add nothing), so every counter and
    ``r_decrements`` stay as they were, bit for bit."""
    jg, tg = _pair("sink_heavy")
    gt = tg.transpose()
    n = tg.n
    rng = np.random.default_rng(5)
    deg_in = (gt.indptr[1:] - gt.indptr[:-1])
    for frac in (0.01, 0.1, 0.5):
        f = torch.as_tensor(rng.random(n) < frac)
        edges = int(torch.where(f, deg_in, 0).sum())
        ids, _ = ops.frontier_compact(f, 1 << 12)
        _, tgt, _, valid = ops.sparse_expand(gt.indptr, gt.indices, ids,
                                             1 << 13)
        full = segment_sum(valid, tgt, n)
        assert torch.equal(segment_sum(valid[:edges], tgt[:edges], n), full)
        assert torch.equal(full, segment_sum(f[torch.repeat_interleave(
            torch.arange(n), deg_in.long())], gt.indices, n))
    for method in ("ac4", "ac4*"):
        got = plan(tg, method=method, frontier="sparse", instrument=True,
                   workers=4, device=CPU).run()
        want = jplan(jg, method=method, frontier="sparse", instrument=True,
                     workers=4).run()
        assert np.array_equal(got.status.numpy(), np.asarray(want.status))
        assert np.array_equal(np.asarray(got.per_worker_edges),
                              np.asarray(want.per_worker_edges))
        assert np.array_equal(got.round_stats.per_round("r_decrements"),
                              want.round_stats.per_round("r_decrements"))


# -- instrument=False is inert; instrument=True adds no host sync ------------

@pytest.mark.parametrize("name", [e.name for e in catalog.PLAN_CATALOG])
def test_instrument_diff_per_plan(name):
    """The check's twin on each plan: no finding; the instrumented run
    reads the host exactly as often as the plain one and makes the same
    kernel calls, and its results are the same."""
    entry = {e.name: e for e in catalog.PLAN_CATALOG}[name]
    found, n = syncs.check_instrument_diff([entry])
    assert (found, n) == ([], 1)
    plain, ev0, calls0 = syncs.instrument_trace(entry, False, None)
    inst, ev1, calls1 = syncs.instrument_trace(entry, True,
                                               catalog.PLAN_MAX_ROUNDS)
    assert len(ev1) == len(ev0) and ev1.count("copy") == ev0.count("copy")
    assert calls1 == calls0
    assert syncs.rounds_of(inst) == syncs.rounds_of(plain)
    assert plain.round_stats is None and inst.round_stats is not None


def test_instrument_mutants_match_reference():
    """The reference's six plan mutants all run; its two instrument
    mutants are caught by the checkers of the same names."""
    names = [m.name for m in mutants.MUTANT_PLANS]
    assert names == [m.name for m in jmutants.MUTANT_PLANS]
    want = {m.name: m.expect for m in jmutants.MUTANT_PLANS
            if m.check == "instrument"}
    assert {m.name: m.expect for m in mutants.MUTANT_PLANS
            if m.check == "instrument"} == want
    for mp in mutants.MUTANT_PLANS:
        if mp.check == "instrument":
            found, _ = syncs.check_instrument_diff([mp])
            assert {f.checker for f in found} == {mp.expect}


# -- span recorder + exporters -------------------------------------------------

def test_recorder_disabled_is_noop():
    rec = obs.get_recorder()
    assert not rec.enabled
    with obs.span("x", cat="t") as sp:
        assert sp is None
    assert obs.instant("y") is None


def test_dispatch_spans_carry_build_attribution(monkeypatch):
    """A dispatch during which a kernel library was built is
    ``"build+execute"``; the others ``"execute"``.  Kernel calls are
    instant events with their path."""
    _, tg = _pair("ER")
    engine = plan(tg, method="ac4", frontier="sparse", instrument=True,
                  device=CPU)
    real = engine._fixpoint

    def building(*args, **kwargs):
        _build.BUILDS[0] += 1             # as if nvcc ran for a library
        return real(*args, **kwargs)

    with obs.recording() as rec:
        monkeypatch.setattr(engine, "_fixpoint", building)
        engine.run()
        monkeypatch.setattr(engine, "_fixpoint", real)
        engine.run()
    spans = rec.select("dispatch", cat="engine", family="trim")
    assert len(spans) == engine.dispatches == 2
    assert [sp.attrs["phase"] for sp in spans] == ["build+execute",
                                                   "execute"]
    assert [sp.attrs["builds"] for sp in spans] == [1, 0]
    assert spans[0].attrs["plan"].endswith("+stats")
    notes = rec.select(cat="kernel")
    assert notes and all(sp.ph == "i" and sp.attrs["path"] == "plain"
                         for sp in notes)
    assert {sp.name for sp in notes} == {"frontier_compact",
                                         "sparse_expand"}


def test_exporters_round_trip(tmp_path):
    rec = obs.Recorder()
    with rec.span("outer", cat="a", k=1):
        with rec.span("inner", cat="b"):
            pass
    rec.instant("mark", cat="a", v="x")
    want = [sp.to_dict() for sp in rec.spans]
    jl = rec.to_jsonl(str(tmp_path / "spans.jsonl"))
    assert obs.read_jsonl(jl) == want
    ct = rec.to_chrome_trace(str(tmp_path / "trace.json"))
    assert isinstance(json.load(open(ct))["traceEvents"], list)
    got = obs.read_chrome_trace(ct)
    assert [(d["name"], d["cat"], d["ph"]) for d in got] == \
        [(d["name"], d["cat"], d["ph"]) for d in want]
    for g_, w in zip(got, want):
        assert g_["ts"] == pytest.approx(w["ts"], abs=1e-9)
        assert g_["dur"] == pytest.approx(w["dur"], abs=1e-9)
        assert g_["attrs"] == w["attrs"]
    # the reference reads the port's files and the other way round
    assert jobs.read_jsonl(jl) == want
    assert [d["name"] for d in jobs.read_chrome_trace(ct)] == \
        [d["name"] for d in want]


def test_recording_restores_previous_recorder_on_exception():
    baseline = obs.get_recorder()
    with pytest.raises(RuntimeError):
        with obs.recording():
            assert obs.get_recorder() is not baseline
            raise RuntimeError("boom")
    assert obs.get_recorder() is baseline
    with obs.recording() as outer:
        with pytest.raises(RuntimeError):
            with obs.recording():
                raise RuntimeError("inner boom")
        assert obs.get_recorder().spans is outer.spans
    assert obs.get_recorder() is baseline


def test_recording_nested_scopes_tee_spans_to_both():
    with obs.recording() as outer:
        with obs.span("before", cat="t"):
            pass
        with obs.recording() as inner:
            with obs.span("shared", cat="t", k=1):
                pass
            obs.instant("mark", cat="t")
        with obs.span("after", cat="t"):
            pass
    assert [sp.name for sp in inner.spans] == ["shared", "mark"]
    names = [sp.name for sp in outer.spans]
    assert names.count("shared") == 1 and names.count("mark") == 1
    teed = next(sp for sp in outer.spans if sp.name == "shared")
    orig = next(sp for sp in inner.spans if sp.name == "shared")
    assert teed.attrs == orig.attrs
    assert teed.dur == pytest.approx(orig.dur, abs=1e-9)
    b = next(sp for sp in outer.spans if sp.name == "before")
    a = next(sp for sp in outer.spans if sp.name == "after")
    assert b.ts <= teed.ts <= a.ts
    with obs.recording() as outer:
        with obs.recording(tee=False) as quiet:
            with obs.span("quiet", cat="t"):
                pass
    assert [sp.name for sp in quiet.spans] == ["quiet"]
    assert outer.spans == []


# -- MetricsPlane ----------------------------------------------------------------

def test_histogram_percentiles_exact_vs_numpy():
    plane = obs.MetricsPlane()
    hist = plane.histogram("t_seconds", "test latencies")
    samples = np.random.default_rng(11).lognormal(-6, 2, size=500)
    for s in samples:
        hist.observe(float(s), family="trim")
    child = hist.labels(family="trim")
    for q, attr in ((50, "p50"), (95, "p95"), (99, "p99")):
        assert getattr(child, attr) == np.percentile(samples, q), q
    assert child.count == 500 and sum(child.counts) == 500
    assert child.sum == pytest.approx(samples.sum())
    ring = plane.histogram("r_seconds", "", ring=16)
    for i in range(100):
        ring.observe(float(i))
    assert ring.labels().count == 100 and len(ring.labels().ring) == 16
    assert ring.labels().p50 == np.percentile(np.arange(84, 100), 50)


def test_label_cardinality_cap_folds_into_overflow():
    plane = obs.MetricsPlane()
    c = plane.counter("things", "")
    cap = obs.LABEL_CARDINALITY_CAP
    for i in range(cap + 6):
        c.inc(worker=str(i))
    assert len(c.children) == cap + 1
    assert c.labels(overflow="true").value == 6
    assert plane.families["repro_metric_labels_dropped"].labels(
        metric="things").value == 6
    with pytest.raises(ValueError):
        plane.counter("things_total", "")
    with pytest.raises(ValueError):
        plane.gauge("things", "")


def test_openmetrics_and_snapshot_round_trip():
    plane = obs.MetricsPlane()
    plane.counter("repro_dispatches", "dispatch count").inc(3, family="trim")
    plane.gauge("repro_engine_live_bytes", "live").set(
        1024, family="trim", component="total")
    h = plane.histogram("repro_dispatch_wall_seconds", "wall")
    h.observe(0.002, family="trim", phase="execute")
    h.observe(3.5, family="trim", phase="build")
    text = plane.to_openmetrics()
    doc = obs.parse_openmetrics(text)
    [(_, labels, v)] = doc["repro_dispatches_total"]["samples"]
    assert (labels, v) == ({"family": "trim"}, 3.0)
    hist = doc["repro_dispatch_wall_seconds"]
    assert hist["type"] == "histogram"
    assert [v for _, lb, v in hist["samples"]
            if lb.get("le") == "+Inf"] == [1.0, 1.0]
    # the reference's plane parses the port's exposition the same way
    assert jobs.parse_openmetrics(text) == doc
    snap = json.loads(json.dumps(plane.snapshot()))
    clone = obs.load_snapshot(snap)
    assert clone.to_openmetrics() == text
    assert jobs.load_snapshot(snap).to_openmetrics() == text
    with pytest.raises(ValueError):
        obs.load_snapshot({"metrics_schema": 99, "families": {}})


def test_rebuild_storm_warns_once_and_counts():
    plane = obs.MetricsPlane(retrace_storm_threshold=3)
    plane.note_build("trim", "p1")
    plane.note_build("trim", "p1")
    with pytest.warns(obs.RetraceStormWarning):
        plane.note_build("trim", "p1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plane.note_build("trim", "p1")
    assert plane.counter("repro_rebuild_storms").labels(
        family="trim").value == 1
    assert plane.counter("repro_plan_builds").labels(
        family="trim", plan="p1").value == 4


def test_slo_tracker_breach_counting():
    plane = obs.MetricsPlane()
    slo = obs.SLOTracker(0.010, window=16, min_samples=4, name="tick",
                         plane=plane)
    for _ in range(8):
        assert slo.observe(0.001) is False
    assert slo.breaches == 0 and not slo.breached
    for _ in range(8):
        slo.observe(0.050)
    assert slo.breached and slo.breaches > 0
    assert plane.gauge("repro_slo_p99_seconds").labels(
        slo="tick").value > 0.010
    assert plane.counter("repro_slo_breaches").labels(
        slo="tick").value == slo.breaches


def test_metrics_server_serves_openmetrics_and_health():
    plane = obs.MetricsPlane()
    plane.counter("repro_dispatches", "").inc(family="trim")
    server = obs.MetricsServer(0, plane_getter=lambda: plane,
                               health_getter=lambda: {"status": "serving"})
    try:
        base = f"http://127.0.0.1:{server.port}"
        body = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "repro_dispatches_total" in body
        assert obs.parse_openmetrics(body)
        health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
        assert health == {"status": "serving"}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")
    finally:
        server.close()


def test_disabled_plane_changes_nothing():
    """The default plane is off: the same bits, dispatches and kernel
    calls as under an enabled plane, and nothing recorded."""
    _, tg = _pair("ER")
    assert not obs.get_plane().enabled
    off = plan(tg, method="ac4", frontier="sparse", instrument=True,
               device=CPU)
    with obs.profile.capturing() as calls_off:
        r_off = off.run()
    with obs.collecting_metrics() as plane:
        on = plan(tg, method="ac4", frontier="sparse", instrument=True,
                  device=CPU)
        with obs.profile.capturing() as calls_on:
            r_on = on.run()
    assert torch.equal(r_off.status, r_on.status)
    assert r_off.rounds == r_on.rounds and off.dispatches == on.dispatches
    assert [c[0] for c in calls_off] == [c[0] for c in calls_on]
    _same(r_off.round_stats, r_on.round_stats, "plane")
    assert "repro_dispatches" not in obs.get_plane().families
    assert plane.counter("repro_dispatches").labels(family="trim").value == 1


def test_enabled_plane_collects_dispatch_round_and_memory_families():
    jg, tg = _pair("ER")
    with obs.collecting_metrics() as plane:
        engine = plan(tg, method="ac4", frontier="sparse", instrument=True,
                      device=CPU)
        res = engine.run()
        engine.run()
    assert plane.counter("repro_dispatches").labels(family="trim").value == 2
    phases = {dict(k)["phase"]
              for k in plane.families["repro_dispatch_wall_seconds"].children}
    assert phases == {"execute"}
    assert plane.counter("repro_fixpoint_rounds").labels(
        family="trim").value == 2 * res.rounds
    work = plane.families["repro_fixpoint_work"]
    assert work.labels(family="trim", stat="r_edges").value == \
        2 * int(res.round_stats.total("r_edges"))
    mem = plane.families["repro_engine_live_bytes"]
    assert mem.labels(family="trim", component="total").value == \
        engine.nbytes() > 0
    calls = plane.families["repro_kernel_calls"]
    assert calls.labels(kernel="sparse_expand", path="plain").value > 0
    # the plan's kernel cost, from its first dispatch only
    nbytes = plane.families["repro_plan_kernel_bytes"].labels(
        family="trim", plan=engine.plan_signature()).value
    assert nbytes > 0
    with obs.profile.capturing() as again:
        plan(tg, method="ac4", frontier="sparse", device=CPU).run()
    assert obs.plan_cost(again)["bytes_accessed"] == nbytes


@pytest.mark.parametrize("method,backend", [("ac4", "dense"),
                                            ("ac3", "windowed")])
def test_plan_cost_keeps_no_call_tensors(monkeypatch, method, backend):
    """The plan cost of a long first dispatch (a 1,000-round chain) keeps
    no wrapper call's tensors: the outputs of earlier rounds are freed as
    the run goes on, so memory stays flat however many rounds it takes,
    and the cost equals the one summed over the calls kept in a list."""
    import weakref
    from repro_torch.graphs import generators as G
    g = G.chain(1000, device=CPU)
    alive, peak = [], [0]
    note = obs.profile.note_call

    def spy(kernel, args, out):
        note(kernel, args, out)
        outs = out if isinstance(out, tuple) else (out,)
        alive.extend(weakref.ref(t) for t in outs
                     if isinstance(t, torch.Tensor))
        alive[:] = [r for r in alive if r() is not None]
        peak[0] = max(peak[0], len(alive))

    kw = dict(method=method, backend=backend, frontier="sparse"
              if method != "ac3" else "auto", device=CPU)
    monkeypatch.setattr(obs.profile, "note_call", spy)
    with obs.collecting_metrics() as plane:
        engine = plan(g, **kw)
        res = engine.run()
    monkeypatch.undo()
    assert res.rounds >= 1000 and len(alive) <= peak[0] <= 8
    nbytes = plane.families["repro_plan_kernel_bytes"].labels(
        family="trim", plan=engine.plan_signature()).value
    with obs.profile.capturing() as calls:
        plan(g, **kw).run()
    assert len(calls) >= 1000
    assert obs.plan_cost(calls)["bytes_accessed"] == nbytes > 0


def test_cli_metrics_json_snapshot(tmp_path, capsys):
    from repro_torch.launch import trim as ttrim
    path = tmp_path / "m.json"
    ttrim.main(["--app", "scc", "--graph", "RMAT", "--device", CPU,
                "--metrics-json", str(path)])
    assert "metrics snapshot" in capsys.readouterr().out
    plane = obs.load_snapshot(json.loads(path.read_text()))
    assert {"repro_dispatches", "repro_fixpoint_rounds",
            "repro_engine_live_bytes"} <= set(plane.families)


# -- memory accounting -----------------------------------------------------------

def test_engine_nbytes_breakdown_components():
    """Each component is the bytes of the tensors (and host arrays) it
    names, ``numel * element_size``."""
    _, tg = _pair("ER")

    def nb(*ts):
        return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                   else t.nbytes for t in ts)

    engine = plan(tg, method="ac4", workers=4, chunk=1, device=CPU)
    engine.run()
    bd = engine.nbytes_breakdown()
    gt = engine.transpose
    assert bd == {"graph": nb(tg.indptr, tg.indices),
                  "transpose": nb(gt.indptr, gt.indices),
                  "row_ids": nb(engine._tarrs[2]),
                  "worker_ids": nb(engine._worker_ids)}
    assert engine.nbytes() == sum(bd.values()) == tg.nbytes() + \
        gt.nbytes() + bd["row_ids"] + bd["worker_ids"]
    pull = plan_reach(tg, backend="windowed", device=CPU)
    pull.run(0)
    assert pull.nbytes_breakdown()["window_tile"] == nb(*pull._tile)
    peel = plan_peel(tg, device=CPU)
    peel.run()
    assert {"graph", "transpose", "edge_src", "row_ids"} == \
        set(peel.nbytes_breakdown())
    stream = plan_stream(tg, capacity=64)
    d = stream.delta
    sbd = stream.nbytes_breakdown()
    assert sbd["delta_insert_buffers"] == nb(
        d.ins_src, d.ins_dst, d.ins_alive, d._ins_src_np, d._ins_dst_np,
        d._ins_alive_np) > 0
    assert sbd["state"] == nb(*stream._state)
    assert stream.nbytes() == sum(sbd.values())
    assert d.nbytes() == sum(d.nbytes_breakdown().values())
    assert obs.engine_nbytes(stream) == {k: v for k, v in sbd.items() if v}
    assert obs.device_memory_stats() == {}          # no card here


def test_plan_cost_formulas():
    """The kernel cost formulas chip_smoke.py shares: bytes of the
    bound column, and flash attention's causal operation count."""
    n, cap = 1000, 128
    mask = torch.zeros(n, dtype=torch.bool)
    assert obs.kernel_cost("frontier_compact", (mask, cap)) == \
        (0, n + 4 * cap + 4)
    assert obs.kernel_cost("bucket_peel", (torch.zeros(n, dtype=torch.int32),
                                           mask, None)) == (0, 6 * n)
    q = torch.zeros(2, 4, 64, 32)
    k = torch.zeros(2, 2, 64, 32)
    flops, nbytes = obs.kernel_cost("flash_attention", (q, k, k, True, None))
    assert flops == 2 * 2 * 4 * 64 * 65 * 32
    assert nbytes == (2 * 2 * 4 * 64 * 32 + 2 * 2 * 2 * 64 * 32) * 4
    full, _ = obs.kernel_cost("flash_attention", (q, k, k, False, None))
    assert full == 4 * 2 * 4 * 64 * 64 * 32
