"""The PyTorch port's FaultPlane and checkpoints against the JAX reference,
on the CPU.

The reference's three contracts (``tests/test_fault.py``), held on both
packages with the same numpy inputs:

1. **No perturbation.**  The disabled plane and an installed schedule that
   never fires give the results, dispatches and kernel builds of a run
   without the plane, and arm as many points as the reference arms.
2. **Deterministic injection, bounded recovery.**  ``FaultSchedule``
   decides as the reference's does for any seed, rate, ``at`` set, point
   subset and budget; every fault point has a recovery (retry, or restore
   and re-apply) that reproduces the uninterrupted run bit for bit, masks
   and counters.
3. **Durable checkpoints, in both directions.**  A checkpoint either
   package writes restores in the other, for every engine family and for
   the SCC driver's generations, and the restored runs equal the
   writer's bit for bit.  A fault in a checkpoint write never corrupts
   the latest good step.

Every compared value is an integer or a bool (exact), except
``compress_with_feedback``'s floats, which must be bit-identical too:
both packages do the same float32 operations in the same order.
"""
import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import fault as jflt
from repro.core import scc as jscc
from repro.core.reach import plan_reach as jplan_reach
from repro.graphs import generators as jgen
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro_torch import core as tcore
from repro_torch import fault as flt
from repro_torch import obs
from repro_torch.core import scc as tscc
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import _build
from repro_torch.launch import trim as ttrim
from repro_torch.optim.adamw import AdamWState
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import compression as tcomp

# the tensors here are tiny: intra-op threads only add overhead, and the
# suite runs several test files side by side
torch.set_num_threads(1)

CPU = "cpu"
NO_SLEEP = dict(sleep=lambda _: None)


def _np(x):
    """A host copy (a CPU tensor's ``numpy()`` would share its memory with
    an engine that goes on updating it in place)."""
    return np.array(x.numpy() if isinstance(x, torch.Tensor) else x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _er(n=64, m=256, seed=3):
    return (jgen.erdos_renyi(n, m, seed=seed, simple=True),
            tgen.erdos_renyi(n, m, seed=seed, simple=True, device=CPU))


# -- one engine of each family, on either package -----------------------------
#
# ``build(pkg, g)`` plans the family's engine, ``run(pkg, e, g)`` runs it
# through its entry point and returns the result as numpy.

def _pkg(pkg):
    return jcore if pkg == "ref" else tcore


def _kw(pkg):
    return {} if pkg == "ref" else {"device": CPU}


def _seeds(n):
    return np.arange(n) % 3 == 0


FAMILIES = {
    "trim": (lambda pkg, g: _pkg(pkg).plan(g, method="ac4", **_kw(pkg)),
             lambda pkg, e, g: _np(e.run().status)),
    "trim_windowed": (
        lambda pkg, g: _pkg(pkg).plan(g, method="ac6", backend="windowed",
                                      workers=4, chunk=8, **_kw(pkg)),
        lambda pkg, e, g: np.concatenate(
            [_np(e.run().status), _np(e.run().per_worker_edges)])),
    "reach": (lambda pkg, g: (jplan_reach(g) if pkg == "ref"
                              else tcore.plan_reach(g, device=CPU)),
              lambda pkg, e, g: _np(e.run(_seeds(g.n)).mask)),
    "peel": (lambda pkg, g: _pkg(pkg).plan_peel(g, **_kw(pkg)),
             lambda pkg, e, g: _np(e.run().coreness)),
    "stream": (lambda pkg, g: _pkg(pkg).plan_stream(g, capacity=64),
               lambda pkg, e, g: _np(e.retrim(full=True).status)),
}


def _engine(family, pkg, graphs):
    g = graphs[0] if pkg == "ref" else graphs[1]
    build, run = FAMILIES[family]
    e = build(pkg, g)
    return e, (lambda: run(pkg, e, g))


# -- the schedule: the reference's decisions ----------------------------------

SCHEDULES = [
    dict(seed=0),
    dict(seed=7, rate=0.05),
    dict(seed=7, rate=0.5, points=("pre-dispatch", "checkpoint-write")),
    dict(seed=123, rate=0.2, at={"post-dispatch": [1, 5, 999]},
         max_faults=40),
    dict(seed=2 ** 40 + 3, rate=1.0, max_faults=3),
    dict(seed=5, at={"mid-update-batch": [2], "metrics-server": [1, 1000]}),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_decisions_match_reference(kw):
    """1,000 armings of every point, interleaved (a permutation drawn from
    a numpy seed), decide as the reference's schedule decides."""
    ref, port = jflt.FaultSchedule(**kw), flt.FaultSchedule(**kw)
    order = np.random.default_rng(kw["seed"] % 97).permutation(
        np.repeat(np.arange(len(flt.FAULT_POINTS)), 1000))
    counts = dict.fromkeys(flt.FAULT_POINTS, 0)
    want, got = [], []
    for i in order:
        p = flt.FAULT_POINTS[i]
        counts[p] += 1
        want.append(ref.should_fire(p, counts[p]))
        got.append(port.should_fire(p, counts[p]))
    assert got == want
    assert port.fired == ref.fired
    assert port.describe() == ref.describe()
    assert flt.FAULT_POINTS == jflt.FAULT_POINTS
    assert flt.IO_POINTS == jflt.IO_POINTS


def test_fault_kinds_and_validation():
    assert issubclass(flt.DeviceFault, RuntimeError)
    assert issubclass(flt.IOFault, OSError)
    for p in flt.FAULT_POINTS:
        assert flt.fault_kind(p) is (flt.IOFault if p in flt.IO_POINTS
                                     else flt.DeviceFault)
        assert (flt.fault_kind(p).__name__
                == jflt.fault_kind(p).__name__)
    with pytest.raises(ValueError):
        flt.FaultPlane(flt.FaultSchedule()).arm("no-such-point")
    with pytest.raises(ValueError):
        flt.FaultSchedule(rate=1.5)
    with pytest.raises(ValueError):
        flt.FaultSchedule(at={"nowhere": [1]})
    with pytest.raises(ValueError):
        flt.call_with_retries(lambda: None, retries=-1)
    assert [flt.backoff_delay(a) for a in range(8)] == \
        [jflt.backoff_delay(a) for a in range(8)]


# -- contract 1: the disabled and inert planes perturb nothing ----------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_zero_perturbation_when_not_firing(family):
    graphs = _er(seed=17)
    base, base_run = _engine(family, "port", graphs)
    builds = _build.BUILDS[0]
    want = base_run()
    assert not flt.get_fault_plane().enabled
    with flt.injecting_faults() as plane:          # enabled, inert
        assert plane.enabled
        armed, armed_run = _engine(family, "port", graphs)
        got = armed_run()
    assert _eq(got, want)
    assert armed.dispatches == base.dispatches
    assert _build.BUILDS[0] == builds
    assert not plane.injected
    with jflt.injecting_faults() as jplane:
        jeng, jrun = _engine(family, "ref", graphs)
        assert _eq(jrun(), want)
    assert dict(plane.armings) == dict(jplane.armings)
    assert plane.armings["pre-dispatch"] == armed.dispatches
    assert not flt.get_fault_plane().enabled       # restored on exit


# -- contract 2: fault x family recovery --------------------------------------

@pytest.mark.parametrize("point", ["pre-dispatch", "post-dispatch"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dispatch_fault_retry_bit_identical(family, point):
    """An injected dispatch fault, retried, reproduces the clean run (and
    the reference's) bit for bit, results and dispatch counts:
    post-dispatch arms before the dispatch is counted."""
    graphs = _er(seed=11)
    clean, clean_run = _engine(family, "port", graphs)
    want = clean_run()
    chaos, chaos_run = _engine(family, "port", graphs)
    with flt.injecting_faults(
            flt.FaultSchedule(0, at={point: [1]})) as plane:
        got = flt.call_with_retries(chaos_run, retries=2, **NO_SLEEP)
    assert _eq(got, want), (family, point)
    assert _eq(got, _engine(family, "ref", graphs)[1]())
    assert plane.injected[point] == 1
    assert plane.recoveries[(point, "retry")] == 1
    assert chaos.dispatches == clean.dispatches


def test_retries_hard_bounded():
    _, g = _er()
    e = tcore.plan(g, method="ac4", device=CPU)
    calls = []
    with flt.injecting_faults(flt.FaultSchedule(0, rate=1.0)) as plane:
        with pytest.raises(flt.DeviceFault):
            flt.call_with_retries(lambda: (calls.append(1), e.run()),
                                  retries=3, **NO_SLEEP)
    assert len(calls) == 4                  # retries + 1, not one more
    assert plane.armings["pre-dispatch"] == 4
    assert not plane.recoveries
    assert e.dispatches == 0


def test_faults_feed_the_metrics_plane():
    _, g = _er()
    e = tcore.plan(g, method="ac4", device=CPU)
    with obs.collecting_metrics() as mp, flt.injecting_faults(
            flt.FaultSchedule(0, at={"pre-dispatch": [1]})):
        flt.call_with_retries(e.run, retries=1, **NO_SLEEP)
    snap = mp.snapshot()
    fam = {f: snap["families"][f] for f in ("repro_faults_injected",
                                            "repro_recoveries")}
    assert fam["repro_faults_injected"]["children"] == [{
        "labels": {"kind": "DeviceFault", "point": "pre-dispatch"},
        "value": 1.0}]
    assert fam["repro_recoveries"]["children"] == [{
        "labels": {"point": "pre-dispatch", "strategy": "retry"},
        "value": 1.0}]


def _stream_pair(seed, capacity=64):
    jg, tg = _er(seed=seed)
    return (jcore.plan_stream(jg, capacity=capacity),
            tcore.plan_stream(tg, capacity=capacity))


def test_mid_update_batch_is_retry_safe():
    """``mid-update-batch`` fires after validation and before any host
    mirror moved: re-applying the same batch is a correct recovery."""
    ref, chaos = _stream_pair(5)
    src, dst = chaos.delta._src_np.copy(), chaos.delta._dst_np.copy()
    batches = [dict(deletions=(src[:7], dst[:7])),
               dict(deletions=(src[9:12], dst[9:12]),
                    insertions=(dst[:3], src[:3]))]
    for b in batches:
        ref.apply(**b)
    with flt.injecting_faults(
            flt.FaultSchedule(0, at={"mid-update-batch": [2]})) as plane:
        for b in batches:
            flt.call_with_retries(lambda b=b: chaos.apply(**b), retries=2,
                                  **NO_SLEEP)
    assert plane.injected["mid-update-batch"] == 1
    assert plane.armings["mid-update-batch"] == 3
    for a, b in zip(chaos._state, ref._state):
        assert _eq(a, b)
    assert (chaos.delta.n_tomb, chaos.delta.n_ins, chaos.dispatches) == \
        (ref.delta.n_tomb, ref.delta.n_ins, ref.dispatches)


def test_stream_dispatch_fault_recovers_via_checkpoint(tmp_path):
    """A pre-dispatch fault in ``apply`` is not retry-safe (the host
    mirrors moved): restore the checkpoint and re-apply, which equals the
    uninterrupted engine and the reference's, status, AC-4 counters and
    overlay."""
    jref, chaos = _stream_pair(8)
    ref = tcore.plan_stream(_er(seed=8)[1], capacity=64)
    src, dst = chaos.delta._src_np.copy(), chaos.delta._dst_np.copy()
    first = dict(deletions=(src[:9], dst[:9]))
    second = dict(deletions=(src[20:25], dst[20:25]))
    for e in (jref, ref, chaos):
        e.apply(**first)
    d = str(tmp_path / "ck")
    flt.save_engine(d, chaos, step=1)
    with flt.injecting_faults(
            flt.FaultSchedule(0, at={"pre-dispatch": [1]})) as plane:
        with pytest.raises(flt.DeviceFault):
            chaos.apply(**second)
    assert plane.injected["pre-dispatch"] == 1
    restored, step, _, _ = flt.restore_engine(d, device=CPU)
    assert step == 1
    for e in (jref, ref, restored):
        e.apply(**second)
    for other in (ref, jref):
        for a, b in ((restored._state[0], other._state[0]),
                     (restored._state[1], other._state[1]),
                     (restored.delta.tomb, other.delta.tomb)):
            assert _eq(a, b)
        assert _eq(restored.retrim().status, other.retrim().status)
        assert restored.dispatches == other.dispatches


# -- checkpoints: the layout and both directions ------------------------------

def _stream_feed(pkg, graphs):
    """A stream engine after deletions, insertions, a compaction and a
    grown buffer (capacity 8, load factor 0.3)."""
    g = graphs[0] if pkg == "ref" else graphs[1]
    e = _pkg(pkg).plan_stream(g, capacity=8, load_factor=0.3)
    src, dst = e.delta._src_np.copy(), e.delta._dst_np.copy()
    rng = np.random.default_rng(4)
    e.apply(deletions=(src[:20], dst[:20]))
    e.apply(insertions=(rng.integers(0, g.n, 6), rng.integers(0, g.n, 6)))
    e.apply(deletions=(src[30:60], dst[30:60]),
            insertions=(src[:5], dst[:5]))           # compacts
    e.apply(insertions=(rng.integers(0, g.n, 20),
                        rng.integers(0, g.n, 20)))   # grows the buffer
    e.apply(deletions=(src[70:74], dst[70:74]))
    return e


def _stream_state(e):
    return [_np(e._state[0]), _np(e._state[1]), _np(e.delta.tomb),
            _np(e.delta.ins_src), _np(e.delta.ins_alive),
            _np(e.retrim().status), np.int64(e.retrim().rounds),
            np.int64(e.compactions), np.int64(e.delta.capacity)]


def _stream_next(e, g_n):
    """One more batch with a deletion of a duplicate-free base edge and an
    insertion, then the full retrim: the run compared after a restore."""
    d = e.delta
    live = np.nonzero(~d._tomb_np)[0][:6]
    e.apply(deletions=(d._src_np[live], d._dst_np[live]),
            insertions=(np.arange(3) % g_n, (np.arange(3) + 5) % g_n))
    out = _stream_state(e)
    out.append(_np(e.retrim(full=True).status))
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_cross_package(family, direction, tmp_path):
    """A checkpoint written by one package restores in the other, and the
    restored engine runs as the writer's engine does, bit for bit."""
    graphs = _er(seed=13)
    src, dst = (("ref", "port") if direction == "ref_to_port"
                else ("port", "ref"))
    d = str(tmp_path / "ck")
    if family == "stream":
        writer = _stream_feed(src, graphs)
        saved = _stream_state(writer)
        (jflt if src == "ref" else flt).save_engine(d, writer, step=5)
        saved_dispatches = writer.dispatches
        saved_builds = writer.transpose_builds
        want = _stream_next(writer, graphs[0].n)
    else:
        writer, run = _engine(family, src, graphs)
        run()                     # builds the transpose where it needs one
        (jflt if src == "ref" else flt).save_engine(d, writer, step=5)
        saved_dispatches = writer.dispatches
        saved_builds = writer.transpose_builds
        want = run()
    if dst == "ref":
        restored, step, tree, meta = jflt.restore_engine(d)
    else:
        restored, step, tree, meta = flt.restore_engine(d, device=CPU)
    assert step == 5 and meta["engine"]["family"] == writer.family
    assert restored.dispatches == saved_dispatches
    assert restored.transpose_builds == saved_builds
    if family == "stream":
        for a, b in zip(_stream_state(restored), saved):
            assert _eq(a, b)
        got = _stream_next(restored, graphs[0].n)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert _eq(a, b)
    else:
        g = graphs[0] if dst == "ref" else graphs[1]
        assert _eq(FAMILIES[family][1](dst, restored, g), want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_roundtrip_bit_identical(family, tmp_path):
    graphs = _er(seed=13)
    engine, run = _engine(family, "port", graphs)
    want = run()
    d = str(tmp_path / "ck")
    flt.save_engine(d, engine, step=3)
    restored, step, _, meta = flt.restore_engine(d, device=CPU)
    assert step == 3 and meta["engine"]["family"] == engine.family
    assert meta["engine"]["plan_kwargs"] == engine._plan_kwargs()
    assert restored.dispatches == engine.dispatches
    assert restored.traces == engine.traces == 0
    assert restored.plan_signature() == engine.plan_signature()
    assert _eq(FAMILIES[family][1]("port", restored, graphs[1]), want)


def test_checkpoint_tree_names_match_reference(tmp_path):
    """The tree naming (sorted dict keys, list indices, NamedTuple fields
    as ``.field``) and the manifest of a nested tree equal the
    reference's; a bfloat16 leaf raises instead of being cast."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 2)).astype(np.float32),
              rng.integers(0, 9, 4).astype(np.int32), np.array(7, np.int32)]
    from repro.optim.adamw import AdamWState as JState
    jtree = {"params": {"w": [jnp.asarray(arrays[0]),
                              jnp.asarray(arrays[1])]},
             "opt": JState(count=jnp.asarray(arrays[2]),
                           mu=[jnp.asarray(arrays[0])], nu=[None]),
             "b": (jnp.asarray(arrays[1]),)}
    ttree = {"params": {"w": [torch.from_numpy(arrays[0]),
                              torch.from_numpy(arrays[1])]},
             "opt": AdamWState(count=torch.from_numpy(arrays[2]),
                               mu=[torch.from_numpy(arrays[0])], nu=[None]),
             "b": (torch.from_numpy(arrays[1]),)}
    assert [k for k, _ in ckpt_lib.leaves(ttree)] == \
        list(jckpt._flatten(jtree)[0])
    jckpt.save(str(tmp_path / "j"), 4, jtree, {"a": 1})
    ckpt_lib.save(str(tmp_path / "t"), 4, ttree, {"a": 1})
    mans = [json.load(open(tmp_path / w / "step_00000004" / "manifest.json"))
            for w in "jt"]
    assert mans[0] == mans[1]
    got, step, meta = ckpt_lib.restore(str(tmp_path / "j"), ttree,
                                       device=CPU)
    assert step == 4 and meta == {"a": 1}
    assert isinstance(got["opt"], AdamWState)
    for (_, a), (_, b) in zip(ckpt_lib.leaves(got), ckpt_lib.leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        ckpt_lib.restore(str(tmp_path / "j"),
                         {**ttree, "b": (torch.zeros(5),)}, device=CPU)
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt_lib.save(str(tmp_path / "bf"), 1,
                      {"x": torch.ones(2, dtype=torch.bfloat16)})
    assert ckpt_lib.latest_step(str(tmp_path / "bf")) is None


def test_restore_checks_family_plan_and_device(tmp_path, monkeypatch):
    jg, tg = _er()
    e = tcore.plan(tg, method="ac4", device=CPU)
    with pytest.raises(ValueError, match="family"):
        e.load_state(e.state_dict(), {"family": "peel"})
    # the reference's plan kwargs: use_kernel ignored, packed/unmasked
    # kept where the port's plan takes them; a sharded plan re-plans on
    # the default group, a packed dense one is refused as plan() refuses
    je = jcore.plan(jg, method="ac4", use_kernel=False, unmasked=True)
    d = str(tmp_path / "ck")
    jflt.save_engine(d, je, step=1)
    restored, _, _, meta = flt.restore_engine(d, device=CPU)
    assert meta["engine"]["plan_kwargs"]["use_kernel"] is False
    assert restored.unmasked and restored._plan_kwargs() == {
        k: v for k, v in meta["engine"]["plan_kwargs"].items()
        if k != "use_kernel"}
    em = dict(meta["engine"], plan_kwargs={
        **meta["engine"]["plan_kwargs"], "backend": "sharded"})
    sharded = flt.engine_from_state(ckpt_lib.load_flat(d)[0], em, device=CPU)
    assert sharded.backend == "sharded" and sharded.unmasked
    em = dict(meta["engine"], plan_kwargs={
        **meta["engine"]["plan_kwargs"], "packed": True})
    with pytest.raises(ValueError, match="sharded"):
        flt.engine_from_state(ckpt_lib.load_flat(d)[0], em, device=CPU)
    ckpt_lib.save(str(tmp_path / "plain"), 1, {"x": np.arange(3)})
    with pytest.raises(ValueError, match="engine"):
        flt.restore_engine(str(tmp_path / "plain"), device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flt.restore_engine(d)                 # the default is the card


# -- contract 3: durable checkpoint writes ------------------------------------

def test_checkpoint_write_fault_preserves_latest(tmp_path):
    _, g = _er()
    e = tcore.plan(g, method="ac4", device=CPU)
    want = e.run().status.numpy()
    d = str(tmp_path / "ck")
    flt.save_engine(d, e, step=1)
    with flt.injecting_faults(
            flt.FaultSchedule(0, at={"checkpoint-write": [1]})):
        with pytest.raises(flt.IOFault):
            flt.save_engine(d, e, step=2)
    assert ckpt_lib.latest_step(d) == 1     # step 2 never became visible
    assert not os.path.exists(os.path.join(d, "step_00000002.tmp"))
    restored, step, _, _ = flt.restore_engine(d, device=CPU)
    assert step == 1 and _eq(restored.run().status, want)


def test_torn_tmp_dir_is_invisible(tmp_path):
    _, g = _er()
    e = tcore.plan(g, method="ac4", device=CPU)
    d = str(tmp_path / "ck")
    flt.save_engine(d, e, step=1)
    torn = os.path.join(d, "step_00000002.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "garbage.npy"), "w") as f:
        f.write("not a checkpoint")
    assert ckpt_lib.latest_step(d) == jckpt.latest_step(d) == 1
    assert flt.restore_engine(d, device=CPU)[1] == 1
    flt.save_engine(d, e, step=2)           # overwrites the torn tmp
    assert ckpt_lib.latest_step(d) == 2 and not os.path.exists(torn)


def test_async_checkpointer_flushes_copies_and_prunes(tmp_path):
    d = str(tmp_path / "ck")
    ck = ckpt_lib.AsyncCheckpointer(d, keep=2)
    x = torch.arange(5, dtype=torch.int32)
    ck.save(1, {"x": x})
    x += 100                    # mutated right after save: not in step 1
    ck.save(2, {"x": x})
    ck.save(3, {"x": x.numpy()})
    x += 100
    ck.close()                              # must flush the queued writes
    tree, step, _ = ckpt_lib.load_flat(d)
    assert step == 3 and _eq(tree["x"], np.arange(5) + 100)
    assert _eq(ckpt_lib.load_flat(d, 2)[0]["x"], np.arange(5) + 100)
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    ck.close()                              # idempotent
    with pytest.raises(RuntimeError):
        ck.save(4, {"x": x})                # a closed writer refuses work


def test_async_checkpointer_error_surfaced_once(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file where the ckpt dir should go")
    ck = ckpt_lib.AsyncCheckpointer(str(blocker))
    ck.save(1, {"x": np.arange(3)})
    with pytest.raises(OSError):
        ck.wait()                           # the write error surfaces...
    ck.wait()                               # ...exactly once
    ck.close()


# -- the SCC driver: generation-level checkpoint/resume -----------------------

def _scc_graphs():
    return (jgen.rmat(6, 400, seed=2),
            tgen.rmat(6, 400, seed=2, device=CPU))


def test_scc_armings_match_reference(tmp_path):
    """One checkpointed ``scc_decompose`` arms the same points as many
    times as the reference's, and its labels and stats equal the clean
    run's."""
    jg, tg = _scc_graphs()
    with jflt.injecting_faults() as jprobe:
        jl, _ = jscc.scc_decompose(jg, checkpoint_dir=str(tmp_path / "j"),
                                   checkpoint_every=1)
    with flt.injecting_faults() as probe:
        tl, ts = tscc.scc_decompose(tg, checkpoint_dir=str(tmp_path / "t"),
                                    checkpoint_every=1, device=CPU)
    assert dict(probe.armings) == dict(jprobe.armings)
    assert probe.armings["checkpoint-write"] == ts["generations"]
    assert _eq(tl, jl)
    clean, clean_stats = tscc.scc_decompose(tg, device=CPU)
    assert _eq(tl, clean) and ts == clean_stats
    tree, step, meta = ckpt_lib.load_flat(str(tmp_path / "t"))
    jtree, jstep, jmeta = jckpt.load_flat(str(tmp_path / "j"))
    assert step == jstep and meta == jmeta
    assert tree.keys() == jtree.keys()
    assert all(_eq(tree[k], jtree[k]) and tree[k].dtype == jtree[k].dtype
               for k in tree)


def _faulted_scc(pkg, g, d, **kw):
    """Fault the last pre-dispatch of a checkpointed run (by then at
    least one generation is on disk)."""
    mod, f = (jscc, jflt) if pkg == "ref" else (tscc, flt)
    extra = {} if pkg == "ref" else {"device": CPU}
    with f.injecting_faults() as probe:
        mod.scc_decompose(g, checkpoint_dir=d + "_probe",
                          checkpoint_every=1, **kw, **extra)
    total = probe.armings["pre-dispatch"]
    assert total >= 2
    with f.injecting_faults(f.FaultSchedule(0, at={"pre-dispatch": [total]})):
        with pytest.raises(f.DeviceFault):
            mod.scc_decompose(g, checkpoint_dir=d, checkpoint_every=1, **kw,
                              **extra)
    assert ckpt_lib.latest_step(d) is not None


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("counters", [False, True])
def test_scc_checkpoint_resume_after_fault(writer, counters, tmp_path):
    """Either package's generation checkpoints resume in both: the labels,
    generations, pivots and per-worker counters equal the clean run."""
    jg, tg = _scc_graphs()
    kw = dict(counters=counters, workers=4, chunk=8)
    clean, clean_stats = tscc.scc_decompose(tg, device=CPU, **kw)
    assert clean_stats["generations"] >= 2   # resume needs a mid-point
    d = str(tmp_path / "ck")
    _faulted_scc(writer, jg if writer == "ref" else tg, d, **kw)
    labels, stats = tscc.scc_decompose(tg, checkpoint_dir=d,
                                       checkpoint_every=1, resume=True,
                                       device=CPU, **kw)
    jlabels, jstats = jscc.scc_decompose(jg, checkpoint_dir=d,
                                         checkpoint_every=1, resume=True,
                                         **kw)
    for lab, st in ((labels, stats), (jlabels, jstats)):
        assert _eq(lab, clean)
        for k in ("generations", "pivots", "trimmed_total",
                  "trim_edges_traversed"):
            assert st[k] == clean_stats[k], k
        if counters:
            assert _eq(st["per_worker_edges"],
                       clean_stats["per_worker_edges"])


def test_scc_checkpointing_does_not_change_labels(tmp_path):
    _, tg = _scc_graphs()
    clean, _ = tscc.scc_decompose(tg, device=CPU)
    d = str(tmp_path / "ck")
    ck = ckpt_lib.AsyncCheckpointer(d, keep=100)
    labels, stats = tscc.scc_decompose(tg, checkpoint_dir=d,
                                       checkpoint_every=2, checkpointer=ck,
                                       device=CPU)
    ck.close()
    assert _eq(labels, clean)
    tree, step, meta = ckpt_lib.load_flat(d)
    assert step == stats["generations"] and _eq(tree["labels"], clean)
    assert tree["regions"].shape == (0, tg.n)
    assert meta["driver"]["next_label"] == int(clean.max()) + 1
    # a resume from the final state replays nothing
    again, st = tscc.scc_decompose(tg, checkpoint_dir=d, checkpoint_every=2,
                                   resume=True, device=CPU)
    assert _eq(again, clean) and st["trim_dispatches"] == 0


# -- the metrics server, the CLI, compression ---------------------------------

def test_metrics_server_answers_503_on_fault():
    srv = obs.MetricsServer(0)
    try:
        url = f"http://127.0.0.1:{srv.port}/healthz"
        with flt.injecting_faults(
                flt.FaultSchedule(0, at={"metrics-server": [2]})) as plane:
            assert urllib.request.urlopen(url, timeout=10).status == 200
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(url, timeout=10)
            assert err.value.code == 503
            assert urllib.request.urlopen(url, timeout=10).status == 200
        assert plane.injected["metrics-server"] == 1
    finally:
        srv.close()


def test_cli_scc_checkpoints_and_faults(tmp_path, capsys):
    """``--app scc`` with the five flags resumes across injected faults and
    ends with the labels of a run without faults (its final checkpoint)."""
    d = str(tmp_path / "ck")
    ttrim.main(["--app", "scc", "--graph", "RMAT", "--device", "cpu",
                "--checkpoint-dir", d, "--checkpoint-every", "1",
                "--fault-seed", "0", "--fault-rate", "0.05",
                "--retries", "5"])
    out = capsys.readouterr().out
    # seed 0 fires the third and fourth pre-dispatch armings
    assert out.count("resuming from latest checkpoint") == 2
    assert "[scc] RMAT" in out
    labels, _ = tscc.scc_decompose(tgen.make("RMAT", device=CPU), device=CPU)
    tree, _, _ = ckpt_lib.load_flat(d)
    assert _eq(tree["labels"].astype(np.int64), labels)
    assert tree["regions"].shape[0] == 0


@pytest.mark.parametrize("argv", [
    ["--app", "check", "--fault-seed", "1"],
    ["--app", "peel", "--checkpoint-dir", "ckpt"],
])
def test_cli_refuses_flags_that_do_not_apply(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrim.main([*argv, "--graph", "chain", "--device", "cpu"])
    assert exc.value.code == 2
    assert "appl" in capsys.readouterr().err


@pytest.mark.parametrize("shape", [(5,), (17, 3), ()])
def test_compress_with_feedback_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    grads = {"a": np.asarray(rng.standard_normal(shape) * 3, np.float32),
             "b": [rng.standard_normal((4,)).astype(np.float32)]}
    jg = {"a": jnp.asarray(grads["a"]), "b": [jnp.asarray(grads["b"][0])]}
    tg = {"a": torch.from_numpy(grads["a"]),
          "b": [torch.from_numpy(grads["b"][0])]}
    jerr, terr = jcomp.init_error_feedback(jg), tcomp.init_error_feedback(tg)
    for _ in range(3):
        jq, jerr = jcomp.compress_with_feedback(jg, jerr)
        tq, terr = tcomp.compress_with_feedback(tg, terr)
        for a, b in ((tq["a"], jq["a"]), (tq["b"][0], jq["b"][0]),
                     (terr["a"], jerr["a"]), (terr["b"][0], jerr["b"][0])):
            assert _eq(a, b) and _np(a).dtype == np.asarray(b).dtype
    q, s = tcomp.quantize(tg["a"])
    jqq, js = jcomp.quantize(jg["a"])
    assert q.dtype == torch.int8 and _eq(q, jqq) and _eq(s, js)
    assert _eq(tcomp.dequantize(q, s), jcomp.dequantize(jqq, js))
