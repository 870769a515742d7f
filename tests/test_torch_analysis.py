"""The port's static-analysis plane (``repro_torch.analysis``) on the CPU,
held against the reference's (``repro.analysis``) where the two say the
same thing.

Comparisons are of names, strings and booleans, so they are exact: the
findings' JSON keys and rendered lines, the mutant twins' names and
``expect`` checkers and the checkers that fire on each pair, the catalog
names, the engines' plan signatures and kwargs.  Kernels are captured on
meta tensors (nothing runs, no library is built); plans run on tiny CPU
graphs.  The captured launches are held against the card's own in
``tests/test_torch_gpu.py``.
"""
import json
import re

import numpy as np
import pytest
import torch

from repro.analysis import catalog as jcatalog
from repro.analysis import findings as jfindings
from repro.analysis import mutants as jmutants
from repro.analysis import races as jraces
from repro_torch.analysis import capture, catalog, check, findings, mutants
from repro_torch.analysis import races, retrace, syncs
from repro_torch.kernels import _build

torch.set_num_threads(1)

SAMPLE = [("write-race", "error", "kernel:x[n=64]", "blocks (0,) and (1,)"),
          ("mutant-caught", "info", "mutant:y", "expected checker fired"),
          ("unstable-plan", "warning", "engine:trim", "2 signatures")]


def test_findings_json_and_render_match_reference():
    assert findings.SEVERITIES == jfindings.SEVERITIES
    assert findings.SCHEMA_VERSION == jfindings.SCHEMA_VERSION
    port, ref = findings.Report(), jfindings.Report()
    port.extend([findings.Finding(*f) for f in SAMPLE])
    ref.extend([jfindings.Finding(*f) for f in SAMPLE])
    for r in (port, ref):
        r.note_subjects("races", 3)
        r.note_subjects("syncs", 2)
    assert port.to_json() == ref.to_json()
    for verbose in (False, True):
        assert port.render(verbose) == ref.render(verbose)
    assert port.ok() is ref.ok() is False
    with pytest.raises(ValueError):
        findings.Finding("x", "fatal", "s", "m")


def test_b10_twins_pair_with_the_reference_and_are_caught():
    assert [(m.name, m.expect) for m in mutants.MUTANT_KERNELS] == \
        [(m.name, m.expect) for m in jmutants.MUTANT_KERNELS]
    results = {r["name"]: r for r in mutants.verify_mutants()}
    for m in mutants.MUTANT_KERNELS:
        assert results[m.name]["caught"], results[m.name]["findings"]


@pytest.mark.parametrize("name", [m.name for m in jmutants.MUTANT_KERNELS])
def test_twin_rule_parity(name):
    """The reference's twin through its race rules and the port's through
    the port's: the same checkers fire, the expected one among them."""
    jm = {m.name: m for m in jmutants.MUTANT_KERNELS}[name]
    tm = {m.name: m for m in mutants.MUTANT_KERNELS}[name]
    jdecls = {**jcatalog.KERNEL_DECLARATIONS, **jmutants.MUTANT_DECLARATIONS}
    tdecls = {**catalog.LAUNCH_DECLARATIONS, **mutants.MUTANT_DECLARATIONS}
    jfired = {f.checker for cap in jm.build()
              for f in jraces.check_capture("s", cap, jdecls)}
    tfired = {f.checker for launch in tm.build()
              for f in races.check_capture("s", launch, tdecls)}
    assert jm.expect in jfired and tm.expect in tfired
    assert tfired == jfired


def test_mutant_twins_never_run_outside_capture():
    """A twin refuses to launch without the recorder: the out-of-bounds
    one would write out of bounds on a card."""
    twin = _twin_wrapper("oob_copy")
    with pytest.raises(RuntimeError, match="never run"):
        twin(catalog.tensor(64, "int32"))


def _twin_wrapper(kernel):
    """The twin's wrapper function itself (``_mutant_launch`` captures it
    at once, so rebuild it the same way)."""
    captured = {}
    real = capture.capture_kernel

    def grab(fn, *args, **kwargs):
        captured["fn"] = fn
        return real(fn, *args, **kwargs)
    mutants.capture_kernel = grab
    try:
        mutants._mutant_launch(kernel, 64, 16)
    finally:
        mutants.capture_kernel = real
    return captured["fn"]


def test_kernel_catalog_names_match_reference():
    assert [e.name for e in catalog.KERNEL_CATALOG] == \
        [e.name for e in jcatalog.KERNEL_CATALOG]


def _global_kernels():
    """Every ``__global__`` function of the port's CUDA sources but the
    copy kernel's, by (library, name)."""
    out = set()
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                               r"\([^)]*\)\s+)?(\w+)", text):
            out.add((path.stem, name))
    return out - {("mutant_copy", k) for k in ("mutant_copy",
                                               "mutant_copy_carry")}


def test_every_launch_is_declared_and_every_kernel_captured():
    """The declarations name exactly the sources' kernels (17), and the
    lattice captures each of them at least once."""
    declared = set(catalog.LAUNCH_DECLARATIONS)
    assert declared == _global_kernels() and len(declared) == 17
    seen = {(launch.library, launch.kernel)
            for entry in catalog.KERNEL_CATALOG for point in entry.points
            for launch in entry.build(point)}
    assert seen == declared
    assert {(mutants.LIB, k) for k in ("mutant_copy", "mutant_copy_carry")} \
        <= set(mutants.MUTANT_DECLARATIONS)


def test_registry_is_clean_under_strict():
    report = check.run_registry_checks()
    assert report.ok(strict=True), report.render()
    assert report.subjects_checked["syncs"] == 23
    assert report.subjects_checked["host-dtypes"] == 23
    assert report.subjects_checked["races"] >= sum(
        len(e.points) for e in catalog.KERNEL_CATALOG)
    assert report.subjects_checked["rebuilds"] == len(
        list(_build.CSRC.glob("*.cu")))
    assert report.subjects_checked["generator-dtypes"] == 6


def _launch(entry_name, point):
    entry = {e.name: e for e in catalog.KERNEL_CATALOG}[entry_name]
    return entry.build(point)[0]


def _fired(launch, decls=catalog.LAUNCH_DECLARATIONS):
    return {f.checker for f in races.check_capture("s", launch, decls)}


def _blocks_folded():
    # a declaration whose block map folds blocks 2i and 2i + 1 onto one
    # slice, as a kernel indexing by blockIdx.x / 2 would
    decl = catalog.LAUNCH_DECLARATIONS[("first_live_scan",
                                        "first_live_w16")]
    halved = catalog.OutputDecl("owned", decl.outputs["first"].extent,
                                lambda launch, shape, b: (b[0] // 2,))
    return {("first_live_scan", "first_live_w16"): catalog.LaunchDecl(
        {"first": halved, "found": halved})}


def _bad(rule):
    fl = _launch("first_live_scan", {"n": 700, "w": 16})
    if rule == "uncovered-block":       # grid by floor, not ceil
        return _fired(fl._replace(grid=(700 // 256, 1, 1)))
    if rule == "oob-write":
        # bucket_peel's grid before the analysis: a thread for a tail that
        # n = 2048 does not have, so a whole block past the end
        bp = _launch("bucket_peel", {"n": 2048})
        return _fired(bp._replace(grid=(_build.blocks(2048 // 4 + 1, 256),
                                        1, 1)))
    if rule == "undeclared-sequential":  # a second grid row redoes the first
        return _fired(fl._replace(grid=(3, 2, 1)))
    if rule == "write-race":
        return _fired(fl, _blocks_folded())
    if rule == "carry-without-sequential":
        return _fired(fl._replace(scratch=True))
    if rule == "unregistered-kernel":
        return _fired(fl._replace(kernel="first_live_w32"))
    if rule == "grid-too-large":
        return _fired(fl._replace(grid=(2**31, 1, 1)))
    entry = {e.name: e for e in catalog.KERNEL_CATALOG}[
        "flash_attention" if rule == "capture-failure"
        else "first_live_scan"]
    point = ({"b": 1, "hq": 2, "hkv": 2, "sq": 32, "sk": 32, "d": 48,
              "causal": True} if rule == "capture-failure"
             else {"n": 0, "w": 16})
    found, _ = races.check_races(
        [catalog.KernelEntry(entry.name, (point,), entry.call)],
        catalog.LAUNCH_DECLARATIONS)
    return {f.checker for f in found}


@pytest.mark.parametrize("rule", [
    "uncovered-block", "oob-write", "undeclared-sequential", "write-race",
    "carry-without-sequential", "unregistered-kernel", "grid-too-large",
    "capture-failure", "no-kernel-launch"])
def test_each_rule_is_killed_by_a_bad_geometry_of_a_real_kernel(rule):
    assert rule in _bad(rule)
    # and the real geometry is clean
    assert not _fired(_launch("first_live_scan", {"n": 700, "w": 16}))


def test_capture_never_loads_a_library(monkeypatch):
    def refuse(*_):
        raise AssertionError("capture loaded or built a library")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = dict(_build.LAUNCHES)
    n = sum(len(entry.build(point)) for entry in catalog.KERNEL_CATALOG
            for point in entry.points)
    assert n > 0 and _build.LAUNCHES == before


def test_capture_restores_the_funnel_after_an_exception():
    real = _build.launch

    def wrapper(x, active):
        from repro_torch.kernels.first_live_scan import first_live_scan
        first_live_scan(x, x, active)           # records one launch
        raise KeyError("boom")
    with pytest.raises(KeyError):
        capture.capture_kernel(wrapper, catalog.tensor((8, 16)),
                               catalog.tensor(8))
    assert _build.launch is real and _build.ACCEPTED == ("cuda",)
    assert not capture.capturing()
    with pytest.raises(ValueError, match="CUDA"):   # meta refused again
        from repro_torch.kernels.first_live_scan import first_live_scan
        first_live_scan(*(catalog.tensor(s) for s in ((8, 16), (8, 16), 8)))


def test_profiled_launches_read_a_chrome_trace():
    """Kernel events of the port's kernels, ordered by start time, with
    their grid and block; copies and PyTorch's own kernels left out."""
    ev = [
        {"cat": "kernel", "ts": 30, "name": "void (anonymous namespace)::"
         "flash_fwd<float, 64>((anonymous namespace)::Params)",
         "args": {"grid": [8, 1, 1], "block": [256, 1, 1]}},
        {"cat": "kernel", "ts": 10, "name": "void (anonymous namespace)::"
         "tile_reduce<unsigned char>(unsigned char const*, long, int*)",
         "args": {"grid": [2, 1, 1], "block": [256, 1, 1]}},
        {"cat": "gpu_memcpy", "ts": 20, "name": "Memcpy DtoD",
         "args": {}},
        {"cat": "kernel", "ts": 25, "name": "void at::native::"
         "vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>"
         "(int, at::native::FillFunctor<int>)",
         "args": {"grid": [1, 1, 1], "block": [128, 1, 1]}},
    ]
    got = capture.profiled_launches({"traceEvents": ev},
                                    {"flash_fwd", "tile_reduce"})
    assert got == [("tile_reduce", (2, 1, 1), (256, 1, 1)),
                   ("flash_fwd", (8, 1, 1), (256, 1, 1))]


def test_scan_tile_is_one_constant():
    """The prefix scan's tile reaches the CUDA source only through the
    build's -DTILE, which is the constant the wrapper sizes its grid
    with."""
    src = (_build.CSRC / "frontier_compact.cu").read_text()
    assert f"-DTILE={_build.SCAN_TILE}" in _build._flags("frontier_compact")
    assert "#error" in src and "4096" not in src
    launches = _launch("prefix_positions", {"n": 10000, "dtype": "int32"})
    assert launches.grid == (_build.blocks(10000, _build.SCAN_TILE), 1, 1)


def test_plan_catalog_names_match_reference():
    assert [e.name for e in catalog.PLAN_CATALOG] == \
        [e.name for e in jcatalog.PLAN_CATALOG]
    assert len(catalog.PLAN_CATALOG) == 23


@pytest.mark.parametrize("name", [e.name for e in jcatalog.PLAN_CATALOG])
def test_plan_syncs_equal_their_budget(name):
    """One run of each plan reads the host exactly ``per_round`` times a
    round (the rounds its result reports), once per probe-loop test, plus
    the stated constant, and copies nothing to the device inside its
    rounds; it is clean under the lint."""
    entry = {e.name: e for e in catalog.PLAN_CATALOG}[name]
    thunk, arrays = entry.build()
    result, counter, tests = syncs.count_syncs(thunk)
    rounds = syncs.rounds_of(result)
    assert rounds >= 1
    assert counter.syncs == syncs.budget(entry, rounds, tests)
    assert counter.copies_in_loop() == 0
    assert all(a.dtype == torch.int32 for a in arrays)
    found, _ = syncs.check_plan_syncs([entry])
    assert not found


def test_sync_counter_sees_host_reads_and_copies():
    x = torch.arange(6, dtype=torch.int32)
    with syncs.SyncCounter() as c:
        bool(x.any()), int(x.sum()), x.sum().item(), x.tolist()
        x.cpu(), float(x.sum()), torch.tensor(3), torch.as_tensor([1, 2])
        torch.as_tensor(x), x.to(torch.int64), torch.zeros(3)
    assert c.events == ["read"] * 6 + ["copy"] * 2


def _ref_engines(family, kw):
    from repro.core import engine as jengine
    from repro.core import peel as jpeel
    from repro.core import reach as jreach
    from repro.core import stream as jstream
    from repro.core.graph import CSRGraph as JCSR
    from repro_torch.core import plan, plan_peel, plan_reach, plan_stream
    from repro_torch.core.graph import CSRGraph as TCSR
    rng = np.random.default_rng(5)
    n, m = 50, 200
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    jg, tg = JCSR.from_edges(n, src, dst), TCSR.from_edges(n, src, dst,
                                                           device="cpu")
    if family == "trim":
        return jengine.plan(jg, **kw), plan(tg, device="cpu", **kw)
    if family == "reach":
        return jreach.plan_reach(jg, **kw), plan_reach(tg, device="cpu",
                                                       **kw)
    if family == "peel":
        return jpeel.plan_peel(jg, **kw), plan_peel(tg, device="cpu", **kw)
    return jstream.plan_stream(jg, **kw), plan_stream(tg, **kw)


@pytest.mark.parametrize("family,kw", [
    ("trim", dict(method="ac6", backend="dense", workers=2)),
    ("trim", dict(method="ac4", backend="windowed", workers=4,
                  frontier="dense", unmasked=True, chunk=64)),
    ("trim", dict(method="ac3", backend="windowed", window=8)),
    ("reach", dict(backend="dense")),
    ("reach", dict(backend="windowed", window=8, frontier="sparse")),
    ("peel", dict(frontier="dense")),
    ("peel", dict()),
    ("stream", dict(capacity=64, load_factor=0.25)),
    ("stream", dict(frontier="dense")),
])
def test_plan_signature_and_kwargs_match_reference(family, kw):
    jeng, teng = _ref_engines(family, kw)
    assert teng.plan_signature() == jeng.plan_signature()
    want = dict(jeng._plan_kwargs())
    del want["use_kernel"]
    assert teng._plan_kwargs() == want
    assert not retrace._kwarg_findings("s", teng._plan_kwargs())


def test_rebuild_lint():
    names = ["a", "b"]
    assert retrace.check_rebuilds(lambda n: f"lib{n}", names) == ([], 2)
    drift = iter(range(100))
    found, _ = retrace.check_rebuilds(lambda n: f"lib{n}.{next(drift)}",
                                      names)
    assert {f.checker for f in found} == {"rebuild-storm"}
    found, _ = retrace.check_rebuilds(lambda n: "libshared", names)
    assert [f.subject for f in found] == ["library:b"]


def test_mutant_report():
    report, ok = check.run_mutant_checks()
    assert ok, report.render(verbose=True)
    by = {}
    for f in report.findings:
        by.setdefault(f.checker, set()).add(f.subject)
    assert by["mutant-waiting"] == {f"mutant:{k}"
                                    for k in mutants.MUTANTS_WAITING}
    assert "mutant-missed" not in by and "control-flagged" not in by
    assert len(by["mutant-caught"]) == (
        len(mutants.MUTANT_KERNELS) + len(mutants.MUTANT_PLANS)
        + len(mutants.MUTANT_PROBES) + len(mutants.MUTANT_GENERATORS))


@pytest.mark.parametrize("argv", [["--strict"], ["--mutants"],
                                  ["--metrics-json", "findings.json"]])
def test_cli_app_check(argv, tmp_path, capsys):
    from repro_torch.launch import trim as ttrim
    if "--metrics-json" in argv:
        argv = ["--metrics-json", str(tmp_path / argv[1])]
    assert ttrim.main(["--app", "check", "--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "0 error(s)" in out
    if "--metrics-json" in argv:
        doc = json.loads((tmp_path / "findings.json").read_text())
        assert doc["version"] == 1 and doc["counts"]["error"] == 0
        assert doc["subjects_checked"]["syncs"] == 23


@pytest.mark.parametrize("flag", [["--fault-seed", "1"],
                                  ["--fault-rate", "0.1"],
                                  ["--retries", "2"],
                                  ["--checkpoint-dir", "ckpt"],
                                  ["--checkpoint-every", "2"]])
def test_cli_app_check_rejects_fault_flags(flag, capsys):
    from repro_torch.launch import trim as ttrim
    with pytest.raises(SystemExit):
        ttrim.main(["--app", "check", *flag])
    assert "static analysis" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--strict", "--mutants"])
def test_cli_check_flags_need_app_check(flag, capsys):
    from repro_torch.launch import trim as ttrim
    with pytest.raises(SystemExit):
        ttrim.main([flag, "--graph", "chain", "--device", "cpu"])
    assert "apply to --app check" in capsys.readouterr().err
