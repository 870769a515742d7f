"""Every cell, configuration, mix, generator and metric of
``BENCHMARK.json`` loads by its name, and the file keeps to the
benchmark's contract."""
import json
import re

import pytest

from trimbench import spec

BENCH = spec.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "trimbench/run.py"]
    assert BENCH["paths"] == ["trimbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.fullmatch(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]


def test_names_unique_and_metrics_well_formed():
    for section in KEYS:
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in WORKLOADS


def test_configs_are_used_and_their_files_agree():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        path = spec.ROOT / c["file"]
        assert path.parent == spec.HERE / "configs"
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        spec.load_module("generators", cfg["generator"])


def test_each_pair_once_and_one_chip():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    cell = spec.cell(workload)
    assert cell.mix["name"] == next(
        w["traffic"] for w in BENCH["workloads"] if w["name"] == workload)
    assert {m["name"] for m in cell.end_to_end} == {
        "trim_throughput", "trim_p95_ms", "peak_mem_gib", "setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_loads_by_name_and_moves_what_it_says(metric):
    mod = spec.load_module("metrics", metric)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert mod.MOVES == entry["moves"]
    assert callable(mod.read)


def test_names_cannot_leave_the_folder():
    for bad in ("../x", "a/b", "", "a b", "x" * 65):
        with pytest.raises(ValueError):
            spec.check_name(bad)


def test_files_under_paths_are_named_from_name_characters():
    for p in spec.HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", rel), rel
