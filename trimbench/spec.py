"""Where the benchmark finds its pieces: the cells of ``BENCHMARK.json``
and, by name, the files of each configuration (``configs/<name>.json``),
traffic mix (``mixes/<name>.json``), graph generator
(``generators/<name>.py``) and per-layer metric (``metrics/<name>.py``).

A later cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


class Cell(NamedTuple):
    """One entry of ``workloads`` with its files loaded."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def check_name(name: str) -> str:
    """``name`` if it is a valid benchmark name (no slash, no space)."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{check_name(name)}.json").read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (names may hold dots, so it is
    loaded from its path, not imported by a dotted name)."""
    path = HERE / kind / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"trimbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: ``BENCHMARK.json``)."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"]
                  if w["name"] == check_name(workload)), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json("configs", entry["config"])
    mix = load_json("mixes", entry["traffic"])
    return Cell(workload, int(entry["chips"]), config, mix,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])
