"""Without a card the benchmark fails and prints no result: no path falls
back to the CPU.  So it does in a folder holding only ``BENCHMARK.json``
and the benchmark's files."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from trimbench import spec


def run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "trimbench/run.py", "--workload", "kron26.ac6",
         "--seed", "2147483660", "--seconds", "1", "--trace", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def no_result(res):
    for line in res.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "metrics" in obj), line


@pytest.mark.parametrize("trace", ["0", "1"])
def test_no_card_no_result(trace):
    res = run(spec.ROOT, trace)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    no_result(res)


def test_bare_folder_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "trimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path, "0")
    assert res.returncode != 0
    no_result(res)


def test_unknown_workload_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "trimbench/run.py", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    no_result(res)
