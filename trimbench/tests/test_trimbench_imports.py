"""Nothing the benchmark runs imports JAX or the JAX package ``repro``,
compared by whole top-level names (``repro_torch`` begins with
``repro``); the reference and the yardstick import nothing of the
program either."""
import ast
import subprocess
import sys

import pytest

from trimbench import guard, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: what decides `correct` and counts bytes and graphs
YARDSTICK = ["reference.py", "leastbytes.py", "csr.py",
             "generators/kronecker.py", "generators/uniform.py"]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    return [p for p in spec.HERE.rglob("*.py")
            if "tests" not in p.relative_to(spec.HERE).parts]


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_forbidden_import(path):
    tops = {guard.top(m) for m in imported(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("rel", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(rel):
    for name in imported(spec.HERE / rel):
        assert guard.top(name) in {"torch", "__future__", "trimbench"}, name
        if guard.top(name) == "trimbench":
            assert name in ("trimbench",) or name.split(".")[1] in (
                "csr", "reference"), name


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded({"repro_torch": 1, "repro_torch.core": 1,
                                   "reprox": 1, "jax_free": 1}) == []
    assert guard.forbidden_loaded({"repro": 1, "repro.core.engine": 1,
                                   "jax.numpy": 1, "jaxlib": 1, "flax": 1,
                                   "torch": 1}) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core.engine"]


def test_a_run_loads_neither_jax_nor_repro():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}]\n"
        "from trimbench import harness, spec\n"
        "for w in ('kron26.ac6', 'kron24.ac4'):\n"
        "    cfg = dict(spec.cell(w).config, scale=10)\n"
        "    out = harness.run_cell(w, 5, 0.1, True, t0=time.perf_counter(),\n"
        "                           device='cpu', config=cfg)\n"
        "    assert out['correct'], out\n"
        "from trimbench import guard\n"
        "print(guard.forbidden_loaded())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
