"""The port's command line (``repro_torch.launch.trim``) on the CPU.

Each app runs on a small named graph (``BA``, and ``chain`` for the
stream) through ``main`` with ``--device cpu``, next to the reference's
own ``run_*`` function on the same graph; the printed lines must carry the
same fields with the same values once the timings are cut out.  Every
flag whose plane is not ported yet raises and names its ROADMAP item, on
every app but ``check``, which runs the static-analysis plane.
"""
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import trim as jtrim
from repro_torch.launch import trim as ttrim

# the suite runs several test files side by side
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _fields(out: str) -> str:
    """The app's result line without its timings: the `` | ``-separated
    segments that hold wall times are dropped."""
    line = [ln for ln in out.splitlines() if ln.startswith("[")][-1]
    return " | ".join(seg for seg in line.split(" | ")
                      if not seg.startswith(("first=", "incremental ")))


@pytest.mark.parametrize("app,graph,argv", [
    ("trim", "BA", []),
    ("trim", "BA", ["--backend", "windowed", "--method", "ac4"]),
    ("scc", "BA", []),
    ("stream", "BA", []),
    ("stream", "chain", []),
    ("peel", "BA", []),
])
def test_cli_app_matches_reference(app, graph, argv, capsys):
    ttrim.main(["--app", app, "--graph", graph, "--device", "cpu", *argv])
    got = _fields(capsys.readouterr().out)
    method = argv[argv.index("--method") + 1] if "--method" in argv else "ac6"
    backend = (argv[argv.index("--backend") + 1] if "--backend" in argv
               else "dense")
    {"trim": lambda: jtrim.run_local(graph, method, 16, backend),
     "scc": lambda: jtrim.run_scc(graph, method, backend),
     "stream": lambda: jtrim.run_stream(graph),
     "peel": lambda: jtrim.run_peel(graph)}[app]()
    want = _fields(capsys.readouterr().out)
    assert got == want
    assert got.startswith(f"[{app}] {graph} ")


@pytest.mark.parametrize("argv,item", [
    (["--dryrun"], "A11"),
    (["--app", "stream", "--metrics-json", "m.json"], "A7"),
    (["--app", "peel", "--checkpoint-every", "2"], "A8"),
    (["--app", "scc", "--dryrun"], "A11"),
    (["--backend", "sharded"], "A6"),
    (["--metrics-json", "m.json"], "A7"),
    (["--app", "scc", "--checkpoint-dir", "ckpt"], "A8"),
    (["--checkpoint-every", "2"], "A8"),
    (["--fault-seed", "1"], "A8"),
    (["--fault-rate", "0.1"], "A8"),
    (["--retries", "2"], "A8"),
])
def test_cli_unported_flags_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttrim.main([*argv, "--graph", "chain", "--device", "cpu"])


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrim.main(["--app", "stream", "--graph", "chain"])


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trim", "--app", "peel",
         "--graph", "BA", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[peel] BA n=100000" in out.stdout and "== AC-4" in out.stdout
