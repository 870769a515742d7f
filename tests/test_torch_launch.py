"""The port's command line (``repro_torch.launch.trim``) on the CPU.

Each app runs on a small named graph (``BA``, and ``chain`` for the
stream) through ``main`` with ``--device cpu``, next to the reference's
own ``run_*`` function on the same graph; the printed lines must carry the
same fields with the same values once the timings are cut out.
``--backend sharded`` runs as a world of one gloo rank, and ``--dryrun
--backend sharded`` sizes one rank of 512 (``tests/test_torch_distributed.py``
holds both against the reference); ``--dryrun`` alone sizes the production
graph for one card on any app (``tests/test_torch_dryrun.py`` holds its
bytes against real engines).
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
    (["--backend", "sharded"], "A6"),
    (["--dryrun", "--backend", "sharded"], "A6"),
])
def test_cli_unported_flags_raise(argv, item, capsys):
    """The two flags ROADMAP A6 used to refuse now run: the sharded trim
    as a world of one rank, the dry-run as one rank of 512."""
    out = ttrim.main([*argv, "--graph", "BA", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "sharded" in text and f"ROADMAP {item}" not in text
    if "--dryrun" in argv:
        assert out["ranks"] == 512 and out["gather_sites_per_round"] == 1
    else:
        assert out.per_worker_edges.shape == (1,)
        assert not torch.distributed.is_initialized()   # left as found


@pytest.mark.parametrize("argv", [["--dryrun"], ["--app", "scc", "--dryrun"]])
def test_cli_dryrun_sizes_the_production_graph(argv, capsys):
    fp = ttrim.main([*argv, "--graph", "chain", "--device", "cpu"])
    first, second = capsys.readouterr().out.strip().splitlines()
    assert first.startswith("[trim-dryrun] ac6/dense on one H100 ")
    assert (f"per-device args {sum(fp['held'].values()) / 2**20:.1f} MiB, "
            f"temps {sum(fp['run'].values()) / 2**20:.1f} MiB, all-gather "
            "sites 0") in first
    assert second == ("  graph: n=64,000,000 m=512,000,000 -> 64,000,000 "
                      "vertices/device; status all_gather 7.6 MiB per round "
                      "once sharded (--backend sharded)")


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
