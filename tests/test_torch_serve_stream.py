"""The port's trim-stream server (``launch/serve.py --app trim-stream``)
against the JAX reference's ``serve_trim_stream``, on the CPU.

Both servers draw the same feed (``numpy.random.default_rng(seed)``, edges
addressed by their position in the generated graph), so every compared
value is exact: the final checkpoints' engine state (``status``,
``counters``, ``tomb``, ``ins_alive``), feed state (``feed_alive``,
``feed_pending``, ``feed_pending_lens``), RNG state and dirty ticks, the
printed line's integer fields, and the FaultPlane's counts under one
schedule.  A checkpoint either package writes resumes in the other.  The
port runs with ``device="cpu"``.
"""
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro import fault as jflt
from repro.configs import trim_graphs as jtrim_graphs
from repro.launch import serve as jserve
from repro_torch import fault as flt
from repro_torch.configs import trim_graphs
from repro_torch.launch import serve
from repro_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(1)

CPU = "cpu"
ENGINE_KEYS = ("status", "counters", "tomb", "ins_alive")
FEED_KEYS = ("feed_alive", "feed_pending", "feed_pending_lens")
LINE = re.compile(
    r"\[serve\] trim-stream (\S+) n=(\d+) m=(\d+): (\d+) ticks \(\d+ "
    r"compile, excluded\), (\d+) updates, \S+ updates/s steady-state, "
    r"dirty ticks (\d+), trimmed (\d+) \(([\d.]+)%\), compactions (\d+)")
FAMILIES = ("chain", "RMAT", "ER", "BA", "layered", "sink_heavy")
#: the reference's metric families that the port names for what it
#: measures (``repro_torch.core.enginebase``, ``repro_torch.obs``)
RENAMED = {"repro_dispatch_latency_seconds": "repro_dispatch_wall_seconds",
           "repro_traces": "repro_kernel_builds",
           "repro_plan_compiles": "repro_plan_builds",
           "repro_plan_cost_flops": "repro_plan_kernel_flops",
           "repro_plan_cost_bytes": "repro_plan_kernel_bytes",
           "repro_kernel_traces": "repro_kernel_calls"}


def _port(graph="chain", **kw):
    kw.setdefault("batch", 32)
    return serve.serve_trim_stream(graph, seed=0, device=CPU, **kw)


def _ref(graph="chain", **kw):
    kw.setdefault("batch", 32)
    return jserve.serve_trim_stream(graph, seed=0, **kw)


def _assert_same_ckpt(da, db, keys=ENGINE_KEYS + FEED_KEYS):
    ta, sa, ma = ckpt_lib.load_flat(da)
    tb, sb, mb = ckpt_lib.load_flat(db)
    assert sa == sb
    for key in keys:
        assert np.array_equal(ta[key], tb[key]), key
    assert ma["feed"] == mb["feed"]           # tick, dirty_ticks, rng_state
    return ta, ma


@pytest.mark.parametrize("graph", FAMILIES)
def test_server_runs_end_in_the_reference_checkpoint(graph, tmp_path,
                                                     capsys):
    da, db = str(tmp_path / "port"), str(tmp_path / "ref")
    _port(graph, ticks=8, checkpoint_dir=da, checkpoint_every=100)
    got = LINE.search(capsys.readouterr().out)
    _ref(graph, ticks=8, checkpoint_dir=db, checkpoint_every=100)
    want = LINE.search(capsys.readouterr().out)
    tree, meta = _assert_same_ckpt(da, db)
    assert meta["feed"]["tick"] == 8
    assert got and want and got.groups() == want.groups()
    assert int(got.group(4)) == 8 and tree["status"].dtype == bool


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(writer, tmp_path):
    """A checkpoint at tick 3 from one package, resumed by the other to
    tick 8, equals the writer's uninterrupted run."""
    first, second = (_ref, _port) if writer == "reference" else (_port, _ref)
    da, db = str(tmp_path / "whole"), str(tmp_path / "resumed")
    first(ticks=8, checkpoint_dir=da, checkpoint_every=100)
    first(ticks=3, checkpoint_dir=db, checkpoint_every=100)
    assert ckpt_lib.latest_step(db) == 3
    second(ticks=8, checkpoint_dir=db, checkpoint_every=100)
    _assert_same_ckpt(da, db)


# -- twins of the reference's serve tests (tests/test_fault.py) ---------------


def test_serve_resume_bit_identical(tmp_path):
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    _port(ticks=8, checkpoint_dir=da, checkpoint_every=100)
    _port(ticks=3, checkpoint_dir=db, checkpoint_every=100)
    _port(ticks=8, checkpoint_dir=db, checkpoint_every=100)
    _, sa, _ = ckpt_lib.load_flat(da)
    assert sa == 8
    _assert_same_ckpt(da, db)


def test_serve_chaos_run_matches_reference(tmp_path):
    """The chaos run under ``FaultSchedule(11, rate=0.08)``: both packages
    arm the same points in the same order, so the schedule fires the same
    faults, and both recover them the same way into the same state."""
    da, db = str(tmp_path / "port"), str(tmp_path / "ref")
    with flt.injecting_faults(flt.FaultSchedule(11, rate=0.08)) as plane:
        engine = _port(ticks=8, checkpoint_dir=da, checkpoint_every=2,
                       retries=8)
    with jflt.injecting_faults(jflt.FaultSchedule(11, rate=0.08)) as jplane:
        _ref(ticks=8, checkpoint_dir=db, checkpoint_every=2, retries=8)
    assert engine is not None
    assert sum(plane.injected.values()) > 0      # chaos actually happened
    assert sum(plane.recoveries.values()) > 0    # ...and was recovered
    assert dict(plane.injected) == dict(jplane.injected)
    assert dict(plane.recoveries) == dict(jplane.recoveries)
    assert dict(plane.armings) == dict(jplane.armings)
    assert ckpt_lib.latest_step(da) == 8         # final checkpoint
    _assert_same_ckpt(da, db)


def test_serve_sigterm_drains_cleanly(tmp_path):
    """SIGTERM mid-feed: the loop breaks at a tick boundary, writes a
    final checkpoint, stops the metrics daemon thread, and returns."""
    d = str(tmp_path / "ck")

    def _kill_once_checkpointed():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if ckpt_lib.latest_step(d) is not None:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    killer = threading.Thread(target=_kill_once_checkpointed, daemon=True)
    killer.start()
    engine = _port(ticks=10_000, checkpoint_dir=d, checkpoint_every=2,
                   metrics_port=0)
    killer.join(timeout=60)
    assert engine is not None                    # clean return, no raise
    last = ckpt_lib.latest_step(d)
    assert last is not None and last < 10_000    # drained early
    _, _, meta = ckpt_lib.load_flat(d)           # final ckpt is loadable
    assert meta["feed"]["tick"] == last
    assert not any(t.name == "repro-metrics"     # daemon stopped
                   for t in threading.enumerate())


def _cli(d, ticks):
    return [sys.executable, "-m", "repro_torch.launch.serve", "--app",
            "trim-stream", "--graph", "chain", "--ticks", str(ticks),
            "--update-batch", "32", "--checkpoint-dir", d,
            "--checkpoint-every", "2", "--device", CPU]


@pytest.mark.slow
def test_serve_sigkill_subprocess_resumes_bit_identical(tmp_path):
    """SIGKILL the serve process after its first checkpoint, restart it
    with the same ``--checkpoint-dir``: the resumed process's final
    checkpoint equals an uninterrupted process's."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..",
                                     "src")
    env["OMP_NUM_THREADS"] = "1"
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    subprocess.run(_cli(da, 8), env=env, check=True, timeout=300,
                   capture_output=True)
    proc = subprocess.Popen(_cli(db, 8), env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            step = ckpt_lib.latest_step(db)
            if step is not None and 0 < step < 8:
                break
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        proc.kill()                              # SIGKILL: no cleanup
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert ckpt_lib.latest_step(db) is not None, "no checkpoint before kill"
    subprocess.run(_cli(db, 8), env=env, check=True, timeout=300,
                   capture_output=True)
    ta, sa, ma = ckpt_lib.load_flat(da)
    tb, sb, mb = ckpt_lib.load_flat(db)
    assert sa == sb == 8
    for key in ("status", "counters", "feed_alive"):
        assert np.array_equal(ta[key], tb[key]), key
    assert ma["feed"]["rng_state"] == mb["feed"]["rng_state"]


# -- the command line, the metrics, the workload table --------------------------


def test_cli_runs_on_the_cpu(capsys):
    engine = serve.main(["--app", "trim-stream", "--graph", "chain",
                         "--ticks", "4", "--device", CPU])
    line = LINE.search(capsys.readouterr().out)
    assert line and line.group(1) == "chain" and line.group(4) == "4"
    assert engine.delta.n == 2_000
    with pytest.raises(SystemExit):              # the reference's choices
        serve.main(["--app", "trim-stream", "--graph", "RMAT22",
                    "--device", CPU])


def test_metrics_snapshot_holds_reference_families(tmp_path, capsys):
    mp, mr = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    scraped = {}

    def scrape(port_of):
        """Once a tick is done (or during the hold after the feed), fetch
        ``/healthz`` and ``/metrics``."""
        deadline = time.monotonic() + 60
        port = None
        while time.monotonic() < deadline and "metrics" not in scraped:
            port = port or port_of()
            if port:
                base = f"http://127.0.0.1:{port}"
                try:
                    health = json.loads(urllib.request.urlopen(
                        f"{base}/healthz").read())
                    if health["ticks_done"] >= 1:
                        scraped["healthz"] = health
                        scraped["metrics"] = urllib.request.urlopen(
                            f"{base}/metrics").read().decode()
                except OSError:
                    pass
            time.sleep(0.02)

    def port_of():
        m = re.search(r"127\.0\.0\.1:(\d+)/metrics", capsys.readouterr().out)
        return int(m.group(1)) if m else None

    scraper = threading.Thread(target=scrape, args=(port_of,), daemon=True)
    scraper.start()
    _port("RMAT", ticks=6, metrics_port=0, metrics_json=mp,
          metrics_hold=2.0)
    scraper.join(timeout=60)
    _ref("RMAT", ticks=6, metrics_port=0, metrics_json=mr)
    got, want = json.loads(open(mp).read()), json.loads(open(mr).read())
    names = set(got["families"])
    want_names = {RENAMED.get(n, n) for n in want["families"]}
    # a CPU run builds no kernel library, so the port has no build counts
    assert want_names - names == {"repro_kernel_builds", "repro_plan_builds"}
    assert "repro_serve_updates" in names and "repro_slo_p99_seconds" in names

    def updates(doc):
        return doc["families"]["repro_serve_updates"]["children"]

    assert updates(got) == updates(want) == [
        {"labels": {"graph": "RMAT"}, "value": 6 * 32 + 3 * 32}]
    assert "repro_serve_updates" in scraped.get("metrics", "")
    assert scraped["healthz"]["graph"] == "RMAT"


def test_trim_graphs_match_reference():
    assert ({k: dataclasses.asdict(w) for k, w in trim_graphs.WORKLOADS.items()}
            == {k: dataclasses.asdict(w)
                for k, w in jtrim_graphs.WORKLOADS.items()})
    assert trim_graphs.DISTRIBUTED_TRIM == jtrim_graphs.DISTRIBUTED_TRIM
    assert serve._STREAM_GRAPHS == jserve._STREAM_GRAPHS
