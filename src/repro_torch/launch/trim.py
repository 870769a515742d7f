"""The port's command line: trimming, SCC decomposition, incremental
trimming and k-core peeling on one named graph (PyTorch port of
``src/repro/launch/trim.py``)::

    python -m repro_torch.launch.trim --graph BA --method ac6
    python -m repro_torch.launch.trim --graph BA --backend windowed
    python -m repro_torch.launch.trim --app scc --graph BA
    python -m repro_torch.launch.trim --app stream --graph BA
    python -m repro_torch.launch.trim --app peel --graph BA
    python -m repro_torch.launch.trim --app stream --graph chain --device cpu
    python -m repro_torch.launch.trim --app check --strict

``--graph`` names one of ``graphs.BENCHMARK_GRAPHS``.  Everything runs on
``--device`` (default ``cuda``; a missing card raises).  Each app plans
its engine once and runs it twice: ``first`` includes the one-time set-up
(row ids, tiles, the kernels' build), ``steady`` is a warm run.  ``--app check`` runs the static-analysis
plane instead (``repro_torch.analysis.check``; ``--strict``,
``--mutants``, and ``--metrics-json PATH`` for the findings JSON): no
graph, no engine, nothing on the card.

Not ported yet, and raising :class:`NotImplementedError` that names the
ROADMAP item: ``--dryrun`` (A11), ``--backend sharded`` (A6),
``--metrics-json`` outside ``--app check`` (A7), ``--checkpoint-dir``,
``--checkpoint-every``, ``--fault-seed``, ``--fault-rate`` and
``--retries`` (A8).
"""
from __future__ import annotations

import argparse
import time


def _sync(device) -> None:
    """Wait for the card, so a host clock times the work and not its
    enqueueing."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_local(graph_name: str, method: str, workers: int,
              backend: str = "dense", device="cuda"):
    from ..core.engine import plan
    from ..graphs import make
    g = make(graph_name, device=device)
    # this entry point never passes active masks
    engine = plan(g, method=method, backend=backend, workers=workers,
                  unmasked=True, device=device)
    t0 = time.time()
    res = engine.run().materialize()
    t_first = time.time() - t0
    t0 = time.time()
    res = engine.run().materialize()
    t_steady = time.time() - t0
    print(f"[trim] {graph_name} n={g.n} m={g.m} method={method} "
          f"backend={backend}: trimmed {res.n_trimmed} "
          f"({res.trimmed_fraction*100:.1f}%) rounds={res.rounds} "
          f"edges={res.edges_traversed} max|Qp|={res.max_frontier} | "
          f"first={t_first:.2f}s steady={t_steady*1e3:.1f}ms "
          f"traces={engine.traces}")
    return res


def run_scc(graph_name: str, method: str, backend: str = "dense",
            reach_backend: str = "windowed", device="cuda"):
    """FW-BW SCC decomposition with trim-2: per worklist generation one
    batched trim dispatch, one trim-2 dispatch and two batched reach
    dispatches; labels reach the host once."""
    import numpy as np

    from ..core.scc import scc_decompose
    from ..graphs import make
    g = make(graph_name, device=device)
    times = []
    for _ in range(2):
        t0 = time.time()
        labels, stats = scc_decompose(g, trim_method=method,
                                      trim_backend=backend,
                                      reach_backend=reach_backend,
                                      device=device)
        times.append(time.time() - t0)
    t_first, t_steady = times
    print(f"[scc] {graph_name} n={g.n} m={g.m} trim={method}/{backend} "
          f"reach={reach_backend}: {len(np.unique(labels)):,} SCCs, "
          f"generations={stats['generations']} pivots={stats['pivots']} "
          f"trimmed={stats['trimmed_total']:,} "
          f"dispatches={stats['trim_dispatches']}+{stats['reach_dispatches']}"
          f" | first={t_first:.2f}s steady={t_steady*1e3:.1f}ms")
    return labels, stats


def run_stream(graph_name: str, batches: int = 3, batch_frac: float = 0.001,
               seed: int = 0, device="cuda"):
    """Incremental trimming under a synthetic deletion feed: ``apply()``
    absorbs each batch through the counter_scatter kernel and a
    delta-seeded fixpoint; ``retrim(full=True)`` is the from-scratch
    baseline on the same overlay."""
    import numpy as np

    from ..core.stream import plan_stream
    from ..graphs import make
    g = make(graph_name, device=device)
    engine = plan_stream(g)
    rng = np.random.default_rng(seed)
    src, dst = engine.delta._src_np, engine.delta._dst_np
    k = max(1, int(g.m * batch_frac))
    alive = np.ones(g.m, bool)
    t_incr, t_full = [], []
    for _ in range(batches):
        ids = rng.choice(np.nonzero(alive)[0], k, replace=False)
        alive[ids] = False
        t0 = time.time()
        engine.apply(deletions=(src[ids], dst[ids]))
        _sync(device)
        t_incr.append(time.time() - t0)
        t0 = time.time()
        engine.retrim(full=True)
        _sync(device)
        t_full.append(time.time() - t0)
    inc, full = np.median(t_incr[1:] or t_incr), np.median(t_full[1:] or t_full)
    res = engine.retrim()
    print(f"[stream] {graph_name} n={g.n} m={g.m}: {batches} batches of "
          f"{k} deletions | incremental {inc*1e3:.1f}ms vs from-scratch "
          f"{full*1e3:.1f}ms ({full/max(inc, 1e-9):.1f}x) | trimmed "
          f"{res.n_trimmed} ({res.trimmed_fraction*100:.1f}%)")
    return engine


def run_peel(graph_name: str, device="cuda"):
    """Full out-degree coreness in one dispatch on the peel engine, plus
    the k = 1 == AC-4 cross-check."""
    import numpy as np

    from ..core.engine import plan
    from ..core.peel import plan_peel
    from ..graphs import make
    g = make(graph_name, device=device)
    engine = plan_peel(g, device=device)
    t0 = time.time()
    res = engine.run().materialize()
    t_first = time.time() - t0
    t0 = time.time()
    res = engine.run().materialize()
    t_steady = time.time() - t0
    core = res.coreness
    hist = np.bincount(core, minlength=res.max_core + 1)
    top = ", ".join(f"k={k}:{hist[k]:,}"
                    for k in range(min(res.max_core, 4) + 1))
    if res.max_core > 4:
        top += f", ..., k={res.max_core}:{hist[res.max_core]:,}"
    ac4 = plan(g, method="ac4", device=device).run().status.cpu().numpy()
    if not np.array_equal(res.status, ac4):
        raise AssertionError("peel(1) != AC-4")
    print(f"[peel] {graph_name} n={g.n} m={g.m}: max coreness "
          f"{res.max_core}, 1-core {int((core >= 1).sum()):,} "
          f"({(core >= 1).mean()*100:.1f}%) [{top}] rounds={res.rounds} "
          f"| k=1 mask == AC-4 | first={t_first:.2f}s "
          f"steady={t_steady*1e3:.1f}ms traces={engine.traces}")
    return res


def _refuse_unported(args) -> None:
    """Raise for the reference's flags that the port does not have yet,
    naming the ROADMAP item that brings each."""
    for given, flag, item in (
            (args.dryrun, "--dryrun", "A11"),
            (args.backend == "sharded", "--backend sharded", "A6"),
            (args.metrics_json is not None, "--metrics-json", "A7"),
            (args.checkpoint_dir is not None, "--checkpoint-dir", "A8"),
            (args.checkpoint_every is not None, "--checkpoint-every", "A8"),
            (args.fault_seed is not None, "--fault-seed", "A8"),
            (args.fault_rate is not None, "--fault-rate", "A8"),
            (args.retries is not None, "--retries", "A8")):
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP {item}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", default="BA")
    ap.add_argument("--method", default="ac6")
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--backend", default="dense",
                    choices=("dense", "windowed", "sharded"))
    ap.add_argument("--app", default="trim",
                    choices=("trim", "scc", "stream", "peel", "check"))
    ap.add_argument("--reach-backend", default="windowed",
                    choices=("dense", "windowed"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    ap.add_argument("--strict", action="store_true",
                    help="--app check: fail on warnings as well as errors")
    ap.add_argument("--mutants", action="store_true",
                    help="--app check: run the mutation corpus")
    ap.add_argument("--metrics-json", metavar="PATH",
                    help="--app check: write the findings JSON to PATH")
    # the reference's flags whose planes are not ported yet: each raises
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--checkpoint-dir", metavar="DIR")
    ap.add_argument("--checkpoint-every", type=int, metavar="GENS")
    ap.add_argument("--fault-seed", type=int, metavar="SEED")
    ap.add_argument("--fault-rate", type=float)
    ap.add_argument("--retries", type=int)
    args = ap.parse_args(argv)
    if args.app == "check":
        # the static-analysis plane: no graph, no engine, no device work
        if any(v is not None for v in (
                args.fault_seed, args.fault_rate, args.retries,
                args.checkpoint_dir, args.checkpoint_every)):
            ap.error("--app check is static analysis; fault injection and "
                     "checkpoints don't apply")
        from ..analysis.check import main as check_main
        argv = ["--strict"] * args.strict + ["--mutants"] * args.mutants
        if args.metrics_json:
            argv += ["--json", args.metrics_json]
        return check_main(argv)
    if args.strict or args.mutants:
        ap.error("--strict/--mutants apply to --app check")
    _refuse_unported(args)
    if args.app == "scc":
        return run_scc(args.graph, args.method, args.backend,
                       args.reach_backend, device=args.device)
    if args.app == "stream":
        return run_stream(args.graph, device=args.device)
    if args.app == "peel":
        return run_peel(args.graph, device=args.device)
    return run_local(args.graph, args.method, args.workers, args.backend,
                     device=args.device)


if __name__ == "__main__":
    out = main()
    raise SystemExit(out if isinstance(out, int) else 0)
