"""The port's command line: trimming, SCC decomposition, incremental
trimming and k-core peeling on one named graph (PyTorch port of
``src/repro/launch/trim.py``)::

    python -m repro_torch.launch.trim --graph BA --method ac6
    python -m repro_torch.launch.trim --graph BA --backend windowed
    python -m repro_torch.launch.trim --graph BA --backend sharded
    torchrun --nproc-per-node 4 -m repro_torch.launch.trim --backend sharded
    python -m repro_torch.launch.trim --app scc --graph BA
    python -m repro_torch.launch.trim --app stream --graph BA
    python -m repro_torch.launch.trim --app peel --graph BA
    python -m repro_torch.launch.trim --app stream --graph chain --device cpu
    python -m repro_torch.launch.trim --app check --strict
    python -m repro_torch.launch.trim --dryrun --method ac6
    python -m repro_torch.launch.trim --dryrun --backend sharded
    python -m repro_torch.launch.trim --app scc --graph RMAT \
        --checkpoint-dir ckpt --fault-seed 7 --fault-rate 0.05 --retries 5

``--graph`` names one of ``graphs.BENCHMARK_GRAPHS``.  Everything runs on
``--device`` (default ``cuda``; a missing card raises).  Each app plans
its engine once and runs it twice: ``first`` includes the one-time set-up
(row ids, tiles, the kernels' build), ``steady`` is a warm run.
``--metrics-json PATH`` runs the app under an enabled MetricsPlane with
instrumented engines and writes the plane's snapshot to PATH
(``obs.load_snapshot`` reads it back): dispatches, fixpoint rounds and
work, live bytes per engine, the kernels' calls and cost, and the card's
allocator bytes.  ``--app check`` runs the static-analysis plane instead
(``repro_torch.analysis.check``; ``--strict``, ``--mutants``, and
``--metrics-json PATH`` for the findings JSON): no graph, no engine,
nothing on the card.

``--fault-seed SEED`` installs a FaultPlane with a seeded
``FaultSchedule`` firing at ``--fault-rate`` an arming, for any app.
``--app scc --checkpoint-dir DIR`` saves the SCC driver's generation
state every ``--checkpoint-every`` generations through an async writer,
and on a ``DeviceFault`` or ``IOFault`` resumes from the latest saved
generation, at most ``--retries`` times.

``--backend sharded`` runs one rank a process (``core.distributed``):
under ``torchrun`` each process is a rank of its ``env://`` group, and a
plain ``python -m`` is a world of one rank over a ``FileStore`` in a
temporary directory, with no network.  NCCL on a card, gloo with
``--device cpu``; rank 0 prints the reference's line.  ``--app scc``
refuses it, as the reference does.

``--dryrun`` sizes the reference's production graph (n = 64,000,000,
m = 512,000,000) for one card, with no graph and no card
(:func:`run_dryrun`): the bytes of every buffer the engine holds and of
the fixpoint's working set (:func:`trim_footprint`), against the card's
memory.  With ``--backend sharded`` it is the twin of the reference's
512-chip dry-run: one rank of 512 runs its AC-3 or AC-6 body on the
meta device (:func:`rank_dryrun`) and the per-rank argument and
temporary bytes, the all-gather sites a round and the status all-gather
bytes a round are reported.
"""
from __future__ import annotations

import argparse
import time


#: the reference's defaults of --checkpoint-every, --fault-rate, --retries
FAULT_DEFAULTS = {"checkpoint_every": 5, "fault_rate": 0.05, "retries": 3}


def _sync(device) -> None:
    """Wait for the card, so a host clock times the work and not its
    enqueueing."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_local(graph_name: str, method: str, workers: int,
              backend: str = "dense", device="cuda", instrument=False):
    """Plan once, run twice (first and steady), print the reference's
    line; on the sharded backend every rank runs and rank 0 prints."""
    from ..core.engine import plan
    from ..graphs import make
    # a sharded engine keeps the graph on the host
    g = make(graph_name, device="cpu" if backend == "sharded" else device)
    # this entry point never passes active masks (sharded AC-4 needs that)
    engine = plan(g, method=method, backend=backend, workers=workers,
                  unmasked=True, instrument=instrument, device=device)
    t0 = time.time()
    res = engine.run().materialize()
    t_first = time.time() - t0
    t0 = time.time()
    res = engine.run().materialize()
    t_steady = time.time() - t0
    if backend == "sharded":
        import torch.distributed as tdist
        if tdist.get_rank() != 0:
            return res
    print(f"[trim] {graph_name} n={g.n} m={g.m} method={method} "
          f"backend={backend}: trimmed {res.n_trimmed} "
          f"({res.trimmed_fraction*100:.1f}%) rounds={res.rounds} "
          f"edges={res.edges_traversed} max|Qp|={res.max_frontier} | "
          f"first={t_first:.2f}s steady={t_steady*1e3:.1f}ms "
          f"traces={engine.traces}")
    return res


def run_sharded(graph_name: str, method: str, workers: int, device="cuda",
                instrument=False):
    """:func:`run_local` on the sharded backend, as one rank of the
    default group (``core.distributed.process_group``: torchrun's, else a
    world of one)."""
    from ..core.distributed import process_group
    with process_group(device) as dev:
        return run_local(graph_name, method, workers, "sharded",
                         device=dev, instrument=instrument)


def _scc_resuming(g, checkpoint_dir: str, retries: int, **kw):
    """``scc_decompose`` with generation checkpoints through an async
    writer; a ``DeviceFault`` or ``IOFault`` is retried with backoff, each
    retry resuming from the latest saved generation, at most ``retries``
    times (the reference's loop)."""
    from .. import fault as flt
    from ..core.scc import scc_decompose
    from ..train.checkpoint import AsyncCheckpointer
    checkpointer = AsyncCheckpointer(checkpoint_dir)
    try:
        att = 0
        while True:
            try:
                return scc_decompose(g, checkpoint_dir=checkpoint_dir,
                                     checkpointer=checkpointer,
                                     resume=att > 0, **kw)
            except (flt.DeviceFault, flt.IOFault) as e:
                att += 1
                if att > retries:
                    raise
                time.sleep(flt.backoff_delay(att - 1))
                try:
                    checkpointer.wait()
                except OSError:
                    pass
                flt.get_fault_plane().record_recovery(
                    getattr(e, "point", "unknown"), "restore")
                print(f"[scc] fault at {getattr(e, 'point', 'unknown')!r}:"
                      f" resuming from latest checkpoint (attempt {att})")
    finally:
        try:
            checkpointer.close()
        except OSError as e:
            print(f"[scc] checkpoint writer error at close: {e}")


def run_scc(graph_name: str, method: str, backend: str = "dense",
            reach_backend: str = "windowed", device="cuda", instrument=False,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            retries: int = 3):
    """FW-BW SCC decomposition with trim-2: per worklist generation one
    batched trim dispatch, one trim-2 dispatch and two batched reach
    dispatches; labels reach the host once.  With ``checkpoint_dir`` it
    runs once, checkpointing and resuming across faults
    (:func:`_scc_resuming`); otherwise twice (first and steady)."""
    import numpy as np

    from ..core.scc import scc_decompose
    from ..graphs import make
    g = make(graph_name, device=device)
    kw = dict(trim_method=method, trim_backend=backend,
              reach_backend=reach_backend, instrument=instrument,
              device=device)
    if checkpoint_dir is not None:
        t0 = time.time()
        labels, stats = _scc_resuming(g, checkpoint_dir, retries,
                                      checkpoint_every=checkpoint_every,
                                      **kw)
        t_first = t_steady = time.time() - t0
    else:
        times = []
        for _ in range(2):
            t0 = time.time()
            labels, stats = scc_decompose(g, **kw)
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
               seed: int = 0, device="cuda", instrument=False):
    """Incremental trimming under a synthetic deletion feed: ``apply()``
    absorbs each batch through the counter_scatter kernel and a
    delta-seeded fixpoint; ``retrim(full=True)`` is the from-scratch
    baseline on the same overlay."""
    import numpy as np

    from ..core.stream import plan_stream
    from ..graphs import make
    g = make(graph_name, device=device)
    engine = plan_stream(g, instrument=instrument)
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


def run_peel(graph_name: str, device="cuda", instrument=False):
    """Full out-degree coreness in one dispatch on the peel engine, plus
    the k = 1 == AC-4 cross-check."""
    import numpy as np

    from ..core.engine import plan
    from ..core.peel import plan_peel
    from ..graphs import make
    g = make(graph_name, device=device)
    engine = plan_peel(g, instrument=instrument, device=device)
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


#: the reference's production graph (``src/repro/launch/trim.py``)
DRYRUN_GRAPH = dict(n=64_000_000, m=512_000_000)


#: ranks of the reference's production mesh (2 pods x 16 x 16 chips)
DRYRUN_RANKS = 512


def trim_footprint(n: int, m: int, method: str = "ac6",
                   backend: str = "dense", workers: int = 16,
                   transpose: bool | None = None, ranks: int = 1) -> dict:
    """The bytes a trim engine over a graph of ``n`` vertices and ``m``
    edges allocates, from the sizes alone: ``{"held": ..., "run": ...}``.

    ``held`` is what the engine keeps between runs, component for
    component what ``obs.memory.engine_nbytes`` reports after a run: the
    CSR (int32 indptr and indices), Gᵀ when the method needs it or the
    caller passes one (``transpose``), Gᵀ's int32 row ids (the methods
    that need Gᵀ) and the int32 worker map.  ``run`` is the peak of what
    one run allocates on top of ``held``, counted off the live tensors
    at the op where the run peaks.  AC-4 and AC-4* peak while the masked
    degree count builds G's row ids (``core.graph.row_ids``): 12 bytes an
    edge (``repeat_interleave``'s int64 gather indices and the int32 ids)
    and 25 a vertex (the degrees, int32 and int64, the all-live mask and
    the scan).  AC-3 and AC-6 peak inside a probe round: 56 and 74 bytes a
    vertex of status, pointer, support and probe vectors, AC-6's chunk
    mask of n/64 and the per-worker counters; the windowed probe adds 17
    a vertex.  On an H100
    the caching allocator's peak over a run, less what was allocated
    before it, equalled these counts to 4 bytes a vertex at RMAT scales
    18 and 20; ``chip_smoke.py`` phase 3 holds them at scale 22.
    ``frontier`` is the engines' default "auto" plan
    (``core.common.frontier_plan``).

    ``backend="sharded"`` sizes one rank of ``ranks``, as the sharded
    engine allocates it.  ``held`` is the rank's block on the device
    (``shard_operands``: the int32 indptr of its ``nl`` rows, the
    32-aligned ``ceil(n / ranks)``, its edge slots, and AC-4's int32
    counters); ``host`` is the CSR, and Gᵀ for AC-4, which the engine
    keeps on the host (``held`` and ``host`` together are
    ``engine_nbytes``).  The edge slots are the largest block's edges,
    taken as ``min(m, 2 * ceil(m / ranks))`` (the reference dry-run's
    twice-balanced assumption, and exact at one rank).  ``run`` is the
    active block a run makes (AC-3/AC-6) and the peak of the rank's body
    above its arguments, from running it on the meta device
    (:func:`rank_dryrun`, whose dict is under ``"rank"``)."""
    from ..core.common import frontier_plan
    from ..core.registry import get_kernel
    spec = get_kernel(method)
    csr = 4 * (n + 1) + 4 * m
    held = {"graph": csr}
    if transpose is None:
        transpose = spec.needs_transpose
    if transpose:
        held["transpose"] = csr
    if backend == "sharded":
        return _sharded_footprint(n, m, method, ranks, held)
    if n and m:
        if spec.needs_transpose:
            held["row_ids"] = 4 * m
        held["worker_ids"] = 4 * n
    fplan = frontier_plan("auto" if spec.supports_frontier else "dense",
                          n, m)
    if spec.needs_transpose:
        run = {"row_ids_build": 12 * m, "vectors": 25 * n}
    else:
        run = {"vectors": (56 if method == "ac3" else 74) * n,
               "per_worker": 4 * workers}
        if method != "ac3":
            run["chunk_mask"] = -(-n // 64)
        if backend == "windowed":
            run["windowed_probe"] = 17 * n
    return {"held": held, "run": run, "frontier": fplan}


def _sharded_footprint(n: int, m: int, method: str, ranks: int,
                       host: dict) -> dict:
    """:func:`trim_footprint`'s sharded case; ``host`` is the CSR (and
    Gᵀ) the rank keeps on the host."""
    from ..core.common import frontier_plan
    from ..core.distributed import block_rows
    nl = block_rows(n, ranks)
    slots = min(m, 2 * -(-m // ranks))
    fp = {"held": {}, "host": host, "run": {},
          "frontier": frontier_plan("dense", n, m)}
    if n and m:
        ac4 = method.startswith("ac4")
        fp["held"]["shard_operands"] = (4 * (nl + 1) + 4 * slots
                                        + (4 * nl if ac4 else 0))
        fp["rank"] = rank_dryrun(method, nl, slots, ranks)
        if not ac4:
            fp["run"]["active_block"] = nl
        fp["run"]["rank_body"] = fp["rank"]["temps"]
    return fp


def rank_dryrun(method: str, rows: int, slots: int, ranks: int) -> dict:
    """One rank's sharded body on the meta device (``core.distributed``'s
    ``run_rank`` through a ``MetaComm`` of ``ranks``, each probe loop one
    micro-step), metered by ``lowering.meter`` for one round and for two:
    the rank's ``rows`` and edge ``slots`` (AC-4: of Gᵀ).  Returns the
    argument bytes, the temporaries (the peak of a one-round run above
    the arguments), and each collective's calls and bytes a round (two
    rounds less one) and in the one-round run."""
    import torch

    from ..core import distributed as dist
    from ..core.registry import get_kernel
    from .lowering import meter
    kind = get_kernel(method).sharded_method

    def run(extra_rounds: int):
        meta = dict(device="meta")
        i32 = dict(dtype=torch.int32, **meta)
        if kind == "ac4":
            ops = (torch.empty(rows + 1, **i32), torch.empty(slots, **i32),
                   torch.empty(rows, **i32))
            go = (True,) * (1 + extra_rounds)      # the loop's entry test
        else:
            ops = (torch.empty(rows + 1, **i32), torch.empty(slots, **i32),
                   torch.empty(rows, dtype=torch.bool, **meta))
            go = (True,) * extra_rounds
        comm = dist.MetaComm(ranks, go=go)
        with dist.MetaScalars():
            _, cost = meter(dist.run_rank, kind, comm, ops)
        return cost, comm.counts()

    one, c1 = run(0)
    _, c2 = run(1)
    return {"args": one.argument_bytes,
            "temps": one.peak_bytes - one.argument_bytes,
            "per_round": {op: (c2[op][0] - c1[op][0], c2[op][1] - c1[op][1])
                          for op in c1},
            "one_round_run": c1, "seconds": one.seconds}


def _dryrun_sharded(method: str, n: int, m: int, ranks: int) -> dict:
    """The reference's ``run_dryrun``: one rank of ``ranks``, sized by
    :func:`trim_footprint` as the sharded engine allocates it."""
    from ..core.distributed import block_rows
    from .mesh import hbm_bytes
    fp = trim_footprint(n, m, method, "sharded", ranks=ranks)
    rd = fp["rank"]
    sites, gbytes = rd["per_round"]["all_gather"]
    held, run = sum(fp["held"].values()), sum(fp["run"].values())
    card = hbm_bytes()
    fits = "fits" if held + run <= card else "does not fit"
    print(f"[trim-dryrun] {method}/sharded on {ranks} ranks (one H100 "
          f"each, NCCL): one rank's body on the meta device in "
          f"{rd['seconds']:.2f}s; per-rank args {rd['args'] / 2**20:.1f} "
          f"MiB, temps {rd['temps'] / 2**20:.1f} MiB, all-gather sites "
          f"{sites} a round; {fits} in {card / 2**30:.1f} GiB (the CSR, "
          f"{sum(fp['host'].values()) / 2**20:.1f} MiB, stays on the host)")
    print(f"  graph: n={n:,} m={m:,} -> {block_rows(n, ranks):,} "
          f"vertices/rank; status all_gather {gbytes / 2**20:.1f} MiB per "
          f"round ({gbytes / 8 / 2**20:.1f} MiB packed)")
    return dict(fp, args=rd["args"], temps=rd["temps"],
                gather_sites_per_round=sites,
                gather_bytes_per_round=gbytes, ranks=ranks)


def run_dryrun(method: str, backend: str = "dense", workers: int = 16, *,
               n: int = DRYRUN_GRAPH["n"], m: int = DRYRUN_GRAPH["m"]):
    """Size trimming of an ``n``-vertex, ``m``-edge graph for one card
    and print the reference's two lines for it; returns
    :func:`trim_footprint`'s dict.  ``backend="sharded"`` sizes one rank
    of :data:`DRYRUN_RANKS` instead (AC-3 or AC-6, as the reference's)."""
    if backend == "sharded":
        if method not in ("ac3", "ac6"):
            raise ValueError(f"the sharded dry-run sizes ac3 or ac6, as the "
                             f"reference's does; got {method!r}")
        return _dryrun_sharded(method, n, m, DRYRUN_RANKS)
    from .mesh import hbm_bytes
    fp = trim_footprint(n, m, method, backend, workers=workers)
    held, temps = sum(fp["held"].values()), sum(fp["run"].values())
    fplan, card = fp["frontier"], hbm_bytes()
    fits = "fits" if held + temps <= card else "does not fit"
    print(f"[trim-dryrun] {method}/{backend} on one H100 (frontier "
          f"{fplan.mode}: cap={fplan.cap} ecap={fplan.ecap}): per-device "
          f"args {held / 2**20:.1f} MiB, temps {temps / 2**20:.1f} MiB, "
          f"all-gather sites 0; {fits} in {card / 2**30:.1f} GiB")
    print(f"  graph: n={n:,} m={m:,} -> {n:,} vertices/device; status "
          f"all_gather {n / 8 / 2**20:.1f} MiB per round once sharded "
          f"(--backend sharded)")
    return fp


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
                    help="write the MetricsPlane snapshot of the run to "
                         "PATH (--app check: the findings JSON)")
    ap.add_argument("--checkpoint-dir", metavar="DIR",
                    help="checkpoint the SCC driver's generation state "
                         "here and resume across faults (--app scc)")
    # the next three default to None so that --app check can tell them
    # given; FAULT_DEFAULTS holds the reference's defaults
    ap.add_argument("--checkpoint-every", type=int, metavar="GENS",
                    help="generations between driver checkpoints (with "
                         "--checkpoint-dir; default 5)")
    ap.add_argument("--fault-seed", type=int, default=None, metavar="SEED",
                    help="install a deterministic FaultSchedule with this "
                         "seed (chaos testing; off by default)")
    ap.add_argument("--fault-rate", type=float,
                    help="per-arming fault probability for --fault-seed "
                         "(default 0.05)")
    ap.add_argument("--retries", type=int,
                    help="bound on resume-from-checkpoint attempts "
                         "(default 3)")
    ap.add_argument("--dryrun", action="store_true",
                    help="size the production graph for one card, or one "
                         "of 512 ranks with --backend sharded (no graph, "
                         "no card)")
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
    if args.app == "scc" and args.backend == "sharded":
        ap.error("--app scc needs a batchable trim backend "
                 "(--backend dense or windowed); shard at the region level")
    if args.checkpoint_dir and args.app != "scc":
        ap.error("--checkpoint-dir applies to --app scc")
    if args.dryrun:
        return run_dryrun(args.method, args.backend, args.workers)
    for name, default in FAULT_DEFAULTS.items():
        if getattr(args, name) is None:
            setattr(args, name, default)
    import contextlib

    from .. import obs
    kw = dict(device=args.device, instrument=args.metrics_json is not None)
    if args.fault_seed is not None:
        from .. import fault as flt
        fault_scope = flt.injecting_faults(
            flt.FaultSchedule(args.fault_seed, rate=args.fault_rate))
    else:
        fault_scope = contextlib.nullcontext(None)
    scope = (obs.collecting_metrics() if args.metrics_json
             else contextlib.nullcontext(None))
    with fault_scope, scope as plane:
        if args.app == "scc":
            out = run_scc(args.graph, args.method, args.backend,
                          args.reach_backend,
                          checkpoint_dir=args.checkpoint_dir,
                          checkpoint_every=args.checkpoint_every,
                          retries=args.retries, **kw)
        elif args.app == "stream":
            out = run_stream(args.graph, **kw)
        elif args.app == "peel":
            out = run_peel(args.graph, **kw)
        elif args.backend == "sharded":
            out = run_sharded(args.graph, args.method, args.workers, **kw)
        else:
            out = run_local(args.graph, args.method, args.workers,
                            args.backend, **kw)
        if plane is not None:
            obs.publish_device_memory(plane)
    if plane is not None:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(plane.snapshot(), f, indent=1)
        print(f"[trim] metrics snapshot: {args.metrics_json} "
              f"({len(plane.families)} families)")
    return out


if __name__ == "__main__":
    out = main()
    raise SystemExit(out if isinstance(out, int) else 0)
