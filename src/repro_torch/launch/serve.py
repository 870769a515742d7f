"""Serving launcher of the port (PyTorch port of
``src/repro/launch/serve.py``): batched prefill + greedy KV-cache decode
for the dense LM architectures, batched scoring for wide-deep, and the
trim-stream server, long-lived incremental graph trimming over a
synthetic edge-update feed::

    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-1.7b          # the card
    python -m repro_torch.launch.serve --arch wide-deep --smoke --device cpu
    python -m repro_torch.launch.serve --app trim-stream --graph ER \
        --device cpu

``--smoke`` serves the reduced configuration; without it the published
one, on ``--device`` (default ``cuda``; a missing card raises), where
the reference refuses for want of a TPU.  Weights are random, drawn from
seed 0 by a ``torch.Generator`` on the device; LM prompts (32 tokens) and
wide-deep requests are ``numpy.random.default_rng(0)`` draws, as in the
reference.  The prefill's attention runs the flash kernel
(``kernels.ops.flash_attention``); decode attends over the preallocated
cache with plain einsums.  ``--app trim-stream`` takes every flag of the
reference's (:func:`serve_trim_stream`) and ``--device``.

Not ported yet, and raising :class:`NotImplementedError` that names the
ROADMAP item: the MoE LMs (A11).  A GNN id exits, as in the reference:
serving applies to the lm and recsys families.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from .. import configs
from ..models.recsys import WideDeep
from ..models.transformer import LM


def _sync(device) -> None:
    """Wait for the card, so a host clock times the work and not its
    enqueueing."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(lm: LM, prompts, gen_len: int):
    """Prefill ``prompts`` (B, P) into a cache preallocated to P + gen_len,
    then ``gen_len`` greedy decode steps.  Returns ``(tokens (B, gen_len +
    1) int64 on the device, stats)``: the prefill's argmax and one token a
    step; ``stats`` holds ``prefill_ms`` (the prefill and its argmax) and
    ``decode_ms`` (one entry a step), each a synchronised host clock."""
    dev = lm.device
    prompt_len = prompts.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(prompts, cache_len=prompt_len + gen_len)
    tok = logits.argmax(-1, keepdim=True)
    _sync(dev)
    stats = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "decode_ms": []}
    out = [tok]
    for i in range(gen_len):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(cache, tok, prompt_len + i)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
        _sync(dev)
        stats["decode_ms"].append((time.perf_counter() - t0) * 1e3)
    return torch.cat(out, dim=1), stats


def serve_lm(arch_id: str, batch: int = 4, prompt_len: int = 32,
             gen_len: int = 16, seed: int = 0, *, smoke: bool = True,
             device="cuda", lm: LM | None = None,
             return_stats: bool = False):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and print
    the reference's line (tokens generated, decode ms, tok/s).  ``lm``
    replaces the random model (e.g. weights carried from the reference by
    ``models.convert.lm_from_numpy``).  Returns the (B, gen_len + 1) int32
    tokens as numpy, and with ``return_stats`` also :func:`generate`'s
    stats."""
    spec = configs.get(arch_id)
    if lm is None:
        cfg = spec.make_reduced() if smoke else spec.make_config()
        gen = torch.Generator(device=device).manual_seed(seed)
        lm = LM(cfg, device=device, generator=gen)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, lm.cfg.vocab, (batch, prompt_len)), device=lm.device)
    toks, stats = generate(lm, prompts, gen_len)
    dt = sum(stats["decode_ms"]) / 1e3
    print(f"[serve] {arch_id}: generated {gen_len} tokens x{batch} "
          f"in {dt*1e3:.1f} ms ({batch*gen_len/dt:.0f} tok/s)")
    toks = toks.to(torch.int32).cpu().numpy()
    return (toks, stats) if return_stats else toks


def serve_recsys(batch: int = 64, seed: int = 0, *, smoke: bool = True,
                 device="cuda", model: WideDeep | None = None,
                 return_stats: bool = False):
    """Score ``batch`` random requests (dense features and multi-hot ids,
    ``numpy.random.default_rng(seed)`` draws as in the reference) with
    wide-deep: one warm-up forward, then 10 timed ones, each synchronised.
    Prints the reference's line (the mean us a batch).  ``model`` replaces
    the random model (e.g. weights carried by
    ``models.convert.widedeep_from_numpy``).  Returns the (B,) float32
    scores as numpy, and with ``return_stats`` also ``{"batch_ms": [...]}``
    (the 10 timed forwards)."""
    if model is None:
        spec = configs.get("wide-deep")
        cfg = spec.make_reduced() if smoke else spec.make_config()
        gen = torch.Generator(device=device).manual_seed(seed)
        model = WideDeep(cfg, device=device, generator=gen)
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    b = {"dense": torch.as_tensor(
            rng.normal(size=(batch, cfg.n_dense)).astype(np.float32),
            device=dev),
         "sparse_ids": torch.as_tensor(
            rng.integers(0, min(cfg.vocab_sizes),
                         (batch, cfg.n_sparse, cfg.ids_per_field)
                         ).astype(np.int32), device=dev)}
    with torch.no_grad():
        scores = model(b)
        times = []
        for _ in range(10):
            _sync(dev)
            t0 = time.perf_counter()
            scores = model(b)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
    dt = sum(times) / 10 / 1e3
    print(f"[serve] wide-deep: batch {batch} in {dt*1e6:.0f} us/req-batch")
    scores = scores.cpu().numpy()
    return (scores, {"batch_ms": times}) if return_stats else scores


# serving-scale graph families: small enough for a 1-core container to
# sustain a live update feed, structurally faithful to paper Table 6
_STREAM_GRAPHS = {
    "ER": ("erdos_renyi", dict(n=20_000, m=120_000, seed=1, simple=True)),
    "BA": ("barabasi_albert", dict(n=10_000, deg=8, seed=1)),
    "RMAT": ("rmat", dict(n_log2=13, m=65_536, seed=1)),
    "chain": ("chain", dict(n=2_000)),
    "layered": ("layered_dag", dict(n=20_000, layers=21, deg=4, seed=1)),
    "sink_heavy": ("sink_heavy", dict(n=20_000, m=80_000, sink_frac=0.9,
                                      seed=1)),
}


def _save_serve_ckpt(checkpoint_dir, engine, step, *, alive, pending, rng,
                     tick, dirty_ticks, checkpointer=None):
    """Checkpoint the engine plus the feed state the serve loop needs to
    resume mid-stream: the live-edge mask, the pending re-insertion
    queue (ragged — stored flat + lengths), and the exact feed RNG state
    (PCG64 state dicts are plain ints, JSON-safe in the manifest)."""
    from .. import fault as flt

    pend = [np.asarray(p, np.int64) for p in pending]
    extra = {
        "feed_alive": alive.copy(),
        "feed_pending": (np.concatenate(pend) if pend
                         else np.zeros(0, np.int64)),
        "feed_pending_lens": np.asarray([len(p) for p in pend], np.int64),
    }
    meta = {"feed": {"tick": int(tick), "dirty_ticks": int(dirty_ticks),
                     "rng_state": rng.bit_generator.state}}
    return flt.save_engine(checkpoint_dir, engine, step, extra_tree=extra,
                           extra_meta=meta, checkpointer=checkpointer)


def _load_serve_state(checkpoint_dir, device="cuda"):
    """Rebuild (engine, alive, pending, rng, tick, dirty_ticks) from the
    latest checkpoint written by :func:`_save_serve_ckpt` (by either
    package), the engine on ``device``."""
    from .. import fault as flt

    engine, step, tree, meta = flt.restore_engine(checkpoint_dir,
                                                  device=device)
    feed = meta["feed"]
    alive = np.asarray(tree["feed_alive"], bool).copy()
    flat = np.asarray(tree["feed_pending"], np.int64)
    pending, off = [], 0
    for ln in np.asarray(tree["feed_pending_lens"], np.int64):
        pending.append(flat[off:off + int(ln)].copy())
        off += int(ln)
    rng = np.random.default_rng()
    rng.bit_generator.state = feed["rng_state"]
    return engine, alive, pending, rng, int(feed["tick"]), \
        int(feed["dirty_ticks"])


def serve_trim_stream(graph: str = "ER", ticks: int = 20, batch: int = 256,
                      seed: int = 0, instrument: bool = False,
                      trace: str | None = None,
                      metrics_port: int | None = None,
                      slo_ms: float = 50.0, metrics_hold: float = 0.0,
                      metrics_json: str | None = None,
                      checkpoint_dir: str | None = None,
                      checkpoint_every: int = 5,
                      fault_seed: int | None = None,
                      fault_rate: float = 0.05, retries: int = 3,
                      device="cuda"):
    """Drive a :class:`~repro_torch.core.stream.StreamEngine` on ``device``
    with a synthetic update feed: each tick deletes a batch of random live
    edges and re-inserts a previously deleted batch (re-insertions may hit
    the revival path and trigger the from-scratch fallback — reported as
    ``dirty``).  The feed draws what the reference's draws (the same
    ``numpy.random.default_rng(seed)`` calls, edges addressed by their
    position in the generated graph), so both packages apply the same
    batches and end in the same state.

    The serving metric is **steady-state** updates/sec, read off the
    ``obs`` span recorder: every tick is a span, every engine dispatch
    inside it records whether a kernel library was built during it
    (phase ``"build+execute"``), and ticks with such a dispatch are
    excluded from the throughput window.  A tick's span closes after its
    device work: ``engine.apply`` returns its rounds as a host int, and on
    a CUDA device ``torch.cuda.synchronize`` then waits for what the
    apply enqueued after its last read (a compaction).  ``trace`` exports
    the tick/dispatch timeline for chrome://tracing.

    ``metrics_port`` (off by default) installs a MetricsPlane for the
    serve and exposes it on a stdlib http server: ``/metrics``
    (OpenMetrics text) and ``/healthz`` (JSON).  It implies
    ``instrument`` and tracks a per-tick SLO — sliding-window p99 against
    ``slo_ms``, with a breach counter.  Port 0 picks a free port;
    ``metrics_hold`` keeps the endpoint up for N seconds after the feed
    finishes, and ``metrics_json`` dumps the snapshot to a file.

    Fault tolerance: ``checkpoint_dir`` checkpoints the engine *and* the
    feed state (live mask, pending queue, RNG state) every
    ``checkpoint_every`` ticks in the reference's layout, resumes from the
    latest step on startup, and writes a final checkpoint on completion or
    SIGTERM (which also drains the async writer and stops the metrics
    server).  ``fault_seed`` installs a deterministic
    :class:`~repro_torch.fault.FaultSchedule`; recovery is tiered per
    fault point: ``mid-update-batch`` fires before any engine-side
    mutation, so the tick is replayed from a host snapshot (same RNG
    state — bit-identical); ``pre-dispatch``/``post-dispatch`` on the
    stream engine fire after host mirrors moved, so the engine is
    restored from the latest checkpoint (or the feed cold-restarts from
    tick 0 when none exists); a failed checkpoint *write* is skipped with
    a warning.  All recoveries are bounded by ``retries`` consecutive
    attempts with exponential backoff and counted in
    ``repro_recoveries{point,strategy}``."""
    from .. import fault as flt
    from .. import obs
    from ..core.stream import plan_stream
    from ..graphs import generators

    plane = server = slo = None
    prev_plane = None
    health = {"status": "warming", "graph": graph, "ticks_done": 0}
    stop = threading.Event()
    prev_sigterm = None
    try:
        prev_sigterm = signal.signal(
            signal.SIGTERM, lambda _s, _f: stop.set())
    except ValueError:          # not on the main thread (tests)
        prev_sigterm = None
    checkpointer = None
    fault_plane = prev_fault = None
    if fault_seed is not None:
        fault_plane = flt.FaultPlane(
            flt.FaultSchedule(fault_seed, rate=fault_rate))
        prev_fault = flt.set_fault_plane(fault_plane)
        print(f"[serve] fault injection armed: "
              f"{fault_plane.schedule.describe()}")
    if metrics_port is not None:
        plane = obs.MetricsPlane()
        prev_plane = obs.set_plane(plane)
        instrument = True            # metrics imply round telemetry
        slo = obs.SLOTracker(slo_ms / 1e3, name="tick", plane=plane)
        server = obs.MetricsServer(metrics_port,
                                   plane_getter=lambda: plane,
                                   health_getter=lambda: dict(health))
        print(f"[serve] metrics endpoint: "
              f"http://127.0.0.1:{server.port}/metrics "
              f"(SLO target {slo_ms:.1f} ms/tick)")
    try:
        fn_name, kwargs = _STREAM_GRAPHS[graph]
        g = getattr(generators, fn_name)(**kwargs, device=device)
        capacity = max(4096, 16 * batch)
        # the feed addresses edges by their position in the *generated*
        # graph (not the engine's base CSR, which re-sorts on compaction)
        # so a restarted process replays the identical update sequence
        indptr_h, indices_h = g.to_numpy()
        src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(indptr_h))
        dst = indices_h.astype(np.int64)
        engine = None
        if checkpoint_dir is not None:
            from ..train import checkpoint as _ckpt
            checkpointer = _ckpt.AsyncCheckpointer(checkpoint_dir)
            if _ckpt.latest_step(checkpoint_dir) is not None:
                (engine, alive, pending, rng, tick,
                 dirty_ticks) = _load_serve_state(checkpoint_dir, device)
                health["ticks_done"] = tick
                print(f"[serve] resumed from {checkpoint_dir} at tick "
                      f"{tick}/{ticks}")
        if engine is None:
            # headroom for many insert batches between compactions
            engine = plan_stream(g, capacity=capacity,
                                 instrument=instrument)
            rng = np.random.default_rng(seed)
            alive = np.ones(g.m, bool)
            pending = []             # deleted batches awaiting re-insertion
            dirty_ticks = 0
            tick = 0
        attempts = 0
        last_saved = None
        snap = None            # pre-tick host state for verbatim replay
        recover = None         # fault point awaiting recovery
        with obs.recording() as rec:
            while tick < ticks and not stop.is_set():
                # recovery runs inside the try: a fault injected *during*
                # recovery (e.g. the plan-time retrim of a restored
                # engine) re-enters the same bounded-attempts accounting
                # instead of crashing the loop
                try:
                    if recover == "mid-update-batch":
                        # fired before any engine-side mutation: rewind
                        # the feed and replay the tick (same RNG draws)
                        rng.bit_generator.state = snap[0]
                        alive = snap[1].copy()
                        pending = [p.copy() for p in snap[2]]
                        dirty_ticks = snap[3]
                        recover = None
                        flt.get_fault_plane().record_recovery(
                            "mid-update-batch", "retry")
                    elif recover is not None:
                        point = recover
                        if (checkpoint_dir is not None and
                                _ckpt.latest_step(checkpoint_dir)
                                is not None):
                            if checkpointer is not None:
                                try:
                                    checkpointer.wait()
                                except OSError:
                                    pass
                            (engine, alive, pending, rng, tick,
                             dirty_ticks) = _load_serve_state(
                                 checkpoint_dir, device)
                            recover = None
                            flt.get_fault_plane().record_recovery(
                                point, "restore")
                            print(f"[serve] fault at {point!r}: "
                                  f"restored from checkpoint, tick "
                                  f"{tick}")
                        else:
                            # no checkpoint yet: degrade to a cold
                            # restart of the feed (deterministic, so
                            # the stream replays identically)
                            engine = plan_stream(g, capacity=capacity,
                                                 instrument=instrument)
                            rng = np.random.default_rng(seed)
                            alive = np.ones(g.m, bool)
                            pending = []
                            dirty_ticks = 0
                            tick = 0
                            recover = None
                            flt.get_fault_plane().record_recovery(
                                point, "restart")
                            print(f"[serve] fault at {point!r}: no "
                                  f"checkpoint, cold restart from "
                                  f"tick 0")
                    # host snapshot: enough to replay this tick verbatim
                    snap = (rng.bit_generator.state, alive.copy(),
                            [p.copy() for p in pending], dirty_ticks)
                    k = min(batch, int(alive.sum()))
                    ids = rng.choice(np.nonzero(alive)[0], k,
                                     replace=False)
                    alive[ids] = False
                    ins = pending.pop(0) if len(pending) >= 3 else None
                    n_upd = k + (0 if ins is None else len(ins))
                    t0 = time.perf_counter()
                    with obs.span("tick", cat="serve", tick=tick,
                                  updates=n_upd):
                        res = engine.apply(
                            deletions=(src[ids], dst[ids]),
                            insertions=None if ins is None else
                            (src[ins], dst[ins]))
                        _sync(g.device)     # the tick's device work ends
                except (flt.DeviceFault, flt.IOFault) as e:
                    attempts += 1
                    health["status"] = "recovering"
                    if attempts > retries:
                        raise
                    time.sleep(flt.backoff_delay(attempts - 1))
                    if recover is None:
                        recover = getattr(e, "point", "unknown")
                    continue
                attempts = 0
                if slo is not None:
                    slo.observe(time.perf_counter() - t0)
                if plane is not None:
                    plane.counter(
                        "repro_serve_updates",
                        "edge updates applied by the serving loop",
                    ).inc(n_upd, graph=graph)
                if ins is not None:
                    alive[ins] = True
                pending.append(ids)
                dirty_ticks += bool(res.dirty)
                tick += 1
                health["ticks_done"] = tick
                health["status"] = "ok"
                if (checkpoint_dir is not None and checkpoint_every > 0
                        and tick % checkpoint_every == 0):
                    try:
                        _save_serve_ckpt(
                            checkpoint_dir, engine, tick, alive=alive,
                            pending=pending, rng=rng, tick=tick,
                            dirty_ticks=dirty_ticks,
                            checkpointer=checkpointer)
                        last_saved = tick
                    except OSError as e:
                        flt.get_fault_plane().record_recovery(
                            getattr(e, "point", "checkpoint-write"),
                            "skip")
                        print(f"[serve] checkpoint at tick {tick} "
                              f"failed ({e}); continuing without it")
            res = flt.call_with_retries(engine.retrim, retries=retries)
        if checkpoint_dir is not None and tick != last_saved:
            try:
                _save_serve_ckpt(checkpoint_dir, engine, tick,
                                 alive=alive, pending=pending, rng=rng,
                                 tick=tick, dirty_ticks=dirty_ticks,
                                 checkpointer=checkpointer)
            except OSError as e:
                print(f"[serve] final checkpoint failed ({e})")
        if stop.is_set():
            health["status"] = "draining"
            print(f"[serve] SIGTERM: drained at tick {tick}/{ticks}, "
                  f"final checkpoint "
                  f"{'written' if checkpoint_dir else 'disabled'}")

        tick_spans = rec.select("tick", cat="serve")
        dispatches = rec.select("dispatch", cat="engine")

        def built_during(t):
            return any(d.attrs.get("phase") == "build+execute"
                       and t.ts <= d.ts < t.ts + t.dur for d in dispatches)

        steady = [t for t in tick_spans if not built_during(t)]
        warm = len(tick_spans) - len(steady)
        n_updates = sum(t.attrs["updates"] for t in tick_spans)
        steady_s = sum(t.dur for t in steady)
        ups = (sum(t.attrs["updates"] for t in steady) / steady_s
               if steady_s else float("nan"))
        print(f"[serve] trim-stream {graph} n={g.n} m={g.m}: "
              f"{len(tick_spans)} ticks "
              f"({warm} compile, excluded), {n_updates} updates, "
              f"{ups:,.0f} updates/s steady-state, dirty ticks "
              f"{dirty_ticks}, trimmed {res.n_trimmed} "
              f"({res.trimmed_fraction*100:.1f}%), "
              f"compactions {engine.compactions}")
        if instrument and res.round_stats is not None:
            rs = res.round_stats
            print(f"[serve]   last-batch telemetry: "
                  f"frontier {int(rs.total('r_frontier'))}, "
                  f"edges {int(rs.total('r_edges'))}, "
                  f"decrements {int(rs.total('r_decrements'))}")
        if slo is not None:
            print(f"[serve]   SLO: tick p99 {slo.p99*1e3:.2f} ms vs "
                  f"target {slo_ms:.1f} ms, breaches {slo.breaches}")
        if trace:
            path = rec.to_chrome_trace(trace)
            print(f"[serve]   chrome trace: {path} "
                  f"({len(rec.spans)} spans)")
        if metrics_json and plane is not None:
            import json
            with open(metrics_json, "w") as f:
                json.dump(plane.snapshot(), f, indent=1)
            print(f"[serve]   metrics snapshot: {metrics_json}")
        if server is not None and metrics_hold > 0 and not stop.is_set():
            print(f"[serve]   holding /metrics for {metrics_hold:.0f}s")
            t_end = time.monotonic() + metrics_hold
            while time.monotonic() < t_end and not stop.is_set():
                time.sleep(0.2)    # SIGTERM-interruptible hold
        return engine
    finally:
        if checkpointer is not None:
            try:
                checkpointer.close()
            except OSError as e:
                print(f"[serve] checkpoint writer error at close: {e}")
        if server is not None:
            server.close()
        if prev_plane is not None:
            obs.set_plane(prev_plane)
        if fault_plane is not None:
            flt.set_fault_plane(prev_fault)
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--app", default="model",
                    choices=("model", "trim-stream"))
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration (default: published)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--graph", default="ER", choices=sorted(_STREAM_GRAPHS))
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--update-batch", type=int, default=256)
    ap.add_argument("--instrument", action="store_true",
                    help="device-resident round telemetry (trim-stream)")
    ap.add_argument("--trace", metavar="PATH",
                    help="write a chrome://tracing timeline (trim-stream)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics + /healthz on this port (0 = any "
                         "free port; off by default, implies --instrument)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="per-tick SLO target for the p99 tracker "
                         "(with --metrics-port)")
    ap.add_argument("--metrics-hold", type=float, default=0.0,
                    metavar="SECONDS",
                    help="keep the metrics endpoint up this long after "
                         "the feed finishes")
    ap.add_argument("--metrics-json", metavar="PATH",
                    help="dump the final MetricsPlane snapshot as JSON "
                         "(with --metrics-port)")
    ap.add_argument("--checkpoint-dir", metavar="DIR",
                    help="checkpoint engine + feed state here and resume "
                         "from the latest step on startup (trim-stream)")
    ap.add_argument("--checkpoint-every", type=int, default=5,
                    metavar="TICKS",
                    help="ticks between checkpoints (with "
                         "--checkpoint-dir; a final checkpoint is always "
                         "written)")
    ap.add_argument("--fault-seed", type=int, default=None, metavar="SEED",
                    help="install a deterministic FaultSchedule with this "
                         "seed (chaos testing; off by default)")
    ap.add_argument("--fault-rate", type=float, default=0.05,
                    help="per-arming fault probability for --fault-seed")
    ap.add_argument("--retries", type=int, default=3,
                    help="bound on consecutive recovery attempts per tick")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    if args.app == "trim-stream":
        return serve_trim_stream(
            args.graph, ticks=args.ticks, batch=args.update_batch,
            instrument=args.instrument, trace=args.trace,
            metrics_port=args.metrics_port, slo_ms=args.slo_ms,
            metrics_hold=args.metrics_hold, metrics_json=args.metrics_json,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            fault_seed=args.fault_seed, fault_rate=args.fault_rate,
            retries=args.retries, device=args.device)
    if args.arch is None:
        ap.error("--arch is required for --app model")
    family = configs.get(args.arch).family
    if family == "lm":
        return serve_lm(args.arch, batch=args.batch, gen_len=args.gen_len,
                        smoke=args.smoke, device=args.device)
    if family == "recsys":
        return serve_recsys(batch=args.batch, smoke=args.smoke,
                            device=args.device)
    raise SystemExit("serving applies to lm/recsys archs")


if __name__ == "__main__":
    main()
