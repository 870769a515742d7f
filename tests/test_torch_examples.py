"""The torch twins of the examples (``examples/torch/``) on the CPU, against
the reference's library on the same inputs.

Each twin's ``main(["--device", "cpu"])`` runs with its size constants
shrunk.  Its integers (trimmed vertices, edges traversed, rounds,
max|Qp|, the α line, the batched runs' counts, SCC counts, generations,
pivots, dispatches, the regions' trims and reaches, the sampler's trim
and blocks) equal the reference's.  The port compiles nothing, so its
``traces`` are 0 and are not compared.  The served and trained models
take the reference's weights (``models.convert``), so the float lines
are compared too: wide-deep's scores and top-100 values to 1e-5 relative
(f32; the indices where the values are distinct), SchNet's losses over
6 steps to 1e-3 relative (f32, AdamW; the two packages batch the
molecules differently, a vmap against a disjoint union).
"""
import importlib.util
import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import plan as jplan
from repro.core.scc import same_partition
from repro.core.scc import scc_decompose as jscc
from repro.core import CSRGraph as JCSR
from repro.core import peeling_alpha as jalpha
from repro.core import plan_reach as jplan_reach
from repro.data import GraphBatchStream as JStream
from repro.graphs import NeighborSampler as JSampler
from repro.graphs import sink_heavy as jsink
from repro.models.gnn import SchNet as JSchNet
from repro.models.recsys import WideDeep as JWideDeep
from repro.optim import AdamW as JAdamW
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch.models import convert

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
SCORE_TOL, LOSS_TOL = 1e-5, 1e-3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_traces(line: str) -> str:
    line = re.sub(r"traces=\d+", "traces=_", line)
    return re.sub(r"trim=\d+ reach=\d+", "trim=_ reach=_", line)


def test_quickstart(monkeypatch, capsys):
    ex = _load("quickstart")
    monkeypatch.setattr(ex, "N", 20_000)
    monkeypatch.setattr(ex, "M", 80_000)
    ex.main(["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()

    g = jsink(n=ex.N, m=ex.M, sink_frac=ex.SINK_FRAC, seed=0)
    want = [f"graph: n={g.n:,} m={g.m:,} α={jalpha(g)}"]
    gt = g.transpose()
    res = {m: jplan(g, method=m, workers=16, transpose=gt).run()
           for m in ex.METHODS}
    for m, r in res.items():
        want.append(f"{m:5s}: trimmed {r.n_trimmed:,} "
                    f"({r.trimmed_fraction*100:.1f}%) | edges traversed "
                    f"{r.edges_traversed:,} | rounds {r.rounds} | "
                    f"max|Qp| {r.max_frontier}")
    want += ["", f"AC-6 traverses "
             f"{res['ac3'].edges_traversed/res['ac6'].edges_traversed:.1f}x "
             f"fewer edges than AC-3 and "
             f"{res['ac4'].edges_traversed/res['ac6'].edges_traversed:.1f}x "
             f"fewer than AC-4 — the paper's §9.3 result.", ""]
    rng = np.random.default_rng(0)
    masks = np.stack([rng.random(g.n) < keep for keep in ex.KEEPS])
    batch = jplan(g, method="ac6", workers=16, transpose=gt).run_batch(masks)
    counts = [f"{int(m.sum() - (np.asarray(b.status).astype(bool) & m).sum()):,}"
              f" of {int(m.sum()):,} trimmed" for m, b in zip(masks, batch)]
    assert got[:len(want)] == want
    assert got[len(want)].startswith("steady-state ac6 run (counters off): ")
    assert got[len(want) + 1] == f"run_batch over 3 masks: {counts}"


def test_scc_decomposition(monkeypatch, capsys):
    ex = _load("scc_decomposition")
    monkeypatch.setattr(ex, "N", 2_000)
    monkeypatch.setattr(ex, "M", 6_000)
    out = ex.main(["--device", "cpu"])
    got = [_no_traces(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]

    g = JCSR.from_edges(10, *map(np.array, zip(*ex.FIGURE1)))
    _, stats = jscc(g, use_trim=True, trim_method="ac6")
    port = dict(out["figure1"])
    assert port.pop("engine_traces") == 0
    stats.pop("engine_traces")
    assert port == stats
    rng = np.random.default_rng(0)
    g = JCSR.from_edges(ex.N, rng.integers(0, ex.N, ex.M),
                        rng.integers(0, ex.N, ex.M))
    want = []
    for use_trim in (True, False):
        labels, stats = jscc(g, use_trim=use_trim, trim_method="ac6",
                             counters=use_trim)
        assert same_partition(out[use_trim][0], labels)
        edges = stats["trim_edges_traversed"]
        want.append(
            f"use_trim={use_trim}: {len(np.unique(labels)):,} SCCs, "
            f"generations={stats['generations']}, pivots={stats['pivots']}, "
            f"trimmed={stats['trimmed_total']:,}, "
            f"trim_edges={'off' if edges is None else f'{edges:,}'}, "
            f"dispatches={stats['trim_dispatches']}+"
            f"{stats['reach_dispatches']} (trim+reach), traces=_, "
            f"transpose_builds={stats['transpose_builds']}")
    engine = jplan(g, method="ac6")
    reach = jplan_reach(g, transpose=engine.transpose)
    for keep in ex.KEEPS:
        mask = rng.random(ex.N) < keep
        live = np.asarray(engine.run(active=mask).status).astype(bool)
        r = reach.run(seeds=int(np.argmax(mask)), active=mask)
        want.append(f"re-trim {keep:.0%} region: "
                    f"{int(mask.sum() - (live & mask).sum()):,} of "
                    f"{int(mask.sum()):,} trimmed; {r.n_reached:,} reachable "
                    f"from its first vertex (traces so far: trim=_ reach=_)")
    assert got[1:3] == want[:2]
    assert got[3].startswith("matches Tarjan oracle")
    assert got[4:] == want[2:]


def test_serve_recsys(monkeypatch, capsys):
    ex = _load("serve_recsys")
    monkeypatch.setattr(ex, "BATCH", 64)
    monkeypatch.setattr(ex, "CANDIDATES", 5_000)
    monkeypatch.setattr(ex, "REPS", 2)
    cfg = jget("wide-deep").make_reduced()
    jm = JWideDeep(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    monkeypatch.setattr(ex, "build_model", lambda c, d: (
        convert.widedeep_from_numpy(c, jax.tree.map(np.asarray, params),
                                    device=d)))
    scores, vals, idx = ex.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()

    rng = np.random.default_rng(0)
    batch = {"dense": jnp.asarray(rng.normal(size=(ex.BATCH, cfg.n_dense)),
                                  jnp.float32),
             "sparse_ids": jnp.asarray(rng.integers(
                 0, min(cfg.vocab_sizes),
                 (ex.BATCH, cfg.n_sparse, cfg.ids_per_field)), jnp.int32)}
    want = np.asarray(jm.forward(params, batch))
    cand = jnp.asarray(rng.normal(size=(ex.CANDIDATES, cfg.retrieval_dim)),
                       jnp.float32)
    jvals, jidx = jm.retrieval_scores(params, {
        "dense": batch["dense"][:1], "sparse_ids": batch["sparse_ids"][:1],
        "candidates": cand})
    jvals, jidx = np.asarray(jvals), np.asarray(jidx)
    scale = float(np.abs(want).max())
    assert float(np.abs(scores.numpy() - want).max()) <= SCORE_TOL * scale
    assert float(np.abs(vals.numpy() - jvals).max()) <= \
        SCORE_TOL * float(np.abs(jvals).max())
    distinct = np.diff(jvals, prepend=np.inf, append=-np.inf)
    distinct = (np.abs(distinct[:-1]) > 1e-4) & (np.abs(distinct[1:]) > 1e-4)
    np.testing.assert_array_equal(idx.numpy()[distinct], jidx[distinct])
    assert lines[0].startswith(f"CTR scoring: batch {ex.BATCH} in ")
    assert lines[1].startswith(f"retrieval: top-100 of {ex.CANDIDATES:,} "
                               "candidates in ")
    best = float(lines[1].rsplit("best=", 1)[1])
    assert abs(best - float(jvals[0])) <= 5e-4


def test_train_gnn_trimmed(monkeypatch, capsys):
    ex = _load("train_gnn_trimmed")
    for name, value in (("GRAPH_N", 5_000), ("GRAPH_M", 20_000),
                        ("STEPS", 6), ("CKPT_EVERY", 3), ("LOG_EVERY", 3)):
        monkeypatch.setattr(ex, name, value)
    cfg = jget("schnet").make_reduced()
    jm = JSchNet(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    monkeypatch.setattr(ex, "build_model", lambda c, d: (
        convert.gnn_from_numpy(c, jax.tree.map(np.asarray, params),
                               device=d)))
    sampler, blocks, hist = ex.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()

    g = jsink(ex.GRAPH_N, ex.GRAPH_M, sink_frac=ex.SINK_FRAC, seed=0)
    js = JSampler(g, fanouts=ex.FANOUTS, seed=0, trim=True)
    assert sampler.trim_stats == js.trim_stats
    jblocks = js.sample(next(js.batches(ex.SEEDS, 1)))
    for b, jb in zip(blocks, jblocks, strict=True):
        for f in ("src_nodes", "dst_nodes", "neighbors", "mask"):
            np.testing.assert_array_equal(getattr(b, f), getattr(jb, f))
    assert lines[0] == (
        f"sampling universe: {g.n:,} vertices, trimmed "
        f"{js.trim_stats['trimmed']:,} sinks first (AC-6 traversed "
        f"{js.trim_stats['edges_traversed']:,} edges)")
    assert lines[1] == f"sampled blocks: {[b.neighbors.shape for b in jblocks]}"

    opt = JAdamW(lr=2e-3)

    def loss_fn(params, batch):
        def single(b):
            return jnp.sum(jm.forward(params, b)[..., 0])
        e = jax.vmap(single)({k: v for k, v in batch.items()
                              if k != "energy"})
        return jnp.mean(jnp.square(e - batch["energy"]))

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        p, s = opt.update(grads, opt_state, params)
        return p, s, {"loss": loss}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        jhist = JTrainer(step, params, opt.init(params), JStream(**ex.STREAM),
                         JTrainerConfig(num_steps=ex.STEPS,
                                        ckpt_dir=ckpt_dir,
                                        ckpt_every=ex.CKPT_EVERY,
                                        log_every=ex.LOG_EVERY),
                         put_batch=lambda b: jax.tree.map(jnp.asarray, b)
                         ).run()
    got = np.array([h["loss"] for h in hist])
    want = np.array([h["loss"] for h in jhist])
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    assert lines[-1] == (f"trained {ex.STEPS} steps: loss {got[0]:.4f} -> "
                         f"{got[-1]:.4f}")
