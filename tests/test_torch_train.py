"""The PyTorch port's training substrate against the JAX reference, on the
CPU: AdamW on the same gradients, the data streams, the neighbour sampler,
the trainer's loss history and the training launcher.

Tolerances, and why:

- AdamW: 1e-6 relative over 3 steps on the same numpy gradients; both run
  the same float32 formulas.
- Streams and sampler blocks: bit for bit; both are the same numpy draws.
- Trainer: each of the 10 losses within 1e-4 relative of the reference's
  (they differ by at most 7.3e-7 at these seeds).  The gradients agree
  closely (``test_torch_gnn.py``), but AdamW's first steps move every
  entry by about +-lr whatever its size, so an entry whose gradient is
  near 0 can take the other sign in the two frameworks and the losses
  drift apart slowly: the trajectory is held loosely, the gradients and
  the optimizer tightly.
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.data import GraphBatchStream as JGraphs
from repro.data import RecsysStream as JRecsys
from repro.data import TokenStream as JTokens
from repro.graphs import NeighborSampler as JSampler
from repro.graphs import sink_heavy as jsink_heavy
from repro.launch.train import build_smoke as jbuild_smoke
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch.data import GraphBatchStream, RecsysStream, TokenStream
from repro_torch.graphs import NeighborSampler, sink_heavy
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models.gnn.common import molecule_loss, molecule_union
from repro_torch.optim import (AdamW, HybridAdamW, cosine_schedule,
                               global_norm)
from repro_torch.optim.adamw import AdamWState
from repro_torch.train import StragglerMonitor, Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch import configs

torch.set_num_threads(1)


# ---------------------------------------------------------------- AdamW


@pytest.mark.parametrize("wd,clip,sched", [
    (0.0, 1.0, False), (0.1, 0.5, True), (0.0, None, True)])
def test_adamw_matches_reference(wd, clip, sched):
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 3).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=wd, clip_norm=clip)
    jopt = JAdamW(**kw, schedule=jcosine(2, 10) if sched else None)
    topt = AdamW(**kw, schedule=cosine_schedule(2, 10) if sched else None)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.as_tensor(p) for p in params]
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        if clip is not None:     # the clip is active on every step
            assert float(np.sqrt(sum((x ** 2).sum() for x in g))) > clip
        jp, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        tp, ts = topt.update([torch.as_tensor(x) for x in g], ts, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert int(ts.count) == int(js.count) == 3
    for m, jm in zip(ts.mu, js.mu):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-8)
    for v, jv in zip(ts.nu, js.nu):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-8)


def test_adamw_step_in_place():
    p = torch.nn.Parameter(torch.ones(4))
    opt = AdamW(lr=0.5, clip_norm=None)
    st = opt.init([p])
    want, _ = opt.update([torch.full((4,), 2.0)], st, [p])
    st = opt.step([p], [torch.full((4,), 2.0)], st)
    assert torch.equal(p.detach(), want[0]) and int(st.count) == 1
    # ``step`` works one tensor at a time in place, its moments too: the
    # values of ``update`` bit for bit, with the clip and the decay on
    rng = np.random.default_rng(5)
    shapes = [(64, 8), (8,), (3, 5, 2)]
    opt = AdamW(lr=1e-2, weight_decay=0.1, clip_norm=0.5)
    params = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
              for s in shapes]
    st = opt.init(params)
    for _ in range(3):
        grads = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
                 for s in shapes]
        want, wst = opt.update(grads, st, params)
        st = opt.step(params, grads, st)
        for q, w in zip(params, want):
            assert torch.equal(q, w)
        for a, b in zip(st.mu + st.nu, wst.mu + wst.nu):
            assert torch.equal(a, b)


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = [torch.tensor([5.0, -3.0])]
    st = opt.init(params)
    for _ in range(200):
        params, st = opt.update([2 * params[0]], st, params)
    assert float(params[0].abs().max()) < 1e-2


def test_clipping_bounds_update():
    opt = AdamW(lr=1.0, clip_norm=1e-6)
    params = [torch.ones(4)]
    p2, _ = opt.update([torch.full((4,), 1e6)], opt.init(params), params)
    assert torch.isfinite(p2[0]).all()


def test_cosine_schedule_and_global_norm():
    fn = cosine_schedule(warmup=10, total=100)
    assert float(fn(torch.tensor(0))) < 0.11
    assert abs(float(fn(torch.tensor(10))) - 1.0) < 1e-6
    assert float(fn(torch.tensor(100))) < 1e-6
    jfn = jcosine(10, 100)
    for s in (0, 3, 10, 55, 99, 100, 140):
        assert abs(float(fn(torch.tensor(s))) - float(jfn(jnp.array(s)))) \
            < 1e-7
    assert abs(float(global_norm([torch.tensor([3.0]),
                                  torch.tensor([4.0])])) - 5.0) < 1e-6


def test_hybrid_adamw_raises_naming_a11():
    """Once a stub that raised (A11); now ported: three steps on the same
    named numpy gradients equal the reference's ``HybridAdamW`` (SGD on the
    ``tables`` paths bit for bit, Adam elsewhere to 1e-6 relative)."""
    from repro.optim import HybridAdamW as JHybrid
    rng = np.random.default_rng(7)
    shapes = {"tables/t0": (16, 4), "wide_tables/t0": (16, 1),
              "mlp/0/w": (4, 3), "mlp/0/b": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    jparams = {"tables": {"t0": jnp.asarray(init["tables/t0"])},
               "wide_tables": {"t0": jnp.asarray(init["wide_tables/t0"])},
               "mlp": [{"w": jnp.asarray(init["mlp/0/w"]),
                        "b": jnp.asarray(init["mlp/0/b"])}]}
    params = {k: torch.tensor(v) for k, v in init.items()}
    sched = cosine_schedule(1, 10)
    jopt = JHybrid(adamw=JAdamW(lr=1e-2, schedule=jcosine(1, 10)),
                   sgd_lr=0.1)
    opt = HybridAdamW(adamw=AdamW(lr=1e-2, schedule=sched), sgd_lr=0.1)
    jst, st = jopt.init(jparams), opt.init(params)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jg = {"tables": {"t0": g["tables/t0"]},
              "wide_tables": {"t0": g["wide_tables/t0"]},
              "mlp": [{"w": g["mlp/0/w"], "b": g["mlp/0/b"]}]}
        jparams, jst = jopt.update(jg, jst, jparams)
        st = opt.step(params, [torch.tensor(g[k]) for k in params], st)
    want = {"tables/t0": jparams["tables"]["t0"],
            "wide_tables/t0": jparams["wide_tables"]["t0"],
            "mlp/0/w": jparams["mlp"][0]["w"],
            "mlp/0/b": jparams["mlp"][0]["b"]}
    for k, p in params.items():
        if "tables" in k:
            np.testing.assert_array_equal(p.numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(p.numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    assert [m.shape for m in st.mu] == [(), (), (4, 3), (3,)]
    assert int(st.count) == int(jst.count) == 3


# -------------------------------------------------------- streams, sampler


@pytest.mark.parametrize("seed", [0, 3])
def test_streams_bit_identical(seed):
    pairs = [(TokenStream(4, 32, 512, seed=seed),
              JTokens(4, 32, 512, seed=seed)),
             (RecsysStream(8, 5, 3, (100, 7, 33), ids_per_field=2,
                           seed=seed),
              JRecsys(8, 5, 3, (100, 7, 33), ids_per_field=2, seed=seed)),
             (GraphBatchStream(128, 30, 64, seed=seed),
              JGraphs(128, 30, 64, seed=seed))]
    for ours, theirs in pairs:
        for step in (0, 1, 17):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("trim", [True, False])
def test_sampler_blocks_match_reference(trim):
    kw = dict(n=3_000, m=12_000, sink_frac=0.7, seed=0)
    ours = NeighborSampler(sink_heavy(**kw, device="cpu"), fanouts=(8, 4),
                           seed=0, trim=trim)
    theirs = JSampler(jsink_heavy(**kw), fanouts=(8, 4), seed=0, trim=trim)
    np.testing.assert_array_equal(ours.allowed, theirs.allowed)
    assert ours.trim_stats == theirs.trim_stats
    if trim:
        assert 0 < ours.trim_stats["trimmed"] < 3_000
    for _ in range(2):
        seeds, jseeds = next(ours.batches(64, 1)), next(theirs.batches(64, 1))
        np.testing.assert_array_equal(seeds, jseeds)
        for a, b in zip(ours.sample(seeds), theirs.sample(jseeds)):
            for f in ("src_nodes", "dst_nodes", "neighbors", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if trim:           # every sampled neighbour survived the trim
            assert ours.allowed[a.src_nodes].all()


# --------------------------------------------------------------- trainer


@pytest.mark.parametrize("arch", ["meshgraphnet", "schnet", "mace",
                                  "equiformer-v2"])
def test_trainer_tracks_reference_history(arch):
    jstep, jparams, jstate, jstream = jbuild_smoke(arch)
    weights = jax.tree.map(np.asarray, jparams)  # the trainer donates them
    jhist = JTrainer(jstep, jparams, jstate, jstream,
                     JTrainerConfig(num_steps=10, log_every=100),
                     put_batch=lambda b: jax.tree.map(jnp.asarray, b)).run()
    model = convert.gnn_from_numpy(configs.get(arch).make_reduced(),
                                   weights, device="cpu")
    opt = AdamW(lr=1e-3)
    params = list(model.parameters())
    hist = Trainer(tlaunch.make_train_step(model, opt, molecule_loss),
                   params, opt.init(params),
                   GraphBatchStream(batch=4, n_nodes=16, n_edges=48, seed=0),
                   TrainerConfig(num_steps=10, log_every=100),
                   put_batch=lambda b: molecule_union(b, "cpu")).run()
    got = np.array([h["loss"] for h in hist])
    want = np.array([h["loss"] for h in jhist])
    assert [h["step"] for h in hist] == list(range(10))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _smoke_trainer(arch, steps, ckpt_dir=None, ckpt_every=50):
    """The launcher's reduced model on the smoke stream (weights from seed
    0, so every call starts from the same ones)."""
    step, params, opt_state, stream, put = tlaunch.build(arch, 0, smoke=True,
                                                         device="cpu")
    return Trainer(step, params, opt_state, stream,
                   TrainerConfig(num_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=ckpt_every, log_every=100),
                   put_batch=put)


def _state_leaves(tr):
    return [t for _, t in ckpt_lib.leaves({"p": tr.params,
                                           "o": tr.opt_state})]


@pytest.mark.parametrize("arch", ["schnet", "meshgraphnet"])
def test_trainer_resume_bit_identical(arch, tmp_path):
    """4 steps with a checkpoint every 2, then a fresh trainer resumes from
    step 4 to 6: the restored parameters and AdamW state equal the saved
    ones, and the losses, parameters and AdamW state equal an
    uninterrupted 6-step run's, bit for bit."""
    whole = _smoke_trainer(arch, 6)
    want = [h["loss"] for h in whole.run()]
    d = str(tmp_path / "ck")
    first = _smoke_trainer(arch, 4, d, ckpt_every=2)
    got = [h["loss"] for h in first.run()]
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    assert ckpt_lib.load_flat(d)[2] == {"stream_step": 4}
    second = _smoke_trainer(arch, 6, d, ckpt_every=2)
    assert second.start_step == 4
    assert isinstance(second.opt_state, AdamWState)
    assert int(second.opt_state.count) == 4
    for a, b in zip(_state_leaves(second), _state_leaves(first)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    hist = second.run()
    assert [h["step"] for h in hist] == [4, 5]
    assert got + [h["loss"] for h in hist] == want
    for a, b in zip(_state_leaves(second), _state_leaves(whole)):
        assert torch.equal(a, b)
    assert ckpt_lib.latest_step(d) == 6


def test_trainer_refuses_checkpoints_and_monitors(tmp_path):
    # a checkpoint of another model is refused, not half-loaded
    d = str(tmp_path / "other")
    other = [torch.zeros(3)]
    ckpt_lib.save(d, 1, {"params": other, "opt": AdamW().init(other)})
    with pytest.raises((KeyError, ValueError)):
        _smoke_trainer("schnet", 2, d)
    mon = StragglerMonitor(threshold=2.0, patience=2)
    acts = [mon.observe(t) for t in [1.0] * 5 + [3.0, 3.0, 1.0]]
    assert acts == ["ok"] * 5 + ["warn", "escalate", "ok"]


# -------------------------------------------------------------- launcher


def test_train_cli_smoke_prints_reference_line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = tlaunch.main(["--arch", "schnet", "--smoke", "--steps", "6",
                             "--device", "cpu"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert line == (f"[train] schnet: first loss {hist[0]['loss']:.4f}, "
                    f"last loss {hist[-1]['loss']:.4f}")
    assert len(hist) == 6 and np.isfinite([h["loss"] for h in hist]).all()


def test_train_cli_refuses_unported():
    """LM training still raises (A11); wide-deep, which raised before it
    was ported, now trains."""
    with pytest.raises(NotImplementedError, match="A11"):
        tlaunch.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu"])
    hist = tlaunch.main(["--arch", "wide-deep", "--smoke", "--steps", "2",
                         "--device", "cpu"])
    assert len(hist) == 2 and np.isfinite([h["loss"] for h in hist]).all()


def test_train_cli_ckpt_dir_resumes(tmp_path):
    d = str(tmp_path / "ck")
    argv = ["--arch", "schnet", "--smoke", "--device", "cpu", "--ckpt-dir", d]
    first = tlaunch.main([*argv, "--steps", "2"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rest = tlaunch.main([*argv, "--steps", "4"])
    assert "[trainer] restored checkpoint at step 2" in buf.getvalue()
    assert [h["step"] for h in first + rest] == [0, 1, 2, 3]
    assert ckpt_lib.latest_step(d) == 4


def test_equiformer_deep_update_vanishes_like_reference():
    """At its published depth EquiformerV2's gradients at initialisation
    overflow the float32 global norm (each equivariant layer norm divides
    an all-zero l > 0 block by sqrt(1e-6)); the reference's AdamW then
    clips every update to 0.  The port reproduces that, rather than
    training where the reference does not (the published config with 8
    channels instead of 128: the published depth 12, l_max, m_max and
    heads)."""
    import dataclasses

    from repro import configs as jconfigs
    from repro.models.gnn import EquiformerV2 as JEquiformer
    from repro.optim import global_norm as jglobal_norm
    cfg = dataclasses.replace(jconfigs.get("equiformer-v2").make_config(),
                              channels=8)
    jmodel = JEquiformer(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = GraphBatchStream(batch=4, n_nodes=30, n_edges=64).batch_at(0)

    def jloss(p, b):
        e = jax.vmap(lambda g: jnp.sum(jmodel.forward(p, g)[..., 0]))(
            {k: v for k, v in b.items() if k != "energy"})
        return jnp.mean(jnp.square(e - b["energy"]))
    _, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tcfg = dataclasses.replace(configs.get("equiformer-v2").make_config(),
                               channels=8)
    model = convert.gnn_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    params = list(model.parameters())
    grads = torch.autograd.grad(molecule_loss(model, molecule_union(
        batch, "cpu")), params)
    assert max(float(g.abs().max()) for g in grads) > 1e19
    assert np.isinf(float(jglobal_norm(jgrads)))
    assert torch.isinf(global_norm(grads))
    new, _ = AdamW(lr=1e-3).update(grads, AdamW(lr=1e-3).init(params),
                                   params)
    assert all(torch.equal(p, q) for p, q in zip(params, new))
    jnew, _ = JAdamW(lr=1e-3).update(jgrads, JAdamW(lr=1e-3).init(jparams),
                                     jparams)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
               zip(jax.tree.leaves(jnew), jax.tree.leaves(jparams)))
