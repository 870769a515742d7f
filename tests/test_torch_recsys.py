"""The port's Wide & Deep, its optimizers and its launchers against the JAX
reference (``src/repro/models/recsys.py``), on the CPU.

Weights are carried from the reference (``convert.widedeep_from_numpy``)
and batches are the same numpy draws, so both packages compute the same
function:

- ``forward``, ``user_tower``, ``retrieval_scores`` and ``loss`` agree to
  1e-5 relative in float32 at the reduced config and at a full-width one
  (the published 40 fields, ``embed_dim`` 32, MLP 1024-512-256, 13 dense
  inputs and 2 ids a field, with every vocab cut to 2^10).  The top-100
  indices are equal where the values are distinct.
- Four training steps with ``AdamW`` and four with ``HybridAdamW`` give
  losses within 1e-5 relative and parameters within 1e-5 relative in the
  2-norm of each tensor.  Not entry by entry: Adam's first steps move an
  entry by about +-lr whatever its gradient's size, so an entry whose
  gradient cancels to about 0 may move the other way in the other
  framework (a few in 10^4 entries here, each by at most ~lr).
- Configs, ``recsys_shapes()`` and the launchers' printed lines equal the
  reference's.
"""
import dataclasses
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.launch.train import build_smoke as jbuild_smoke
from repro.models import recsys as jrecsys
from repro.optim import AdamW as JAdamW
from repro.optim import HybridAdamW as JHybrid
from repro_torch import configs
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert, recsys
from repro_torch.optim import AdamW, HybridAdamW

torch.set_num_threads(1)

RTOL = 1e-5


def _full_width():
    """The published widths with every vocab cut to 2^10."""
    return dict(name="wide-deep-full-width", n_sparse=40, embed_dim=32,
                mlp=(1024, 512, 256), n_dense=13, ids_per_field=2,
                vocab_sizes=(1 << 10,) * 40)


def _configs(which):
    """``(reference config, port config)`` of ``which``."""
    if which == "reduced":
        return (jconfigs.get("wide-deep").make_reduced(),
                configs.get("wide-deep").make_reduced())
    return (jrecsys.WideDeepConfig(**_full_width()),
            recsys.WideDeepConfig(**_full_width()))


def _models(which, seed=0):
    jcfg, cfg = _configs(which)
    jm = jrecsys.WideDeep(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, convert.widedeep_from_numpy(cfg, tree, device="cpu")


def _batch(cfg, b, seed=0, candidates=0):
    rng = np.random.default_rng(seed)
    out = {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
           "sparse_ids": np.stack(
               [rng.integers(0, v, (b, cfg.ids_per_field))
                for v in cfg.vocab_sizes], axis=1).astype(np.int32),
           "labels": rng.integers(0, 2, (b,)).astype(np.float32)}
    if candidates:
        out["candidates"] = rng.normal(
            size=(candidates, cfg.retrieval_dim)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("which", ["reduced", "full-width"])
def test_forward_tower_loss_match_reference(which):
    jm, params, m = _models(which)
    b = _batch(m.cfg, 64, seed=1)
    with torch.no_grad():
        logits = m(_t(b))
        tower = m.user_tower(_t(b))
        loss = m.loss(_t(b))
    want = np.asarray(jm.forward(params, b))
    scale = np.abs(want).max()
    assert logits.shape == (64,) and logits.dtype == torch.float32
    _close(logits, want, atol=RTOL * scale)
    jt = np.asarray(jm.user_tower(params, b))
    assert tower.shape == (64, m.cfg.retrieval_dim)
    _close(tower, jt, atol=RTOL * np.abs(jt).max())
    _close(loss, jm.loss(params, b))


@pytest.mark.parametrize("which", ["reduced", "full-width"])
def test_retrieval_scores_match_reference(which):
    jm, params, m = _models(which)
    b = _batch(m.cfg, 1, seed=2, candidates=4096)
    with torch.no_grad():
        vals, idx = m.retrieval_scores(_t(b))
    jv, ji = (np.asarray(x) for x in jm.retrieval_scores(params, b))
    assert vals.shape == idx.shape == (100,)
    _close(vals, jv, atol=RTOL * np.abs(jv).max())
    distinct = np.ones(100, bool)
    distinct[1:] &= np.diff(jv) != 0
    distinct[:-1] &= np.diff(jv) != 0
    assert distinct.sum() > 90
    np.testing.assert_array_equal(idx.numpy()[distinct], ji[distinct])


def test_param_tree_names_and_counts():
    jm, params, m = _models("reduced")
    tree = convert.widedeep_to_numpy(m)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    assert jax.tree.all(jax.tree.map(np.array_equal, tree,
                                     jax.tree.map(np.asarray, params)))
    names = list(m.params())
    assert "tables/t0" in names and "wide_tables/t5" in names
    assert "mlp/1/w" in names and "query_proj" in names
    # the reference's count leaves out query_proj and counts bias twice
    cfg = m.cfg
    assert (sum(p.numel() for p in m.parameters()) ==
            cfg.param_count() - 1 + cfg.mlp[-1] * cfg.retrieval_dim)
    pub = configs.get("wide-deep").make_config()
    assert pub.param_count() == 2_521_512_975
    # the deep and the wide tables, in float32
    assert sum(pub.vocab_sizes) * (pub.embed_dim + 1) * 4 == 10_078_126_080


def test_sharded_lookup_and_specs_raise_naming_a6():
    cfg = configs.get("wide-deep").make_reduced()
    with pytest.raises(NotImplementedError, match="A6"):
        recsys.WideDeep(cfg, lookup="collective", device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        recsys.WideDeep(cfg, device="cpu").param_specs()


def test_init_distributions_follow_reference():
    cfg = recsys.WideDeepConfig(**_full_width())
    m = recsys.WideDeep(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    t = m.tables["t0"].detach()
    assert abs(float(t.std()) - 0.01) < 1e-3
    assert not m.wide_tables["t0"].detach().any()
    w = m.mlp[0].w.detach()
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.02
    assert not m.mlp[0].b.detach().any() and not m.bias.detach().any()
    again = recsys.WideDeep(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.head, m.head)              # seeded


# ---------------------------------------------------------------- training


def _flat(tree):
    """The reference's tree as ``{path: array}``."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in kp)
        out[name] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("which", ["reduced", "full-width"])
@pytest.mark.parametrize("opt", ["adamw", "hybrid"])
def test_train_steps_match_reference(which, opt):
    jm, params, m = _models(which)
    if opt == "adamw":
        jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    else:
        jopt = JHybrid(adamw=JAdamW(lr=1e-3, clip_norm=None), sgd_lr=0.05)
        topt = HybridAdamW(adamw=AdamW(lr=1e-3, clip_norm=None), sgd_lr=0.05)
    jstep = jax.jit(jrecsys.make_recsys_train_step(jm, jopt))
    step = recsys.make_recsys_train_step(m, topt)
    tp = m.params()
    jst, st = jopt.init(params), topt.init(tp)
    for i in range(4):
        b = _batch(m.cfg, 32, seed=10 + i)
        params, jst, jmet = jstep(params, jst, b)
        tp, st, met = step(tp, st, _t(b))
        _close(met["loss"], jmet["loss"])
    want = _flat(params)
    assert set(want) == set(tp)
    for name, p in tp.items():
        diff = np.linalg.norm(p.detach().numpy() - want[name])
        assert diff <= RTOL * np.linalg.norm(want[name]), name
    assert int(st.count) == int(jst.count) == 4


def test_hybrid_adamw_table_split():
    """``tests/test_optim.py::test_hybrid_adamw_table_split`` on both
    packages."""
    jparams = {"tables": {"t0": jnp.ones((8, 4))}, "mlp": jnp.ones((4, 4))}
    jopt = JHybrid(adamw=JAdamW(lr=1e-2, clip_norm=None), sgd_lr=0.1)
    jst = jopt.init(jparams)
    jp2, jst2 = jopt.update(jax.tree.map(jnp.ones_like, jparams), jst,
                            jparams)
    params = {"tables/t0": torch.ones((8, 4)), "mlp": torch.ones((4, 4))}
    opt = HybridAdamW(adamw=AdamW(lr=1e-2, clip_norm=None), sgd_lr=0.1)
    st = opt.init(params)
    # tables carry no moments (scalar placeholders)
    assert st.mu[0].shape == () == jst.mu["tables"]["t0"].shape
    assert st.mu[1].shape == (4, 4) == jst.mu["mlp"].shape
    p2, st2 = opt.update([torch.ones_like(p) for p in params.values()], st,
                         params)
    np.testing.assert_allclose(p2[0].numpy(), 0.9, rtol=1e-6)
    np.testing.assert_array_equal(p2[0].numpy(), jp2["tables"]["t0"])
    assert not np.allclose(p2[1].numpy(), params["mlp"].numpy())
    _close(p2[1], jp2["mlp"], rtol=1e-6)
    assert int(st2.count) == int(jst2.count) == 1
    assert torch.equal(params["tables/t0"], torch.ones((8, 4)))   # pure


def test_hybrid_adamw_step_in_place_equals_update():
    _, _, m = _models("reduced")
    opt = HybridAdamW(adamw=AdamW(lr=1e-2))
    params = m.params()
    st = opt.init(params)
    rng = np.random.default_rng(4)
    grads = [torch.as_tensor(rng.normal(size=p.shape).astype(np.float32))
             for p in params.values()]
    want, wst = opt.update(grads, st, params)
    sgd = {n: (p.detach() - 0.05 * g) for (n, p), g in
           zip(params.items(), grads) if "tables" in n}
    st2 = opt.step(params, grads, st)
    for p, w in zip(params.values(), want):
        assert torch.equal(p.detach(), w)
    for a, b in zip(st2.mu + st2.nu, wst.mu + wst.nu):
        assert torch.equal(a, b)
    assert len(sgd) == 12                 # tables and wide_tables
    for n, w in sgd.items():              # SGD: p - sgd_lr * g exactly
        assert torch.equal(params[n].detach(), w)
        assert st2.mu[list(params).index(n)].shape == ()


# ----------------------------------------------------------------- configs


def test_configs_and_shapes_match_reference():
    spec, jspec = configs.get("wide-deep"), jconfigs.get("wide-deep")
    assert spec.family == jspec.family == "recsys"
    assert spec.source == jspec.source
    for make in ("make_config", "make_reduced"):
        assert (dataclasses.asdict(getattr(spec, make)())
                == dataclasses.asdict(getattr(jspec, make)()))
    assert ({k: dataclasses.asdict(c) for k, c in tbase.recsys_shapes().items()}
            == {k: dataclasses.asdict(c)
                for k, c in jbase.recsys_shapes().items()})
    assert spec.shapes == tbase.recsys_shapes()
    assert recsys.default_vocab_sizes() == jrecsys.default_vocab_sizes()
    assert recsys.default_vocab_sizes(7) == jrecsys.default_vocab_sizes(7)
    assert sum(recsys.default_vocab_sizes()) == 76_349_440


# --------------------------------------------------------------- launchers

SERVE_LINE = re.compile(r"\[serve\] wide-deep: batch (\d+) in (\d+) "
                        r"us/req-batch")


def test_serve_cli_prints_reference_line(capsys):
    jserve.serve_recsys(batch=4)
    want = SERVE_LINE.search(capsys.readouterr().out)
    scores = serve.main(["--arch", "wide-deep", "--smoke", "--device",
                         "cpu"])
    got = SERVE_LINE.search(capsys.readouterr().out)
    assert want and got and got.group(1) == want.group(1) == "4"
    assert scores.shape == (4,) and np.isfinite(scores).all()
    again = serve.serve_recsys(batch=4, device="cpu")
    np.testing.assert_array_equal(again, scores)               # seeded


def test_serve_recsys_with_carried_weights_matches_reference():
    jm, params, m = _models("reduced")
    want = jserve.serve_recsys(batch=16)      # the reference's own weights
    jcfg = jconfigs.get("wide-deep").make_reduced()
    ref_params = jrecsys.WideDeep(jcfg).init(jax.random.PRNGKey(0))
    m = convert.widedeep_from_numpy(
        m.cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    got, stats = serve.serve_recsys(batch=16, model=m, return_stats=True)
    _close(got, want, atol=RTOL * np.abs(want).max())
    assert len(stats["batch_ms"]) == 10


def test_train_cli_first_loss_matches_reference_with_carried_weights():
    jstep, jparams, jst, jstream = jbuild_smoke("wide-deep")
    _, _, jmet = jstep(jparams, jst, jstream.batch_at(0))
    step, params, st, stream, put = tlaunch.build("wide-deep", smoke=True,
                                                  device="cpu")
    carried = _flat(jparams)
    assert set(carried) == set(params)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.tensor(carried[name]))
    _, _, met = step(params, st, put(stream.batch_at(0)))
    _close(met["loss"], jmet["loss"])
    assert stream.batch == 32 and stream.ids_per_field == 2

    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = tlaunch.main(["--arch", "wide-deep", "--smoke", "--steps",
                             "3", "--device", "cpu"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert line == (f"[train] wide-deep: first loss {hist[0]['loss']:.4f}, "
                    f"last loss {hist[-1]['loss']:.4f}")
