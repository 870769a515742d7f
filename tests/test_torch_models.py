"""The PyTorch port's LM against the JAX reference, on the CPU.

The reduced configurations of the three dense LMs (qwen3-1.7b with
qk_norm, deepseek-7b with MHA, minitron-4b with 3 q heads over one kv
head) run in both packages on the same weights (the reference's
``LM.init``, carried over by ``models.convert.lm_from_numpy``) and the
same numpy tokens.  The reference's CPU prefill attends through
``attention_ref_chunked``; the port's through the flash kernel's plain
version.  Tolerances: ``compute_dtype=float32`` to 1e-4 (both sum in
f32, in other orders); bf16 to 6e-2, the reference's own serving
tolerance (``tests/test_models_smoke.py``): XLA fuses bf16 elementwise
chains in f32 where torch rounds after each op, which moves logits of
size ~5 by one or two bf16 steps (0.03).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models.transformer import LM as JLM
from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models.convert import lm_from_numpy, lm_to_numpy
from repro_torch.models.transformer import LM

torch.set_num_threads(1)

DENSE = ["qwen3-1.7b", "deepseek-7b", "minitron-4b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 6e-2}


def _pair(arch, dt, **over):
    """The reference's and the port's model on the same weights."""
    jdt, tdt = DTYPES[dt]
    jcfg = dataclasses.replace(jconfigs.get(arch).make_reduced(),
                               compute_dtype=jdt, **over)
    tcfg = dataclasses.replace(configs.get(arch).make_reduced(),
                               compute_dtype=tdt, **over)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = lm_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _close(got, want, dt):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


def _tokens(vocab, b=2, t=32, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def test_configs_match_reference():
    for arch in DENSE + ["llama4-maverick-400b-a17b", "arctic-480b"]:
        for make in ("make_config", "make_reduced"):
            j = getattr(jconfigs.get(arch), make)()
            t = getattr(configs.get(arch), make)()
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            for key in ("compute_dtype", "param_dtype"):
                assert str(jd.pop(key)).split(".")[-1].rstrip("'>") in \
                    str(td.pop(key))
            assert jd == td, arch
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
    assert configs.get("qwen3-1.7b").make_config().param_count() \
        == 2_031_732_736
    for arch in DENSE:
        assert ({k: dataclasses.asdict(c)
                 for k, c in configs.get(arch).shapes.items()}
                == {k: dataclasses.asdict(c)
                    for k, c in jconfigs.get(arch).shapes.items()})
    for arch in ("meshgraphnet", "schnet", "mace", "equiformer-v2"):
        assert configs.get(arch).family == "gnn"      # ported (GNN slice)
        for make in ("make_config", "make_reduced"):
            assert (dataclasses.asdict(getattr(configs.get(arch), make)())
                    == dataclasses.asdict(getattr(jconfigs.get(arch),
                                                  make)()))
    assert configs.get("wide-deep").family == "recsys"    # ported (A11)
    for make in ("make_config", "make_reduced"):
        assert (dataclasses.asdict(getattr(configs.get("wide-deep"), make)())
                == dataclasses.asdict(getattr(jconfigs.get("wide-deep"),
                                              make)()))
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_and_rope(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).astype(np.int32)
    tx = torch.as_tensor(x).to(tdt)
    _close(layers.rms_norm(tx, torch.as_tensor(scale)),
           jlayers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale)), dt)
    _close(layers.rope(tx, torch.as_tensor(pos), 1e6),
           jlayers.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e6), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (3, 1)])
def test_decode_attend(dt, hq, hkv):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(hq * 10 + hkv)
    q = rng.normal(size=(2, 1, hq, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, hkv, 16)).astype(np.float32)
    valid = np.arange(24) <= 17
    got = layers._decode_attend(*(torch.as_tensor(a).to(tdt)
                                  for a in (q, k, v)), torch.as_tensor(valid))
    want = jlayers._decode_attend(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  jnp.asarray(valid))
    assert got.dtype == tdt and got.shape == (2, 1, hq, 16)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode(arch, dt):
    """forward logits, prefill logits and cache, and one decode step."""
    jm, params, tm = _pair(arch, dt)
    t = 32
    toks = _tokens(jm.cfg.vocab, t=t)
    jl, _, _ = jm.forward(params, jnp.asarray(toks))
    tl, aux, _ = tm.forward(torch.as_tensor(toks, dtype=torch.long))
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    _close(tl, jl, dt)

    jlog, (jk, jv) = jm.prefill(params, jnp.asarray(toks[:, :-1]))
    tlog, (tk, tv) = tm.prefill(torch.as_tensor(toks[:, :-1]), cache_len=t)
    _close(tlog, jlog, dt)
    assert tk.shape == (jm.cfg.n_layers, 2, t, jm.cfg.n_kv_heads,
                        jm.cfg.d_head)
    assert tk.dtype == DTYPES[dt][1]
    _close(tk[:, :, :t - 1], jk, dt)
    _close(tv[:, :, :t - 1], jv, dt)
    assert not tk[:, :, t - 1:].any()        # the padding, as serve's

    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jd, (jk2, _) = jm.decode_step(params, (jnp.pad(jk, pad),
                                           jnp.pad(jv, pad)),
                                  jnp.asarray(toks[:, -1:]),
                                  jnp.array(t - 1, jnp.int32))
    td, (tk2, _) = tm.decode_step((tk, tv), torch.as_tensor(toks[:, -1:]),
                                  t - 1)
    _close(td, jd, dt)
    _close(tk2, jk2, dt)                     # written in place at t - 1
    assert tk2 is tk


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chunked_attention_and_layer_groups(dt):
    """A dense config with chunked-local attention (chunk 8 < S), and one
    with the llama4 grouping (layer_group 2: a local and a global layer):
    forward, and a decode step inside and past the first chunk."""
    for over in (dict(attention="chunked", chunk_size=8),
                 dict(attention="chunked", chunk_size=8, n_layers=4,
                      layer_group=2)):
        jm, params, tm = _pair("qwen3-1.7b", dt, **over)
        t = 24                                # three chunks
        toks = _tokens(jm.cfg.vocab, t=t, seed=2)
        jl, _, _ = jm.forward(params, jnp.asarray(toks))
        tl, _, _ = tm.forward(torch.as_tensor(toks))
        _close(tl, jl, dt)
        for p in (5, 20):
            _, (jk, jv) = jm.prefill(params, jnp.asarray(toks[:, :p]))
            pad = ((0, 0), (0, 0), (0, t - p), (0, 0), (0, 0))
            jd, _ = jm.decode_step(params, (jnp.pad(jk, pad),
                                            jnp.pad(jv, pad)),
                                   jnp.asarray(toks[:, p:p + 1]),
                                   jnp.array(p, jnp.int32))
            _, cache = tm.prefill(torch.as_tensor(toks[:, :p]), cache_len=t)
            td, _ = tm.decode_step(cache, torch.as_tensor(toks[:, p:p + 1]),
                                   p)
            _close(td, jd, dt)
            _close(td, tl[:, p], dt)          # decode == forward


def test_prefill_decode_consistency_f32():
    """decode_step(pos=T-1) after prefill(tokens[:, :T-1]) equals the
    last position of forward(tokens): the serving path is exact."""
    _, _, tm = _pair("qwen3-1.7b", "f32")
    toks = torch.as_tensor(_tokens(tm.cfg.vocab, t=16))
    full, _, _ = tm.forward(toks)
    _, cache = tm.prefill(toks[:, :-1], cache_len=16)
    got, _ = tm.decode_step(cache, toks[:, -1:], 15)
    torch.testing.assert_close(got, full[:, -1], atol=1e-5, rtol=1e-5)


def test_convert_round_trip_and_init():
    jm, params, tm = _pair("qwen3-1.7b", "f32")
    tree = jax.tree.map(np.asarray, params)
    back = lm_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own initialisation: the reference's shapes, dtypes and
    # scales (1/sqrt(fan-in), embed 0.02, norms one), from a generator
    cfg = configs.get("qwen3-1.7b").make_reduced()
    mine = lm_to_numpy(LM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3)))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if "norm" in str(path) or "ln" in str(path):
            assert (b == 1).all()
        else:
            assert abs(b.std() / a.std() - 1) < 0.1, path
    again = lm_to_numpy(LM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3)))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(mine), jax.tree.leaves(again)))


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "arctic-480b"])
def test_moe_raises(arch):
    """Once the MoE LMs raised (A11); now ported: the reduced config
    builds with a ``moe`` module in every block, and its forward gives
    finite logits and a positive aux loss (``tests/test_torch_moe.py``
    holds them against the reference)."""
    cfg = configs.get(arch).make_reduced()
    assert cfg.moe
    lm = LM(cfg, device="cpu")
    assert all(hasattr(b, "moe") and not hasattr(b, "ffn")
               for b in lm.blocks)
    assert sum(p.numel() for p in lm.parameters()) == cfg.param_count()
    logits, aux, _ = lm(torch.as_tensor(_tokens(cfg.vocab), dtype=torch.long))
    assert logits.shape == (2, 32, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0
    x = torch.zeros(1, 1, cfg.d_model, dtype=cfg.compute_dtype)
    out, aux = layers.moe_ffn(lm.blocks[0].moe.weights(), cfg, x)
    assert out.shape == x.shape and aux.dtype == torch.float32


@pytest.mark.parametrize("arch", DENSE)
def test_init_in_place_keeps_the_draws(arch):
    """``LM.init_weights`` draws into each parameter and scales it in
    place; the bits are those of the earlier ``p.copy_(torch.randn(...) *
    scale)``, drawn from the same generator in the same order."""
    cfg = configs.get(arch).make_reduced()
    got = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    want = LM(cfg, device="cpu", init=False)
    with torch.no_grad():
        for name, p in want.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
                p.fill_(1.0)
                continue
            scale = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
            p.copy_(torch.randn(p.shape, generator=gen,
                                dtype=torch.float32) * scale)
    for (name, a), b in zip(got.named_parameters(), want.parameters()):
        assert torch.equal(a, b), name
