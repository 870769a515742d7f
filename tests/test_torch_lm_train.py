"""LM training in the PyTorch port against the JAX reference, on the CPU.

The attention gradient (``kernels.flash_attention.flash_attention_bwd``)
is held against ``jax.vjp`` of the reference's ``attention_ref_chunked``,
which is what the reference's training step differentiates off the TPU
(its Pallas kernel has no backward).  The three dense LMs at their reduced
configurations (qwen3-1.7b with qk_norm, deepseek-7b with MHA,
minitron-4b with 3 q heads over one kv head) run ``LM.loss``, its
gradients and one ``make_train_step`` in both packages on the same
weights (the reference's ``LM.init`` through ``models.convert``) and the
same ``TokenStream`` batch; gradients are compared leaf by leaf in the
reference's stacked tree (``convert.lm_to_numpy``).

Tolerances, and why:

- ``flash_attention_bwd``: float32 to 1e-5 of each gradient's largest
  entry (both sum in f32, in other orders); bfloat16 to 2^-7 of it (both
  compute in f32 and round the gradient to bf16 once: one bf16 step).
- LM, ``compute_dtype=float32``: loss 1e-5 relative, gradients 1e-4 of
  each leaf's largest entry (measured: 2.3e-6 at most), parameters after
  one AdamW step 2e-5 absolute (measured 6.6e-6).
- LM, bfloat16 (the configs' default): gradients to ``TOL["bf16"]`` =
  6e-2 of each leaf's largest entry, the serving tolerance of
  ``tests/test_torch_models.py`` (measured 3.8e-2: XLA fuses bf16
  elementwise chains in f32 where torch rounds after each op), loss 1e-3
  relative (measured 2.2e-4).  AdamW's first step moves an entry by
  ``lr * g / |g|``, so an entry whose gradient is near 0 may move the
  other way in the other package: every entry is within ``2 lr`` of the
  reference's, and fewer than 1% by more than 1e-4 (measured 0.33%).
- Trainer: 6 losses within 2e-3 relative of the reference's (bf16).
- Remat, resumes: bit for bit.
"""
import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import TokenStream as JTokens
from repro.kernels import ref as jref
from repro.launch.train import build_smoke as jbuild_smoke
from repro.models.transformer import LM as JLM
from repro.models.transformer import make_train_step as jmake_train_step
from repro.optim import AdamW as JAdamW
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models.transformer import LM, make_train_step
from repro_torch.optim import AdamW
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(1)

DENSE = ["qwen3-1.7b", "deepseek-7b", "minitron-4b"]
MOE = ["llama4-maverick-400b-a17b", "arctic-480b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BWD_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-3}
GRAD_TOL = {"f32": 1e-4, "bf16": 6e-2}
LR = 1e-3


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# ------------------------------------------------------ attention gradient


def _attn_inputs(hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((2, hq, sq, d), (2, hkv, sk, d), (2, hkv, sk, d),
             (2, hq, sq, d))]


def _jax_attn_grads(arrays, dt, causal):
    jq, jk, jv, jdo = (jnp.asarray(a).astype(DTYPES[dt][0]) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref_chunked(
        q, k, v, causal=causal), jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [16, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (3, 1)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_matches_jax_grad(dt, heads, causal, s, d, monkeypatch):
    """64 query rows a step, so S = 128 and 256 span several blocks."""
    monkeypatch.setattr(fa, "bwd_block_rows", lambda *shape: 64)
    arrays = _attn_inputs(*heads, s, s, d)
    want = _jax_attn_grads(arrays, dt, causal)
    q, k, v, dout = (torch.as_tensor(a).to(DTYPES[dt][1]) for a in arrays)
    got = fa.flash_attention_bwd(q, k, v, dout, causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel(g, w) <= BWD_TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_queries_at_the_end(dt, monkeypatch):
    """Sq < Sk: the queries are the last Sq positions, as in the forward;
    the default block (all 96 rows), blocks of 37 rows (a ragged last
    one) and of one row agree."""
    arrays = _attn_inputs(4, 2, 96, 160, 16, seed=3)
    want = _jax_attn_grads(arrays, dt, True)
    q, k, v, dout = (torch.as_tensor(a).to(DTYPES[dt][1]) for a in arrays)
    got = fa.flash_attention_bwd(q, k, v, dout)
    for g, w in zip(got, want):
        assert _rel(g, w) <= BWD_TOL[dt]
    for rows in (37, 1):
        monkeypatch.setattr(fa, "bwd_block_rows", lambda *shape: rows)
        for a, b in zip(fa.flash_attention_bwd(q, k, v, dout), got):
            torch.testing.assert_close(a, b, rtol=BWD_TOL[dt],
                                       atol=BWD_TOL[dt])


def test_flash_bwd_refuses_more_queries_than_keys():
    q, k, v, dout = (torch.as_tensor(a) for a in
                     _attn_inputs(2, 1, 32, 16, 16))
    with pytest.raises(ValueError, match="Sq=32 > Sk=16"):
        fa.flash_attention_bwd(q, k, v, dout)
    with pytest.raises(ValueError, match="gradient contract"):
        ops.flash_attention(q.requires_grad_(), k, v)


def test_flash_attention_autograd_routes_through_the_function():
    """With grad enabled and an input that requires it, ``ops.
    flash_attention`` is ``FlashAttentionFn``: the plain forward's values
    and ``flash_attention_bwd``'s gradient; without, the plain path as
    before.  The CPU counts no launch, forward or backward."""
    arrays = _attn_inputs(4, 2, 128, 128, 16, seed=1)
    q, k, v, dout = (torch.as_tensor(a) for a in arrays)
    before = dict(ops.LAUNCHES)
    plain = ops.flash_attention(q, k, v)
    assert plain.grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(out.detach(), plain)
    out.backward(dout)
    want = fa.flash_attention_bwd(q, k, v, dout)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    assert ops.LAUNCHES == before


def test_bwd_block_rows_budget():
    # the training shape: 1024 rows of 4096 keys over (2, 16) heads is
    # one 512 MiB float32 temporary
    assert fa.bwd_block_rows(2, 16, 4096, 4096) == 1024
    assert fa.bwd_block_rows(1, 4, 32, 32) == 32
    assert fa.bwd_block_rows(1 << 12, 64, 1 << 14, 1 << 14) == 1


# --------------------------------------------------------- loss, gradients


def _pair(arch, dt, **over):
    """The reference's model and parameters and the port's model on the
    same weights."""
    jdt, tdt = DTYPES[dt]
    jcfg = dataclasses.replace(jconfigs.get(arch).make_reduced(),
                               compute_dtype=jdt, **over)
    tcfg = dataclasses.replace(configs.get(arch).make_reduced(),
                               compute_dtype=tdt, **over)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    return jm, params, tm


def _batch(vocab, step=0):
    host = JTokens(4, 32, vocab, seed=0).batch_at(step)
    return host, {k: torch.as_tensor(v).long() for k, v in host.items()}


def _leaves(tree) -> dict:
    return dict(ckpt_lib.leaves(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch, dt):
    jm, params, tm = _pair(arch, dt)
    host, batch = _batch(jm.cfg.vocab)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, host))
    loss, met = tm.loss(batch)
    assert set(met) == set(jmet) == {"nll", "aux"}
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL[dt] * float(jloss)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    got, want = _leaves(convert.lm_to_numpy(tm, grads)), _leaves(jgrads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= GRAD_TOL[dt], name


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch, dt):
    jm, params, tm = _pair(arch, dt)
    host, batch = _batch(jm.cfg.vocab)
    jopt = JAdamW(lr=LR)
    jp, js, jmet = jax.jit(jmake_train_step(jm, jopt))(
        params, jopt.init(params), jax.tree.map(jnp.asarray, host))
    opt = AdamW(lr=LR)
    ps = list(tm.parameters())
    before = [p.detach().clone() for p in ps]
    out, st, met = make_train_step(tm, opt)(ps, opt.init(ps), batch)
    assert out is ps and int(st.count) == int(js.count) == 1
    assert set(met) == set(jmet) == {"nll", "aux", "loss"}
    assert abs(float(met["loss"]) - float(jmet["loss"])) \
        <= LOSS_TOL[dt] * float(jmet["loss"])
    assert any(not torch.equal(p, b) for p, b in zip(ps, before))
    got, want = _leaves(convert.lm_to_numpy(tm)), _leaves(jp)
    off = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        if dt == "f32":
            assert diff.max() <= 2e-5, name
        else:
            assert diff.max() <= 2 * LR * (1 + 1e-3) + 1e-6, name
        off += int((diff > 1e-4).sum())
        total += diff.size
    assert off < 0.01 * total
    for name, w in _leaves(js.mu).items():
        m = _leaves(convert.lm_to_numpy(tm, st.mu))[name]
        assert _rel(m, w) <= 10 * GRAD_TOL[dt], name


@pytest.mark.parametrize("arch", DENSE)
def test_remat_gives_the_same_gradients(arch):
    """remat on and off: the same loss and gradients bit for bit, with the
    attention recomputed in the backward (twice the flash calls) and less
    saved for the backward."""
    grads, calls, saved = {}, {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(configs.get(arch).make_reduced(),
                                  remat=remat)
        lm = LM(cfg, device="cpu")
        _, batch = _batch(cfg.vocab)
        nbytes = [0]
        real, n = ops.note_kernel, [0]

        def note(name, *a, real=real, n=n):
            n[0] += name == "flash_attention"
            return real(name, *a)

        def pack(t, nbytes=nbytes):
            nbytes[0] += t.numel() * t.element_size()
            return t
        ops.note_kernel = note
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss, _ = lm.loss(batch)
            grads[remat] = torch.autograd.grad(loss, list(lm.parameters()))
        finally:
            ops.note_kernel = real
        calls[remat], saved[remat] = n[0], nbytes[0]
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    assert calls == {False: cfg.n_layers, True: 2 * cfg.n_layers}
    assert saved[True] < saved[False] / 2


def test_serving_unchanged_by_training():
    """The parameters require grad, yet ``forward``, ``prefill`` and
    ``decode_step`` stay no-grad (no graph is built) and give the same
    bits as on a copy whose parameters require none."""
    cfg = configs.get("qwen3-1.7b").make_reduced()
    live = LM(cfg, device="cpu")
    frozen = LM(cfg, device="cpu").requires_grad_(False)
    assert all(p.requires_grad for p in live.parameters())
    assert not any(p.requires_grad for p in frozen.parameters())
    toks = torch.as_tensor(_batch(cfg.vocab)[0]["tokens"]).long()
    a, b = frozen(toks)[0], live(toks)[0]
    assert b.grad_fn is None and torch.equal(a, b)
    la, ca = frozen.prefill(toks[:, :16], cache_len=32)
    lb, cb = live.prefill(toks[:, :16], cache_len=32)
    assert torch.equal(la, lb) and all(map(torch.equal, ca, cb))
    da, _ = frozen.decode_step(ca, toks[:, 16:17], 16)
    db, _ = live.decode_step(cb, toks[:, 16:17], 16)
    assert db.grad_fn is None and torch.equal(da, db)


def test_lm_to_numpy_round_trip():
    _, params, tm = _pair("qwen3-1.7b", "f32")
    tree = convert.lm_to_numpy(tm)
    want = _leaves(params)
    assert _leaves(tree).keys() == want.keys()
    for name, arr in _leaves(tree).items():
        np.testing.assert_array_equal(arr, want[name])
    parts = convert.lm_list(tm, tree)
    assert all(np.array_equal(a, p.detach().numpy())
               for a, p in zip(parts, tm.parameters()))
    tree["blocks"]["ln1"] = tree["blocks"]["ln1"][:, :3]
    with pytest.raises(ValueError, match="blocks.0.ln1"):
        convert.lm_list(tm, tree)


# ---------------------------------------------------- trainer, checkpoints


@pytest.mark.parametrize("arch", DENSE)
def test_trainer_tracks_reference_history(arch):
    jstep, jparams, jstate, jstream = jbuild_smoke(arch)
    weights = jax.tree.map(np.asarray, jparams)  # the trainer donates them
    jhist = JTrainer(jstep, jparams, jstate, jstream,
                     JTrainerConfig(num_steps=6, log_every=100),
                     put_batch=lambda b: jax.tree.map(jnp.asarray, b)).run()
    model = convert.lm_from_numpy(configs.get(arch).make_reduced(), weights,
                                  device="cpu")
    opt = AdamW(lr=LR)
    params = list(model.parameters())
    hist = Trainer(make_train_step(model, opt), params, opt.init(params),
                   TokenStream(batch=4, seq=32, vocab=model.cfg.vocab,
                               seed=0),
                   TrainerConfig(num_steps=6, log_every=100),
                   put_batch=lambda b: {k: torch.as_tensor(v).long()
                                        for k, v in b.items()}).run()
    assert [h["step"] for h in hist] == list(range(6))
    for key in ("loss", "nll", "aux"):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in jhist], rtol=2e-3)


def _smoke_trainer(arch, steps, ckpt_dir=None, ckpt_every=50):
    """The launcher's reduced model on the smoke stream (weights from seed
    0, so every call starts from the same ones)."""
    step, params, opt_state, stream, put, layout = tlaunch.build(
        arch, 0, smoke=True, device="cpu")
    return Trainer(step, params, opt_state, stream,
                   TrainerConfig(num_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=ckpt_every, log_every=100),
                   put_batch=put, layout=layout)


def _state(tr) -> dict:
    """A port trainer's state by the reference's leaf names."""
    return dict(ckpt_lib.leaves(tr.layout.tree(tr.params, tr.opt_state)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minitron-4b"])
def test_lm_resume_bit_identical(arch, tmp_path):
    """4 steps with a checkpoint every 2, then a fresh trainer resumes at
    step 4 and runs to 6: the losses, parameters and AdamW state equal an
    uninterrupted 6-step run's, bit for bit, and the checkpoint's leaves
    are the reference's stacked ones."""
    whole = _smoke_trainer(arch, 6)
    want = [h["loss"] for h in whole.run()]
    d = str(tmp_path / "ck")
    first = _smoke_trainer(arch, 4, d, ckpt_every=2)
    got = [h["loss"] for h in first.run()]
    flat, step, meta = ckpt_lib.load_flat(d)
    assert step == 4 and meta == {"stream_step": 4}
    names = set(_leaves(JLM(jconfigs.get(arch).make_reduced()).init(
        jax.random.PRNGKey(0))))
    assert set(flat) == ({f"params/{n}" for n in names}
                         | {f"opt/.{m}/{n}" for n in names
                            for m in ("mu", "nu")} | {"opt/.count"})
    second = _smoke_trainer(arch, 6, d, ckpt_every=2)
    assert second.start_step == 4 and int(second.opt_state.count) == 4
    for name, arr in _state(second).items():
        np.testing.assert_array_equal(arr, flat[name])
    hist = second.run()
    assert got + [h["loss"] for h in hist] == want
    ref = _state(whole)
    for name, arr in _state(second).items():
        assert arr.dtype == ref[name].dtype
        np.testing.assert_array_equal(arr, ref[name])


def test_checkpoint_port_to_reference(tmp_path):
    """The port's trainer writes step 2; the reference's trainer restores
    exactly those leaves and trains on to step 4, within the trainers'
    tolerance of the port's own steps 2-3."""
    arch = "qwen3-1.7b"
    d = str(tmp_path / "ck")
    port = _smoke_trainer(arch, 2, d)
    port.run()
    saved, _, _ = ckpt_lib.load_flat(d)
    jstep, jparams, jstate, jstream = jbuild_smoke(arch)
    jtr = JTrainer(jstep, jparams, jstate, jstream,
                   JTrainerConfig(num_steps=4, ckpt_dir=d, log_every=100),
                   put_batch=lambda b: jax.tree.map(jnp.asarray, b))
    assert jtr.start_step == 2
    restored = _leaves({"params": jtr.params, "opt": jtr.opt_state})
    assert restored.keys() == saved.keys()
    for name, arr in restored.items():
        np.testing.assert_array_equal(arr, saved[name])
    jhist = jtr.run()
    more = _smoke_trainer(arch, 4)
    want = [h["loss"] for h in more.run()][2:]
    np.testing.assert_allclose([h["loss"] for h in jhist], want, rtol=2e-3)


def test_checkpoint_reference_to_port(tmp_path):
    """The reference's trainer writes step 2; the port's trainer restores
    it bit for bit into its parameters and AdamW state and trains on."""
    arch = "minitron-4b"
    d = str(tmp_path / "ck")
    jstep, jparams, jstate, jstream = jbuild_smoke(arch)
    JTrainer(jstep, jparams, jstate, jstream,
             JTrainerConfig(num_steps=2, ckpt_dir=d, log_every=100),
             put_batch=lambda b: jax.tree.map(jnp.asarray, b)).run()
    saved, _, _ = ckpt_lib.load_flat(d)
    port = _smoke_trainer(arch, 4, d)
    assert port.start_step == 2 and int(port.opt_state.count) == 2
    state = _state(port)
    assert state.keys() == saved.keys()
    for name, arr in state.items():
        assert arr.dtype == saved[name].dtype
        np.testing.assert_array_equal(arr, saved[name])
    hist = port.run()
    assert [h["step"] for h in hist] == [2, 3]
    assert np.isfinite([h["loss"] for h in hist]).all()


# -------------------------------------------------------------- launcher


@pytest.mark.parametrize("arch", DENSE)
def test_train_cli_lm_smoke_line(arch):
    """``--smoke --device cpu`` trains and prints the reference's line."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = tlaunch.main(["--arch", arch, "--smoke", "--steps", "3",
                             "--device", "cpu"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert line == (f"[train] {arch}: first loss {hist[0]['loss']:.4f}, "
                    f"last loss {hist[-1]['loss']:.4f}")
    assert len(hist) == 3 and np.isfinite([h["loss"] for h in hist]).all()


@pytest.mark.parametrize("arch", MOE)
def test_train_cli_moe_raises(arch):
    """Once the MoE LMs raised (A11); now ported: ``--smoke --device
    cpu`` trains them and prints the reference's line."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = tlaunch.main(["--arch", arch, "--smoke", "--steps", "2",
                             "--device", "cpu"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert line == (f"[train] {arch}: first loss {hist[0]['loss']:.4f}, "
                    f"last loss {hist[-1]['loss']:.4f}")
    assert len(hist) == 2 and np.isfinite([h["loss"] for h in hist]).all()
    assert all(h["aux"] > 0 for h in hist)


def test_train_cli_lm_ckpt_dir_resumes(tmp_path):
    d = str(tmp_path / "ck")
    argv = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
            "--ckpt-dir", d]
    first = tlaunch.main([*argv, "--steps", "2"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rest = tlaunch.main([*argv, "--steps", "3"])
    assert "[trainer] restored checkpoint at step 2" in buf.getvalue()
    assert [h["step"] for h in first + rest] == [0, 1, 2]
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
