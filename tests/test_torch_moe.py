"""The PyTorch port's capacity-based MoE FFN against the JAX reference, on
the CPU.

``layers.moe_ffn`` (the reference's reaches no Pallas kernel, so it runs
as it is) is held in f32 compute to 1e-5 (outputs) and 1e-6 (aux):
top-1 and top-2, no dense branch, arctic's dense residual or llama4's
shared expert, capacity factors 0.5 (drops), 1.25 and 8, a decode-sized
batch (the capacity floor of 8) and a zeroed router (every gate ties; the
lower expert wins, as ``jax.lax.top_k`` orders ties).

The reduced arctic-480b and llama4-maverick LMs run in both packages on
the reference's weights (``convert.lm_from_numpy``).  In f32 the logits,
aux and serving match to 1e-4, and training (loss, nll, aux, every
gradient, remat on and off, one AdamW step) to the tolerances of
``tests/test_torch_lm_train.py``.  In bf16 the two packages round at
other places (see ``tests/test_torch_models.py``): the logits are held to
that file's 6e-2 a pair of layers (arctic's 2 layers: 6e-2; llama4's 4:
1.2e-1; measured, a dense reduced LM cut to 4 layers, minitron-4b's,
already differs by up to 0.116 over prefill and 8 decode steps, and
llama4's by 0.091 where both packages routed alike).  bf16 router
logits tie often: where one package's gates tie, or nearly, the other's
may order them the other way and send the token to another expert.  That
token's output, every later token of its sequence in later layers
(attention) and, through the capacity ranks, later tokens of the same
call then legitimately differ.  So the bf16 tests record both packages'
gates at every MoE call, replay the reference's dispatch rules on them,
and hold the logits to that tolerance only where both packages took
the same route all the way; every routing difference where the inputs
still agreed must be a near tie (the port's router logits of the k-th
and the next expert at most ``NEAR_TIE`` apart), and each is reported
with its gap.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models.transformer import LM as JLM
from repro.models.transformer import make_train_step as jmake_train_step
from repro.optim import AdamW as JAdamW
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.launch.train import build_smoke as jbuild_smoke
from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert, layers, transformer
from repro_torch.models.transformer import LM, make_train_step
from repro_torch.optim import AdamW
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(1)

MOE = ["arctic-480b", "llama4-maverick-400b-a17b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FFN_TOL, AUX_TOL = 1e-5, 1e-6
TOL = {"f32": 1e-4, "bf16": 6e-2}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
#: a routing difference between the packages at clean inputs is a near
#: tie if the port's router logits (log gates) of the k-th and the next
#: expert, or of two of the top k, are at most this far apart: four bf16
#: steps at logits in [2, 4) (measured: the flips' gaps reach 0.0078,
#: one bf16 step at logits in [1, 2))
NEAR_TIE = 2.0 ** -4
LR = 1e-3


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _leaves(tree) -> dict:
    return dict(ckpt_lib.leaves(jax.tree.map(np.asarray, tree)))


# ------------------------------------------------------------- moe_ffn


def _ffn_case(k, branch, cf, t, seed=0, zero_router=False):
    """The two packages' configs, a numpy weight dict and x (2, t/2, d)."""
    e, d, f = 8, 32, 48
    kw = dict(name="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=1,
              d_head=16, d_ff=f, vocab=64, moe=True, n_experts=e, top_k=k,
              capacity_factor=cf, moe_dense_residual=branch == "dense",
              moe_shared_expert=branch == "shared")
    jcfg = jlayers.LMConfig(compute_dtype=jnp.float32, **kw)
    tcfg = layers.LMConfig(compute_dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(d, e), "w_gate": w(e, d, f), "w_up": w(e, d, f),
         "w_down": w(e, f, d)}
    if zero_router:
        p["router"][:] = 0
    if branch != "none":
        p["dense"] = {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    return jcfg, tcfg, p, x


def _ffn_pair(jcfg, tcfg, p, x):
    jout, jaux = jlayers.moe_ffn(jax.tree.map(jnp.asarray, p), jcfg,
                                 jnp.asarray(x))
    tout, taux = layers.moe_ffn(jax.tree.map(torch.as_tensor, p), tcfg,
                                torch.as_tensor(x))
    assert tout.shape == x.shape and tout.dtype == torch.float32
    assert taux.shape == () and taux.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=FFN_TOL, rtol=FFN_TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    return tout


def _kept(tcfg, p, x):
    """The port's dispatch of x: (top experts (T, k), kept (T*k,))."""
    xf = torch.as_tensor(x).reshape(-1, x.shape[-1])
    gates = torch.softmax(xf @ torch.as_tensor(p["router"]), -1)
    _, top_e = layers.moe_route(gates, tcfg.top_k)
    top, keep, _ = _dispatch(gates.numpy(), tcfg)
    np.testing.assert_array_equal(top, top_e.numpy())
    return top, keep


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("branch", ["none", "dense", "shared"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_reference(k, branch, cf):
    jcfg, tcfg, p, x = _ffn_case(k, branch, cf, 64)
    _ffn_pair(jcfg, tcfg, p, x)
    cap = layers.moe_capacity(tcfg, 64)
    assert cap == max(int(cf * 64 * k / 8), 8, 1)
    _, keep = _kept(tcfg, p, x)
    assert keep.all() == (cf == 8.0)          # 0.5 and 1.25 drop here


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_decode_batch_hits_the_floor(k):
    """T = 4 tokens: the statistical capacity is 0, the floor gives
    min(T k, 8) slots an expert, so nothing is dropped."""
    jcfg, tcfg, p, x = _ffn_case(k, "dense", 1.25, 4, seed=1)
    assert layers.moe_capacity(tcfg, 4) == min(4 * k, 8)
    _ffn_pair(jcfg, tcfg, p, x)
    assert _kept(tcfg, p, x)[1].all()


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_all_gates_tie(k):
    """A zeroed router: every gate is 1/E, every token goes to experts 0
    .. k-1 with weight 1/k, and at cf 0.5 (8 slots for 32 k assignments)
    the earliest tokens keep them; the aux loss is exactly E * 1/E."""
    jcfg, tcfg, p, x = _ffn_case(k, "none", 0.5, 64, seed=2,
                                 zero_router=True)
    out = _ffn_pair(jcfg, tcfg, p, x)
    top, keep = _kept(tcfg, p, x)
    assert (top == np.arange(k)).all()
    cap = layers.moe_capacity(tcfg, 64)
    assert keep.reshape(64, k)[:cap].all() and not keep.reshape(64, k)[
        cap:].any()
    assert not out.reshape(64, -1)[cap:].any()           # dropped: exact 0
    assert float(layers.moe_ffn(jax.tree.map(torch.as_tensor, p), tcfg,
                                torch.as_tensor(x))[1]) == 1.0


def test_moe_route_tie_order():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.4, 0.1, 0.4, 0.1]])
    w, e = layers.moe_route(gates, 2)
    jw, je = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert e.tolist() == [[0, 1], [1, 3], [0, 2]]


# ------------------------------------------------- routing of a whole LM


def _dispatch(gates, cfg):
    """The reference's rules on one call's (T, E) gates, in numpy:
    ``(top experts (T, k), kept (T, k), the gap (T,))``, the gap the least
    difference of router logits (log gates) between consecutive ones
    among the first k + 1."""
    t, _ = gates.shape
    k = cfg.top_k
    top = np.argsort(-gates, axis=-1, kind="stable")[:, :k]
    logs = np.log(-np.sort(-gates, axis=-1)[:, :k + 1])
    gap = (logs[:, :k] - logs[:, 1:]).min(-1)
    flat = top.reshape(-1)
    order = np.argsort(flat, kind="stable")
    ranks = np.arange(t * k) - np.searchsorted(flat[order], flat[order],
                                               side="left")
    pos = np.empty(t * k, np.int64)
    pos[order] = ranks
    keep = pos < layers.moe_capacity(cfg, t)
    return top, keep.reshape(t, k), gap


class _Routing:
    """Both packages' gates at every MoE call, in call order: each
    package's ``transformer.moe_ffn`` is wrapped (for the test's length)
    by one that also computes the gates as ``moe_ffn`` does (the
    reference's reach the host by ``jax.debug.callback``)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []

        def jwrap(p, cfg, x):
            xf = x.reshape(-1, x.shape[-1])
            gates = jax.nn.softmax((xf @ p["router"].astype(
                cfg.compute_dtype)).astype(jnp.float32), axis=-1)
            jax.debug.callback(lambda g: self.ref.append(np.array(g)),
                               gates, ordered=True)
            return jlayers.moe_ffn(p, cfg, x)

        def twrap(p, cfg, x, axes=None):
            xf = x.reshape(-1, x.shape[-1])
            gates = torch.softmax((xf @ p["router"].to(
                cfg.compute_dtype)).float(), dim=-1)
            self.port.append(gates.detach().numpy().copy())
            return layers.moe_ffn(p, cfg, x, axes=axes)

        monkeypatch.setattr(jtransformer, "moe_ffn", jwrap)
        monkeypatch.setattr(transformer, "moe_ffn", twrap)

    def calls(self):
        jax.effects_barrier()
        assert len(self.ref) == len(self.port)
        out = list(zip(self.ref, self.port))
        self.ref.clear()
        self.port.clear()
        return out


def _replay(cfg, calls, b, s, steps=0):
    """Where both packages routed alike: ``(clean (B, s + steps) bool,
    flips)``.  ``calls``: the prefill's (or forward's) ``n_layers`` calls
    over B x s tokens, then ``n_layers`` a decode step over B.  A position
    is dirty once its input to a layer differs: a dispatch (expert or
    capacity drop) that differs at a layer dirties the token for the
    layers after it, attention spreads dirt to the later positions of the
    sequence.  ``flips``: (layer, batch row, position, the port's gap) of
    each expert choice that differs where the input was still clean;
    each must be a near tie."""
    n = cfg.n_layers
    assert len(calls) == n * (1 + steps)
    clean = np.ones((b, s + steps), bool)
    flips = []

    def step(l, dirty, gates_ref, gates_port, positions):
        rt, rk, _ = _dispatch(gates_ref, cfg)
        pt, pk, gap = _dispatch(gates_port, cfg)
        route = (rt != pt).any(-1).reshape(dirty.shape)
        differs = route | (rk != pk).any(-1).reshape(dirty.shape)
        gap = gap.reshape(dirty.shape)
        for bi, i in zip(*np.nonzero(route & ~dirty)):
            flips.append((l, int(bi), int(positions[i]), float(gap[bi, i])))
        return dirty | differs

    dirty = np.zeros((b, s), bool)
    seen = []                     # per layer: a dirty cached position
    for l in range(n):
        dirty = np.logical_or.accumulate(dirty, axis=1)
        seen.append(dirty.any(1))
        dirty = step(l, dirty, *calls[l], np.arange(s))
    clean[:, :s] = ~dirty
    for j in range(steps):
        tok = np.zeros((b, 1), bool)
        for l in range(n):
            seen[l] = seen[l] | tok[:, 0]
            tok = tok | seen[l][:, None]
            tok = step(l, tok, *calls[n * (1 + j) + l], [s + j])
        clean[:, s + j] = ~tok[:, 0]
    return clean, flips


def _report_flips(flips, what):
    for l, bi, i, gap in flips:
        print(f"{what}: routing differs at layer {l}, row {bi}, position "
              f"{i}: the port's router logits there are {gap:.3g} apart")
    far = [f for f in flips if f[3] > NEAR_TIE]
    assert not far, f"{what}: routing differs away from a near tie: {far}"


def _pair(arch, dt, **over):
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


def _tol(cfg, dt) -> float:
    """The logits' tolerance: bf16's 6e-2 a pair of layers."""
    return TOL[dt] * (cfg.n_layers / 2 if dt == "bf16" else 1)


def _tokens(vocab, b=2, t=32, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_matches_reference(arch, dt, monkeypatch):
    """Forward logits and aux of the reduced MoE LMs (2 x 32 tokens)."""
    rec = _Routing(monkeypatch)
    jm, params, tm = _pair(arch, dt)
    toks = _tokens(jm.cfg.vocab)
    jl, jaux, _ = jm.forward(params, jnp.asarray(toks))
    tl, taux, _ = tm.forward(torch.as_tensor(toks, dtype=torch.long))
    clean, flips = _replay(tm.cfg, rec.calls(), *toks.shape)
    _report_flips(flips, f"{arch} {dt} forward")
    if dt == "f32":
        assert clean.all() and not flips
    assert clean.mean() >= 0.25, f"only {clean.sum()} clean positions"
    got, want = tl.numpy(), np.asarray(jl, np.float32)
    tol = _tol(tm.cfg, dt)
    np.testing.assert_allclose(got[clean], want[clean], atol=tol, rtol=tol)
    assert taux.dtype == torch.float32 and float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= TOL[dt] * float(jaux)


def _reference_serve(jm, params, prompts, gen_len):
    """The reference's ``serve_lm`` loop: prefill, padded cache, greedy
    decode; its tokens and every step's logits."""
    p = prompts.shape[1]
    logits, (k, v) = jm.prefill(params, jnp.asarray(prompts))
    pad = ((0, 0), (0, 0), (0, gen_len), (0, 0), (0, 0))
    cache = (jnp.pad(k, pad), jnp.pad(v, pad))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, steps = [tok], [logits]
    for i in range(gen_len):
        logits, cache = jm.decode_step(params, cache, tok,
                                       jnp.array(p + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
        steps.append(logits)
    return (np.asarray(jnp.concatenate(toks, 1)),
            [np.asarray(s, np.float32) for s in steps])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE)
def test_serving_matches_reference(arch, dt, monkeypatch):
    """Prefill (4 x 16 prompt tokens) and 8 greedy decode steps: in f32
    the port's ``serve_lm`` gives the reference's tokens; in bf16 the
    port, teacher-forced on the reference's tokens, gives each step's
    logits within 6e-2 and the same first token wherever both packages
    routed alike.  (The logits that count are the last prompt
    position's and the decode steps': a routing difference in an early
    layer dirties the rest of its row, so four rows of 16 leave more of
    them to compare than two rows of 32.)"""
    rec = _Routing(monkeypatch)
    jm, params, tm = _pair(arch, dt)
    b, s, gen = 4, 16, 8
    prompts = np.random.default_rng(0).integers(0, jm.cfg.vocab, (b, s))
    want, jlogits = _reference_serve(jm, params, prompts.astype(np.int32),
                                     gen)
    tlog, cache = tm.prefill(torch.as_tensor(prompts), cache_len=s + gen)
    steps = [tlog.numpy()]
    for i in range(gen):
        tlog, cache = tm.decode_step(cache, torch.tensor(
            want[:, i:i + 1], dtype=torch.long), s + i)
        steps.append(tlog.numpy())
    clean, flips = _replay(tm.cfg, rec.calls(), b, s, gen)
    _report_flips(flips, f"{arch} {dt} serving")
    clean = clean[:, s - 1:]              # the positions whose logits count
    assert clean.mean() >= 0.25, f"only {clean.sum()} clean steps"
    tol = _tol(tm.cfg, dt)
    for i, (got, ref) in enumerate(zip(steps, jlogits)):
        rows = clean[:, i]
        np.testing.assert_allclose(got[rows], ref[rows], atol=tol, rtol=tol)
        if dt == "f32":
            assert rows.all()
            np.testing.assert_array_equal(got.argmax(-1), want[:, i])
    if dt == "f32":
        assert not flips
        served = tserve.serve_lm(arch, batch=b, prompt_len=s, gen_len=gen,
                                 seed=0, device="cpu", lm=tm)
        np.testing.assert_array_equal(served, want)
    else:
        first = clean[:, 0]
        np.testing.assert_array_equal(steps[0].argmax(-1)[first],
                                      want[first, 0])


@pytest.mark.parametrize("floor", [2, 16])
def test_capacity_floor_flag_matches_reference(floor, monkeypatch):
    """``perf_flags.FLAGS.moe_decode_capacity_floor`` set in both
    packages: ``moe_capacity`` follows the reference's rule, and a reduced
    arctic in f32 serves 4 x 16 prompt tokens and 4 decode steps (a
    floor of 2 drops decode assignments, 16 keeps them) with the
    reference's logits to 1e-4 and its tokens."""
    from repro.launch import perf_flags as jflags
    from repro_torch.launch import perf_flags
    monkeypatch.setattr(jflags, "FLAGS", jflags.PerfFlags(
        moe_decode_capacity_floor=floor))
    monkeypatch.setattr(perf_flags, "FLAGS", perf_flags.PerfFlags(
        moe_decode_capacity_floor=floor))
    rec = _Routing(monkeypatch)
    jm, params, tm = _pair("arctic-480b", "f32")
    cfg = tm.cfg
    for t in (1, 2, 4, 8, 64, 1024):
        want = max(int(cfg.capacity_factor * t * cfg.top_k
                       / cfg.n_experts), min(t * cfg.top_k, floor), 1)
        assert layers.moe_capacity(cfg, t) == want
    b, s, gen = 4, 16, 4
    prompts = np.random.default_rng(0).integers(0, jm.cfg.vocab, (b, s))
    want, jlogits = _reference_serve(jm, params, prompts.astype(np.int32),
                                     gen)
    tlog, cache = tm.prefill(torch.as_tensor(prompts), cache_len=s + gen)
    steps = [tlog.numpy()]
    for i in range(gen):
        tlog, cache = tm.decode_step(cache, torch.tensor(
            want[:, i:i + 1], dtype=torch.long), s + i)
        steps.append(tlog.numpy())
    calls = rec.calls()
    clean, flips = _replay(cfg, calls, b, s, gen)
    assert clean.all() and not flips
    dropped = any(not _dispatch(g, cfg)[1].all()
                  for _, g in calls[cfg.n_layers:])
    assert dropped == (floor == 2)
    for got, ref in zip(steps, jlogits):
        np.testing.assert_allclose(got, ref, atol=TOL["f32"],
                                   rtol=TOL["f32"])
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# --------------------------------------------------------------- training


def _batch(vocab, step=0):
    host = TokenStream(4, 32, vocab, seed=0).batch_at(step)
    return host, {k: torch.as_tensor(v).long() for k, v in host.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(arch, remat):
    """f32: ``LM.loss`` (nll + 0.01 aux) and every gradient against
    ``jax.value_and_grad`` of the reference's, remat on and off in both."""
    jm, params, tm = _pair(arch, "f32", remat=remat)
    host, batch = _batch(jm.cfg.vocab)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, host))
    loss, met = tm.loss(batch)
    assert set(met) == {"nll", "aux"}
    for key in ("nll", "aux"):
        assert abs(met[key].item() - float(jmet[key])) \
            <= LOSS_TOL * float(jmet[key]), key
    assert met["aux"].item() > 0
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * float(jloss)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    got, want = _leaves(convert.lm_to_numpy(tm, grads)), _leaves(jgrads)
    assert got.keys() == want.keys()
    assert any("moe/dense/w_down" in n for n in want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= GRAD_TOL, name
    assert np.abs(want["blocks/moe/router"]).max() > 0


@pytest.mark.parametrize("arch", MOE)
def test_remat_gives_the_same_gradients(arch):
    """bf16 (the configs' compute), remat on and off: the same loss, aux
    and gradients bit for bit; the recompute routes as the forward did."""
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(configs.get(arch).make_reduced(),
                                  remat=remat)
        lm = LM(cfg, device="cpu")
        _, batch = _batch(cfg.vocab)
        loss, met = lm.loss(batch)
        out[remat] = (loss, met["aux"], torch.autograd.grad(
            loss, list(lm.parameters())))
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    assert all(torch.equal(a, b) for a, b in zip(out[False][2],
                                                  out[True][2]))


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_reference(arch):
    """One AdamW step (f32): the loss and the first moments (1e-3 of each
    largest entry) as the reference's.  AdamW's first step moves an entry
    by ``lr g / (|g| + eps)``; an expert that saw few tokens has gradient
    entries near ``eps``, where the step follows the gradient's last
    bits: every parameter is within ``2 lr`` of the reference's, and
    fewer than 0.1% by more than 2e-5 (the dense LMs' bound)."""
    jm, params, tm = _pair(arch, "f32")
    host, batch = _batch(jm.cfg.vocab)
    jopt = JAdamW(lr=LR)
    jp, js, jmet = jax.jit(jmake_train_step(jm, jopt))(
        params, jopt.init(params), jax.tree.map(jnp.asarray, host))
    opt = AdamW(lr=LR)
    ps = list(tm.parameters())
    out, st, met = make_train_step(tm, opt)(ps, opt.init(ps), batch)
    assert out is ps and int(st.count) == int(js.count) == 1
    for key in ("loss", "nll", "aux"):
        assert abs(float(met[key]) - float(jmet[key])) \
            <= LOSS_TOL * float(jmet[key]), key
    got, want = _leaves(convert.lm_to_numpy(tm)), _leaves(jp)
    off = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        off += int((diff > 2e-5).sum())
        total += diff.size
    assert off < 1e-3 * total
    mu = _leaves(convert.lm_to_numpy(tm, st.mu))
    for name, w in _leaves(js.mu).items():
        assert _rel(mu[name], w) <= 10 * GRAD_TOL, name


# ------------------------------------------------------ weights, checkpoints


@pytest.mark.parametrize("arch", MOE)
def test_weights_round_trip(arch):
    """``lm_to_numpy(lm_from_numpy(tree))`` is the reference's MoE tree,
    bit for bit, and ``lm_list`` takes it apart in parameter order."""
    jm = JLM(jconfigs.get(arch).make_reduced())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = convert.lm_from_numpy(configs.get(arch).make_reduced(), tree,
                               device="cpu")
    names = [n for n, _ in tm.named_parameters()]
    assert "blocks.1.moe.dense.w_gate" in names
    assert "blocks.0.ffn.w_gate" not in names
    back = convert.lm_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    parts = convert.lm_list(tm, tree)
    assert all(np.array_equal(a, p.detach().numpy())
               for a, p in zip(parts, tm.parameters()))


@pytest.mark.parametrize("arch", MOE)
def test_init_draws_the_reference_shapes_and_scales(arch):
    cfg = configs.get(arch).make_reduced()
    ref = jax.tree.map(np.asarray, JLM(jconfigs.get(arch).make_reduced())
                       .init(jax.random.PRNGKey(0)))
    mine = convert.lm_to_numpy(LM(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(1)))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree.leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if "ln" in str(path) or "norm" in str(path):
            assert (b == 1).all()
        else:
            assert abs(b.std() / a.std() - 1) < 0.15, path


def _smoke_trainer(arch, steps, ckpt_dir=None):
    step, params, opt_state, stream, put, layout = tlaunch.build(
        arch, 0, smoke=True, device="cpu")
    return Trainer(step, params, opt_state, stream,
                   TrainerConfig(num_steps=steps, ckpt_dir=ckpt_dir,
                                 log_every=100),
                   put_batch=put, layout=layout)


@pytest.mark.parametrize("arch", MOE)
def test_checkpoint_crosses_the_packages(arch, tmp_path):
    """The port's trainer writes step 2 in the reference's layout (the
    MoE leaves and their AdamW moments included); the reference's trainer
    restores exactly those leaves and trains on.  Then the reference's
    step-4 checkpoint restores into the port bit for bit."""
    d = str(tmp_path / "ck")
    _smoke_trainer(arch, 2, d).run()
    saved, step, _ = ckpt_lib.load_flat(d)
    assert step == 2
    assert any(n.startswith("opt/.nu/blocks/moe/w_gate") for n in saved)
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
    assert np.isfinite([h["loss"] for h in jhist]).all()
    saved, step, _ = ckpt_lib.load_flat(d)
    assert step == 4
    port = _smoke_trainer(arch, 5, d)
    assert port.start_step == 4 and int(port.opt_state.count) == 4
    state = dict(ckpt_lib.leaves(port.layout.tree(port.params,
                                                  port.opt_state)))
    assert state.keys() == saved.keys()
    for name, arr in state.items():
        assert arr.dtype == saved[name].dtype
        np.testing.assert_array_equal(arr, saved[name])
    assert np.isfinite(port.run()[0]["loss"])


# --------------------------------------------------------------- launchers


@pytest.mark.parametrize("arch", MOE)
def test_launchers_serve_and_train(arch):
    toks = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--gen-len", "4"])
    assert toks.shape == (2, 5) and toks.min() >= 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        hist = tlaunch.main(["--arch", arch, "--smoke", "--steps", "3",
                             "--device", "cpu"])
    line = buf.getvalue().strip().splitlines()[-1]
    assert line == (f"[train] {arch}: first loss {hist[0]['loss']:.4f}, "
                    f"last loss {hist[-1]['loss']:.4f}")
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert all(h["aux"] > 0 for h in hist)
