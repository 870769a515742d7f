"""The sharded LM (``repro_torch.models.sharding``, ``LM.param_specs``,
``LM.cache_specs``, the sharded train, prefill and decode steps) against
the JAX reference's unsharded steps, on the CPU over gloo.

The reference's specs are compared leaf by leaf for all five LM ids at
their published configurations.  The steps run on spawned gloo ranks
(``core.distributed.spawn``), one spawn per mesh: (1, 2), (2, 1) and
(2, 2) over ("data", "model"), and (2, 2, 1) over ("pod", "data",
"model"), whose dp is the two axes ("pod", "data").  Every rank loads
the reference's ``LM.init`` weights (saved by this process) into the
port (``convert.lm_from_numpy``), places them (``shard_lm``) and runs,
for qwen3-1.7b's, deepseek-7b's and minitron-4b's reduced configs in
f32 with remat on: the loss and its gradients, one AdamW step (lr 1e-3)
on them, and a prefill of 10 tokens into a 24-slot cache then 4
decode steps, under the reference's three decode cache specs on the
(L, B, S, Hkv, Dh) cache (batch 4: the batch on dp, the sequence on tp;
batch 1: the sequence over dp and tp; chunked attention, chunk 8: the
batch on dp, head features on tp).  Each rank gathers its results
(``full_tensor``) and saves them with ``torch.save``; this process holds
them against the reference's jitted ``make_train_step``, its prefill and
decode steps, and the unsharded port on the same weights.  Where tp
does not divide the heads (minitron-4b's 3 over tp = 2, and on a (1, 3)
mesh minitron-4b's 3 and arctic-480b's 4, a rank then holding none),
each rank pads its block to ceil(H / tp) heads, as GSPMD pads them: the
results must still equal the unsharded port's.  ``WORK`` says which arch
and cache case each mesh runs; the sharded ``launch.cells`` steps
(``make_train_step`` among them) run on (2, 2) against the unsharded
cells.

Tolerances (f32), and why:

- loss 1e-5 relative and gradients 1e-4 of each leaf's largest entry,
  as ``tests/test_torch_lm_train.py`` (both sum in f32, in other orders;
  the shards add their partial sums in another order again).
- parameters after AdamW 2e-5 absolute and AdamW's first moments 1e-3
  of each leaf's largest entry, as ``tests/test_torch_lm_train.py``
  states for f32 (measured here: 6.8e-6 at most against the reference,
  3.7e-6 against the unsharded port).
- prefill and decode logits 1e-3 of the largest logit (the issue's
  serving tolerance); against the unsharded port 1e-4.
- the KV cache against the unsharded port's 1e-5.
"""
import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import configs
from repro_torch.core import distributed as TD
from repro_torch.models import convert, sharding
from repro_torch.models.transformer import LM, MeshAxes
from repro_torch.optim import AdamW

ARCHS = ("qwen3-1.7b", "deepseek-7b", "minitron-4b")
ALL_LM = ARCHS + ("arctic-480b", "llama4-maverick-400b-a17b")
#: name -> (shape, axis names)
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "1x3": ((1, 3), ("data", "model"))}
#: decode cache case -> (batch, config overrides)
SERVE = {"batch": (4, {}),
         "one": (1, {}),
         "chunked": (4, dict(attention="chunked", chunk_size=8))}
#: what each mesh's ranks run: arch -> serve cases (every arch that can
#: split its heads also trains).  A rank's first call of an op at a new
#: shape pays DTensor's sharding propagation (~1.5 s a model here), so
#: the three cache cases run on qwen3-1.7b (GQA, the card's model), the
#: others serve their "batch" case; the multi-axis dp mesh trains and
#: serves qwen3-1.7b alone, and the cells run on (2, 2).
WORK = {"1x2": {"qwen3-1.7b": tuple(SERVE), "deepseek-7b": ("batch",),
                "minitron-4b": ("batch",)},
        "2x1": {"qwen3-1.7b": tuple(SERVE), "deepseek-7b": ("batch",),
                "minitron-4b": ("batch",)},
        "2x2": {"qwen3-1.7b": tuple(SERVE), "deepseek-7b": ("batch",),
                "minitron-4b": ("batch",)},
        "pod2x2x1": {"qwen3-1.7b": ("batch", "one")},
        "1x3": {"minitron-4b": ("batch",), "arctic-480b": ("batch",)}}
CELLS_ON = ("2x2",)
#: seconds a world of ranks may take: ~30 s alone, but a full test run
#: shares the cores with other files
SPAWN_TIMEOUT = 600.0
T, P, STEPS = 24, 10, 4         # cache slots, prompt, decode steps
LR = 1e-3
TOL = dict(loss=1e-5, grad=1e-4, param=2e-5, logits=1e-3, port=1e-4,
           cache=1e-5)


def _cfg(arch, **over):
    return dataclasses.replace(configs.get(arch).make_reduced(),
                               compute_dtype=torch.float32, remat=True,
                               **over)


def _jcfg(arch, **over):
    import jax.numpy as jnp

    from repro import configs as jconfigs
    return dataclasses.replace(jconfigs.get(arch).make_reduced(),
                               compute_dtype=jnp.float32, remat=True, **over)


def _axes(names):
    from repro_torch.launch.mesh import data_axes
    return MeshAxes(dp=data_axes("pod" in names), tp="model")


def _serve_tokens(vocab, b):
    return np.random.default_rng(3).integers(0, vocab, (b, T)).astype(
        np.int64)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _leaves(tree) -> dict:
    from repro_torch.train import checkpoint as ckpt_lib
    return {k: np.asarray(v) for k, v in ckpt_lib.leaves(tree)}


# -- the ranks ------------------------------------------------------------------

def _serve(lm, tokens, b):
    """Prefill P tokens into a T-slot cache, then STEPS teacher-forced
    decode steps: the logits (STEPS + 1, b, V) and the final cache."""
    toks = torch.as_tensor(tokens)
    logits, cache = lm.prefill(toks[:, :P], cache_len=T)
    out = [logits]
    for i in range(STEPS):
        logits, cache = lm.decode_step(cache, toks[:, P + i:P + i + 1],
                                       P + i)
        out.append(logits)
    full = [t.full_tensor() if isinstance(t, DTensor) else t
            for t in out]
    kv = [c.full_tensor() if isinstance(c, DTensor) else c
          for c in cache]
    return torch.stack(full).numpy(), [c.numpy() for c in kv], cache


def _train(lm, batch):
    """Loss, gradients, global norm and one AdamW step of ``lm``."""
    from repro_torch.kernels import ops
    from repro_torch.optim import global_norm
    calls = []
    plain = ops.flash_attention

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return plain(*a, **k)
    ops.flash_attention = counted
    try:
        ps = list(lm.parameters())
        loss, _ = lm.loss(batch)
        grads = torch.autograd.grad(loss, ps)
    finally:
        ops.flash_attention = plain
    res = dict(loss=loss.detach().item(), grads=convert.lm_to_numpy(lm, grads),
               flash=calls, gnorm=float(global_norm(grads)))
    if isinstance(grads[0], DTensor):
        res["local_norm"] = math.sqrt(sum(
            float((g.to_local().float() ** 2).sum()) for g in grads))
    opt = AdamW(lr=LR)
    st = opt.step(ps, grads, opt.init(ps))
    if isinstance(grads[0], DTensor):
        res["moment_placements"] = [
            tuple(m.placements) == tuple(v.placements) == tuple(p.placements)
            for m, v, p in zip(st.mu, st.nu, ps)]
    res.update(params=convert.lm_to_numpy(lm),
               mu=convert.lm_to_numpy(lm, st.mu))
    return res


def _cells(mesh, out):
    """The sharded LM cells of ``launch.cells`` (the step ``build_cell(...,
    mesh=)`` builds, at qwen3-1.7b's reduced config, seed-0 weights)
    beside the unsharded ones on the CPU: their results and the
    placements of their arguments."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import cells
    cfg = _cfg("qwen3-1.7b")
    for kind, meta in (("train", dict(batch=4, seq=16)),
                       ("prefill", dict(batch=4, seq=16)),
                       ("decode", dict(batch=4, seq=16)),
                       ("decode", dict(batch=1, seq=16))):
        cell = ShapeCell(f"{kind}{meta['batch']}", kind, meta)
        got = {}
        for name, build in (
                ("sharded", cells._build_lm(cfg, cell, None, mesh)),
                ("plain", cells._build_lm(cfg, cell, torch.device("cpu")))):
            res = build.fn(*build.abstract_args)
            res = res[2]["loss"] if kind == "train" else res[0]
            got[name] = (res.full_tensor() if isinstance(res, DTensor)
                         else res).numpy()
            args = build.abstract_args
            if name == "sharded":
                got["args"] = [tuple(t.placements) for t in (
                    list(args[0]) + list(args[1].mu) + [args[2]["tokens"]]
                    if kind == "train" else
                    [args[1]] if kind == "prefill" else
                    list(args[1]) + [args[2]])]
                got["count"] = (type(args[1].count).__name__
                                if kind == "train" else None)
        out[cell.name] = got


def _rank_main(rank, world, mesh_name, wdir):
    """One spawned rank of ``mesh_name``: every arch's train step and
    serve cases, the cells, and the placement checks; results saved."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)    # the ranks share the cores
    shape, names = MESHES[mesh_name]
    mesh = make_mesh(shape, names, device="cpu")
    axes = _axes(names)
    weights = torch.load(os.path.join(wdir, "weights.pt"),
                         weights_only=False)
    out = {"coord": mesh.get_coordinate()}
    for arch, cases in WORK[mesh_name].items():
        tree, batch = weights[arch]
        batch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
        try:
            lm = sharding.shard_lm(convert.lm_from_numpy(
                _cfg(arch), tree, device="cpu"), mesh, axes)
        except ValueError as e:
            out[arch] = {"error": str(e)}
            continue
        res = {"train": _train(lm, batch)}
        res["placements"] = {n: tuple(p.placements)
                             for n, p in lm.named_parameters()}
        for case in cases:
            b, over = SERVE[case]
            lm = sharding.shard_lm(convert.lm_from_numpy(
                _cfg(arch, **over), tree, device="cpu"), mesh, axes)
            logits, kv, cache = _serve(lm, _serve_tokens(lm.cfg.vocab, b), b)
            res[case] = dict(logits=logits, kv=kv,
                             cache_placements=tuple(cache[0].placements))
        out[arch] = res
    if mesh_name in CELLS_ON:
        out["cells"] = {}
        _cells(mesh, out["cells"])
    # a dimension over two mesh axes: split in mesh order (GSPMD's
    # major-to-minor), each rank's block its own
    if len(shape) == 3:
        t = torch.arange(8.0 * 3).reshape(8, 3)
        d = distribute_tensor(
            t, mesh, sharding.placements((("pod", "data"), None), mesh),
            src_data_rank=None)
        out["two_axis_block"] = d.to_local().numpy()
    torch.save(out, os.path.join(wdir, f"rank{rank}.pt"))


# -- this process ---------------------------------------------------------------

def _reference_weights():
    """arch -> (the reference's ``LM.init`` tree as numpy, the training
    batch as numpy)."""
    import jax

    from repro.data import TokenStream as JTokens
    from repro.models.transformer import LM as JLM
    out = {}
    for arch in ARCHS + ("arctic-480b",):
        jm = JLM(_jcfg(arch))
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        out[arch] = (params, JTokens(4, 32, jm.cfg.vocab, seed=0)
                     .batch_at(0))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights, saved, then one spawn per mesh, one after
    another in a background thread (each joined within
    ``TD.SPAWN_TIMEOUT``); ``get(mesh_name)`` waits for one and gives
    every rank's results, ``get("weights")`` the weights."""
    root = tmp_path_factory.mktemp("sharded")
    weights = _reference_weights()
    torch.save(weights, root / "weights.pt")
    TD.SPAWN_TIMEOUT, timeout = SPAWN_TIMEOUT, TD.SPAWN_TIMEOUT
    pool = ThreadPoolExecutor(1)
    jobs = {}
    for name, (shape, _) in MESHES.items():
        d = root / name
        d.mkdir()
        os.symlink(root / "weights.pt", d / "weights.pt")
        world = math.prod(shape)
        jobs[name] = (d, world, pool.submit(
            TD.spawn, _rank_main, world, args=(name, str(d)),
            store_dir=str(d)))
    done = {"weights": weights}

    def get(name):
        if name not in done:
            d, world, job = jobs[name]
            job.result()
            done[name] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
        return done[name]
    yield get
    pool.shutdown(cancel_futures=True)
    TD.SPAWN_TIMEOUT = timeout


_MEMO: dict = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _reference_train(arch, weights):
    """The reference's loss, gradients and one jitted ``make_train_step``
    on the same weights and batch."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import LM as JLM
    from repro.models.transformer import make_train_step as jstep
    from repro.optim import AdamW as JAdamW
    tree, batch = weights[arch]
    jm = JLM(_jcfg(arch))
    params = jax.tree.map(jnp.asarray, tree)
    jb = jax.tree.map(jnp.asarray, batch)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jb)
    opt = JAdamW(lr=LR)
    new, st, met = jax.jit(jstep(jm, opt))(params, opt.init(params), jb)
    np_ = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    assert abs(float(met["loss"]) - float(loss)) <= 1e-6 * float(loss)
    return dict(loss=float(loss), grads=np_(grads), params=np_(new),
                mu=np_(st.mu))


def _reference_serve(arch, case, weights):
    """The reference's prefill logits and STEPS decode steps' logits
    (STEPS + 1, b, V), its cache padded to T slots as the port's."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import LM as JLM
    b, over = SERVE[case]
    jm = JLM(_jcfg(arch, **over))
    params = jax.tree.map(jnp.asarray, weights[arch][0])
    toks = _serve_tokens(jm.cfg.vocab, b).astype(np.int32)
    logits, (k, v) = jm.prefill(params, jnp.asarray(toks[:, :P]))
    pad = ((0, 0), (0, 0), (0, T - P), (0, 0), (0, 0))
    cache = (jnp.pad(k, pad), jnp.pad(v, pad))
    out = [np.asarray(logits)]
    for i in range(STEPS):
        logits, cache = jm.decode_step(params, cache,
                                       jnp.asarray(toks[:, P + i:P + i + 1]),
                                       jnp.array(P + i, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out)


def _port_unsharded(arch, case, weights):
    """The unsharded port on the same weights: the train results or a
    serve case's (logits, kv)."""
    tree, batch = weights[arch]
    if case == "train":
        lm = convert.lm_from_numpy(_cfg(arch), tree, device="cpu")
        return _train(lm, {k: torch.as_tensor(v).long()
                           for k, v in batch.items()})
    b, over = SERVE[case]
    lm = convert.lm_from_numpy(_cfg(arch, **over), tree, device="cpu")
    logits, kv, _ = _serve(lm, _serve_tokens(lm.cfg.vocab, b), b)
    return logits, kv


def _uneven(arch, mesh_name) -> bool:
    """Whether the mesh's tp does not divide ``arch``'s q or kv heads."""
    shape, names = MESHES[mesh_name]
    tp = shape[names.index("model")]
    cfg = _cfg(arch)
    return bool(cfg.n_heads % tp or cfg.n_kv_heads % tp)


# -- specs ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_LM)
def test_param_specs_match_reference(arch):
    """Every leaf of the published config, the MoE leaves included, at
    the reference's two axis sets: the port's spec (a layer's, the layer
    axis dropped) is the reference's PartitionSpec content."""
    from repro import configs as jconfigs
    from repro.models.transformer import LM as JLM
    from jax.sharding import PartitionSpec as PS

    from repro.models.transformer import MeshAxes as JAxes
    jcfg = jconfigs.get(arch).make_config()
    cfg = configs.get(arch).make_config()
    # the layer count does not change a spec: two layers keep it small
    jm = JLM(dataclasses.replace(jcfg, n_layers=jcfg.layer_group * 2))
    lm = LM(dataclasses.replace(cfg, n_layers=cfg.layer_group * 2),
            device="meta", init=False)
    for dp in (("data",), ("pod", "data")):
        want = _ref_specs(jm.param_specs(JAxes(dp=dp)))
        got = lm.param_specs(MeshAxes(dp=dp))
        assert len(got) == len(list(lm.parameters()))
        seen = set()
        for name, spec in got.items():
            path, layer = convert._ref_path(name)
            ref = want["/".join(path)]
            full = (None,) + spec if layer is not None else spec
            assert PS(*full) == ref, name
            seen.add("/".join(path))
        assert seen == set(want)


def _ref_specs(specs) -> dict:
    """The reference's spec tree as ``{"blocks/attn/wq": tuple}``."""
    import jax
    from jax.sharding import PartitionSpec as PS
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PS))
    return {"/".join(k.key for k in path): s for path, s in flat}


def test_cache_specs_match_reference():
    from jax.sharding import PartitionSpec as PS

    from repro.models.transformer import LM as JLM
    from repro.models.transformer import MeshAxes as JAxes
    jm = JLM(_jcfg("qwen3-1.7b"))
    lm = LM(_cfg("qwen3-1.7b"), device="meta", init=False)
    for dp in (("data",), ("pod", "data")):
        for shard_seq in (False, True):
            want = jm.cache_specs(JAxes(dp=dp), shard_seq)
            got = lm.cache_specs(MeshAxes(dp=dp), shard_seq)
            assert tuple(PS(*s) for s in got) == want


def test_placements_follow_the_spec():
    """A spec's placements on a one-rank mesh, and its refusals: a name
    the mesh lacks, an axis used twice, a tuple out of mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_mesh
    with TD.process_group("cpu"):
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
        pl = sharding.placements
        assert pl((None, "model"), mesh) == [Replicate(), Replicate(),
                                             Shard(1)]
        assert pl((("pod", "data"), None, "model"), mesh) == [
            Shard(0), Shard(0), Shard(2)]
        assert _spec_of(pl((("pod", "data"), None, "model"), mesh),
                                mesh, 3) == (("pod", "data"), None, "model")
        with pytest.raises(ValueError, match="no axis 'stage'"):
            pl(("stage",), mesh)
        with pytest.raises(ValueError, match="used twice"):
            pl(("model", "model"), mesh)
        with pytest.raises(ValueError, match="not in the mesh's order"):
            pl((("data", "pod"),), mesh)


def test_make_mesh_refuses_mismatches():
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh((1, 1), ("data", "model"), device="cpu")
    with TD.process_group("cpu"):
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh((2, 2), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="nccl"):
            make_mesh((1, 1), ("data", "model"), device="cuda")
        with pytest.raises(ValueError, match="backend"):
            make_mesh((1,), ("data",), device="meta")


def test_moe_lm_is_placed():
    """``shard_lm`` places a reduced MoE LM by its specs (the experts on
    tp and D on dp) and its sharded forward, on a one-rank mesh, gives
    the unsharded one's logits and aux bit for bit (the same ops on the
    same tensors; tests/test_torch_moe_sharded.py holds several ranks)."""
    from repro_torch.launch.mesh import make_mesh
    with TD.process_group("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        cfg = configs.get("arctic-480b").make_reduced()
        lm = LM(cfg, device="cpu")
        tokens = torch.as_tensor(_serve_tokens(cfg.vocab, 2))
        want, want_aux, _ = lm(tokens)
        sharding.shard_lm(lm, mesh)
        assert lm.blocks[0].moe.w_gate.placements == tuple(
            sharding.placements(("model", ("data",), None), mesh))
        got, aux, _ = lm(tokens)
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), want)
        assert torch.equal(aux, want_aux)


def test_shard_lm_refuses_another_device():
    """Parameters on another device than the mesh's ranks raise; a
    one-rank mesh keeps the weights' storage (no second copy)."""
    from repro_torch.launch.mesh import make_mesh
    with TD.process_group("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="mesh is of 'cpu' ranks"):
            sharding.shard_lm(LM(_cfg("qwen3-1.7b"), device="meta",
                                 init=False), mesh)
        lm = LM(_cfg("qwen3-1.7b"), device="cpu")
        ptrs = [p.data_ptr() for p in lm.parameters()]
        sharding.shard_lm(lm, mesh)
        assert [p.to_local().data_ptr() for p in lm.parameters()] == ptrs


# -- the sharded steps ----------------------------------------------------------

ALL = [(m, a) for m in WORK for a in WORK[m]]
UNEVEN = [c for c in ALL if _uneven(c[1], c[0])]
CASES = [c for c in ALL if c not in UNEVEN]
SERVE_CASES = [(m, a, c) for m, a in CASES for c in WORK[m][a]]


@pytest.mark.parametrize("mesh_name,arch", UNEVEN)
def test_tp_must_divide_heads(runs, mesh_name, arch):
    """tp need not divide the heads any more: minitron-4b's 3 heads over
    tp = 2 (and its one kv head over tp = 2 and 3), arctic-480b's 4 over
    tp = 3.  Every rank runs the flash kernel on ceil(H / tp) heads (its
    block padded with zero heads, GSPMD's padding), and the sharded step
    equals the unsharded port's: the loss (1e-5), gradients (1e-4 of
    each leaf's largest entry), the prefill and teacher-forced decode
    logits (1e-4 of the largest) and their greedy tokens, and the cache
    (1e-5); a dense LM also the reference's loss and gradients.  The
    AdamW step's parameters are held to 2e-5 where the clipped |g| is at
    least 100 x AdamW's eps, and within 2 lr everywhere: a first Adam
    step moves an entry by lr g / (|g| + eps), so where |g| is near eps
    the gradients' last-bit differences (the shards sum in another
    order) move it by a share of lr (5.2e-5 seen for one entry of
    minitron-4b's w_down at tp = 2; phase 22 of chip_smoke.py holds its
    f32 step by the same rule)."""
    weights = runs("weights")
    plain = _memo(("port", arch, "train"),
                  lambda: _port_unsharded(arch, "train", weights))
    shape, names = MESHES[mesh_name]
    dp = math.prod(n for n, a in zip(shape, names) if a != "model")
    tp = shape[names.index("model")]
    cfg = _cfg(arch)
    width = -(-cfg.n_heads // tp)
    assert _uneven(arch, mesh_name)
    for r in runs(mesh_name):
        assert "error" not in r[arch]
        got = r[arch]["train"]
        assert abs(got["loss"] - plain["loss"]) <= TOL["loss"] * plain["loss"]
        gg, pg = _leaves(got["grads"]), _leaves(plain["grads"])
        assert gg.keys() == pg.keys()
        for name, g in pg.items():
            assert _rel(gg[name], g) <= TOL["grad"], name
        scale = min(1.0, 1.0 / (plain["gnorm"] + 1e-12))
        for name, w in _leaves(plain["params"]).items():
            diff = np.abs(_leaves(got["params"])[name] - w)
            far = np.abs(pg[name]) * scale >= 100 * AdamW().eps
            assert diff.max() <= 2 * LR, name
            assert (diff[far] <= TOL["param"]).all(), name
        assert got["flash"] == [(4 // dp, width, 32, cfg.d_head)] \
            * (2 * cfg.n_layers)
        logits, kv = _memo(("port", arch, "batch"),
                           lambda: _port_unsharded(arch, "batch", weights))
        served = r[arch]["batch"]
        for i in range(STEPS + 1):
            assert _rel(served["logits"][i], logits[i]) <= TOL["port"], i
        assert np.array_equal(served["logits"].argmax(-1), logits.argmax(-1))
        for c, p in zip(served["kv"], kv):
            assert _rel(c, p) <= TOL["cache"]
    if arch in ARCHS:
        want = _memo(("ref", arch), lambda: _reference_train(arch, weights))
        got = runs(mesh_name)[0][arch]["train"]
        assert abs(got["loss"] - want["loss"]) <= TOL["loss"] * want["loss"]
        gg, wg = _leaves(got["grads"]), _leaves(want["grads"])
        for name, w in wg.items():
            assert _rel(gg[name], w) <= TOL["grad"], name


@pytest.mark.parametrize("mesh_name,arch", CASES)
def test_sharded_train_step(runs, mesh_name, arch):
    """The loss, gradients and one AdamW step against the reference's
    jitted steps and the unsharded port; every rank holds the same."""
    weights = runs("weights")
    want = _memo(("ref", arch), lambda: _reference_train(arch, weights))
    plain = _memo(("port", arch, "train"),
                  lambda: _port_unsharded(arch, "train", weights))
    ranks = runs(mesh_name)
    got = ranks[0][arch]["train"]
    assert abs(got["loss"] - want["loss"]) <= TOL["loss"] * want["loss"]
    assert abs(got["loss"] - plain["loss"]) <= TOL["loss"] * plain["loss"]
    gg, wg, pg = (_leaves(t["grads"]) for t in (got, want, plain))
    assert gg.keys() == wg.keys()
    for name, w in wg.items():
        assert _rel(gg[name], w) <= TOL["grad"], name
        assert _rel(gg[name], pg[name]) <= TOL["grad"], name
    gp, wp = _leaves(got["params"]), _leaves(want["params"])
    for name, w in wp.items():
        assert np.abs(gp[name] - w).max() <= TOL["param"], name
    for name, w in _leaves(want["mu"]).items():
        assert _rel(_leaves(got["mu"])[name], w) <= 10 * TOL["grad"], name
    # remat on: each layer's attention twice (forward and recompute), on
    # each rank's (B/dp, H/tp) block at group 1
    shape, names = MESHES[mesh_name]
    dp = math.prod(n for n, a in zip(shape, names) if a != "model")
    tp = shape[names.index("model")]
    cfg = _cfg(arch)
    assert got["flash"] == [(4 // dp, cfg.n_heads // tp, 32, cfg.d_head)] \
        * (2 * cfg.n_layers)
    assert plain["flash"] == [(4, cfg.n_heads, 32, cfg.d_head)] \
        * (2 * cfg.n_layers)
    for r in ranks[1:]:
        assert r[arch]["train"]["loss"] == got["loss"]
        for name, g in _leaves(r[arch]["train"]["params"]).items():
            assert np.array_equal(g, gp[name]), name


@pytest.mark.parametrize("mesh_name,arch", CASES)
def test_sharded_grad_norm_sums_every_shard(runs, mesh_name, arch):
    """AdamW's clip norm over DTensor gradients is the global norm (the
    unsharded port's to 1e-6), which the rank's own blocks miss as soon
    as dp or tp is above one; AdamW's moments keep their parameters'
    placements."""
    plain = _memo(("port", arch, "train"),
                  lambda: _port_unsharded(arch, "train", runs("weights")))
    for r in runs(mesh_name):
        got = r[arch]["train"]
        assert abs(got["gnorm"] - plain["gnorm"]) <= 1e-6 * plain["gnorm"]
        assert abs(got["local_norm"] - plain["gnorm"]) > 1e-3 * plain["gnorm"]
        assert all(got["moment_placements"])


@pytest.mark.parametrize("mesh_name,arch,case", SERVE_CASES)
def test_sharded_prefill_decode(runs, mesh_name, arch, case):
    """Prefill logits and 4 decode steps against the reference's (1e-3
    of the largest logit) and the unsharded port's (1e-4), the cache
    gathered against the unsharded port's, on the cache placement the
    reference's decode cell gives that case."""
    weights = runs("weights")
    want = _memo(("ref", arch, case),
                 lambda: _reference_serve(arch, case, weights))
    plain, plain_kv = _memo(("port", arch, case),
                            lambda: _port_unsharded(arch, case, weights))
    shape, names = MESHES[mesh_name]
    b = SERVE[case][0]
    spec = LM(_cfg(arch, **SERVE[case][1]), device="meta", init=False
              ).decode_cache_spec(b, _axes(names))
    dp = _axes(names).dp
    assert spec == {"batch": (None, dp, "model", None, None),
                    "one": (None, None, dp + ("model",), None, None),
                    "chunked": (None, dp, None, None, "model")}[case]
    for r in runs(mesh_name):
        got = r[arch][case]
        assert got["logits"].shape == want.shape == (STEPS + 1, b,
                                                     _cfg(arch).vocab)
        for i in range(STEPS + 1):
            assert _rel(got["logits"][i], want[i]) <= TOL["logits"], i
            assert _rel(got["logits"][i], plain[i]) <= TOL["port"], i
        for c, p in zip(got["kv"], plain_kv):
            assert _rel(c, p) <= TOL["cache"]
        fake = _FakeMesh(shape, names)
        assert _spec_of(got["cache_placements"], fake, 5) == \
            _canonical(spec)


class _FakeMesh:
    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


def _spec_of(placements, mesh, ndim: int) -> tuple:
    """``sharding.placements`` undone: the spec of ``placements`` on
    ``mesh`` for a tensor of ``ndim`` dimensions."""
    from torch.distributed.tensor import Replicate, Shard
    dims: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            dims[p.dim % ndim].append(name)
        else:
            assert isinstance(p, Replicate), p
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in dims)


def _canonical(spec):
    """A spec with one-name tuples written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_parameters_placed_by_their_specs(runs, mesh_name):
    """Each DTensor parameter's placements are its spec's."""
    shape, names = MESHES[mesh_name]
    fake = _FakeMesh(shape, names)
    axes = _axes(names)
    for arch in WORK[mesh_name]:
        specs = LM(_cfg(arch), device="meta", init=False).param_specs(axes)
        for r in runs(mesh_name):
            got = r[arch]["placements"]
            assert got.keys() == specs.keys()
            for name, pl in got.items():
                assert _spec_of(pl, fake, len(specs[name])) == \
                    _canonical(specs[name]), name


@pytest.mark.parametrize("mesh_name", CELLS_ON)
def test_sharded_cells(runs, mesh_name):
    """``launch.cells``' sharded LM cells (``build_cell(..., mesh=)``):
    the train, prefill and decode (batch 4 and 1) steps on the mesh equal
    the unsharded cells on the CPU (same seed-0 weights); their arguments
    are placed as the reference's in_shardings: the parameters and
    AdamW's moments by ``param_specs`` (the count a plain tensor), tokens
    on (dp, None), the cache by the decode spec."""
    shape, names = MESHES[mesh_name]
    fake = _FakeMesh(shape, names)
    axes = _axes(names)
    dp = axes.dp
    pspecs = list(LM(_cfg("qwen3-1.7b"), device="meta", init=False)
                  .param_specs(axes).values())
    want = {"train4": pspecs * 2 + [(dp, None)],
            "prefill4": [(dp, None)],
            "decode4": [(None, dp, "model", None, None)] * 2 + [(dp, None)],
            "decode1": [(None, None, dp + ("model",), None, None)] * 2
            + [(None, None)]}
    for r in runs(mesh_name):
        cells = r["cells"]
        assert set(cells) == set(want)
        for name, c in cells.items():
            tol = 1e-5 if name == "train4" else 1e-4
            assert _rel(c["sharded"], c["plain"]) <= tol, name
            assert [_spec_of(pl, fake, len(sp)) for pl, sp in
                    zip(c["args"], want[name])] == \
                [_canonical(sp) for sp in want[name]], name
        assert cells["train4"]["count"] == "Tensor"


def test_two_axis_dimension_in_mesh_order(runs):
    """On the (pod, data, model) = (2, 2, 1) mesh a dimension of 8 rows
    sharded over ("pod", "data") gives rank (p, d) rows 2 (2p + d) ..
    2 (2p + d) + 1: pod major, data minor, as GSPMD's tuple axes."""
    full = np.arange(8.0 * 3).reshape(8, 3)
    for r in runs("pod2x2x1"):
        p, d, _ = r["coord"]
        blk = 2 * p + d
        np.testing.assert_array_equal(r["two_axis_block"],
                                      full[2 * blk:2 * blk + 2])
