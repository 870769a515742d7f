"""The sharded MoE LMs (``layers._moe_ffn_sharded`` under ``shard_lm``:
experts on tp, their D on the fsdp axes, the routing global over the
batch) against the JAX reference's unsharded steps and the unsharded
port, on the CPU over gloo.

The steps run on spawned gloo ranks (``core.distributed.spawn``), one
spawn per mesh: (1, 2), (2, 1) and (2, 2) over ("data", "model").  Every
rank loads the reference's ``LM.init`` weights (saved by this process)
into the port (``convert.lm_from_numpy``), places them (``shard_lm``) and
runs, for arctic-480b's and llama4-maverick's reduced configs in f32
with remat on: the loss (aux included) and its gradients, one AdamW step
(lr 1e-3) on them, and a prefill of 10 tokens into a 24-slot cache then
4 decode steps on the reference's decode cache spec (arctic: the batch on
dp, the sequence on tp; llama4's chunked attention: the batch on dp,
head features on tp).  arctic trains at capacity factor 0.5, so
assignments drop: the capacity counts all B * S tokens and the capacity
ranks sort all T * k assignments, not a rank's share, and the routing
(each call's top experts and kept assignments) must equal the unsharded
port's.  Each rank gathers its results (``full_tensor``) and saves them;
this process holds them against the reference's jitted steps and the
unsharded port on the same weights.  The sharded ``launch.cells`` MoE
steps run on (2, 2) against the unsharded cells.

Tolerances (f32), and why:

- loss 1e-5 relative and gradients 1e-4 of each leaf's largest entry,
  as ``tests/test_torch_moe.py`` (the shards add their partial sums in
  other orders).
- parameters after AdamW: ``tests/test_torch_moe.py``'s MoE rule, every
  entry within 2 lr of the reference's and fewer than 0.1% beyond 2e-5
  (an expert that saw few tokens has gradients near AdamW's eps, where
  a first step follows the gradient's last bits).
- prefill and decode logits 1e-3 of the largest logit against the
  reference, 1e-4 against the unsharded port.
- routing: equal.
"""
import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.core import distributed as TD
from repro_torch.models import convert, layers, sharding
from repro_torch.models.transformer import LM, MeshAxes
from repro_torch.optim import AdamW

ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
#: the training case's config overrides: arctic's drops assignments
TRAIN_OVER = {"arctic-480b": dict(capacity_factor=0.5),
              "llama4-maverick-400b-a17b": {}}
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
NAMES = ("data", "model")
CELLS_ON = ("2x2",)
SPAWN_TIMEOUT = 600.0
T, P, STEPS = 24, 10, 4         # cache slots, prompt, decode steps
B_SERVE = 4
LR = 1e-3
TOL = dict(loss=1e-5, grad=1e-4, param=2e-5, logits=1e-3, port=1e-4)


def _cfg(arch, **over):
    return dataclasses.replace(configs.get(arch).make_reduced(),
                               compute_dtype=torch.float32, remat=True,
                               **over)


def _jcfg(arch, **over):
    import jax.numpy as jnp

    from repro import configs as jconfigs
    return dataclasses.replace(jconfigs.get(arch).make_reduced(),
                               compute_dtype=jnp.float32, remat=True, **over)


def _serve_tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (B_SERVE, T)).astype(
        np.int64)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _leaves(tree) -> dict:
    from repro_torch.train import checkpoint as ckpt_lib
    return {k: np.asarray(v) for k, v in ckpt_lib.leaves(tree)}


class _Routes:
    """While entered, each MoE call's routing is kept: ``top_e`` (T, k)
    from ``layers.moe_route`` and ``keep`` (T * k,) from
    ``layers._moe_dispatch``, as numpy, in call order."""

    def __enter__(self):
        self.top_e, self.keep = [], []
        self._route, self._dispatch = layers.moe_route, layers._moe_dispatch

        def route(gates, k):
            out = self._route(gates, k)
            self.top_e.append(out[1].detach().numpy().copy())
            return out

        def dispatch(xf, router, cfg):
            out = self._dispatch(xf, router, cfg)
            self.keep.append(out[1].detach().numpy().copy())
            return out
        layers.moe_route, layers._moe_dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        layers.moe_route, layers._moe_dispatch = self._route, self._dispatch


# -- the ranks ------------------------------------------------------------------

def _serve(lm, tokens):
    """Prefill P tokens into a T-slot cache, then STEPS teacher-forced
    decode steps: the logits (STEPS + 1, B, V) and the cache's placement."""
    toks = torch.as_tensor(tokens)
    logits, cache = lm.prefill(toks[:, :P], cache_len=T)
    out = [logits]
    for i in range(STEPS):
        logits, cache = lm.decode_step(cache, toks[:, P + i:P + i + 1],
                                       P + i)
        out.append(logits)
    full = [t.full_tensor() if isinstance(t, DTensor) else t for t in out]
    pl = tuple(cache[0].placements) if isinstance(cache[0], DTensor) \
        else None
    return torch.stack(full).numpy(), pl


def _train(lm, batch):
    """Loss, aux, gradients and one AdamW step of ``lm``, with the
    routing of every MoE call of the loss and its backward (remat)."""
    ps = list(lm.parameters())
    with _Routes() as routes:
        loss, met = lm.loss(batch)
        grads = torch.autograd.grad(loss, ps)
    res = dict(loss=loss.detach().item(), aux=met["aux"].detach().item(),
               grads=convert.lm_to_numpy(lm, grads), top_e=routes.top_e,
               keep=routes.keep)
    opt = AdamW(lr=LR)
    opt.step(ps, grads, opt.init(ps))
    res["params"] = convert.lm_to_numpy(lm)
    return res


def _cells(mesh, out):
    """The sharded MoE cells of ``launch.cells`` (arctic's reduced config,
    seed-0 weights) beside the unsharded ones on the CPU."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import cells
    cfg = _cfg("arctic-480b")
    for kind, meta in (("train", dict(batch=4, seq=16)),
                       ("decode", dict(batch=4, seq=16))):
        cell = ShapeCell(f"{kind}{meta['batch']}", kind, meta)
        got = {}
        for name, build in (
                ("sharded", cells._build_lm(cfg, cell, None, mesh)),
                ("plain", cells._build_lm(cfg, cell, torch.device("cpu")))):
            res = build.fn(*build.abstract_args)
            res = res[2]["loss"] if kind == "train" else res[0]
            got[name] = (res.full_tensor() if isinstance(res, DTensor)
                         else res).numpy()
        out[cell.name] = got


def _rank_main(rank, world, mesh_name, wdir):
    """One spawned rank of ``mesh_name``: each arch's train step and
    serve case, the cells; results saved."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)    # the ranks share the cores
    mesh = make_mesh(MESHES[mesh_name], NAMES, device="cpu")
    weights = torch.load(os.path.join(wdir, "weights.pt"),
                         weights_only=False)
    out = {}
    for arch in ARCHS:
        tree, batch = weights[arch]
        batch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
        lm = sharding.shard_lm(convert.lm_from_numpy(
            _cfg(arch, **TRAIN_OVER[arch]), tree, device="cpu"), mesh)
        res = {"train": _train(lm, batch),
               "placements": {n: tuple(p.placements)
                              for n, p in lm.named_parameters()}}
        lm = sharding.shard_lm(convert.lm_from_numpy(
            _cfg(arch), tree, device="cpu"), mesh)
        res["serve"] = _serve(lm, _serve_tokens(lm.cfg.vocab))
        out[arch] = res
    if mesh_name in CELLS_ON:
        out["cells"] = {}
        _cells(mesh, out["cells"])
    torch.save(out, os.path.join(wdir, f"rank{rank}.pt"))


# -- this process ---------------------------------------------------------------

def _reference_weights():
    """arch -> (the reference's ``LM.init`` tree as numpy, the training
    batch as numpy)."""
    import jax

    from repro.data import TokenStream as JTokens
    from repro.models.transformer import LM as JLM
    out = {}
    for arch in ARCHS:
        jm = JLM(_jcfg(arch))
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        out[arch] = (params, JTokens(4, 32, jm.cfg.vocab, seed=0)
                     .batch_at(0))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights, saved, then one spawn per mesh, one after
    another in a background thread; ``get(mesh_name)`` waits for one and
    gives every rank's results, ``get("weights")`` the weights."""
    root = tmp_path_factory.mktemp("moe_sharded")
    weights = _reference_weights()
    torch.save(weights, root / "weights.pt")
    TD.SPAWN_TIMEOUT, timeout = SPAWN_TIMEOUT, TD.SPAWN_TIMEOUT
    pool = ThreadPoolExecutor(1)
    jobs = {}
    for name, shape in MESHES.items():
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
    """The reference's loss, aux, gradients and one jitted
    ``make_train_step`` on the same weights, batch and capacity."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import LM as JLM
    from repro.models.transformer import make_train_step as jstep
    from repro.optim import AdamW as JAdamW
    tree, batch = weights[arch]
    jm = JLM(_jcfg(arch, **TRAIN_OVER[arch]))
    params = jax.tree.map(jnp.asarray, tree)
    jb = jax.tree.map(jnp.asarray, batch)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jb)
    opt = JAdamW(lr=LR)
    new, _, _ = jax.jit(jstep(jm, opt))(params, opt.init(params), jb)
    np_ = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return dict(loss=float(loss), aux=float(met["aux"]), grads=np_(grads),
                params=np_(new))


def _reference_serve(arch, weights):
    """The reference's prefill logits and STEPS decode steps' logits
    (STEPS + 1, B, V), its cache padded to T slots as the port's."""
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import LM as JLM
    jm = JLM(_jcfg(arch))
    params = jax.tree.map(jnp.asarray, weights[arch][0])
    toks = _serve_tokens(jm.cfg.vocab).astype(np.int32)
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
    """The unsharded port on the same weights: the train results or the
    serve logits."""
    tree, batch = weights[arch]
    if case == "train":
        lm = convert.lm_from_numpy(_cfg(arch, **TRAIN_OVER[arch]), tree,
                                   device="cpu")
        return _train(lm, {k: torch.as_tensor(v).long()
                           for k, v in batch.items()})
    lm = convert.lm_from_numpy(_cfg(arch), tree, device="cpu")
    return _serve(lm, _serve_tokens(lm.cfg.vocab))[0]


def _axes_of(placements, names, ndim):
    """The spec of ``placements`` (``sharding.placements`` undone)."""
    from torch.distributed.tensor import Replicate, Shard
    dims: list = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            dims[p.dim % ndim].append(name)
        else:
            assert isinstance(p, Replicate), p
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in dims)


# -- tests ----------------------------------------------------------------------

CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("mesh_name,arch", CASES)
def test_sharded_moe_train_step(runs, mesh_name, arch):
    """The loss (aux included), its gradients and one AdamW step against
    the reference's jitted steps and the unsharded port; every rank
    holds the same."""
    weights = runs("weights")
    want = _memo(("ref", arch), lambda: _reference_train(arch, weights))
    plain = _memo(("port", arch, "train"),
                  lambda: _port_unsharded(arch, "train", weights))
    ranks = runs(mesh_name)
    got = ranks[0][arch]["train"]
    for key in ("loss", "aux"):
        assert abs(got[key] - want[key]) <= TOL["loss"] * want[key], key
        assert abs(got[key] - plain[key]) <= TOL["loss"] * plain[key], key
    gg, wg, pg = (_leaves(t["grads"]) for t in (got, want, plain))
    assert gg.keys() == wg.keys()
    assert any("moe/w_gate" in n for n in wg)
    for name, w in wg.items():
        assert _rel(gg[name], w) <= TOL["grad"], name
        assert _rel(gg[name], pg[name]) <= TOL["grad"], name
    gp, wp = _leaves(got["params"]), _leaves(want["params"])
    off = total = 0
    for name, w in wp.items():
        diff = np.abs(gp[name] - w)
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        off += int((diff > TOL["param"]).sum())
        total += diff.size
    assert off < 1e-3 * total
    for r in ranks[1:]:
        assert r[arch]["train"]["loss"] == got["loss"]
        for name, g in _leaves(r[arch]["train"]["params"]).items():
            assert np.array_equal(g, gp[name]), name


@pytest.mark.parametrize("mesh_name,arch", CASES)
def test_sharded_routing_is_global(runs, mesh_name, arch):
    """Every MoE call of the sharded loss and its remat backward routes
    the whole batch as the unsharded port does: the same top experts and
    the same kept assignments, on every rank.  arctic's capacity factor
    0.5 drops assignments (llama4's top-1 at 1.25 drops some too): with
    a rank's share of the tokens the
    capacity and the ranks within an expert would drop others."""
    plain = _memo(("port", arch, "train"),
                  lambda: _port_unsharded(arch, "train", runs("weights")))
    cfg = _cfg(arch, **TRAIN_OVER[arch])
    n_calls = 2 * cfg.n_layers      # the forward and the remat recompute
    assert len(plain["top_e"]) == len(plain["keep"]) == n_calls
    for r in runs(mesh_name):
        got = r[arch]["train"]
        assert len(got["top_e"]) == len(got["keep"]) == n_calls
        for a, b in zip(got["top_e"], plain["top_e"]):
            assert a.shape == (4 * 32, cfg.top_k)
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["keep"], plain["keep"]):
            np.testing.assert_array_equal(a, b)
    dropped = sum(int((~k).sum()) for k in plain["keep"])
    if arch == "arctic-480b":
        assert dropped > 0
    if dropped:
        # a rank's share of the tokens would give another capacity
        shape = MESHES[mesh_name]
        if shape[0] > 1:
            assert layers.moe_capacity(cfg, 4 * 32 // shape[0]) \
                != layers.moe_capacity(cfg, 4 * 32)


@pytest.mark.parametrize("mesh_name,arch", CASES)
def test_sharded_moe_prefill_decode(runs, mesh_name, arch):
    """Prefill logits and 4 decode steps against the reference's (1e-3
    of the largest logit) and the unsharded port's (1e-4), on the cache
    placement the reference's decode cell gives the arch."""
    weights = runs("weights")
    want = _memo(("ref", arch, "serve"),
                 lambda: _reference_serve(arch, weights))
    plain = _memo(("port", arch, "serve"),
                  lambda: _port_unsharded(arch, "serve", weights))
    spec = LM(_cfg(arch), device="meta", init=False).decode_cache_spec(
        B_SERVE, MeshAxes())
    assert spec == ((None, ("data",), None, None, "model")
                    if arch.startswith("llama4") else
                    (None, ("data",), "model", None, None))
    for r in runs(mesh_name):
        logits, pl = r[arch]["serve"]
        assert logits.shape == want.shape == (STEPS + 1, B_SERVE,
                                              _cfg(arch).vocab)
        for i in range(STEPS + 1):
            assert _rel(logits[i], want[i]) <= TOL["logits"], i
            assert _rel(logits[i], plain[i]) <= TOL["port"], i
        assert _axes_of(pl, NAMES, 5) == tuple(
            e[0] if isinstance(e, tuple) else e for e in spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_parameters_placed_by_their_specs(runs, mesh_name):
    """Each DTensor parameter's placements are its spec's: the experts'
    E on tp and D on dp, the router's D on dp, the dense residual and
    shared expert as the dense FFN."""
    for arch in ARCHS:
        specs = LM(_cfg(arch), device="meta", init=False).param_specs()
        assert specs["blocks.0.moe.w_gate"] == ("model", ("data",), None)
        assert specs["blocks.0.moe.w_down"] == ("model", None, ("data",))
        assert specs["blocks.0.moe.router"] == (("data",), None)
        assert specs["blocks.0.moe.dense.w_gate"] == (("data",), "model")
        for r in runs(mesh_name):
            got = r[arch]["placements"]
            assert got.keys() == specs.keys()
            for name, pl in got.items():
                want = tuple(e[0] if isinstance(e, tuple) else e
                             for e in specs[name])
                assert _axes_of(pl, NAMES, len(want)) == want, name


@pytest.mark.parametrize("mesh_name", CELLS_ON)
def test_sharded_moe_cells(runs, mesh_name):
    """``launch.cells``' sharded MoE cells (``build_cell(..., mesh=)``
    builds a MoE LM on the mesh): the train and decode steps equal the
    unsharded cells on the CPU (same seed-0 weights)."""
    for r in runs(mesh_name):
        cells = r["cells"]
        assert set(cells) == {"train4", "decode4"}
        for name, c in cells.items():
            tol = 1e-5 if name == "train4" else 1e-4
            assert np.isfinite(c["sharded"]).all()
            assert _rel(c["sharded"], c["plain"]) <= tol, name
