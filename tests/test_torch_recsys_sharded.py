"""Wide & Deep on a DeviceMesh (``WideDeep(lookup="collective", mesh=)``,
``param_specs``, ``HybridAdamW`` and ``AdamW`` over DTensors, the sharded
``retrieval_scores``, ``launch.cells`` on a mesh) against the JAX
reference's unsharded functions and the unsharded port, on the CPU over
gloo.

One spawn per mesh: (1, 2), (2, 1) and (2, 2) over ("data", "model").
Every rank loads the reference's ``WideDeep.init`` weights (saved by this
process) through ``convert.widedeep_from_numpy(..., mesh=)``, so each
keeps its rows of every table (row-sharded over "model"), and runs the
reduced config in f32: the forward logits of a batch on dp, one train
step under ``AdamW`` and one under ``HybridAdamW`` (SGD on the tables'
local rows), and ``retrieval_scores`` of one query against 4,096
candidates placed over dp and "model".  The ids hold the first and the
last row of every table shard, so the masked lookup's edges are taken.
On (2, 2) the lookup ``"auto"`` (on a mesh the same masked lookup: the
reference leaves it to GSPMD) runs the forward too, and ``launch.cells``' four recsys
cell kinds (train_batch, serve_p99, serve_bulk, retrieval_cand, at small
batches) run on the mesh against the unsharded cells.  In this process
the reference's own ``_bag_collective`` (its ``shard_map``) runs on a
one-device jax mesh against its ``"auto"`` lookup.

Tolerances (f32): logits and loss 1e-6 relative (the bag sums of one
field add two rows; across shards they add in another order);
parameters 2e-5 absolute; the top-100 indices equal and their values to
1e-6 relative.
"""
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.core import distributed as TD
from repro_torch.models import convert, recsys
from repro_torch.optim import AdamW, HybridAdamW

MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
NAMES = ("data", "model")
CELLS_ON = ("2x2",)
SPAWN_TIMEOUT = 600.0
B, N_CAND = 32, 4096
LR, SGD_LR = 1e-3, 0.05
TOL = dict(logits=1e-6, loss=1e-6, param=2e-5, top=1e-6)
#: the cells at small batches: name -> (kind, meta)
CELLS = {"train_batch": ("train", dict(batch=16)),
         "serve_p99": ("serve", dict(batch=8)),
         "serve_bulk": ("serve", dict(batch=32)),
         "retrieval_cand": ("retrieval", dict(batch=1, n_candidates=512))}


def _cfg():
    return configs.get("wide-deep").make_reduced()


def _optimizers():
    return {"adamw": AdamW(lr=LR),
            "hybrid": HybridAdamW(adamw=AdamW(lr=LR, clip_norm=None),
                                  sgd_lr=SGD_LR)}


def _batch(cfg, b, seed, candidates=0):
    """A numpy batch whose ids hold the first and last row of every
    table shard at tp 2 (rows 0, v/2 - 1, v/2, v - 1) in each field (at
    batch 1, its two ids two of them)."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, (b, cfg.ids_per_field))
                    for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    for f, v in enumerate(cfg.vocab_sizes):
        edges = (0, v // 2 - 1, v // 2, v - 1)
        n = min(b, 4)
        ids[:n, f, 0] = edges[:n]
        ids[0, f, 1] = edges[(f + 1) % 4]
    out = {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
           "sparse_ids": ids,
           "labels": rng.integers(0, 2, (b,)).astype(np.float32)}
    if candidates:
        out["candidates"] = rng.normal(
            size=(candidates, cfg.retrieval_dim)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _flat(tree) -> dict:
    """A parameter tree as ``{"tables/t0": array}``."""
    import jax
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in kp)
        out[name] = np.asarray(leaf)
    return out


def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


# -- the ranks ------------------------------------------------------------------

def _model(tree, mesh, lookup="collective"):
    return convert.widedeep_from_numpy(_cfg(), tree, device="cpu",
                                       lookup=lookup, mesh=mesh)


def _run(tree, mesh, lookup="collective"):
    """Forward logits, one step under each optimizer, retrieval."""
    cfg = _cfg()
    out = {}
    m = _model(tree, mesh, lookup)
    with torch.no_grad():
        out["logits"] = _full(m(_t(_batch(cfg, B, 1)))).numpy()
    if lookup != "collective":
        return out
    out["placements"] = {n: tuple(p.placements) if isinstance(p, DTensor)
                         else None for n, p in m.params().items()}
    for name, opt in _optimizers().items():
        m = _model(tree, mesh)
        params = m.params()
        st = opt.init(params)
        step = recsys.make_recsys_train_step(m, opt)
        _, st, met = step(params, st, _t(_batch(cfg, B, 2)))
        out[name] = dict(
            loss=float(met["loss"]),
            params={n: _full(p).numpy() for n, p in params.items()},
            moments=[tuple(m_.placements) if isinstance(m_, DTensor)
                     else tuple(m_.shape) for m_ in st.mu])
    m = _model(tree, mesh)
    with torch.no_grad():
        vals, idx = m.retrieval_scores(_t(_batch(cfg, 1, 3, N_CAND)))
    out["top"] = (vals.numpy(), idx.numpy())
    return out


def _cells(mesh, out):
    """``launch.cells``' recsys steps on the mesh and unsharded, on the
    same random batches (the cells' own are zeros)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import cells
    cfg = _cfg()
    for name, (kind, meta) in CELLS.items():
        cell = ShapeCell(name, kind, meta)
        b = meta["batch"]
        batch = _batch(cfg, b, 4, meta.get("n_candidates", 0))
        if kind != "train":
            batch.pop("labels")
        got = {}
        for which, build in (
                ("sharded", cells._build_recsys(cfg, cell, None, mesh)),
                ("plain", cells._build_recsys(cfg, cell,
                                              torch.device("cpu")))):
            args = build.abstract_args
            if which == "sharded":
                got["args"] = {k: tuple(v.placements)
                               for k, v in args[-1].items()}
                got["param_args"] = [
                    tuple(p.placements) for p in args[0].values()]
            res = build.fn(*args[:-1], _t(batch))
            if kind == "train":
                res = (res[2]["loss"], *res[0].values())
            elif kind == "retrieval":
                res = tuple(res)
            else:
                res = (res,)
            got[which] = [_full(r).numpy() for r in res]
        out[name] = got


def _rank_main(rank, world, mesh_name, wdir):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(MESHES[mesh_name], NAMES, device="cpu")
    tree = torch.load(os.path.join(wdir, "weights.pt"), weights_only=False)
    out = {"collective": _run(tree, mesh)}
    if mesh_name in CELLS_ON:
        out["auto"] = _run(tree, mesh, "auto")
        out["cells"] = {}
        _cells(mesh, out["cells"])
    torch.save(out, os.path.join(wdir, f"rank{rank}.pt"))


# -- this process ---------------------------------------------------------------

def _reference():
    """The reference's weights (numpy) and its forward, train steps and
    retrieval on the batches the ranks use."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import recsys as jrecsys
    from repro.optim import AdamW as JAdamW
    from repro.optim import HybridAdamW as JHybrid
    jcfg = jconfigs.get("wide-deep").make_reduced()
    jm = jrecsys.WideDeep(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = _cfg()
    out = {"tree": jax.tree.map(np.asarray, params),
           "logits": np.asarray(jm.forward(params, _batch(cfg, B, 1)))}
    for name, jopt in (("adamw", JAdamW(lr=LR)),
                       ("hybrid", JHybrid(adamw=JAdamW(lr=LR, clip_norm=None),
                                          sgd_lr=SGD_LR))):
        step = jax.jit(jrecsys.make_recsys_train_step(jm, jopt))
        new, _, met = step(params, jopt.init(params),
                           jax.tree.map(jnp.asarray, _batch(cfg, B, 2)))
        out[name] = dict(loss=float(met["loss"]), params=_flat(new))
    vals, idx = jm.retrieval_scores(params, _batch(cfg, 1, 3, N_CAND))
    out["top"] = (np.asarray(vals), np.asarray(idx))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("recsys_sharded")
    ref = _reference()
    torch.save(ref["tree"], root / "weights.pt")
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
    done = {"ref": ref}

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


def _plain(runs):
    """The unsharded port on the reference's weights."""
    if "plain" not in _MEMO:
        _MEMO["plain"] = _run(runs("ref")["tree"], None)
    return _MEMO["plain"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_collective_forward(runs, mesh_name):
    """Logits of a batch on dp against the reference's and the unsharded
    port's (1e-6 relative); every rank gathers the same."""
    want = runs("ref")["logits"]
    plain = _plain(runs)["logits"]
    for r in runs(mesh_name):
        got = r["collective"]["logits"]
        assert got.shape == (B,)
        assert _rel(got, want) <= TOL["logits"]
        assert _rel(got, plain) <= TOL["logits"]


@pytest.mark.parametrize("opt", ["adamw", "hybrid"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_collective_train_step(runs, mesh_name, opt):
    """One step under AdamW and under HybridAdamW (the tables' SGD on each
    rank's rows): the loss (1e-6 relative) and every parameter (2e-5)
    against the reference's jitted step; the moments placed as their
    parameters, HybridAdamW's table moments 0-d."""
    want = runs("ref")[opt]
    for r in runs(mesh_name):
        got = r["collective"][opt]
        assert abs(got["loss"] - want["loss"]) <= TOL["loss"] * want["loss"]
        assert got["params"].keys() == want["params"].keys()
        for name, w in want["params"].items():
            assert np.abs(got["params"][name] - w).max() <= TOL["param"], \
                name
        names = list(got["params"])
        for name, m in zip(names, got["moments"]):
            if opt == "hybrid" and "tables" in name:
                assert m == (), name
            else:
                assert m == r["collective"]["placements"][name], name
    before = _flat(runs("ref")["tree"])
    assert max(np.abs(got["params"][n] - before[n]).max()
               for n in before) > LR / 2


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_retrieval_top100(runs, mesh_name):
    """The exact top 100 of 4,096 candidates placed over dp and "model":
    the reference's indices, its values to 1e-6 relative."""
    wv, wi = runs("ref")["top"]
    for r in runs(mesh_name):
        vals, idx = r["collective"]["top"]
        assert vals.shape == idx.shape == (100,)
        np.testing.assert_array_equal(idx, wi)
        assert _rel(vals, wv) <= TOL["top"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tables_row_sharded_by_param_specs(runs, mesh_name):
    """Every ``tables``/``wide_tables`` leaf is Shard(0) over "model" and
    replicated over "data"; every other leaf replicated."""
    from torch.distributed.tensor import Replicate, Shard
    for r in runs(mesh_name):
        for name, pl in r["collective"]["placements"].items():
            if "tables" in name:
                assert pl == (Replicate(), Shard(0)), name
            else:
                assert pl == (Replicate(), Replicate()), name


@pytest.mark.parametrize("mesh_name", CELLS_ON)
def test_auto_lookup_on_a_mesh(runs, mesh_name):
    """``lookup="auto"`` on the row-sharded tables gives the reference's
    logits (the port runs its one row-sharded lookup for it)."""
    want = runs("ref")["logits"]
    for r in runs(mesh_name):
        assert _rel(r["auto"]["logits"], want) <= TOL["logits"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_sharded_recsys_cells(runs, cell):
    """``launch.cells._build_recsys`` on (2, 2): the step's results equal
    the unsharded cell's on the same batch; the batch is placed as the
    reference's in_shardings (dp; retrieval's query replicated and its
    candidates over dp and "model"), the tables on "model"."""
    from torch.distributed.tensor import Replicate, Shard
    kind = CELLS[cell][0]
    dp = Shard(0)
    want_args = ({"dense": (Replicate(), Replicate()),
                  "sparse_ids": (Replicate(), Replicate()),
                  "candidates": (Shard(0), Shard(0))}
                 if kind == "retrieval" else
                 {"dense": (dp, Replicate()), "sparse_ids": (dp, Replicate())})
    if kind == "train":
        want_args["labels"] = (dp, Replicate())
    for r in runs("2x2"):
        got = r["cells"][cell]
        assert got["args"] == want_args
        assert (Replicate(), Shard(0)) in got["param_args"]
        assert len(got["sharded"]) == len(got["plain"])
        for a, b in zip(got["sharded"], got["plain"]):
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b)
            else:
                assert _rel(a, b) <= (TOL["param"] if kind == "train"
                                      else TOL["logits"])


def test_reference_bag_collective_on_a_one_device_mesh():
    """The reference's own ``_bag_collective`` (its ``shard_map``) on a
    one-device jax mesh gives its ``"auto"`` logits, and the port's
    collective lookup on a one-rank mesh gives them too."""
    import jax
    from jax.sharding import Mesh

    from repro import configs as jconfigs
    from repro.models import recsys as jrecsys
    from repro_torch.launch.mesh import make_mesh
    jcfg = jconfigs.get("wide-deep").make_reduced()
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    jm = jrecsys.WideDeep(jcfg, lookup="collective", mesh=mesh)
    params = jm.init(jax.random.PRNGKey(0))
    b = _batch(_cfg(), B, 1)
    want = np.asarray(jrecsys.WideDeep(jcfg).forward(params, b))
    got = np.asarray(jm.forward(params, b))
    assert _rel(got, want) <= TOL["logits"]
    tree = jax.tree.map(np.asarray, params)
    with TD.process_group("cpu"):
        tmesh = make_mesh((1, 1), NAMES, device="cpu")
        m = _model(tree, tmesh)
        with torch.no_grad():
            port = _full(m(_t(b))).numpy()
    assert _rel(port, want) <= TOL["logits"]
