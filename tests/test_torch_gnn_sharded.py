"""The four GNNs on a DeviceMesh (``launch.cells._build_gnn(..., mesh)``,
``models.gnn.common.edge_sharded``, ``perf_flags.gnn_edge_dp``) against
the JAX reference's unsharded loss and AdamW step, on the CPU over gloo.

One spawn per mesh: (1, 2), (2, 1) and (2, 2) over ("data", "model").
Every rank builds each GNN's cell step on the mesh at its reduced config
(parameters replicated), loads the reference's ``init`` weights (saved by
this process) into it, and runs one AdamW step (lr 1e-3) on two batches:

- the ``molecule`` cell: 4 graphs of 16 nodes and 48 edges on dp, each
  rank's graphs one disjoint union, the loss the mean over all 4;
- a large graph (300 nodes, 900 edges, 8 features, 5 classes, padded to
  512 and 1,024 as the reference's cell pads), its arrays on ``gdp``:
  with ``gnn_edge_dp`` None (the data axis) and ("data", "model").  The
  edges join random nodes, so every rank's block reaches nodes of the
  others' blocks.

The step's AdamW records the gradients it is given.  This process holds
the loss, the gradients and the parameters after the step against the
reference's ``value_and_grad`` and ``AdamW.update`` on the same weights
and batches.  On (2, 2) ``build_cell`` builds MeshGraphNet's published
config at the large-graph shape, sharded, against the unsharded cell.

Each step is also held against the unsharded port's step (the cell
built without a mesh) on the same weights and batch.

Tolerances (f32): loss 1e-5 relative; gradients 1e-4 of each leaf's
largest entry; parameters 2e-5 absolute (the ranks add their partial
sums in other orders than one device).  One exception: EquiformerV2's
large-graph gradients against the reference, 1e-3, where the unsharded
port itself lies 2.2e-4 from the reference (``layers/0/radial/1/b``;
measured); against the unsharded port they keep 1e-4.
"""
import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import distributed as TD
from repro_torch.models import convert

ARCHS = ("meshgraphnet", "schnet", "mace", "equiformer-v2")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
NAMES = ("data", "model")
#: the large-graph cases: name -> perf_flags.gnn_edge_dp
EDGE_DP = {"large": None, "large_dm": ("data", "model")}
CELLS_ON = ("2x2",)
SPAWN_TIMEOUT = 600.0
MOLECULE = dict(batch=4, n_nodes=16, n_edges=48)
LARGE = dict(n_nodes=300, n_edges=900, d_feat=8, classes=5)
LR = 1e-3
TOL = dict(loss=1e-5, grad=1e-4, param=2e-5)
#: (arch, kind) -> the gradients' tolerance against the reference where the
#: unsharded port itself lies further from it (module docstring)
REF_GRAD_TOL = {("equiformer-v2", "large"): 1e-3}


def _cell(case):
    from repro_torch.configs.base import ShapeCell
    if case == "molecule":
        return ShapeCell("molecule", "train", dict(MOLECULE))
    return ShapeCell("minibatch", "train", dict(LARGE))


def _cfg(arch, case):
    out = 1 if case == "molecule" else LARGE["classes"]
    return dataclasses.replace(configs.get(arch).make_reduced(), out_dim=out)


def _batch(case):
    """The case's numpy batch, as the cell takes it (a large graph padded
    to multiples of 512)."""
    if case == "molecule":
        from repro_torch.data import GraphBatchStream
        return GraphBatchStream(**MOLECULE, seed=0).batch_at(0)
    rng = np.random.default_rng(5)
    n, m = LARGE["n_nodes"], LARGE["n_edges"]
    pn, pm = 512, 1024
    out = {"feats": np.zeros((pn, LARGE["d_feat"]), np.float32),
           "pos": np.zeros((pn, 3), np.float32),
           "edge_src": np.zeros((pm,), np.int32),
           "edge_dst": np.zeros((pm,), np.int32),
           "labels": np.zeros((pn,), np.int32)}
    out["feats"][:n] = rng.normal(size=(n, LARGE["d_feat"]))
    out["pos"][:n] = rng.normal(size=(n, 3)) * 2
    out["edge_src"][:m] = rng.integers(0, n, m)
    out["edge_dst"][:m] = rng.integers(0, n, m)
    out["labels"][:n] = rng.integers(0, LARGE["classes"], n)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _flat(tree, path="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


# -- the ranks ------------------------------------------------------------------

def _step(arch, case, tree, mesh):
    """One AdamW step of the cell on ``mesh`` from the reference's
    weights: the loss, and the gradients and parameters by path."""
    from repro_torch.launch import cells, perf_flags
    from repro_torch.optim import AdamW
    perf_flags.reset()
    perf_flags.FLAGS.gnn_edge_dp = EDGE_DP.get(case)
    seen = {}
    real = AdamW.step

    def keep(self, params, grads, state):
        seen["grads"] = [g.detach().clone() for g in grads]
        return real(self, params, grads, state)
    AdamW.step = keep
    try:
        cfg = _cfg(arch, case)
        build = cells._build_gnn(configs.get(arch), cfg, _cell(case),
                                 torch.device("cpu"), mesh)
        params, st, _ = build.abstract_args
        src = convert.gnn_from_numpy(
            cfg, tree, d_feat=None if case == "molecule" else
            LARGE["d_feat"], device="cpu")
        names = ["/" + n.replace(".", "/") for n, _ in
                 src.named_parameters()]
        with torch.no_grad():
            for p, q in zip(params, src.parameters(), strict=True):
                p.copy_(q)
        batch = {k: torch.as_tensor(v) for k, v in _batch(case).items()}
        _, _, met = build.fn(params, st, batch)
    finally:
        AdamW.step = real
        perf_flags.reset()
    return dict(loss=float(met["loss"]),
                grads=dict(zip(names, (g.numpy() for g in seen["grads"]))),
                params=dict(zip(names, (p.detach().numpy().copy()
                                        for p in params))))


def _cells(mesh, out):
    """``build_cell`` of MeshGraphNet's published config at the large
    graph's shape, on the mesh and unsharded: the step's loss and
    parameters."""
    from repro_torch.launch import cells
    for name, m in (("sharded", mesh), ("plain", None)):
        build = cells.build_cell("meshgraphnet", _cell("large"),
                                 device="cpu", mesh=m)
        params, st, _ = build.abstract_args
        batch = {k: torch.as_tensor(v) for k, v in _batch("large").items()}
        _, _, met = build.fn(params, st, batch)
        out[name] = (float(met["loss"]),
                     [p.detach().numpy().copy() for p in params])


def _rank_main(rank, world, mesh_name, wdir):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(MESHES[mesh_name], NAMES, device="cpu")
    trees = torch.load(os.path.join(wdir, "weights.pt"), weights_only=False)
    out = {}
    for arch in ARCHS:
        for case in ("molecule",) + tuple(EDGE_DP):
            out[arch, case] = _step(arch, case, trees[arch, _kind(case)],
                                    mesh)
    if mesh_name in CELLS_ON:
        out["cells"] = {}
        _cells(mesh, out["cells"])
    torch.save(out, os.path.join(wdir, f"rank{rank}.pt"))


def _kind(case):
    return "molecule" if case == "molecule" else "large"


# -- this process ---------------------------------------------------------------

def _jmodel(arch, kind):
    from repro import configs as jconfigs
    from repro.models.gnn import MACE, EquiformerV2, MeshGraphNet, SchNet
    out = 1 if kind == "molecule" else LARGE["classes"]
    cfg = dataclasses.replace(jconfigs.get(arch).make_reduced(), out_dim=out)
    cls = {"meshgraphnet": MeshGraphNet, "schnet": SchNet, "mace": MACE,
           "equiformer-v2": EquiformerV2}[arch]
    return cls(cfg, d_feat=None if kind == "molecule" else LARGE["d_feat"])


def _reference_weights():
    import jax
    return {(arch, kind): jax.tree.map(
        np.asarray, _jmodel(arch, kind).init(jax.random.PRNGKey(0)))
        for arch in ARCHS for kind in ("molecule", "large")}


def _reference_step(arch, kind, tree):
    """The reference's loss, gradients and one ``AdamW.update``: the
    molecule cell's ``_batched_gnn_loss``, a large graph's ``loss``."""
    import jax
    import jax.numpy as jnp

    from repro.launch.cells import _batched_gnn_loss
    from repro.optim import AdamW as JAdamW
    jm = _jmodel(arch, kind)
    loss_fn = _batched_gnn_loss(jm) if kind == "molecule" else jm.loss
    params = jax.tree.map(jnp.asarray, tree)
    batch = jax.tree.map(jnp.asarray, _batch(kind))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    opt = JAdamW(lr=LR)
    new, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    return dict(loss=float(loss), grads=_flat(grads), params=_flat(new))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights, saved; one spawn per mesh in a background
    thread; the reference's steps meanwhile in this process."""
    root = tmp_path_factory.mktemp("gnn_sharded")
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
    done = {"weights": weights,
            "ref": {key: _reference_step(*key, tree)
                    for key, tree in weights.items()}}

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


CASES = [(m, a, c) for m in MESHES for a in ARCHS
         for c in ("molecule",) + tuple(EDGE_DP)]


@pytest.mark.parametrize("mesh_name,arch,case", CASES)
def test_sharded_gnn_step(runs, mesh_name, arch, case):
    """One AdamW step on the mesh: the loss, the gradients (summed over
    the split axes) and the parameters against the reference's; every
    rank holds the same."""
    want = runs("ref")[arch, _kind(case)]
    plain = _memo((arch, case), lambda: _step(
        arch, case, runs("weights")[arch, _kind(case)], None))
    ref_tol = REF_GRAD_TOL.get((arch, _kind(case)), TOL["grad"])
    ranks = runs(mesh_name)
    for r in ranks:
        got = r[arch, case]
        for other in (want, plain):
            assert abs(got["loss"] - other["loss"]) \
                <= TOL["loss"] * other["loss"]
        assert got["grads"].keys() == want["grads"].keys()
        for name, w in want["grads"].items():
            assert got["grads"][name].shape == w.shape, name
            assert _rel(got["grads"][name], w) <= ref_tol, name
            assert _rel(got["grads"][name], plain["grads"][name]) \
                <= TOL["grad"], name
        for name, w in want["params"].items():
            assert np.abs(got["params"][name] - w).max() <= TOL["param"], \
                name
    for r in ranks[1:]:
        assert r[arch, case]["loss"] == ranks[0][arch, case]["loss"]


@pytest.mark.parametrize("mesh_name", CELLS_ON)
def test_sharded_gnn_build_cell(runs, mesh_name):
    """``build_cell("meshgraphnet", ..., mesh=)`` at its published config
    (15 layers, 128 wide) on the large graph: the sharded step's loss and
    parameters equal the unsharded cell's (seed-0 weights)."""
    for r in runs(mesh_name):
        (ls, ps), (lp, pp) = r["cells"]["sharded"], r["cells"]["plain"]
        assert abs(ls - lp) <= TOL["loss"] * lp
        assert len(ps) == len(pp)
        for a, b in zip(ps, pp):
            assert np.abs(a - b).max() <= TOL["param"]
