"""The PyTorch port's GNN family against the JAX reference, on the CPU.

Each of the four GNNs runs at its reduced config with the reference's
weights carried over by ``models.convert.gnn_from_numpy``, on the same
numpy inputs.  Tolerances (float32 throughout):

- forward: 1e-4 absolute and relative, the reference's own kernel
  tolerance; the two frameworks sum and contract in other orders.
- loss: 1e-5 relative; gradients: every entry within 1e-4 of the largest
  |g| of its tensor, plus 1e-4 relative — a sum-order difference
  propagated back through a few layers.
- rotation invariance: the reference's 2e-3 (``tests/test_models_smoke.py``).

On the CPU the port's ``segment_sum`` is the kernel's plain version; the
CUDA kernel itself is held against it in ``tests/test_torch_gpu.py``.
"""
import dataclasses
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.launch.train import build_smoke as jbuild_smoke
from repro.models import equivariant as jeq
from repro.models.gnn import MACE, EquiformerV2, MeshGraphNet, SchNet
from repro.models.gnn import common as jcommon
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import convert, equivariant as teq
from repro_torch.models.gnn import common

torch.set_num_threads(1)

JCLS = {"meshgraphnet": MeshGraphNet, "schnet": SchNet, "mace": MACE,
        "equiformer-v2": EquiformerV2}
ARCHS = list(JCLS)
N, M = 20, 60


def _ref_model(arch, d_feat=None, out_dim=None, seed=0):
    cfg = jconfigs.get(arch).make_reduced()
    if out_dim is not None:
        cfg = dataclasses.replace(cfg, out_dim=out_dim)
    model = JCLS[arch](cfg, d_feat=d_feat)
    params = model.init(jax.random.PRNGKey(seed))
    port = convert.gnn_from_numpy(
        _port_cfg(arch, out_dim), jax.tree.map(np.asarray, params),
        d_feat=d_feat, device="cpu")
    return model, params, port


def _port_cfg(arch, out_dim=None):
    cfg = configs.get(arch).make_reduced()
    return cfg if out_dim is None else dataclasses.replace(cfg,
                                                           out_dim=out_dim)


def _graph(seed=0, d_feat=None, classes=None, energy=False):
    rng = np.random.default_rng(seed)
    b = {"species": rng.integers(0, 8, N).astype(np.int32),
         "pos": (rng.normal(size=(N, 3)) * 2).astype(np.float32),
         "edge_src": rng.integers(0, N, M).astype(np.int32),
         "edge_dst": rng.integers(0, N, M).astype(np.int32)}
    if d_feat is not None:
        b["feats"] = rng.normal(size=(N, d_feat)).astype(np.float32)
        del b["species"]
    if classes is not None:
        b["labels"] = rng.integers(0, classes, N).astype(np.int32)
    if energy:
        b["energy"] = np.float32(rng.normal() * 3)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}


def _close_grads(tgrads, jtree, port):
    flat = dict(_flatten(jax.tree.map(np.asarray, jtree)))
    names = dict(_flatten(convert.gnn_to_numpy(port)))
    assert set(flat) == set(names)
    tg = dict(zip([n for n, _ in _named(port)], tgrads))
    for name, want in flat.items():
        got = tg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/{i}")
    else:
        yield path, tree


def _named(module):
    """(tree path, parameter) in ``module.parameters()`` order."""
    names = {}
    for full, p in module.named_parameters():
        names[id(p)] = "/" + full.replace(".", "/")
    return [(names[id(p)], p) for p in module.parameters()]


def test_gnn_configs_match_reference():
    for arch in ARCHS:
        spec, jspec = configs.get(arch), jconfigs.get(arch)
        assert spec.family == jspec.family == "gnn"
        for make in ("make_config", "make_reduced"):
            assert (dataclasses.asdict(getattr(spec, make)())
                    == dataclasses.asdict(getattr(jspec, make)()))
        assert ({k: dataclasses.asdict(c) for k, c in spec.shapes.items()}
                == {k: dataclasses.asdict(c)
                    for k, c in jspec.shapes.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_forward_matches_reference(arch):
    model, params, port = _ref_model(arch)
    b = _graph()
    want = np.asarray(jax.jit(model.forward)(params, _j(b)))
    with torch.no_grad():
        got = port(_t(b)).numpy()
    assert got.shape == want.shape == (N, port.cfg.out_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schema", ["species_energy", "feats_labels"])
def test_gnn_loss_and_grads_match_reference(arch, schema):
    if schema == "species_energy":
        model, params, port = _ref_model(arch)
        b = _graph(seed=1, energy=True)
    else:
        model, params, port = _ref_model(arch, d_feat=12, out_dim=5, seed=1)
        b = _graph(seed=2, d_feat=12, classes=5)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, _j(b))
    tloss = port.loss(_t(b))
    tgrads = torch.autograd.grad(tloss, list(port.parameters()))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    _close_grads(tgrads, grads, port)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_forward_passes_one_index(arch, monkeypatch):
    """A forward groups its edges by destination once (``segment_index``
    of ``edge_dst``: numpy's stable argsort) and hands that index to every
    aggregation; with it, the loss and gradients equal the reference's
    (the plain segment sum on the CPU does not read it)."""
    model, params, port = _ref_model(arch)
    b = _graph(seed=1, energy=True)
    made, passed = [], []

    def index(ids, n):
        made.append(ops.segment_index(ids, n))
        return made[-1]
    real = ops.segment_sum

    def seg_sum(values, ids, n, index=None):
        passed.append(index)
        return real(values, ids, n, index)
    monkeypatch.setattr(sys.modules[type(port).__module__], "segment_index",
                        index)
    monkeypatch.setattr(ops, "segment_sum", seg_sum)
    tloss = port.loss(_t(b))
    tgrads = torch.autograd.grad(tloss, list(port.parameters()))
    assert len(made) == 1 and passed
    assert all(i is made[0] for i in passed)
    assert np.array_equal(made[0].order.numpy(),
                          np.argsort(b["edge_dst"], kind="stable"))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, _j(b))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    _close_grads(tgrads, grads, port)


def test_segment_ops_with_index_match_reference():
    """segment_sum, segment_mean and segment_softmax with the caller's
    index (dropped and negative ids, an empty segment) equal the
    reference's, and so does segment_sum's gradient."""
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(90, 3, 4)).astype(np.float32)
    ids = rng.integers(-2, 11, 90).astype(np.int32)     # segment 11 empty
    logits = rng.normal(size=(90, 2)).astype(np.float32)
    n = 12
    ti = torch.as_tensor(ids)
    index = common.segment_index(ti, n)
    jv, ji = jnp.asarray(vals), jnp.asarray(ids)
    np.testing.assert_allclose(
        common.segment_mean(torch.as_tensor(vals), ti, n, index).numpy(),
        np.asarray(jcommon.segment_mean(jv, ji, n)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        common.segment_softmax(torch.as_tensor(logits), ti, n,
                               index).numpy(),
        np.asarray(jcommon.segment_softmax(jnp.asarray(logits), ji, n)),
        atol=1e-6, rtol=1e-5)
    w = rng.normal(size=(n, 3, 4)).astype(np.float32)
    tv = torch.as_tensor(vals).requires_grad_(True)
    got = common.segment_sum(tv, ti, n, index)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jax.ops.segment_sum(jv, ji, num_segments=n)), atol=1e-5,
        rtol=1e-5)
    (got * torch.as_tensor(w)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(
        jax.ops.segment_sum(v, ji, num_segments=n) * jnp.asarray(w)))(jv)
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_molecule_union_matches_vmap_loss(arch):
    """The disjoint union of the port equals the reference's ``vmap`` over
    the graphs: the loss of ``build_smoke``'s step and its gradients."""
    jstep, params, _, stream = jbuild_smoke(arch)
    batch = stream.batch_at(0)
    port = convert.gnn_from_numpy(_port_cfg(arch),
                                  jax.tree.map(np.asarray, params),
                                  device="cpu")

    def jloss(p, b):
        def single(g):
            return jnp.sum(JCLS[arch](jconfigs.get(arch).make_reduced())
                           .forward(p, g)[..., 0])
        e = jax.vmap(single)({k: v for k, v in b.items() if k != "energy"})
        return jnp.mean(jnp.square(e - b["energy"]))
    loss, grads = jax.jit(jax.value_and_grad(jloss))(params, _j(batch))
    union = common.molecule_union(batch, "cpu")
    assert union["edge_src"].shape == (4 * 48,)
    assert int(union["edge_dst"].max()) < 4 * 16
    tloss = common.molecule_loss(port, union)
    tgrads = torch.autograd.grad(tloss, list(port.parameters()))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    _close_grads(tgrads, grads, port)


@pytest.mark.parametrize("arch", ["schnet", "mace", "equiformer-v2"])
def test_gnn_rotation_invariance(arch):
    cfg = configs.get(arch).make_reduced()
    from repro_torch.models.gnn import MODELS
    port = MODELS[type(cfg)](cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    b = _t(_graph(seed=3))
    rz = lambda t: np.array([[np.cos(t), -np.sin(t), 0],
                             [np.sin(t), np.cos(t), 0], [0, 0, 1]])
    ry = lambda t: np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                             [-np.sin(t), 0, np.cos(t)]])
    rot = torch.as_tensor(rz(0.3) @ ry(1.1) @ rz(-0.7), dtype=torch.float32)
    with torch.no_grad():
        e1 = port(b).numpy()
        e2 = port(dict(b, pos=b["pos"] @ rot.T)).numpy()
    rel = np.abs(e1 - e2).max() / max(np.abs(e1).max(), 1e-9)
    assert rel < 2e-3, rel


def test_equivariant_constants_match_reference():
    for l in range(7):
        np.testing.assert_array_equal(teq.j_matrix(l), jeq.j_matrix(l))
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                np.testing.assert_array_equal(teq.real_cg(l1, l2, l3),
                                              jeq.real_cg(l1, l2, l3))
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(50, 3)) * 2).astype(np.float32)
    v[0] = 0.0                                  # a zero-length edge
    np.testing.assert_allclose(teq.sh(torch.as_tensor(v), 6).numpy(),
                               np.asarray(jeq.sh(jnp.asarray(v), 6)),
                               atol=1e-5, rtol=1e-5)
    consts = teq.WignerConstants(6, "cpu")
    for l in range(7):
        for inv in (False, True):
            np.testing.assert_allclose(
                teq.wigner_d_align(consts, torch.as_tensor(v), l,
                                   inverse=inv).numpy(),
                np.asarray(jeq.wigner_d_align(jnp.asarray(v), l,
                                              inverse=inv)),
                atol=1e-5, rtol=1e-5)
    r = np.abs(rng.normal(size=64) * 4).astype(np.float32)
    # the two float32 linspaces place SchNet's 300 centres up to one ulp
    # apart (4.8e-7 at 4); with gamma = 894 that moves a basis value by up
    # to 2 gamma |r - c| ulp ~ 3e-5, hence 5e-5 for the Gaussian basis
    for t_fn, j_fn, args, tol in (
            (teq.bessel_basis, jeq.bessel_basis, (8, 5.0), 1e-5),
            (teq.gaussian_basis, jeq.gaussian_basis, (300, 10.0), 5e-5),
            (teq.poly_cutoff, jeq.poly_cutoff, (5.0,), 1e-5)):
        np.testing.assert_allclose(t_fn(torch.as_tensor(r), *args).numpy(),
                                   np.asarray(j_fn(jnp.asarray(r), *args)),
                                   atol=tol, rtol=1e-5)
    assert teq.num_sh(6) == jeq.num_sh(6) == 49
    assert teq.l_slices(3) == jeq.l_slices(3)



@pytest.mark.parametrize("case", ["roadmap", "2d"])
def test_segment_max_softmax_out_of_range_ids(case):
    """Ids outside ``[0, n)``, negatives too: segment_max drops them (as
    ``jax.ops.segment_max``) and segment_softmax reads the max and sum of
    the segment JAX's gather wraps and clamps them to, on the CPU and
    without a scatter out of range; to 1e-6 relative."""
    if case == "roadmap":
        ids = np.array([0, 1, 1, 3], np.int32)
        logits = np.array([0.0, -0.5, 0.5, np.log(2.0)], np.float32)
        n = 3
    else:
        rng = np.random.default_rng(9)
        ids = rng.integers(-7, 9, 40).astype(np.int32)
        logits = rng.normal(size=(40, 3)).astype(np.float32)
        n = 5
    tl, ti = torch.as_tensor(logits), torch.as_tensor(ids)
    jl, ji = jnp.asarray(logits), jnp.asarray(ids)
    np.testing.assert_array_equal(
        common.segment_max(tl, ti, n).numpy(),
        np.asarray(jax.ops.segment_max(jl, ji, num_segments=n)))
    np.testing.assert_allclose(
        common.segment_softmax(tl, ti, n).numpy(),
        np.asarray(jcommon.segment_softmax(jl, ji, n)), rtol=1e-6, atol=0)

def test_segment_ops_match_reference():
    """segment_mean / segment_softmax (with an empty segment) and the
    segment_sum gradient (a gather, zero for dropped ids)."""
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(90, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 11, 90).astype(np.int32)      # segment 11 empty
    logits = rng.normal(size=(90, 2)).astype(np.float32)
    n = 12
    np.testing.assert_allclose(
        common.segment_mean(torch.as_tensor(vals), torch.as_tensor(ids),
                            n).numpy(),
        np.asarray(jcommon.segment_mean(jnp.asarray(vals), jnp.asarray(ids),
                                        n)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        common.segment_softmax(torch.as_tensor(logits), torch.as_tensor(ids),
                               n).numpy(),
        np.asarray(jcommon.segment_softmax(jnp.asarray(logits),
                                           jnp.asarray(ids), n)),
        atol=1e-6, rtol=1e-5)
    bad = ids.copy()
    bad[::7] = -1
    bad[1::9] = n + 3
    w = rng.normal(size=(n, 3, 4)).astype(np.float32)
    tv = torch.as_tensor(vals, dtype=torch.float32).requires_grad_(True)
    (common.segment_sum(tv, torch.as_tensor(bad), n)
     * torch.as_tensor(w)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(
        jax.ops.segment_sum(v, jnp.asarray(bad), num_segments=n)
        * jnp.asarray(w)))(jnp.asarray(vals))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jg))
    assert not tv.grad[::7].any()
    before = dict(ops.LAUNCHES)
    common.segment_sum(tv, torch.as_tensor(ids), n)
    assert ops.LAUNCHES == before            # the plain path never counts


def test_gnn_convert_round_trip_and_mismatch():
    """``gnn_from_numpy`` takes an arch id (its published config) or a
    config, and refuses a tree that is not the model's."""
    from repro_torch.models.gnn import MODELS
    cfg = configs.get("schnet").make_config()
    model = MODELS[type(cfg)](cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    tree = convert.gnn_to_numpy(model)
    back = convert.gnn_from_numpy("schnet", tree, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 back.parameters()))
    del tree["layers"][0]["filter"]
    with pytest.raises(ValueError, match="tree differs"):
        convert.gnn_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="not a GNN"):
        convert.gnn_from_numpy("qwen3-1.7b", {}, device="cpu")
