"""The port's training collectives against the JAX reference's, on the CPU
over gloo: ``train.compression.compressed_psum``,
``train.pipeline.gpipe_apply`` and ``train.fault.ElasticManager`` with
``train.checkpoint.restore(shardings=...)``.

The reference runs as its own test runs it
(``tests/test_train_substrate.py``): one subprocess with 8 host devices
(``--xla_force_host_platform_device_count=8``), ``compressed_psum``
inside ``shard_map`` over a ("dp",) mesh of the first W devices and
``gpipe_apply`` over a ("stage",) mesh of the first S; it saves its
outputs with ``np.save``.  The port runs W gloo ranks spawned by
``core.distributed.spawn`` (worlds 2, 4 and 8), each saving its results
with ``torch.save``.

- ``compressed_psum``: every rank's output equals the reference's bit
  for bit (both round half to even; ``scale / scale2`` is an f32 op in
  both), on a (W, 1000) and a (W, 37, 5) input (185 elements: padded to
  a multiple of W), and is within the int8 grid's error of the plain
  sum.  At world 1 it is ``dequantize(quantize(x))`` bit for bit.
- ``gpipe_apply`` (stage ``tanh(x @ w)``, M = 6 microbatches of 8 x 16):
  at S = 2 and 4 against the reference's on the same ``ws`` and ``xs``
  to 1e-6, and against the sequential loop to 1e-6; at S = 1 (no
  exchange) equal to the loop.
- ``ElasticManager``: 4 ranks with rank 1 failed and model axis 2 give
  a (1, 2) mesh of ranks 0 and 2, rank 3 left over; a checkpoint of a
  reduced LM's parameters saved unsharded, restored onto that mesh by
  ``param_specs`` and gathered back, equals the saved arrays bit for
  bit; with no failure the mesh is (2, 2); too few ranks raise.
"""
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as TD
from repro_torch.train import compression, pipeline

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, 8)
STAGES = (2, 4)
M, MB, D = 6, 8, 16
SHAPES = ((1000,), (37, 5))


def _psum_inputs(world):
    rng = np.random.default_rng(world)
    return [rng.normal(size=(world,) + s).astype(np.float32) * (i + 1)
            for i, s in enumerate(SHAPES)]


def _pipe_inputs(stages):
    rng = np.random.default_rng(100 + stages)
    ws = (rng.normal(size=(stages, D, D)) / np.sqrt(D)).astype(np.float32)
    xs = rng.normal(size=(M, MB, D)).astype(np.float32)
    return ws, xs


def _loop(ws, xs):
    ref = xs
    for w in ws:
        ref = np.tanh(ref @ w)
    return ref


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.jaxcompat import shard_map
    from repro.train.compression import compressed_psum
    from repro.train.pipeline import gpipe_apply
    import test_torch_train_collectives as T

    out = {out!r}
    for w in T.WORLDS:
        mesh = Mesh(np.array(jax.devices()[:w]), ("dp",))
        for i, x in enumerate(T._psum_inputs(w)):
            got = jax.jit(shard_map(
                lambda xl: compressed_psum(xl[0], "dp", w)[None],
                mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp")))(x)
            np.save(os.path.join(out, f"psum_{{w}}_{{i}}.npy"),
                    np.asarray(got))
    for s in T.STAGES:
        ws, xs = T._pipe_inputs(s)
        mesh = Mesh(np.array(jax.devices()[:s]), ("stage",))
        got = gpipe_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws),
                          jnp.asarray(xs), mesh=mesh, axis="stage")
        np.save(os.path.join(out, f"pipe_{{s}}.npy"), np.asarray(got))
    print("REF_OK")
""")


# -- the ranks ------------------------------------------------------------------

def _rank_main(rank, world, out_dir, ckpt_dir):
    """One spawned rank: compressed_psum on this world; gpipe_apply when
    the world is a stage count; the elastic mesh at world 4."""
    torch.set_num_threads(1)
    out = {"psum": [compression.compressed_psum(torch.as_tensor(x[rank]))
                    .numpy() for x in _psum_inputs(world)]}
    if world in STAGES:
        ws, xs = _pipe_inputs(world)
        out["pipe"] = pipeline.gpipe_apply(
            lambda w, x: torch.tanh(x @ w), torch.as_tensor(ws),
            torch.as_tensor(xs)).numpy()
    if world == 4:
        out["elastic"] = _elastic(rank, ckpt_dir)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _lm():
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    cfg = configs.get("qwen3-1.7b").make_reduced()
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _elastic(rank, ckpt_dir):
    """The elastic path on 4 ranks: meshes with and without a failure,
    too few ranks, and a restore onto the shrunk mesh gathered back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.transformer import MeshAxes
    from repro_torch.train.fault import ElasticManager
    out = {}
    em = ElasticManager(ckpt_dir, model_axis_size=2)
    full = em.usable_mesh()
    out["full"] = full.mesh.tolist()
    try:
        ElasticManager(ckpt_dir, model_axis_size=8).usable_mesh()
    except RuntimeError as e:
        out["too_few"] = str(e)
    lm = _lm()
    names = [n for n, _ in lm.named_parameters()]
    like = {n: p.detach() for n, p in lm.named_parameters()}
    specs = lm.param_specs(MeshAxes())
    mesh, tree, step, meta = em.handle_failure(
        {1}, like, lambda: {n: specs[n] for n in names})
    out.update(mesh=mesh.mesh.tolist(), names=mesh.mesh_dim_names,
               coord=mesh.get_coordinate(), step=step, meta=meta)
    assert all(isinstance(t, DTensor) for t in tree.values())
    if mesh.get_coordinate() is not None:
        out["placements"] = {n: tuple(t.placements) for n, t in tree.items()}
        out["gathered"] = {n: t.full_tensor().numpy()
                           for n, t in tree.items()}
    else:
        out["local_sizes"] = {n: t.to_local().numel()
                              for n, t in tree.items()}
    return out


# -- this process ---------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's spawns (one world after
    another), started on first use; ``get(key)``: a world's ranks'
    results, ``"ref"`` the reference's output directory, ``"ckpt"`` the
    checkpoint's."""
    from repro_torch.train import checkpoint
    root = tmp_path_factory.mktemp("collectives")
    ref_dir, ckpt_dir = root / "ref", root / "ckpt"
    ref_dir.mkdir()
    lm = _lm()
    checkpoint.save(str(ckpt_dir), 7, {n: p.detach() for n, p in
                                       lm.named_parameters()},
                    {"note": "unsharded"})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    script = REFERENCE.format(src=str(ROOT / "src"),
                              tests=str(ROOT / "tests"), out=str(ref_dir))
    side = ThreadPoolExecutor(1)
    ranks = ThreadPoolExecutor(1)
    jobs = {"ref": side.submit(subprocess.run, [sys.executable, "-c",
                                                script],
                               capture_output=True, text=True, env=env,
                               timeout=600)}
    dirs = {}
    for w in WORLDS:
        dirs[w] = root / f"world{w}"
        dirs[w].mkdir()
        jobs[w] = ranks.submit(TD.spawn, _rank_main, w,
                               args=(str(dirs[w]), str(ckpt_dir)),
                               store_dir=str(dirs[w]))
    done = {"ckpt": ckpt_dir}

    def get(key):
        if key not in done:
            res = jobs[key].result()
            if key == "ref":
                assert "REF_OK" in res.stdout, res.stderr[-3000:]
                done[key] = ref_dir
            else:
                done[key] = [torch.load(dirs[key] / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(key)]
        return done[key]
    yield get
    side.shutdown(cancel_futures=True)
    ranks.shutdown(cancel_futures=True)


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_bit_for_bit(runs, world, shape):
    want = np.load(runs("ref") / f"psum_{world}_{shape}.npy")
    x = _psum_inputs(world)[shape]
    exact = x.sum(0)
    # the int8 grid of the shared scale, twice (quantize, requantize)
    step = np.abs(x).max() / 127.0 * world
    for rank, r in enumerate(runs(world)):
        got = r["psum"][shape]
        assert got.dtype == np.float32 and got.shape == x.shape[1:]
        assert np.array_equal(got, want[rank]), rank
        assert np.abs(got - exact).max() <= world * step


def test_compressed_psum_world_one_is_quantize_roundtrip():
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 33))
                        .astype(np.float32))
    with TD.process_group("cpu"):
        got = compression.compressed_psum(x)
    want = compression.dequantize(*compression.quantize(x))
    assert torch.equal(got, want)


@pytest.mark.parametrize("stages", STAGES)
def test_gpipe_matches_reference_and_loop(runs, stages):
    want = np.load(runs("ref") / f"pipe_{stages}.npy")
    ws, xs = _pipe_inputs(stages)
    loop = _loop(ws, xs)
    for r in runs(stages):
        assert r["pipe"].shape == (M, MB, D)
        np.testing.assert_allclose(r["pipe"], want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["pipe"], loop, atol=1e-6, rtol=0)


def test_gpipe_one_stage_skips_the_exchange():
    ws, xs = _pipe_inputs(2)
    with TD.process_group("cpu"):
        got = pipeline.gpipe_apply(lambda w, x: torch.tanh(x @ w),
                                   torch.as_tensor(ws[:1]),
                                   torch.as_tensor(xs))
    np.testing.assert_allclose(got.numpy(), _loop(ws[:1], xs), atol=1e-6,
                               rtol=0)


def test_elastic_mesh_after_a_failure(runs):
    from repro_torch.train import checkpoint
    saved, step, meta = checkpoint.load_flat(str(runs("ckpt")))
    for rank, r in enumerate(runs(4)):
        e = r["elastic"]
        assert e["full"] == [[0, 1], [2, 3]]
        assert e["too_few"] == "not enough healthy devices for model axis"
        assert e["mesh"] == [[0, 2]] and e["names"] == ("data", "model")
        assert e["step"] == step == 7 and e["meta"] == {"note": "unsharded"}
        if rank in (0, 2):
            assert list(e["coord"]) == [0, rank // 2]
            assert e["gathered"].keys() == saved.keys()
            for name, arr in saved.items():
                assert np.array_equal(e["gathered"][name], arr), name
            assert any("Shard" in str(pl) for pl in e["placements"].values())
        else:                   # left out of the mesh: no blocks
            assert e["coord"] is None
            assert set(e["local_sizes"].values()) == {0}
