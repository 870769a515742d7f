"""The dry-run of the sharded cells at the reference's production meshes
(``launch.mesh.make_production_mesh``, ``launch.lowering``'s collective
count, ``launch.dryrun --mesh pod|multi|both``) against the JAX
reference, on the CPU.

* Rank 0's argument bytes (parameters, optimizer state, batch, cache) of
  one cell of each family and kind, at the (16, 16) and (2, 16, 16)
  meshes, equal the reference's per-device bytes exactly.  The
  reference's side comes from its own ``in_shardings`` on a
  ``jax.sharding.AbstractMesh`` of the same shape: each leaf's
  ``NamedSharding`` spec, every sharded dimension rounded up to a whole
  number of blocks (GSPMD's padding of an uneven split; rank 0 of a
  DTensor holds ``torch.chunk``'s first block, the same size).
* The meter's collectives on a hand-built DTensor function at a fake
  (16, 16) mesh: kinds, result bytes, calls and mesh axes all known in
  advance; the link rates by the ranks' nodes.
* ``dryrun.main(["--mesh", ...])`` on small cells: records named by the
  mesh, ``n_devices`` 256 or 512, a collective term where collectives
  run and a bound that is the largest of the three terms, ``--jobs``
  keeping the records; no process group left behind, and the fake group
  refused where one is already up.
* arctic-480b's 56 heads over tp = 16: rank 0's flash kernel sees
  ceil(56 / 16) = 4 heads; the decode cells' and the MoE's split
  dimensions divide at both meshes.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch import cells as jcells
from repro_torch import configs
from repro_torch.core import distributed as TD
from repro_torch.launch import cells, dryrun, lowering, mesh
from repro_torch.models import sharding

torch.set_num_threads(1)

#: one cell of each family and kind (arctic-480b: 56 heads, which tp = 16
#: does not divide, and the MoE's experts)
ARG_CELLS = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
             ("qwen3-1.7b", "decode_32k"), ("arctic-480b", "train_4k"),
             ("arctic-480b", "prefill_32k"), ("arctic-480b", "decode_32k"),
             ("schnet", "molecule"), ("meshgraphnet", "ogb_products"),
             ("wide-deep", "train_batch"), ("wide-deep", "serve_p99"),
             ("wide-deep", "retrieval_cand")]


def _abstract_mesh(multi_pod: bool):
    from jax.sharding import AbstractMesh, AxisType
    shape, axes = mesh.PRODUCTION_MESHES[multi_pod]
    return AbstractMesh(shape, axes,
                        axis_types=(AxisType.Auto,) * len(shape))


def _reference_per_device(arch, shape, multi_pod) -> int:
    """The reference's per-device argument bytes of the cell: each leaf's
    block under its ``in_shardings`` entry, uneven dimensions padded up
    to whole blocks."""
    import jax
    from jax.sharding import NamedSharding
    amesh = _abstract_mesh(multi_pod)
    sizes = dict(zip(amesh.axis_names, amesh.axis_sizes))
    build = jcells.build_cell(arch, shape, amesh, multi_pod)
    leaves = jax.tree.leaves(build.abstract_args)
    shards = jax.tree.leaves(build.in_shardings,
                             is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shards)
    total = 0
    for leaf, sh in zip(leaves, shards):
        dims = list(leaf.shape)
        for d, entry in enumerate(sh.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            dims[d] = -(-dims[d] // math.prod(sizes[a] for a in axes))
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


def _local_bytes(tree) -> int:
    """Bytes of the distinct storages of rank 0's blocks in ``tree``."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in map(lowering.local, lowering.tensors(tree))
                }.values())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi"])
@pytest.mark.parametrize("arch,shape", ARG_CELLS)
def test_rank0_argument_bytes_match_reference(arch, shape, multi_pod):
    want = _reference_per_device(arch, shape, multi_pod)
    with mesh.make_production_mesh(multi_pod=multi_pod) as m:
        build = cells.build_cell(arch, shape, mesh=m)
        args = build.abstract_args
        assert all(t.device.type == "meta" for t in
                   map(lowering.local, lowering.tensors(args))
                   if t.dim() > 0)     # decode's position is a host scalar
        got = _local_bytes(args)
        del build, args
    assert got == want
    assert not tdist.is_initialized()


# ------------------------------------------------------------- the meter


def test_meter_counts_collectives_by_kind_and_axis():
    """A DTensor (4096, 1024) f32 on (data, model) = (Shard(0),
    Shard(1)) gathered over "model" (one all-gather whose result is rank
    0's (256, 1024) block: 1 MiB), then ``torch.distributed.all_reduce``
    of 8 floats over "data" (32 B): the kinds, calls, bytes and axes, and
    the collective term at the inter-node rate (each axis spans two
    nodes of 8)."""
    with mesh.make_production_mesh() as m:
        x = sharding.local_zeros((4096, 1024), torch.float32,
                                 ("data", "model"), m, "meta")

        def step(x):
            y = x.redistribute(m, [Shard(0), Replicate()])
            t = torch.empty(8, device="meta")
            tdist.all_reduce(t, group=m.get_group("data"))
            return y.to_local() + 1, t

        (out, _), cost = lowering.meter(step, x, mesh=m)
        assert out.shape == (256, 1024)
    coll = cost.collective_summary()
    assert coll["bytes_by_kind"] == {"all-gather": 256 * 1024 * 4,
                                     "all-reduce": 32, "reduce-scatter": 0,
                                     "all-to-all": 0,
                                     "collective-permute": 0}
    assert coll["counts"] == {"all-gather": 1, "all-reduce": 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["bytes_by_axis"] == {"model": 256 * 1024 * 4, "data": 32}
    assert coll["counts_by_axis"] == {"model": 1, "data": 1}
    assert coll["total"] == cost.collective_bytes == 256 * 1024 * 4 + 32
    assert coll["link_bw"] == {"model": mesh.INTERNODE_BW,
                               "data": mesh.INTERNODE_BW}
    roof = cost.roofline()
    assert roof["collective_s"] == pytest.approx(
        (256 * 1024 * 4 + 32) / mesh.INTERNODE_BW, rel=1e-12)
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])


def test_link_rates_by_node():
    assert mesh.link_bw(range(8)) == mesh.NVLINK_BW == 450e9
    assert mesh.link_bw([8, 15]) == mesh.NVLINK_BW
    assert mesh.link_bw(range(16)) == mesh.INTERNODE_BW == 50e9
    assert mesh.link_bw([0, 256]) == mesh.INTERNODE_BW


# ---------------------------------------------------------------- the mesh


def test_production_mesh_and_n_devices():
    assert (mesh.n_devices(), mesh.n_devices(False),
            mesh.n_devices(True)) == (1, 256, 512)
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        with mesh.make_production_mesh(multi_pod=multi_pod) as m:
            assert tuple(m.shape) == shape and m.mesh_dim_names == axes
            assert m.device_type == "cuda" and sharding.is_fake(m)
            assert tdist.get_world_size() == mesh.n_devices(multi_pod)
            assert tdist.get_rank() == 0
            assert tuple(m.get_coordinate()) == (0,) * len(shape)
        assert not tdist.is_initialized()


def test_production_mesh_refuses_a_live_group():
    """Never over a live group (gloo here; NCCL on the card), never a CPU
    tensor; the fake group is refused by ``make_mesh``, so no serving or
    training entry point runs on it; the group goes on a raise too."""
    with TD.process_group("cpu"):
        with pytest.raises(RuntimeError, match="already initialised"):
            with mesh.make_production_mesh():
                pass
        assert "gloo" in str(tdist.get_backend()).lower()
    with pytest.raises(ValueError, match="meta or cuda"):
        with mesh.make_production_mesh(device="cpu"):
            pass
    with pytest.raises(KeyError):
        with mesh.make_production_mesh():
            with pytest.raises(ValueError, match="nccl"):
                mesh.make_mesh((16, 16), ("data", "model"), device="cuda")
            with pytest.raises(RuntimeError, match="already initialised"):
                with mesh.make_production_mesh(multi_pod=True):
                    pass
            raise KeyError("leaves the block")
    assert not tdist.is_initialized()


def test_local_zeros_is_torch_chunk_block():
    """Rank 0's block of an uneven split (56 heads over 16, 3 over 16,
    a dimension over ("pod", "data")) is ``local_block``'s, made without
    the global tensor; ``shard_offset`` gives its start and length."""
    with mesh.make_production_mesh(multi_pod=True) as m:
        for shape, spec in (((2, 56, 128), (None, "model", None)),
                            ((3, 40), ("model", None)),
                            ((33, 7), (("pod", "data"), "model"))):
            z = sharding.local_zeros(shape, torch.bfloat16, spec, m, "meta")
            want = sharding.local_block(
                torch.empty(shape, dtype=torch.bfloat16, device="meta"), m,
                sharding.placements(spec, m))
            assert z.shape == want.shape
            assert z.to_local().shape == want.to_local().shape
            plc = sharding.placements(spec, m)
            assert tuple(sharding.shard_offset(m, plc, d, n)[1]
                         for d, n in enumerate(shape)) == tuple(
                z.to_local().shape)


def test_decode_and_expert_splits_divide():
    """The decode cells' cache splits (B 128 over dp, S 32,768 over tp;
    maverick's long_500k S 524,288 over dp and tp; its chunked head
    features 128 over tp) and the MoE's 128 experts over tp divide at
    both meshes: every rank's block is the same size."""
    for multi_pod in (False, True):
        with mesh.make_production_mesh(multi_pod=multi_pod) as m:
            dp = mesh.data_axes(multi_pod)
            for shape, spec in (
                    ((1, 128, 32768, 8, 128), (None, dp, "model", None,
                                               None)),
                    ((1, 1, 524288, 8, 128), (None, None, dp + ("model",),
                                              None, None)),
                    ((1, 128, 32768, 8, 128), (None, dp, None, None,
                                               "model")),
                    ((128, 7168, 4864), ("model", dp, None))):
                plc = sharding.placements(spec, m)
                for d, n in enumerate(shape):
                    parts = math.prod(m.size(i) for i, p in enumerate(plc)
                                      if isinstance(p, Shard) and p.dim == d)
                    assert n % parts == 0
                    assert sharding.shard_offset(m, plc, d, n) == (
                        0, n // parts)


def test_padded_heads_on_rank0():
    """arctic-480b's prefill at (16, 16), one layer: rank 0's flash kernel
    runs on its (B/dp, S, ceil(56/16), D) = (2, 32768, 4, 128) block,
    once; the meter counts that launch and the collectives of the head
    gathers on "model"."""
    from repro_torch.models import layers
    seen, orig = [], layers._causal

    def keep(q, k, v):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v)
    layers._causal = keep
    try:
        with mesh.make_production_mesh() as m:
            build = cells.build_cell("arctic-480b", "prefill_32k", 1, mesh=m)
            _, cost = lowering.meter(build.fn, *build.abstract_args, mesh=m)
            del build
    finally:
        layers._causal = orig
    assert seen == [((2, 32768, 4, 128), (2, 32768, 4, 128))]
    assert cost.launches == {"flash_fwd_wgmma": 1}
    coll = cost.collective_summary()
    assert coll["counts_by_axis"]["model"] > 0
    assert coll["bytes_by_kind"]["all-gather"] > 0


# ------------------------------------------------------------- the CLI


def _reduced(monkeypatch, arch):
    spec = configs.get(arch)
    cfg = spec.make_reduced()
    monkeypatch.setitem(configs.REGISTRY, arch, dataclasses.replace(
        spec, make_config=lambda: cfg))


@pytest.mark.parametrize("mesh_name,names", [
    ("pod", ["h100x256_16x16"]), ("multi", ["h100x512_2x16x16"]),
    ("both", ["h100x256_16x16", "h100x512_2x16x16"])])
def test_dryrun_cli_meshes(mesh_name, names, tmp_path, monkeypatch, capsys):
    """The reduced qwen3-1.7b (4 heads over tp = 16) at its train_4k cell:
    one record a mesh, rank 0's numbers, a collective term, the bound the
    largest term, the flash kernel launched at each layer's forward and
    recompute."""
    _reduced(monkeypatch, "qwen3-1.7b")
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                        "--mesh", mesh_name, "--out", str(out)]) == 0
    assert not tdist.is_initialized()
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == names
    cfg = configs.get("qwen3-1.7b").make_config()
    for r in recs:
        assert r["status"] == "ok" and r["kind"] == "train"
        assert r["n_devices"] == (512 if "512" in r["mesh"] else 256)
        pd, roof = r["per_device"], r["roofline"]
        assert pd["collective_bytes"] == pd["collectives"]["total"] > 0
        assert set(pd["collectives"]["bytes_by_axis"]) <= {"pod", "data",
                                                            "model"}
        assert roof["collective_s"] > 0
        assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
        # remat recomputes each layer's attention in the backward
        assert pd["launches"] == {
            "flash_fwd_wgmma": (1 + cfg.remat) * cfg.n_layers}
        assert r["fits"] == (pd["peak_hbm_est"] <= mesh.hbm_bytes())
        assert pd["peak_hbm_est"] >= pd["argument_bytes"] > 0
        assert r["notes"].startswith(f"rank 0 of {r['n_devices']}")
    assert "done; failures=0" in capsys.readouterr().out


def test_dryrun_cli_mesh_jobs_keep_the_records(tmp_path):
    """``--jobs 2`` (each worker its own fake groups) writes the records
    one process writes, in order."""
    recs = []
    for jobs in ("1", "2"):
        out = tmp_path / f"dry{jobs}.jsonl"
        assert dryrun.main(["--arch", "schnet", "--shape", "molecule",
                            "--mesh", "both", "--out", str(out),
                            "--jobs", jobs]) == 0
        recs.append([dict(json.loads(line), trace_s=None)
                     for line in out.read_text().splitlines()])
    assert recs[0] == recs[1]
    assert [r["mesh"] for r in recs[0]] == ["h100x256_16x16",
                                            "h100x512_2x16x16"]
    for r in recs[0]:
        # the gradients' all-reduce over the data axes, and the loss's
        assert r["roofline"]["collective_s"] > 0
        assert r["per_device"]["collectives"]["counts"]["all-reduce"] > 0
    assert not tdist.is_initialized()


def test_dryrun_error_record_exits_1(tmp_path, monkeypatch):
    """A cell that fails to build is an ``error`` record and the command
    exits 1; the fake group is gone."""
    def broken(*a, **k):
        raise RuntimeError("no such cell")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "schnet", "--shape", "molecule",
                        "--mesh", "multi", "--out", str(out)]) == 1
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "error" and rec["mesh"] == "h100x512_2x16x16"
    assert "no such cell" in rec["error"]
    assert not tdist.is_initialized()


def test_materialize_draws_rank0_blocks_from_the_seed():
    """``sharding.materialize`` (how a cell on a fake mesh gets its blocks
    on the card): an LM built and placed on meta, then given its blocks
    on the CPU from a seed-0 generator by ``transformer.init_param``,
    holds on a one-rank mesh exactly the unsharded seed-0 LM's weights
    (the same draws in the same order), as DTensors of the parameters'
    placements."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import LM, MeshAxes, init_param
    cfg = configs.get("arctic-480b").make_reduced()
    want = LM(cfg, device="cpu")
    with TD.process_group("cpu"):
        m = make_mesh((1, 1), ("data", "model"), device="cpu")
        lm = LM(cfg, device="meta", init=False)
        specs = lm.param_specs(MeshAxes())
        sharding.place_module(lm, specs, m)
        g = torch.Generator().manual_seed(0)
        sharding.materialize(lm, "cpu",
                             lambda n, p, t: init_param(n, p, t, g))
        for (name, got), ref in zip(lm.named_parameters(),
                                    want.parameters()):
            assert isinstance(got, DTensor), name
            assert got.placements == tuple(sharding.placements(specs[name],
                                                               m)), name
            assert torch.equal(got.to_local(), ref), name


def test_fake_mesh_cells_on_the_cpu_refused():
    """A fake mesh is of "cuda" ranks: a cell built on it holds meta blocks
    (the dry-run) or the card's; CPU blocks are refused."""
    with mesh.make_production_mesh() as m:
        with pytest.raises(ValueError, match="meta or cuda"):
            cells.build_cell("schnet", "molecule", mesh=m, device="cpu")
    assert not tdist.is_initialized()
