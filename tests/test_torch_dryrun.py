"""The port's dry-run tools against the JAX reference, on the CPU:
``launch.perf_flags``, ``launch.mesh``, ``launch.lowering`` (a step run on
the meta device), ``launch.cells``, ``launch.dryrun`` and the trim CLI's
``--dryrun``.

* Every (arch x shape) cell of ``configs.REGISTRY``: the same skip status
  as the reference's, ``model_flops`` equal to the reference's, and the
  argument bytes (parameters, optimizer state, batch) equal to the
  ``nbytes`` sum of the reference's abstract arguments, exactly, also
  under ``serve_bf16_params`` and ``recsys_hybrid_opt``.  The reference's
  cells are built on a one-device mesh: only their shapes are read.
* FLOPs at each family's reduced config against XLA's ``cost_analysis``
  of the reference's step (jitted on the CPU, one device, layers
  unrolled so XLA counts each; the LM training steps with remat on both
  sides): XLA counts every elementwise op and the full attention square,
  the port the matmul-class ops and the causal attention pairs, so the
  port's count is a fixed share of XLA's for each step (0.46 for a
  decode step, 0.74-0.95 for the rest).  Each case is held within 3% of
  its own share: losing the attention backward's FLOPs (11-30% of a
  training step here) or remat's recomputed forward (6-14%) fails it.
* The meta peak of a reduced LM training step equals the tracker's peak
  on the same step run on CPU tensors, exactly.  On the CPU the flash
  forward's plain version materialises the scores, which the card's
  kernel keeps on chip, so the CPU run computes it outside the tracker
  and writes it into the output the kernel's wrapper allocates.
* ``trim_footprint``'s held bytes equal ``obs.memory.engine_nbytes`` of
  real CPU engines, exactly, for every method x backend on a chain, an
  RMAT and a BA graph, with and without a caller's transpose; its run
  bytes lie within 10% of the peak the tracker counts over a dense
  engine's CPU run.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro import configs as jconfigs
from repro.configs.base import ShapeCell as JCell
from repro.jaxcompat import make_mesh
from repro.launch import cells as jcells
from repro.launch import perf_flags as jflags
from repro_torch import configs, obs
from repro_torch.configs.base import ShapeCell
from repro_torch.core import plan
from repro_torch.graphs import generators as G
from repro_torch.kernels import ref
from repro_torch.launch import cells, dryrun, lowering, mesh, perf_flags
from repro_torch.launch import trim as ttrim

torch.set_num_threads(1)

CELLS = [(a, s) for a, spec in sorted(configs.REGISTRY.items())
         for s in spec.shapes]
#: the largest relative distance of a FLOP case's port/XLA ratio from
#: its own measured ratio (FLOP_CASES)
FLOP_TOL = 0.03


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh((1, 1), ("data", "model"), auto=True)


@pytest.fixture
def flags(monkeypatch):
    """Both packages' flag objects, fresh, restored after the test."""
    monkeypatch.setattr(jflags, "FLAGS", jflags.PerfFlags())
    monkeypatch.setattr(perf_flags, "FLAGS", perf_flags.PerfFlags())
    return jflags.FLAGS, perf_flags.FLAGS


def _reduced(monkeypatch, arch, **over):
    """Point the port's registry entry of ``arch`` at its reduced config
    (with ``over`` replaced)."""
    spec = configs.get(arch)
    cfg = dataclasses.replace(spec.make_reduced(), **over)
    monkeypatch.setitem(configs.REGISTRY, arch, dataclasses.replace(
        spec, make_config=lambda: cfg))
    return cfg


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in lowering.tensors(tree)}.values())


def _nbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


# ---------------------------------------------------------------- flags


def test_perf_flags_match_reference():
    got = [(f.name, f.default) for f in
           dataclasses.fields(perf_flags.PerfFlags)]
    want = [(f.name, f.default) for f in dataclasses.fields(jflags.PerfFlags)]
    assert got == want


def test_perf_flags_reset(flags):
    perf_flags.FLAGS.moe_decode_capacity_floor = 2
    assert perf_flags.reset() is perf_flags.FLAGS
    assert perf_flags.FLAGS == perf_flags.PerfFlags()


def test_gnn_edge_dp_runs_equiformer(flags):
    """``gnn_edge_dp`` set: the reduced EquiformerV2 runs and gives the
    unflagged output (without a mesh its pins move nothing); inside an
    edge split over other axes the pin refuses."""
    from repro_torch.models.gnn import EquiformerV2
    from repro_torch.models.gnn.common import edge_sharded
    cfg = configs.get("equiformer-v2").make_reduced()
    model = EquiformerV2(cfg, device="cpu")
    batch = {"species": torch.zeros(4, dtype=torch.long),
             "pos": torch.randn(4, 3),
             "edge_src": torch.tensor([0, 1, 2]),
             "edge_dst": torch.tensor([1, 2, 3])}
    want = model(batch)
    perf_flags.FLAGS.gnn_edge_dp = ("data", "model")
    assert torch.equal(model(batch), want)
    with edge_sharded([], ("data", "model")):
        assert torch.equal(model(batch), want)
    with edge_sharded([], ("data",)):
        with pytest.raises(ValueError, match="split over"):
            model(batch)


def test_mesh_is_one_card():
    """The one-card dry-run's device count and memory; the production
    meshes (256 and 512 ranks) are tests/test_torch_dryrun_mesh.py's."""
    assert mesh.n_devices() == mesh.n_devices(None) == 1
    assert mesh.hbm_bytes() == (int(torch.cuda.get_device_properties(0)
                                    .total_memory)
                                if torch.cuda.is_available() else 80e9)


# ---------------------------------------------------------------- cells


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(arch, shape, jmesh, flags):
    """Skip status, model FLOPs and argument bytes of every cell."""
    if configs.get(arch).shapes[shape].skip:
        for build in (lambda: jcells.build_cell(arch, shape, jmesh, False),
                      lambda: cells.build_cell(arch, shape)):
            with pytest.raises(ValueError, match="is skipped"):
                build()
        rec = dryrun.run_cell(arch, shape, verbose=False)
        assert rec["status"] == "skipped"
        assert rec["skip_reason"] == jconfigs.get(arch).shapes[shape].skip
        return
    want = jcells.build_cell(arch, shape, jmesh, False)
    got = cells.build_cell(arch, shape)
    assert got.model_flops == want.model_flops
    assert _storage_bytes(got.abstract_args) == _nbytes(
        want.abstract_args)
    assert all(t.device.type == "meta" for t in
               lowering.tensors(got.abstract_args)
               if t.dim() > 0)


FLAG_CELLS = [(a, s) for a, s in CELLS
              if configs.get(a).shapes[s].kind in ("prefill", "decode")
              and not configs.get(a).shapes[s].skip] + [
    ("wide-deep", "train_batch")]


@pytest.mark.parametrize("arch,shape", FLAG_CELLS)
def test_cell_bytes_under_flags(arch, shape, jmesh, flags):
    """``serve_bf16_params`` halves an LM's serving weights and
    ``recsys_hybrid_opt`` drops the tables' moments, in both packages."""
    before = _storage_bytes(cells.build_cell(arch, shape)
                                    .abstract_args)
    for f in flags:
        f.serve_bf16_params = f.recsys_hybrid_opt = True
    want = jcells.build_cell(arch, shape, jmesh, False)
    got = cells.build_cell(arch, shape).abstract_args
    assert _storage_bytes(got) == _nbytes(want.abstract_args)
    assert _storage_bytes(got) < before


# ------------------------------------------------------------ lowering


#: (arch, kind, cell meta or None for the registry's cell, the port's
#: FLOPs over XLA's as measured here)
FLOP_CASES = [("qwen3-1.7b", "train", dict(batch=2, seq=256), 0.788),
              ("qwen3-1.7b", "prefill", dict(batch=2, seq=256), 0.740),
              ("qwen3-1.7b", "decode", dict(batch=2, seq=256), 0.458),
              ("arctic-480b", "train", dict(batch=2, seq=128), 0.830),
              ("schnet", "molecule", None, 0.850),
              ("meshgraphnet", "full_graph_sm", None, 0.946),
              ("wide-deep", "train", dict(batch=256), 0.917)]


@pytest.mark.parametrize("arch,kind,meta,want", FLOP_CASES)
def test_flops_against_xla(arch, kind, meta, want, jmesh, monkeypatch):
    jspec, spec = jconfigs.get(arch), configs.get(arch)
    if meta is None:
        jcell, cell = jspec.shapes[kind], spec.shapes[kind]
    else:
        jcell, cell = JCell("t", kind, meta), ShapeCell("t", kind, meta)
    jcfg = jspec.make_reduced()
    over = {}
    if jspec.family == "lm":
        over = dict(remat=kind == "train")
        jcfg = dataclasses.replace(jcfg, scan_unroll=True, **over)
    monkeypatch.setitem(jconfigs.REGISTRY, arch, dataclasses.replace(
        jspec, make_config=lambda: jcfg, shapes={"t": jcell}))
    b = jcells.build_cell(arch, "t", jmesh, False)
    with jmesh:
        compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings).lower(
            *b.abstract_args).compile()
    xla = compiled.cost_analysis()["flops"]
    _reduced(monkeypatch, arch, **over)
    got = cells.build_cell(arch, cell)
    _, cost = lowering.meter(got.fn, *got.abstract_args)
    ratio = cost.flops / xla
    print(f"{arch} {kind}: port {cost.flops:.4g} FLOPs, XLA {xla:.4g}, "
          f"ratio {ratio:.3f}")
    assert abs(ratio / want - 1) <= FLOP_TOL


def _flash_outside_tracker(monkeypatch):
    """On the CPU: the flash forward's plain version computed outside the
    tracker, into the output the kernel's wrapper allocates."""
    real = ref.flash_attention_ref

    def standin(q, k, v, causal=True, sm_scale=None):
        out = torch.empty_like(q)
        with _disable_current_modes():
            want = real(q, k, v, causal=causal, sm_scale=sm_scale)
        return out.copy_(want)
    monkeypatch.setattr(ref, "flash_attention_ref", standin)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "arctic-480b"])
def test_peak_on_meta_equals_cpu(arch, remat, monkeypatch):
    _flash_outside_tracker(monkeypatch)
    cfg = _reduced(monkeypatch, arch, remat=remat)
    cell = ShapeCell("t", "train", dict(batch=2, seq=64))
    on_meta = cells.build_cell(arch, cell)
    _, meta = lowering.meter(on_meta.fn, *on_meta.abstract_args)
    on_cpu = cells.build_cell(arch, cell, device="cpu")
    _, cpu = lowering.meter(on_cpu.fn, *on_cpu.abstract_args)
    assert meta.peak_bytes == cpu.peak_bytes
    assert meta.argument_bytes == cpu.argument_bytes
    assert meta.peak_bytes > meta.argument_bytes
    # remat runs every layer's attention forward twice
    assert meta.launches == {"flash_fwd_wgmma": cfg.n_layers * (1 + remat)}


def test_peak_counts_views_once_and_in_place_ops_not_at_all():
    x = torch.empty(1024, device="meta")

    def step(x):
        y = x * 2               # 4 KB
        v = y[::2]              # a view: nothing
        v.add_(1)               # in place: nothing
        z = y.reshape(32, 32)   # a view again
        del y, v
        return z.sum(0)         # 128 B, while z still holds y's storage

    _, cost = lowering.meter(step, x)
    assert cost.argument_bytes == 4096
    assert cost.peak_bytes == 4096 + 4096 + 128
    assert cost.output_bytes == 128


def test_replay_counts_equal_running(monkeypatch):
    """A repeated attention backward replayed from its first call counts
    what running it counts."""
    _reduced(monkeypatch, "qwen3-1.7b", n_layers=3, remat=True)
    cell = ShapeCell("t", "train", dict(batch=2, seq=256))
    costs = []
    for replay in (lowering._Replay, lambda fn, *counters: fn):
        monkeypatch.setattr(lowering, "_Replay", replay)
        b = cells.build_cell("qwen3-1.7b", cell)
        costs.append(dataclasses.replace(
            lowering.meter(b.fn, *b.abstract_args)[1], seconds=0))
    assert costs[0] == costs[1]


def test_meta_cost_of_a_graph_kernel_raises():
    from repro_torch.analysis.capture import captured_launches
    from repro_torch.kernels import ops
    flags = torch.empty((4096, 16), dtype=torch.bool, device="meta")
    pending = torch.empty(4096, dtype=torch.bool, device="meta")
    with captured_launches(keep_outputs=False):
        with pytest.raises(ValueError, match="depends on the data"):
            lowering.meter(ops.frontier_expand, flags, flags, pending)


def test_lowering_cache_hits_on_key():
    lowering.clear_caches()
    x = torch.empty(8, device="meta")
    before = lowering.cache_stats()
    a = lowering.lower(lambda x: x + 1, (x,), key=("t", 8))
    b = lowering.lower(lambda x: x + 2, (x,), key=("t", 8))
    after = lowering.cache_stats()
    assert a is b
    assert after["meter_hits"] == before["meter_hits"] + 1
    assert after["meter_misses"] == before["meter_misses"] + 1
    assert after["costs"] == 1
    lowering.clear_caches()
    assert lowering.cache_stats() == {"meter_hits": 0, "meter_misses": 0,
                                      "costs": 0}


# --------------------------------------------------------------- dryrun


def test_dryrun_cli_writes_records(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "schnet", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["shape"] for r in recs] == list(
        configs.get("schnet").shapes)
    for r in recs:
        assert r["status"] == "ok"
        pd = r["per_device"]
        assert pd["flops"] > 0 and pd["bytes"] > 0
        assert pd["peak_hbm_est"] >= pd["argument_bytes"] > 0
        assert pd["collective_bytes"] == 0
        assert pd["launches"] == {"segment_rows": 3}
        assert r["fits"] == (pd["peak_hbm_est"] <= mesh.hbm_bytes())
        roof = r["roofline"]
        assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"])
        assert roof["collective_s"] == 0 and r["notes"] == cells.NOTES
        assert "no collectives" in r["notes"]
    assert "done; failures=0" in capsys.readouterr().out


def test_dryrun_cli_jobs_keep_the_records(tmp_path):
    """``--jobs 2`` writes the records one process writes, in order."""
    recs = []
    for jobs in ("1", "2"):
        out = tmp_path / f"dry{jobs}.jsonl"
        assert dryrun.main(["--arch", "schnet", "--out", str(out),
                            "--jobs", jobs]) == 0
        recs.append([dict(json.loads(line), trace_s=None)
                     for line in out.read_text().splitlines()])
    assert recs[0] == recs[1]


def test_dryrun_cut_depth_and_own_shape():
    full = dryrun.run_cell("arctic-480b", "decode_32k", verbose=False)
    one = dryrun.run_cell("arctic-480b", ShapeCell(
        "decode_32k", "decode", dict(batch=128, seq=32768)), n_layers=1,
        verbose=False)
    assert one["n_layers"] == 1
    assert one["per_device"]["peak_hbm_est"] < \
        full["per_device"]["peak_hbm_est"]
    assert full["fits"] is False


# ---------------------------------------------------------- trim dryrun


GRAPHS = {"chain": lambda: G.chain(3000, device="cpu"),
          "RMAT": lambda: G.rmat(n_log2=12, m=32768, seed=1, device="cpu"),
          "BA": lambda: G.barabasi_albert(5000, deg=4, seed=1,
                                          device="cpu")}


@pytest.mark.parametrize("pass_transpose", [False, True])
@pytest.mark.parametrize("backend", ["dense", "windowed"])
@pytest.mark.parametrize("method", ["ac3", "ac4", "ac4*", "ac6"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_trim_footprint_equals_engine_nbytes(graph, method, backend,
                                             pass_transpose):
    g = GRAPHS[graph]()
    gt = g.transpose() if pass_transpose else None
    eng = plan(g, method=method, backend=backend, workers=16, transpose=gt,
               device="cpu")
    eng.run()
    fp = ttrim.trim_footprint(g.n, g.m, method, backend, workers=16,
                              transpose=pass_transpose or None)
    assert fp["held"] == obs.engine_nbytes(eng)


#: trim_footprint's "run" over the peak the tracker counts on a CPU run
TRIM_RUN_BAND = (0.9, 1.1)


@pytest.mark.parametrize("method", ["ac3", "ac4", "ac4*", "ac6"])
@pytest.mark.parametrize("n_log2", [12, 14])
def test_trim_footprint_run_near_the_tracked_peak(method, n_log2):
    """The dense backend's working set.  A CPU run peaks where a card
    run does, at the same tensors, but in the windowed probe, whose plain
    version builds (n, W) window tiles: the windowed backend is held on
    the card only (``chip_smoke.py`` phase 3)."""
    g = G.rmat(n_log2=n_log2, m=8 << n_log2, seed=1, device="cpu")
    eng = plan(g, method=method, backend="dense", workers=16, device="cpu")
    eng.run()
    _, cost = lowering.meter(eng.run)
    est = sum(ttrim.trim_footprint(g.n, g.m, method, "dense",
                                   workers=16)["run"].values())
    assert TRIM_RUN_BAND[0] <= est / cost.peak_bytes <= TRIM_RUN_BAND[1]


@pytest.mark.parametrize("argv", [["--dryrun"],
                                  ["--app", "scc", "--dryrun"],
                                  ["--dryrun", "--method", "ac4",
                                   "--backend", "windowed"]])
def test_trim_dryrun_lines(argv, capsys):
    fp = ttrim.main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    method = argv[argv.index("--method") + 1] if "--method" in argv \
        else "ac6"
    n, m = ttrim.DRYRUN_GRAPH["n"], ttrim.DRYRUN_GRAPH["m"]
    assert lines[0].startswith(f"[trim-dryrun] {method}/")
    assert "all-gather sites 0" in lines[0] and "fits in" in lines[0]
    held = sum(fp["held"].values())
    assert f"per-device args {held / 2**20:.1f} MiB" in lines[0]
    assert lines[1].strip().startswith(f"graph: n={n:,} m={m:,} -> {n:,} "
                                       "vertices/device")
    assert f"{n / 8 / 2**20:.1f} MiB per round" in lines[1]
    assert fp["frontier"].cap == 1 << 20
