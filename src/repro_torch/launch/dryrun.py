"""Dry-run every (architecture x shape) cell for one H100, or for rank 0
of a 256- or 512-rank H100 mesh (PyTorch port of
``src/repro/launch/dryrun.py``)::

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out dryrun.jsonl --jobs 4
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 4

Each cell's step runs once on the meta device (``launch.lowering``): no
data, no card, nothing allocated.  The record answers the reference's
question for one card: does the cell fit, and what bounds it.  Its keys
are the reference's where the meaning carries; these are renamed or new:

* ``lower_s`` and ``compile_s`` -> ``trace_s``: the seconds of the meta
  run (nothing is lowered or compiled);
* ``per_device.hlo_flops`` -> ``per_device.flops``: the PyTorch ops'
  FLOPs by ``torch.utils.flop_counter``'s formulas plus the hand
  kernels' (``obs.profile``), with the split by dtype in
  ``per_device.flops_by_dtype``;
* ``per_device.hlo_bytes`` -> ``per_device.bytes``: every PyTorch op's
  input and output bytes plus the hand kernels' (the eager path's
  traffic: PyTorch fuses nothing);
* ``per_device.temp_bytes``: the peak of live bytes less the arguments
  and the outputs; ``peak_hbm_est`` is that peak;
* new: ``fits`` (``peak_hbm_est`` within the card's memory),
  ``per_device.launches`` (hand-kernel launches by kernel) and
  ``per_device.ops`` (PyTorch ops run).

The compute term counts each dtype's FLOPs at its peak rate
(``launch.mesh``: bf16 989.4 TFLOP/s, f32 67), the memory term the bytes
at 3.35 TB/s.  The port runs every layer, so no layer-count
extrapolation is needed (the reference's ``_lm_cost_extrapolated``
exists because XLA counts a scan body once).

``--mesh`` picks the meshes; the names differ from the reference's,
whose ``single`` is its 256-chip pod:

* ``single`` (the default): one card, no mesh; ``collective_bytes`` and
  ``collective_s`` are 0, and ``notes`` says so;
* ``pod``: the reference's ``single``, 256 ranks as a (16, 16) ("data",
  "model") mesh, records named ``h100x256_16x16``;
* ``multi``: 512 ranks as a (2, 16, 16) ("pod", "data", "model") mesh,
  ``h100x512_2x16x16``;
* ``both``: the reference's ``both``, ``pod`` then ``multi`` for each
  cell.

On a mesh the record is rank 0's: the cell is built on meta over a fake
process group of that many ranks (``launch.mesh.make_production_mesh``,
made for the cell and destroyed after it), and rank 0's step runs on its
blocks (``launch.lowering``).  ``per_device`` holds rank 0's FLOPs,
bytes, arguments, peak and launches, and ``collective_bytes`` with
``collectives``: the reference's ``bytes_by_kind``, ``counts`` and
``total`` of the result bytes of every collective rank 0 issues, plus
``bytes_by_axis``, ``counts_by_axis`` and ``link_bw`` by mesh axis.  The
roofline's ``collective_s`` sums each axis's bytes over its link's rate
(NVLink 450e9 B/s within a node of 8 cards, 50e9 B/s between nodes), and
``bound_s`` is the largest of the three terms.  ``fits`` holds the peak
against one H100's memory; where it fails, ``notes`` lists the largest
live tensors near the peak.  ``model_flops_total`` is the whole step's,
so ``useful_flops_ratio`` divides its per-rank share by rank 0's FLOPs,
as the reference's.

``--jobs N`` traces the cells in N worker processes (each makes its own
fake groups); the records keep the cells' order.  A cell that fails to
build or run is an ``error`` record, and the command exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import traceback
from concurrent.futures import ProcessPoolExecutor

from .. import configs
from . import lowering
from .cells import build_cell
from .mesh import (PRODUCTION_MESHES, hbm_bytes, make_production_mesh,
                   n_devices)


#: ``--mesh`` -> the ``multi_pod`` of each record (None: one card)
MESHES = {"single": (None,), "pod": (False,), "multi": (True,),
          "both": (False, True)}


def mesh_name(multi_pod: bool | None) -> str:
    """A record's ``mesh``: ``single_h100``, ``h100x256_16x16`` or
    ``h100x512_2x16x16``."""
    if multi_pod is None:
        return "single_h100"
    shape, _ = PRODUCTION_MESHES[bool(multi_pod)]
    return (f"h100x{n_devices(multi_pod)}_"
            + "x".join(str(n) for n in shape))


def run_cell(arch_id: str, shape, n_layers: int | None = None, *,
             multi_pod: bool | None = None, verbose: bool = True) -> dict:
    """The dry-run record of one cell; ``shape`` is a cell name or a
    ``ShapeCell``; ``n_layers`` cuts an LM's depth; ``multi_pod`` None
    for one card, False for rank 0 of the 256-rank mesh, True for rank
    0 of the 512-rank one."""
    from . import perf_flags
    spec = configs.get(arch_id)
    cell = shape if not isinstance(shape, str) else spec.shapes[shape]
    name = mesh_name(multi_pod)
    rec = {"arch": arch_id, "shape": cell.name, "mesh": name,
           "kind": cell.kind, "n_devices": n_devices(multi_pod)}
    if n_layers is not None:
        rec["n_layers"] = n_layers
    if cell.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        return rec
    key = ("dryrun", arch_id, cell.name, cell.kind,
           tuple(sorted(cell.meta.items())), n_layers, multi_pod,
           repr(perf_flags.FLAGS))
    with contextlib.ExitStack() as stack:
        mesh = None
        if multi_pod is not None:
            mesh = stack.enter_context(make_production_mesh(
                multi_pod=multi_pod))
        build = build_cell(arch_id, cell, n_layers, mesh=mesh)
        cost = lowering.lower(build.fn, build.abstract_args, key=key,
                              mesh=mesh)
    peak = cost.peak_bytes
    roof = cost.roofline()
    fits = peak <= hbm_bytes()
    notes = build.notes
    if mesh is not None:
        notes = f"rank 0 of {rec['n_devices']} (a fake process group)"
        if not fits:
            notes += "; largest live tensors near the peak: " + ", ".join(
                f"{op} {list(shp)} {dt} {nb / 1e9:.2f} GB"
                for nb, op, shp, dt in cost.largest)
    coll = cost.collective_summary()
    rec.update({
        "status": "ok",
        "trace_s": round(cost.seconds, 2),
        "per_device": {
            "flops": cost.flops,
            "flops_by_dtype": cost.flops_by_dtype,
            "bytes": cost.bytes,
            "kernel_bytes": cost.kernel_bytes,
            "collective_bytes": float(coll["total"]),
            "collectives": coll,
            "launches": cost.launches,
            "ops": cost.ops,
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": peak - cost.argument_bytes - cost.output_bytes,
            "peak_hbm_est": peak,
        },
        "fits": fits,
        "roofline": roof,
        "model_flops_total": build.model_flops,
        "useful_flops_ratio": (build.model_flops / rec["n_devices"]
                               / cost.flops if cost.flops else 0.0),
        "notes": notes,
    })
    if verbose:
        pd = rec["per_device"]
        print(f"[{arch_id} × {cell.name} × {name}] trace "
              f"{cost.seconds:.1f}s | flops {pd['flops']:.3e} | bytes "
              f"{pd['bytes']:.3e} | coll {pd['collective_bytes']:.3e} | "
              f"terms (ms): C={roof['compute_s']*1e3:.2f}"
              f" M={roof['memory_s']*1e3:.2f} "
              f"X={roof['collective_s']*1e3:.2f} -> {roof['dominant']} "
              f"| useful {rec['useful_flops_ratio']*100:.0f}% | peak "
              f"{peak / 1e9:.2f} GB, fits={rec['fits']}")
    return rec


def cells_of(args) -> list:
    if args.all:
        return [(arch_id, shape) for arch_id, spec in
                sorted(configs.REGISTRY.items()) for shape in spec.shapes]
    if not args.arch:
        raise SystemExit("--arch or --all required")
    spec = configs.get(args.arch)
    return [(args.arch, s) for s in ([args.shape] if args.shape
                                     else spec.shapes)]


def _record(job) -> dict:
    """:func:`run_cell`'s record of ``job`` = (arch, shape, multi_pod), or
    an ``error`` record with the exception."""
    arch_id, shape, multi_pod = job
    try:
        return run_cell(arch_id, shape, multi_pod=multi_pod)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch_id, "shape": shape,
                "mesh": mesh_name(multi_pod), "status": "error",
                "error": repr(e)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=tuple(MESHES), default="single",
                    help="single: one card; pod: 256 ranks (16, 16); "
                         "multi: 512 ranks (2, 16, 16); both: pod and "
                         "multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes tracing cells (default 1: "
                         "this process)")
    args = ap.parse_args(argv)
    jobs = [(arch, shape, mp) for arch, shape in cells_of(args)
            for mp in MESHES[args.mesh]]
    out_f = open(args.out, "a") if args.out else None
    failures = 0
    with contextlib.ExitStack() as stack:
        run = map
        if args.jobs > 1:
            run = stack.enter_context(ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"))).map
        for rec in run(_record, jobs):
            failures += rec["status"] == "error"
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    if out_f:
        out_f.close()
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
