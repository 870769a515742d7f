"""Dry-run every (architecture x shape) cell for one H100 (PyTorch port of
``src/repro/launch/dryrun.py``)::

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out dryrun.jsonl --jobs 4

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

``collective_bytes`` and ``collective_s`` are 0: one card has no
collectives, and ``notes`` says so.  The compute term counts each dtype's
FLOPs at its peak rate (``launch.mesh``: bf16 989.4 TFLOP/s, f32 67), the
memory term the bytes at 3.35 TB/s.  The port runs every layer, so no
layer-count extrapolation is needed (the reference's
``_lm_cost_extrapolated`` exists because XLA counts a scan body once).

``--mesh single`` (the default) is the one card; ``multi`` and ``both``
are the reference's 256- and 512-chip meshes, whose meta-device dry-run
(a fake process group of that many ranks) is ROADMAP A6's last item:
they raise.  The sharded cells themselves run on a real mesh
(``cells.build_cell(..., mesh=)``).  ``--jobs N`` traces the cells
in N worker processes; the records keep the cells' order.  The command
exits 1 when any cell's status is ``error``.
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
from .mesh import hbm_bytes, n_devices


def run_cell(arch_id: str, shape, n_layers: int | None = None, *,
             verbose: bool = True) -> dict:
    """The dry-run record of one cell; ``shape`` is a cell name or a
    ``ShapeCell``; ``n_layers`` cuts an LM's depth."""
    from . import perf_flags
    spec = configs.get(arch_id)
    cell = shape if not isinstance(shape, str) else spec.shapes[shape]
    rec = {"arch": arch_id, "shape": cell.name, "mesh": "single_h100",
           "kind": cell.kind, "n_devices": n_devices()}
    if n_layers is not None:
        rec["n_layers"] = n_layers
    if cell.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        return rec
    build = build_cell(arch_id, cell, n_layers)
    key = ("dryrun", arch_id, cell.name, cell.kind,
           tuple(sorted(cell.meta.items())), n_layers,
           repr(perf_flags.FLAGS))
    cost = lowering.lower(build.fn, build.abstract_args, key=key)
    peak = cost.peak_bytes
    roof = cost.roofline()
    rec.update({
        "status": "ok",
        "trace_s": round(cost.seconds, 2),
        "per_device": {
            "flops": cost.flops,
            "flops_by_dtype": cost.flops_by_dtype,
            "bytes": cost.bytes,
            "kernel_bytes": cost.kernel_bytes,
            "collective_bytes": 0.0,
            "launches": cost.launches,
            "ops": cost.ops,
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": peak - cost.argument_bytes - cost.output_bytes,
            "peak_hbm_est": peak,
        },
        "fits": peak <= hbm_bytes(),
        "roofline": roof,
        "model_flops_total": build.model_flops,
        "useful_flops_ratio": (build.model_flops / cost.flops
                               if cost.flops else 0.0),
        "notes": build.notes,
    })
    if verbose:
        pd = rec["per_device"]
        print(f"[{arch_id} × {cell.name} × single_h100] trace "
              f"{cost.seconds:.1f}s | flops {pd['flops']:.3e} | bytes "
              f"{pd['bytes']:.3e} | terms (ms): C={roof['compute_s']*1e3:.2f}"
              f" M={roof['memory_s']*1e3:.2f} X=0.00 -> {roof['dominant']} "
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


def _record(cell) -> dict:
    """:func:`run_cell`'s record of ``cell`` = (arch, shape), or an
    ``error`` record with the exception."""
    arch_id, shape = cell
    try:
        return run_cell(arch_id, shape)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch_id, "shape": shape, "mesh": "single_h100",
                "status": "error", "error": repr(e)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes tracing cells (default 1: "
                         "this process)")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the dry-run of the 256/512-chip meshes "
            "(a fake process group on the meta device) is not ported yet: "
            "ROADMAP A6, its last item")
    out_f = open(args.out, "a") if args.out else None
    failures = 0
    with contextlib.ExitStack() as stack:
        run = map
        if args.jobs > 1:
            run = stack.enter_context(ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"))).map
        for rec in run(_record, cells_of(args)):
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
