"""The readings behind each limit of the check: the program's numbers on
many seeds (the lower reading) and the controls' (the upper), at the
cell's own size, in one process per call.

    python3 trimbench/control.py --workloads kron26.ac6 urand26.ac6 \\
        --seeds 101 102 ... --control-seeds 201 202 203 [--out FILE]

For each seed and configuration the graph is built once; each workload
on it plans and warms up its engine through the harness's own
``plan_engine``, as every run does, and judges one call against the
reference.  On the control seeds the reference's answer with
one guarantee broken (``reference.control``) is judged in the program's
place.  One JSON line per reading.  The benchmark's own runs never run
this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CONTROLS = ("int16_counters", "early_stop")


def program_reading(cell, indptr, indices, live, device) -> dict:
    import torch

    from trimbench import harness, reference

    mix = cell.mix
    engine = harness.plan_engine(mix, indptr, indices, device)
    res = engine.run(counters=bool(mix["counters"]))
    ref_pw = _ref_counters(cell, indptr, indices, live)
    out = reference.judge(res.status, res.per_worker_edges, live, ref_pw)
    out["rounds"] = res.rounds
    del engine, res
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ref_counters(cell, indptr, indices, live):
    from trimbench import reference
    mix = cell.mix
    if not mix["counters"]:
        return None
    return reference.counters(mix["method"], indptr, indices, live,
                              int(mix["workers"]), int(mix["chunk"]))


def control_reading(cell, kind, indptr, indices, live) -> dict:
    from trimbench import reference
    mix = cell.mix
    status, pw = reference.control(kind, mix["method"], indptr, indices,
                                   int(mix["workers"]), int(mix["chunk"]),
                                   bool(mix["counters"]))
    return reference.judge(status, pw, live,
                           _ref_counters(cell, indptr, indices, live))


def readings(workloads, seeds, control_seeds, device="cuda", config=None):
    """Yield one dict per reading: workload, seed, who, the numbers."""
    from trimbench import reference, spec

    cells = [spec.cell(w) for w in workloads]
    by_config = {}
    for c in cells:
        by_config.setdefault(c.config["name"], []).append(c)
    for name, group in by_config.items():
        cfg = group[0].config if config is None else config
        gen = spec.load_module("generators", cfg["generator"])
        for seed in sorted(set(seeds) | set(control_seeds)):
            t0 = time.perf_counter()
            indptr, indices = gen.make(cfg, seed, device)
            live, rounds = reference.trim(indptr, indices)
            for cell in group:
                base = {"workload": cell.name, "seed": seed,
                        "ref_rounds": rounds,
                        "trimmed": int((~live).sum())}
                if seed in seeds:
                    yield dict(base, who="program", **program_reading(
                        cell, indptr, indices, live, device))
                if seed in control_seeds:
                    for kind in CONTROLS:
                        if kind == "int16_counters" \
                                and not cell.mix["counters"]:
                            continue
                        yield dict(base, who=kind, **control_reading(
                            cell, kind, indptr, indices, live))
            del indptr, indices, live
            yield {"config": name, "seed": seed,
                   "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workloads", nargs="+", required=True)
    p.add_argument("--seeds", nargs="*", type=int, default=[])
    p.add_argument("--control-seeds", nargs="*", type=int, default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    sink = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workloads, args.seeds, args.control_seeds):
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
