"""Run one cell of the port's benchmark once.

    python3 trimbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints one JSON object as the last line of standard output (the
end-to-end metrics, or with ``--trace 1`` the per-layer ones), and each
number compared against the reference beside its limit as the last lines
of standard error.  Exits non-zero, printing no result, without enough
CUDA cards, when the checkout lacks the program, or when JAX or the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernels build once per checkout, into a fixed directory inside it
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "trimbench"
                                          / "kernels")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from trimbench import guard, harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("trimbench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"trimbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0=T0)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"trimbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    harness.report_checks(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
