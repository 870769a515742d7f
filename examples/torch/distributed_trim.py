"""Sharded trimming on ``torch.distributed`` ranks (the twin of
``examples/distributed_trim.py``).

    python examples/torch/distributed_trim.py                # one NCCL rank
    python examples/torch/distributed_trim.py --device cpu   # 8 gloo ranks
    torchrun --nproc-per-node 4 examples/torch/distributed_trim.py

Each rank trims its row block of BA(20000, 8, seed 0) with AC-6; the
status is re-assembled by one all-gather a round, and every rank ends
with the whole result, which equals the single-engine AC-6 run.  Rank 0
prints the per-rank traversed edges and their imbalance.  On the CPU the
ranks are spawned processes in a gloo group; on a card each rank is one
NCCL rank (NCCL takes one rank a card, so one card runs one rank).
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import plan
from repro_torch.graphs import barabasi_albert

#: the graph: the reference's sizes
N, DEG, SEED = 20_000, 8, 0
#: gloo ranks spawned with --device cpu (the reference's 8 devices)
CPU_RANKS = 8


def trim_rank(device):
    """This rank's sharded AC-6 run, held against the single-engine
    run; returns ``(graph, result, engine)``."""
    # on the host: the sharded engine keeps it there and moves only this
    # rank's block to the device; the single engine moves all of it
    g = barabasi_albert(N, DEG, seed=SEED, device="cpu")
    single = plan(g, method="ac6", device=device).run()
    eng = plan(g, method="ac6", backend="sharded", unmasked=True,
               device=device)
    res = eng.run().materialize()
    assert np.array_equal(single.status.cpu().numpy(), res.status)
    return g, res, eng


def report(g, res, eng) -> dict:
    pw = res.per_worker_edges
    imb = pw.max() / max(pw.mean(), 1)
    calls, nbytes = eng.last_collectives["all_gather"]
    ranks = len(pw)
    print(f"graph n={g.n:,} m={g.m:,}: trimmed {res.n_trimmed:,} vertices "
          f"on {ranks} rank{'s' * (ranks > 1)}")
    print("per-rank traversed edges:", pw.tolist())
    print(f"load imbalance (max/mean): {imb:.2f}x; rounds={res.rounds}; "
          f"status all_gather per round = "
          f"{-(-g.n // ranks) / 1024:.1f} KiB/rank "
          f"({calls} all-gathers, {nbytes:,} bytes in the run)")
    return dict(trimmed=res.n_trimmed, per_rank_edges=pw.tolist(),
                rounds=res.rounds, imbalance=float(imb))


def _cpu_rank(rank, world_size):
    g, res, eng = trim_rank("cpu")
    if rank == 0:
        report(g, res, eng)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cpu" and "WORLD_SIZE" not in
            os.environ and not torch.distributed.is_initialized()):
        dist.spawn(_cpu_rank, CPU_RANKS)       # not under torchrun
        return None
    with dist.process_group(args.device) as dev:
        g, res, eng = trim_rank(dev)
        if torch.distributed.get_rank() == 0:
            return report(g, res, eng)
    return None


if __name__ == "__main__":
    main()
