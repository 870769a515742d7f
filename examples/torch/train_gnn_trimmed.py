"""Train a SchNet energy model on the PyTorch port, with checkpoints and
the paper's technique in the data layer: trim-filtered neighbour sampling
(the twin of ``examples/train_gnn_trimmed.py``).

    python examples/torch/train_gnn_trimmed.py                 # on the card
    python examples/torch/train_gnn_trimmed.py --device cpu

The sampler trims the graph on the device first (AC-6), so every sampled
neighbour has an outgoing edge into the survivors; then the reduced
SchNet (weights from seed 0 on the device, :func:`build_model`) trains on
synthetic molecule batches, each batch one disjoint union of its graphs,
checkpointing every 100 steps.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs import get
from repro_torch.data import GraphBatchStream
from repro_torch.graphs import NeighborSampler, sink_heavy
from repro_torch.launch.train import make_train_step
from repro_torch.models.gnn import SchNet
from repro_torch.models.gnn.common import molecule_loss, molecule_union
from repro_torch.optim import AdamW
from repro_torch.train import Trainer, TrainerConfig

#: the sampling universe, the seed batch and the training run: the
#: reference's sizes
GRAPH_N, GRAPH_M, SINK_FRAC = 50_000, 200_000, 0.7
FANOUTS, SEEDS = (8, 4), 64
STEPS, CKPT_EVERY, LOG_EVERY = 300, 100, 50
STREAM = dict(batch=8, n_nodes=16, n_edges=48, seed=0)


def build_model(cfg, device):
    """The trained model: the reduced config's weights from seed 0."""
    return SchNet(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    device = ap.parse_args(argv).device

    # 1) the paper's technique in the data path: sample only from the
    #    trimmed (arc-consistent) universe — no dead-end neighbours
    g = sink_heavy(GRAPH_N, GRAPH_M, sink_frac=SINK_FRAC, seed=0,
                   device=device)
    sampler = NeighborSampler(g, fanouts=FANOUTS, seed=0, trim=True)
    print(f"sampling universe: {g.n:,} vertices, trimmed "
          f"{sampler.trim_stats['trimmed']:,} sinks first "
          f"(AC-6 traversed {sampler.trim_stats['edges_traversed']:,} edges)")
    blocks = sampler.sample(next(sampler.batches(SEEDS, 1)))
    print(f"sampled blocks: {[b.neighbors.shape for b in blocks]}")

    # 2) train a SchNet on synthetic molecular batches
    cfg = get("schnet").make_reduced()
    model = build_model(cfg, device)
    opt = AdamW(lr=2e-3)
    params = list(model.parameters())
    stream = GraphBatchStream(**STREAM)
    step = make_train_step(model, opt, molecule_loss)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(step, params, opt.init(params), stream,
                     TrainerConfig(num_steps=STEPS, ckpt_dir=ckpt_dir,
                                   ckpt_every=CKPT_EVERY,
                                   log_every=LOG_EVERY),
                     put_batch=lambda b: molecule_union(b, device))
        hist = tr.run()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"trained {STEPS} steps: loss {first:.4f} -> {last:.4f}")
    assert last < first
    return sampler, blocks, hist


if __name__ == "__main__":
    main()
