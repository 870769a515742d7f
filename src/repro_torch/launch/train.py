"""Training launcher of the port (PyTorch port of
``src/repro/launch/train.py``) for the GNN family::

    python -m repro_torch.launch.train --arch schnet --smoke --device cpu
    python -m repro_torch.launch.train --arch meshgraphnet --steps 5  # card

``--smoke`` trains the reduced configuration on
``GraphBatchStream(batch=4, n_nodes=16, n_edges=48)``, as the reference
does.  Without it the published configuration trains on the ``molecule``
cell's stream (``GraphBatchStream(batch=128, n_nodes=30, n_edges=64)``),
on ``--device`` (default ``cuda``; a missing card raises), where the
reference refuses for want of a TPU.  Weights are random, drawn from
seed 0 by a ``torch.Generator`` on the device; the optimizer is AdamW
(lr 1e-3) with the reference's formulas.  Each step batches its graphs as
one disjoint union (``models.gnn.common.molecule_union``), so every layer
aggregates the whole batch with one ``segment_sum`` launch.  It prints the
reference's line ``[train] {arch}: first loss ..., last loss ...``.
``--ckpt-dir DIR`` checkpoints the parameters and the AdamW state there
(``TrainerConfig`` defaults: every 50 steps and at the end, the newest 3
kept) and resumes from the latest step in DIR.

Not ported yet, and raising :class:`NotImplementedError` that names the
ROADMAP item: LM and recsys training (A11).
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from ..data import GraphBatchStream
from ..models.gnn import MODELS
from ..models.gnn.common import molecule_loss, molecule_union
from ..optim import AdamW
from ..train import Trainer, TrainerConfig

#: the molecule cell of ``configs.base.gnn_shapes`` and the smoke stream
MOLECULE = dict(batch=128, n_nodes=30, n_edges=64)
SMOKE = dict(batch=4, n_nodes=16, n_edges=48)


def make_train_step(model, opt: AdamW, loss_fn):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``:
    the loss and its gradient by autograd, then one AdamW update written
    into ``params`` (the model's parameters) in place."""
    def step(params, opt_state, batch):
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        opt_state = opt.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach()}
    return step


def build(arch_id: str, seed: int = 0, *, smoke: bool = True,
          device="cuda"):
    """``(step, params, opt_state, stream, put_batch)`` for a GNN id: the
    reduced config on the smoke stream, or the published one on the
    molecule cell's.  Other families raise naming their ROADMAP item."""
    spec = configs.get(arch_id)
    if spec.family != "gnn":
        raise NotImplementedError(
            f"{arch_id!r}: {spec.family} training is not ported to "
            "repro_torch yet (ROADMAP A11: LM training, recsys)")
    cfg = spec.make_reduced() if smoke else spec.make_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = MODELS[type(cfg)](cfg, device=device, generator=gen)
    opt = AdamW(lr=1e-3)
    params = list(model.parameters())
    stream = GraphBatchStream(**(SMOKE if smoke else MOLECULE), seed=seed)
    step = make_train_step(model, opt, molecule_loss)
    return (step, params, opt.init(params), stream,
            lambda b: molecule_union(b, device))


def build_smoke(arch_id: str, seed: int = 0, *, device="cuda"):
    """The reference's ``build_smoke``: ``(step, params, opt_state,
    stream)`` at the reduced config; batches go through
    ``models.gnn.common.molecule_union`` first."""
    return build(arch_id, seed, smoke=True, device=device)[:4]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration (default: published)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    step, params, opt_state, stream, put = build(
        args.arch, 0, smoke=args.smoke, device=args.device)
    tr = Trainer(step, params, opt_state, stream,
                 TrainerConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                               log_every=5),
                 put_batch=put)
    hist = tr.run()
    losses = [h["loss"] for h in hist]
    print(f"[train] {args.arch}: first loss {losses[0]:.4f}, "
          f"last loss {losses[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
