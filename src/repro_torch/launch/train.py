"""Training launcher of the port (PyTorch port of
``src/repro/launch/train.py``) for the LM (dense and MoE), GNN and recsys
families::

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --device cpu
    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 3   # card
    python -m repro_torch.launch.train --arch arctic-480b --smoke --device cpu
    python -m repro_torch.launch.train --arch schnet --smoke --device cpu
    python -m repro_torch.launch.train --arch meshgraphnet --steps 5  # card
    python -m repro_torch.launch.train --arch wide-deep --smoke --device cpu

``--smoke`` trains the reduced configuration on the reference's smoke
stream: ``TokenStream(batch=4, seq=32)`` for an LM,
``GraphBatchStream(batch=4, n_nodes=16, n_edges=48)`` for a GNN,
``RecsysStream(batch=32)`` for wide-deep.  Without it the published
configuration trains on ``--device`` (default ``cuda``; a missing card
raises), where the reference refuses for want of a TPU: an LM on
``TokenStream(batch=2, seq=4096)`` (``train_4k``'s sequence, its batch of
256 cut to what one card holds; remat as the config sets it), a GNN on
the ``molecule`` cell's stream (``GraphBatchStream(batch=128,
n_nodes=30, n_edges=64)``), wide-deep on the ``train_batch`` cell's
65,536 rows.  Weights are random, drawn from seed 0 by a
``torch.Generator`` on the device; the optimizer is AdamW (lr 1e-3) with
the reference's formulas.  A GNN step batches its graphs as one disjoint
union (``models.gnn.common.molecule_union``), so every layer aggregates
the whole batch with one ``segment_sum`` launch; an LM's batches become
int64 tensors on the device.  It prints the reference's line ``[train]
{arch}: first loss ..., last loss ...``.  ``--ckpt-dir DIR`` checkpoints
the parameters and the AdamW state there (``TrainerConfig`` defaults:
every 50 steps and at the end, the newest 3 kept; an LM's in the
reference's stacked layout) and resumes from the latest step in DIR.
The MoE LMs train at their reduced configs: at the published width
neither fits one card (arctic's f32 weights and gradients at one layer
are 112 GB); across cards they train sharded, the experts on "model"
(``launch.cells.build_cell(..., mesh=)``).
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from ..data import GraphBatchStream, RecsysStream, TokenStream
from ..models import convert, transformer
from ..models.gnn import MODELS
from ..models.gnn.common import molecule_loss, molecule_union
from ..models.recsys import WideDeep, make_recsys_train_step
from ..optim import AdamW
from ..train import Trainer, TrainerConfig

#: the molecule cell of ``configs.base.gnn_shapes`` and the smoke stream
MOLECULE = dict(batch=128, n_nodes=30, n_edges=64)
SMOKE = dict(batch=4, n_nodes=16, n_edges=48)
#: an LM's batches: the reference's smoke stream, and train_4k's sequence
#: at the batch one card holds
LM_SMOKE = dict(batch=4, seq=32)
LM_FULL = dict(batch=2, seq=4096)


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
    """``(step, params, opt_state, stream, put_batch, layout)`` for an LM,
    GNN or recsys id: the reduced config on the smoke stream, or the
    published one on :data:`LM_FULL` (LMs), the molecule cell's (GNNs) or
    the ``train_batch`` cell's stream (recsys).  ``layout`` is the
    ``Trainer``'s: an LM's ``models.convert.LMLayout`` (checkpoints in the
    reference's stacked layout), else None."""
    spec = configs.get(arch_id)
    cfg = spec.make_reduced() if smoke else spec.make_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    if spec.family == "lm":
        return _build_lm(cfg, gen, seed, smoke, device)
    if spec.family == "recsys":
        return _build_recsys(spec, cfg, gen, seed, smoke, device)
    model = MODELS[type(cfg)](cfg, device=device, generator=gen)
    opt = AdamW(lr=1e-3)
    params = list(model.parameters())
    stream = GraphBatchStream(**(SMOKE if smoke else MOLECULE), seed=seed)
    step = make_train_step(model, opt, molecule_loss)
    return (step, params, opt.init(params), stream,
            lambda b: molecule_union(b, device), None)


def _build_lm(cfg, gen, seed: int, smoke: bool, device):
    model = transformer.LM(cfg, device=device, generator=gen)
    opt = AdamW(lr=1e-3)
    params = list(model.parameters())
    stream = TokenStream(**(LM_SMOKE if smoke else LM_FULL), vocab=cfg.vocab,
                         seed=seed)

    def put(b):
        return {k: torch.as_tensor(v, device=device).long()
                for k, v in b.items()}

    return (transformer.make_train_step(model, opt), params,
            opt.init(params), stream, put, convert.LMLayout(model))


def _build_recsys(spec, cfg, gen, seed: int, smoke: bool, device):
    model = WideDeep(cfg, device=device, generator=gen)
    opt = AdamW(lr=1e-3)
    params = model.params()
    batch = 32 if smoke else spec.shapes["train_batch"].meta["batch"]
    stream = RecsysStream(batch=batch, n_dense=cfg.n_dense,
                          n_sparse=cfg.n_sparse, vocab_sizes=cfg.vocab_sizes,
                          ids_per_field=cfg.ids_per_field, seed=seed)

    def put(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    return (make_recsys_train_step(model, opt), params, opt.init(params),
            stream, put, None)


def build_smoke(arch_id: str, seed: int = 0, *, device="cuda"):
    """The reference's ``build_smoke``: ``(step, params, opt_state,
    stream)`` at the reduced config; a GNN's batches go through
    ``models.gnn.common.molecule_union`` first, an LM's or recsys
    batch's arrays become tensors on the device."""
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
    step, params, opt_state, stream, put, layout = build(
        args.arch, 0, smoke=args.smoke, device=args.device)
    tr = Trainer(step, params, opt_state, stream,
                 TrainerConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                               log_every=5),
                 put_batch=put, layout=layout)
    hist = tr.run()
    losses = [h["loss"] for h in hist]
    print(f"[train] {args.arch}: first loss {losses[0]:.4f}, "
          f"last loss {losses[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
