"""Training loop (PyTorch port of ``src/repro/train/trainer.py``).

``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)`` runs
once per batch; the loop then reads the metrics as Python floats, which
waits for the device (the reference's ``block_until_ready``), times the
step with a :class:`StragglerMonitor` and logs every ``log_every`` steps.

With ``ckpt_dir`` the trainer checkpoints ``{"params", "opt"}`` through an
:class:`~repro_torch.train.checkpoint.AsyncCheckpointer` (keeping the
newest ``keep``) every ``ckpt_every`` steps and at the end, with
``stream_step`` in the metadata, and resumes from the latest step at
start-up.  The port's step updates the model's parameters in place, so a
restore copies the saved values into those very tensors (rebinding the
list would leave the model training its old weights) and rebuilds the
optimizer state, its step count included.  With a ``layout`` (an LM's
``models.convert.LMLayout``) the state is saved and restored in that
layout, the reference's stacked one; without one ``{"params": list,
"opt": AdamWState}`` is saved as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import checkpoint as ckpt_lib
from .fault import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10


def _device_of(tree):
    """The device of the first tensor in ``tree`` (the CPU without one)."""
    return next((x.device for _, x in ckpt_lib.leaves(tree)
                 if isinstance(x, torch.Tensor)), torch.device("cpu"))


class Trainer:
    """Single-process training loop.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    stream.batch_at(step) -> host batch dict
    layout: ``tree(params, opt_state)`` / ``load(tree, params)`` of the
    checkpointed state, or None to save it as it is held
    """

    def __init__(self, step_fn: Callable, params, opt_state, stream,
                 cfg: TrainerConfig, put_batch: Callable | None = None,
                 layout=None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.stream = stream
        self.cfg = cfg
        self.put_batch = put_batch or (lambda b: b)
        self.layout = layout
        self.monitor = StragglerMonitor()
        self.ckpt = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
                     if cfg.ckpt_dir else None)
        self.start_step = 0
        self.history: list[dict] = []
        if cfg.ckpt_dir and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            state, step, _ = ckpt_lib.restore(
                cfg.ckpt_dir, self._state(), device=_device_of(params))
            if layout is None:
                with torch.no_grad():
                    for (_, p), (_, q) in zip(
                            ckpt_lib.leaves(self.params),
                            ckpt_lib.leaves(state["params"])):
                        p.copy_(q)
                self.opt_state = state["opt"]
            else:
                self.opt_state = layout.load(state, self.params)
            self.start_step = step
            print(f"[trainer] restored checkpoint at step {step}")

    def _state(self) -> dict:
        if self.layout is None:
            return {"params": self.params, "opt": self.opt_state}
        return self.layout.tree(self.params, self.opt_state)

    def run(self):
        cfg = self.cfg
        for step in range(self.start_step, cfg.num_steps):
            batch = self.put_batch(self.stream.batch_at(step))
            self.monitor.start_step()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            rec = {k: float(v) for k, v in metrics.items()}   # waits
            action = self.monitor.end_step()
            if action == "escalate":
                print(f"[trainer] step {step}: straggler escalation "
                      f"(median {self.monitor.median:.3f}s)")
            rec["step"] = step
            self.history.append(rec)
            if step % cfg.log_every == 0:
                print(f"[trainer] step {step}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in rec.items() if k != "step"))
            if self.ckpt and (step + 1) % cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self._state(),
                               metadata={"stream_step": step + 1})
        if self.ckpt:
            self.ckpt.save(cfg.num_steps, self._state(),
                           metadata={"stream_step": cfg.num_steps})
            self.ckpt.wait()
        return self.history
