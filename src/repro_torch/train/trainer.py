"""Training loop (PyTorch port of ``src/repro/train/trainer.py``).

``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)`` runs
once per batch; the loop then reads the metrics as Python floats, which
waits for the device (the reference's ``block_until_ready``), times the
step with a :class:`StragglerMonitor` and logs every ``log_every`` steps.

Not ported: checkpointing (``ckpt_dir`` raises, ROADMAP A8) and the
elastic restore that rides on it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .fault import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_dir: str | None = None
    log_every: int = 10


class Trainer:
    """Single-process training loop.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    stream.batch_at(step) -> host batch dict
    """

    def __init__(self, step_fn: Callable, params, opt_state, stream,
                 cfg: TrainerConfig, put_batch: Callable | None = None):
        if cfg.ckpt_dir is not None:
            raise NotImplementedError(
                "checkpointing (ckpt_dir) is not ported to repro_torch yet "
                "(ROADMAP A8)")
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.stream = stream
        self.cfg = cfg
        self.put_batch = put_batch or (lambda b: b)
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []

    def run(self):
        cfg = self.cfg
        for step in range(cfg.num_steps):
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
        return self.history
