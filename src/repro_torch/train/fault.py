"""Fault tolerance at cluster scale (PyTorch port of
``src/repro/train/fault.py``): straggler detection and elastic mesh
management.

  StragglerMonitor  rolling per-step timing; flags steps slower than
                    ``threshold x`` the rolling median, and escalates
                    after ``patience`` consecutive flags.
  ElasticManager    builds the largest (data, model) ``DeviceMesh`` of
                    the surviving ranks and replays the latest checkpoint
                    onto it (``checkpoint.restore(shardings=...)``).

A ``DeviceMesh``'s subgroups are made collectively over the whole
world, so every rank of the group calls :meth:`ElasticManager.usable_mesh`,
the ranks it leaves out included (torch 2.13 gives them the mesh with
``get_coordinate()`` None, empty DTensor blocks, and no subgroups).  A
rank that has really died cannot join: the survivors first make a new
world (a restart under ``torchrun``), then the mesh on it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.times: deque[float] = deque(maxlen=window)
        self._consecutive = 0
        self.flagged_steps: list[int] = []
        self._step = 0
        self._t0: float | None = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self) -> str:
        """Returns action: 'ok' | 'warn' | 'escalate'."""
        dt = time.perf_counter() - self._t0
        self._step += 1
        return self.observe(dt)

    def observe(self, step_time: float) -> str:
        median = float(np.median(self.times)) if len(self.times) >= 5 else None
        self.times.append(step_time)
        if median is None:
            return "ok"
        if step_time > self.threshold * median:
            self._consecutive += 1
            self.flagged_steps.append(self._step)
            if self._consecutive >= self.patience:
                self._consecutive = 0
                return "escalate"
            return "warn"
        self._consecutive = 0
        return "ok"

    @property
    def median(self) -> float | None:
        return float(np.median(self.times)) if self.times else None


@dataclasses.dataclass
class ElasticManager:
    """Rebuilds meshes over surviving ranks and replays checkpoints.  The
    meshes' device type is the default group's (``cuda`` under NCCL,
    ``cpu`` under gloo: ``core.distributed.BACKEND_OF``)."""
    ckpt_dir: str
    model_axis_size: int = 1           # model-parallel degree to preserve

    def usable_mesh(self, ranks=None, failed=frozenset()):
        """The largest (data, model) mesh of ``ranks`` (default: every
        rank of the default group) less ``failed``, ``model_axis_size``
        wide, in rank order; raises as the reference does when not one
        data row fits.  A collective: every rank of the world calls it."""
        import torch
        import torch.distributed as tdist
        from torch.distributed.device_mesh import DeviceMesh

        from ..core.distributed import BACKEND_OF
        backend = str(tdist.get_backend()).lower()
        device = next(d for d, b in BACKEND_OF.items() if b in backend)
        ranks = list(range(tdist.get_world_size()) if ranks is None
                     else ranks)
        healthy = [r for r in ranks if r not in failed]
        tp = self.model_axis_size
        dp = len(healthy) // tp
        if dp < 1:
            raise RuntimeError("not enough healthy devices for model axis")
        grid = torch.tensor(healthy[: dp * tp]).reshape(dp, tp)
        return DeviceMesh(device, grid, mesh_dim_names=("data", "model"))

    def restore_onto(self, mesh, like, spec_fn):
        """Restore the latest checkpoint resharded onto ``mesh``.

        spec_fn: a factory of a spec tree (per-dimension tuples of mesh
        axis names, the reference's PartitionSpecs, ``()`` replicated)
        of ``like``'s structure."""
        from ..models.sharding import placements
        from . import checkpoint as ckpt_lib
        shardings = _map_specs(lambda sp: (mesh, placements(sp, mesh)),
                               spec_fn(), like)
        return ckpt_lib.restore(self.ckpt_dir, like, shardings=shardings)

    def handle_failure(self, failed_ids, like, spec_fn):
        """Full elastic recovery path: shrink mesh, replay checkpoint."""
        mesh = self.usable_mesh(failed=failed_ids)
        tree, step, meta = self.restore_onto(mesh, like, spec_fn)
        return mesh, tree, step, meta


def _map_specs(fn, specs, like):
    """``fn`` over the specs of a spec tree that follows ``like``: a spec
    is the tuple standing where ``like`` has a leaf (a tensor or array),
    None a leaf left unplaced."""
    if isinstance(like, dict):
        return {k: _map_specs(fn, specs[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        out = [_map_specs(fn, s, x) for s, x in zip(specs, like, strict=True)]
        return type(like)(*out) if hasattr(like, "_fields") else \
            type(like)(out)
    return None if specs is None else fn(tuple(specs))
