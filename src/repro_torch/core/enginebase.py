"""Shared base for the port's engine families (PyTorch port of
``src/repro/core/enginebase.py``).

It owns what every engine needs: the graph, a transpose built at most
once (O(n+m) counting sort, pre-seedable) and the dispatch accounting.

* ``dispatches`` counts device dispatches: each ``run`` is 1 and each
  ``run_batch`` is 1 whatever the batch size; the degenerate n = 0 /
  m = 0 shortcuts are 0.  The SCC driver's per-generation contract
  (DESIGN.md §8) is asserted against this count, so a fixpoint driven
  from the host, round by round, still counts one dispatch.
* ``traces`` stays 0: PyTorch runs eagerly and compiles nothing per
  shape.  The property is kept so callers written against the reference
  read the same accounting.

The reference's ``_dispatch`` also opens an ``obs`` span, feeds the
MetricsPlane and arms the FaultPlane.  The port has none of those planes
yet; what needs them raises :class:`NotImplementedError` naming the
ROADMAP item that brings it (A7 observability and metrics, A8 faults and
checkpoints).
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import _CKPT_A8, _NBYTES_A7, CSRGraph


class EngineBase:
    """Engine over one graph: transpose cache + dispatch accounting."""

    #: engine family name; subclasses override
    family = "engine"

    def __init__(self, graph: CSRGraph, *, transpose: CSRGraph | None = None):
        self.graph = graph
        self._transpose = transpose
        self._transpose_builds = 0
        self._dispatches = 0

    @property
    def transpose(self) -> CSRGraph:
        """Gᵀ, built at most once (O(n+m) counting sort) and cached."""
        if self._transpose is None:
            self._transpose = self.graph.transpose()
            self._transpose_builds += 1
        return self._transpose

    @property
    def transpose_builds(self) -> int:
        return self._transpose_builds

    @property
    def traces(self) -> int:
        """Always 0 under eager PyTorch (nothing is traced)."""
        return 0

    @property
    def dispatches(self) -> int:
        return self._dispatches

    def _as_mask(self, x, shape, what):
        """``x`` (numpy or torch) as a bool tensor on the engine's device,
        raising unless its shape is ``shape``."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        return x.to(self.device, torch.bool)

    def _dispatch(self, fn, *args):
        """Run one fixpoint call and count it as one dispatch, however
        many rounds and host syncs it takes."""
        out = fn(*args)
        self._dispatches += 1
        return out

    def nbytes(self) -> int:
        raise NotImplementedError(_NBYTES_A7)

    def nbytes_breakdown(self) -> dict:
        raise NotImplementedError(_NBYTES_A7)

    def state_dict(self):
        raise NotImplementedError(_CKPT_A8)

    def state_meta(self) -> dict:
        raise NotImplementedError(_CKPT_A8)

    def load_state(self, tree, meta) -> None:
        raise NotImplementedError(_CKPT_A8)


__all__ = ["EngineBase"]
