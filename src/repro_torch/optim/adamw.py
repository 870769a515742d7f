"""AdamW with global-norm clipping (PyTorch port of
``src/repro/optim/adamw.py``).

A plain class over a list of tensors, functional like the reference:
``init(params)`` makes the state, ``update(grads, state, params)`` returns
the new parameters and state.  It keeps the reference's formulas, which
differ from ``torch.optim.AdamW``: the global norm is clipped with
``+ 1e-12`` (``clip_grad_norm_`` adds 1e-6), the bias corrections use the
float32 step count, weight decay is added to the update (not applied to
the parameters first), and ``schedule(count)`` scales the learning rate.
The step count lives on the parameters' device, so an update never waits
for the host.

Not ported: ``HybridAdamW`` (the recsys optimizer, ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    count: torch.Tensor          # 0-d int32
    mu: list
    nu: list


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    # optional schedule: step count (0-d tensor) -> multiplier
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None

    def init(self, params) -> AdamWState:
        params = list(params)
        dev = params[0].device if params else torch.device("cpu")
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          mu=zeros,
                          nu=[torch.zeros_like(z) for z in zeros])

    def update(self, grads, state: AdamWState, params):
        """Returns ``(new_params, new_state)``; nothing is modified."""
        grads, params = list(grads), list(params)
        count = state.count + 1
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
            grads = [g * scale for g in grads]
        b1, b2 = self.b1, self.b2
        mu = [b1 * m + (1 - b1) * g.to(torch.float32)
              for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g.to(torch.float32))
              for v, g in zip(state.nu, grads)]
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=c.device), c)
        lr = self.lr * (self.schedule(count) if self.schedule else 1.0)

        def step(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        new = [step(p, m, v) for p, m, v in zip(params, mu, nu)]
        return new, AdamWState(count=count, mu=mu, nu=nu)

    @torch.no_grad()
    def step(self, params, grads, state: AdamWState) -> AdamWState:
        """:meth:`update`, with the new values copied into ``params`` in
        place (the parameters of a module); returns the new state."""
        params = list(params)
        new, state = self.update(grads, state, params)
        for p, q in zip(params, new):
            p.copy_(q)
        return state


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


def cosine_schedule(warmup: int, total: int):
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return warm * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return fn


class HybridAdamW:
    """The recsys optimizer of the reference (AdamW for dense parameters,
    SGD for embedding tables): not ported with the recsys family."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "HybridAdamW is the recsys optimizer; it is not ported to "
            "repro_torch yet (ROADMAP A11, recsys)")
