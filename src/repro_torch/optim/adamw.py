"""AdamW with global-norm clipping (PyTorch port of
``src/repro/optim/adamw.py``).

A plain class over a list of tensors (or a dict of them, whose values are
taken in order), functional like the reference: ``init(params)`` makes
the state, ``update(grads, state, params)`` returns the new parameters
and state; ``step`` writes the same values in place, one tensor at a
time.  It keeps the reference's formulas, which
differ from ``torch.optim.AdamW``: the global norm is clipped with
``+ 1e-12`` (``clip_grad_norm_`` adds 1e-6), the bias corrections use the
float32 step count, weight decay is added to the update (not applied to
the parameters first), and ``schedule(count)`` scales the learning rate.
The step count lives on the parameters' device, so an update never waits
for the host.

:class:`HybridAdamW` is the recsys optimizer: Adam for the dense
parameters, momentum-free SGD for the embedding tables.  It takes the
parameters by name, as the reference's tree paths (``tables/t0``,
``mlp/0/w``: ``models.recsys.WideDeep.params()``).
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
        params = _tensors(params)
        dev = params[0].device if params else torch.device("cpu")
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          mu=zeros,
                          nu=[torch.zeros_like(z) for z in zeros])

    def update(self, grads, state: AdamWState, params):
        """Returns ``(new_params, new_state)``; nothing is modified."""
        grads, params = list(grads), _tensors(params)
        count = state.count + 1
        scale = self._clip_scale(grads)
        if scale is not None:
            grads = [g * scale for g in grads]
        b1, b2 = self.b1, self.b2
        mu = [b1 * m + (1 - b1) * g.to(torch.float32)
              for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g.to(torch.float32))
              for v, g in zip(state.nu, grads)]
        bc1, bc2, lr = _corrections(self, count)
        new = [self._param_step(p, m, v, bc1, bc2, lr)
               for p, m, v in zip(params, mu, nu)]
        return new, AdamWState(count=count, mu=mu, nu=nu)

    @torch.no_grad()
    def step(self, params, grads, state: AdamWState) -> AdamWState:
        """:meth:`update` in place: the same values, bit for bit, written
        into ``params`` (the parameters of a module) and into ``state``'s
        moment tensors, one tensor at a time, so the temporaries are one
        tensor's and not a second copy of the model and its moments.
        Returns the new state (which holds ``state``'s moment tensors)."""
        params, grads = _tensors(params), list(grads)
        count = state.count + 1
        scale = self._clip_scale(grads)
        bc1, bc2, lr = _corrections(self, count)
        b1, b2 = self.b1, self.b2
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            g32 = (g if scale is None else g * scale).to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            del g32
            p.copy_(self._param_step(p, m, v, bc1, bc2, lr))
        return AdamWState(count=count, mu=state.mu, nu=state.nu)

    def _clip_scale(self, grads):
        """The global-norm clip's factor (a 0-d tensor), or None."""
        if self.clip_norm is None:
            return None
        gnorm = global_norm(grads)
        return torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)

    def _param_step(self, p, m, v, bc1, bc2, lr):
        upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if self.weight_decay:
            upd = upd + self.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * upd).to(p.dtype)


def _tensors(params) -> list:
    """A dict's values, or the tensors of an iterable, as a list."""
    return list(params.values() if isinstance(params, dict) else params)


def _corrections(adamw: AdamW, count):
    """The bias corrections ``1 - b ** count`` (float32 count, as the
    reference) and the scheduled learning rate."""
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(adamw.b1, dtype=torch.float32,
                                     device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(adamw.b2, dtype=torch.float32,
                                     device=c.device), c)
    lr = adamw.lr * (adamw.schedule(count) if adamw.schedule else 1.0)
    return bc1, bc2, lr


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


@dataclasses.dataclass(frozen=True)
class HybridAdamW:
    """AdamW for dense parameters, momentum-free SGD for leaves matched by
    ``sgd_path`` — the classic recsys hybrid: huge embedding tables carry
    no optimizer moments (a 0-d zero each) and skip the Adam math.  As in
    the reference, the Adam leaves get the bias corrections and the
    schedule of ``adamw``, but neither its clipping nor its weight decay.

    ``params`` is a dict from the reference's ``/``-joined tree paths
    (``tables/t0``, ``wide_tables/t3``, ``mlp/0/w``) to tensors; ``grads``
    and the moments follow its order."""
    adamw: AdamW
    sgd_lr: float = 0.05
    sgd_path: Callable[[str], bool] = staticmethod(
        lambda path: "tables" in path)

    def _mask(self, params) -> list:
        return [bool(self.sgd_path(name)) for name in params]

    def init(self, params: dict) -> AdamWState:
        tensors = list(params.values())
        dev = tensors[0].device if tensors else torch.device("cpu")
        zeros = [torch.zeros((), dtype=torch.float32, device=p.device) if m
                 else torch.zeros_like(p, dtype=torch.float32)
                 for p, m in zip(tensors, self._mask(params))]
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    def update(self, grads, state: AdamWState, params: dict):
        """Returns ``(new_params, new_state)`` as lists in ``params``'
        order; nothing is modified."""
        count = state.count + 1
        outs = [self._leaf(*leaf) for leaf in
                self._leaves(params, grads, state, count)]
        return [o[0] for o in outs], AdamWState(
            count=count, mu=[o[1] for o in outs], nu=[o[2] for o in outs])

    @torch.no_grad()
    def step(self, params: dict, grads, state: AdamWState) -> AdamWState:
        """:meth:`update`, with the new values copied into ``params`` in
        place one tensor at a time (a table's temporaries, not a second
        copy of every table); returns the new state."""
        count = state.count + 1
        mu, nu = [], []
        for leaf in self._leaves(params, grads, state, count):
            p_new, m, v = self._leaf(*leaf)
            leaf[1].copy_(p_new)
            mu.append(m)
            nu.append(v)
        return AdamWState(count=count, mu=mu, nu=nu)

    def _leaves(self, params, grads, state, count):
        bc = _corrections(self.adamw, count)
        return [(is_sgd, p, g, m, v, bc) for is_sgd, p, g, m, v in zip(
            self._mask(params), params.values(), grads, state.mu,
            state.nu)]

    def _leaf(self, is_sgd, p, g, m, v, bc):
        """One leaf's ``(new_p, mu, nu)``: SGD, or Adam with the bias
        corrections and the scheduled rate ``bc = (bc1, bc2, lr)``."""
        g32 = g.to(torch.float32)
        if is_sgd:
            return (p.to(torch.float32) - self.sgd_lr * g32).to(p.dtype), m, v
        a = self.adamw
        bc1, bc2, lr = bc
        m2 = a.b1 * m + (1 - a.b1) * g32
        v2 = a.b2 * v + (1 - a.b2) * torch.square(g32)
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + a.eps)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m2, v2
