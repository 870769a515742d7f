"""GPipe-style pipeline parallelism over a ``torch.distributed`` group
(PyTorch port of ``src/repro/train/pipeline.py``).

With M microbatches over S stages the classic schedule reaches
utilization M/(M+S-1): at tick t, stage s computes microbatch t-s (when
valid) and passes its activation to stage s+1.  The reference rotates
the activations with ``collective_permute`` inside ``shard_map``; here
rank s of the group is stage s and each tick's rotation is one
``batch_isend_irecv`` (send to (s+1) mod S, receive from (s-1) mod S).

``gpipe_apply`` is model-agnostic: ``stage_fn(stage_params, x) -> y``
with the same activation shape between stages (the usual transformer
block contract).
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

__all__ = ["gpipe_apply"]


def _stage(tree, s: int):
    """Stage ``s``'s slice of the leading stage axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, s) for v in tree)
    return tree[s]


def _rotate(y, group, stage: int, n_stages: int):
    """``y`` sent to the next stage; the previous stage's received."""
    if n_stages == 1:           # the ring is this rank: no exchange
        return y
    peer = (lambda r: r) if group is None else (
        lambda r: tdist.get_global_rank(group, r))
    y = y.contiguous()
    buf = torch.empty_like(y)
    ops = [tdist.P2POp(tdist.isend, y, peer((stage + 1) % n_stages), group),
           tdist.P2POp(tdist.irecv, buf, peer((stage - 1) % n_stages),
                       group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return buf


def gpipe_apply(stage_fn, stage_params, microbatches, *, group=None):
    """Run S pipeline stages over M microbatches, S the size of ``group``
    (the default group when None), this rank stage ``rank(group)``.

    stage_params: a tree (dicts, lists, tensors) with a leading stage
    axis of S entries; this rank takes its own.
    microbatches: (M, mb, ...) tensor, the same on every rank.
    Returns the (M, mb, ...) outputs after all S stages, on every rank
    (the last stage's, summed over the group with zeros elsewhere: the
    reference's ``psum``).  At S = 1 the exchange is skipped (the ring is
    the rank itself); the values are the same."""
    n_stages = tdist.get_world_size(group)
    stage = tdist.get_rank(group)
    params = _stage(stage_params, stage)
    m = microbatches.shape[0]
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t; the others take the rotated input
        x_in = microbatches[t if t < m else 0] if stage == 0 else buf
        y = stage_fn(params, x_in)
        # the last stage emits microbatch t - (S - 1)
        emit = t - (n_stages - 1)
        if stage == n_stages - 1 and emit >= 0:
            outs[emit] = y
        buf = _rotate(y, group, stage, n_stages)
    # only the last stage holds real outputs; every rank gets them
    if stage != n_stages - 1:
        outs.zero_()
    tdist.all_reduce(outs, group=group)
    return outs
