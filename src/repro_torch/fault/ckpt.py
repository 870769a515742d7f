"""Engine checkpoint/restore over ``train/checkpoint.py``'s writer (the
port of ``src/repro/fault/ckpt.py``).

The engines serialize through the ``state_dict()`` / ``state_meta()`` /
``load_state()`` protocol of :class:`~repro_torch.core.enginebase.
EngineBase` (DESIGN.md §14): ``state_dict`` is a flat ``{name: array}``
tree (the graph, the transpose or overlay, the persistent fixpoint
state), ``state_meta`` its JSON side (the engine family, the plan kwargs
a fresh process re-plans from, the accounting counters).  This module
writes both through the manifest layout (atomic tmp-dir rename, one
``.npy`` a leaf), arms the ``"checkpoint-write"`` fault point, feeds the
``repro_checkpoint_seconds`` histogram, and rebuilds a live engine from a
checkpoint, on an explicit device, with :func:`restore_engine`.

A checkpoint the reference wrote restores here and the other way round:
the tree names and metadata are the reference's.  The reference's plan
kwargs carry ``use_kernel``, which the port does not have (the tensor's
device picks the kernel), so it is ignored.  A sharded plan restores on
the restoring process's default group, whatever its world size.
"""
from __future__ import annotations

import time

from .plane import get_fault_plane


def _observe_checkpoint(elapsed: float, mode: str) -> None:
    from .. import obs
    mp = obs.get_plane()
    if mp.enabled:
        mp.histogram(
            "repro_checkpoint_seconds",
            "checkpoint save latency on the caller's thread (async mode "
            "measures the inline host copy + enqueue)",
        ).observe(elapsed, mode=mode)


def save_tree(ckpt_dir: str, step: int, tree: dict,
              metadata: dict | None = None, *, checkpointer=None) -> int:
    """Write one checkpoint through the manifest writer.

    Arms ``"checkpoint-write"`` first: a fired fault aborts before any
    bytes move, and the writer's atomic rename keeps a torn write from
    ever shadowing the previous good step.  ``checkpointer`` (an
    ``AsyncCheckpointer``) moves the disk IO off the caller's thread
    (the host copy stays inline).  Returns ``step``."""
    from ..train import checkpoint as _ckpt

    plane = get_fault_plane()
    if plane.enabled:
        plane.arm("checkpoint-write", step=step, dir=ckpt_dir)
    t0 = time.perf_counter()
    if checkpointer is not None:
        checkpointer.save(step, tree, metadata)
        mode = "async"
    else:
        _ckpt.save(ckpt_dir, step, tree, metadata)
        mode = "sync"
    _observe_checkpoint(time.perf_counter() - t0, mode)
    return step


def save_engine(ckpt_dir: str, engine, step: int, *,
                extra_tree: dict | None = None,
                extra_meta: dict | None = None, checkpointer=None) -> int:
    """Checkpoint one engine (plus optional caller state riding along).
    The engine's meta lands under the ``"engine"`` metadata key, where
    :func:`restore_engine` looks for it."""
    tree = dict(engine.state_dict())
    if extra_tree:
        tree.update(extra_tree)
    meta = {"engine": engine.state_meta()}
    if extra_meta:
        meta.update(extra_meta)
    return save_tree(ckpt_dir, step, tree, meta, checkpointer=checkpointer)


def _port_kwargs(kwargs: dict) -> dict:
    """A checkpoint's plan kwargs as the port's ``plan*`` functions take
    them: ``use_kernel`` dropped.  A sharded plan re-plans on the
    restoring process's default group: the checkpoint stores no world
    size (nor does the reference's), so a plan saved at one world size
    restores at another."""
    kwargs = dict(kwargs)
    kwargs.pop("use_kernel", None)
    return kwargs


def engine_from_state(tree: dict, em: dict, *, device="cuda"):
    """Rebuild a live engine on ``device`` from a checkpoint tree and its
    ``"engine"`` metadata: re-plan from the recorded plan kwargs, then
    ``load_state`` overwrites every state array with the checkpoint's
    exact values, so a resumed run is bit-identical, not merely
    equivalent."""
    from ..core.graph import CSRGraph, resolve_device

    dev = resolve_device(device)
    family = em["family"]
    kwargs = _port_kwargs(em.get("plan_kwargs", {}))
    if family == "stream":
        from ..core.stream import plan_stream
        base = CSRGraph.from_numpy(tree["base_indptr"],
                                   tree["base_indices"], dev)
        engine = plan_stream(base, **kwargs)
    elif family in ("trim", "reach", "peel"):
        graph = CSRGraph.from_numpy(tree["graph_indptr"],
                                    tree["graph_indices"], dev)
        if family == "trim":
            from ..core.engine import plan as plan_fn
        elif family == "reach":
            from ..core.reach import plan_reach as plan_fn
        else:
            from ..core.peel import plan_peel as plan_fn
        engine = plan_fn(graph, device=dev, **kwargs)
    else:
        raise ValueError(f"cannot restore unknown engine family "
                         f"{family!r}")
    engine.load_state(tree, em)
    return engine


def restore_engine(ckpt_dir: str, step: int | None = None, *,
                   device="cuda"):
    """Load the latest (or a given) checkpoint and rebuild its engine on
    ``device`` (default the card; ``device="cpu"`` off it).

    Returns ``(engine, step, tree, meta)``: the raw tree and metadata
    ride along, so callers recover what they saved with
    ``save_engine(extra_tree=..., extra_meta=...)``."""
    from ..train import checkpoint as _ckpt

    tree, step, meta = _ckpt.load_flat(ckpt_dir, step)
    if "engine" not in meta:
        raise ValueError(f"checkpoint step {step} in {ckpt_dir!r} has no "
                         "'engine' metadata (not written by save_engine)")
    engine = engine_from_state(tree, meta["engine"], device=device)
    return engine, step, tree, meta


__all__ = ["save_tree", "save_engine", "engine_from_state",
           "restore_engine"]
