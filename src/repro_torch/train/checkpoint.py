"""Checkpoints on disk (PyTorch port of ``src/repro/train/checkpoint.py``).

Layout, the reference's: ``<dir>/step_<N:08d>/`` holds one ``.npy`` per
leaf of the saved tree plus a ``manifest.json`` (leaf names, shapes,
dtypes, step, user metadata), written into ``step_<N>.tmp`` and renamed,
so a torn write never shadows the previous good step.  A checkpoint that
either package writes, the other reads.

Trees are nested dicts (keys in sorted order), lists, tuples and
NamedTuples (``AdamWState``) of tensors or numpy arrays; a leaf's name is
its path joined by ``/``, a NamedTuple field written ``.field``, as the
reference's ``tree_flatten_with_path`` renders it (``params/0``,
``opt/.count``, ``opt/.mu/3``).  ``None`` is an empty subtree.  A dtype
that numpy cannot hold (``bfloat16``) raises: it is never cast quietly.

:func:`restore` puts the leaves on an explicit ``device`` (the default
is the card), or, with ``shardings=`` (the reference's
reshard-on-restore), places each leaf on a ``DeviceMesh`` as a DTensor;
:func:`load_flat` returns numpy arrays, as the reference's does.
:class:`AsyncCheckpointer` moves the disk writes to a background thread;
its ``save`` takes a real host copy inline, so the caller may mutate its
tensors (CPU ones included) as soon as ``save`` returns.
"""
from __future__ import annotations

import atexit
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(tree, fn, prefix=()):
    """``tree``'s structure with each leaf replaced by ``fn(name, leaf)``,
    called in the reference's flattening order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, prefix + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn,
                                     prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def leaves(tree) -> list:
    """``(name, leaf)`` pairs of ``tree`` in the reference's flattening
    order and naming."""
    out = []
    _rebuild(tree, lambda name, leaf: out.append((name, leaf)))
    return out


def _host_array(x, *, copy: bool = False) -> np.ndarray:
    """``x`` as a numpy array on the host.  ``copy=True`` guarantees the
    result shares no memory with ``x`` (a CPU tensor's ``numpy()`` is a
    view).  Raises for dtypes numpy cannot hold."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        host = t.cpu()
        if copy and t.device.type == "cpu":
            host = host.clone()
        try:
            return host.numpy()
        except TypeError as e:          # bfloat16, the float8 types, ...
            raise TypeError(
                f"a {t.dtype} tensor cannot be written to a .npy "
                "checkpoint; cast it to a dtype numpy holds (float32) "
                "before saving") from e
    arr = np.asarray(x)
    return arr.copy() if copy else arr


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None):
    """Write a checkpoint; returns its path.  Atomic by a tmp-dir
    rename."""
    path = _step_dir(ckpt_dir, step)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for name, leaf in leaves(tree):
        arr = _host_array(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete step in ``ckpt_dir`` (a ``.tmp`` is not one),
    or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _manifest(ckpt_dir: str, step: int | None):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def _is_placed(x) -> bool:
    """A ``(DeviceMesh, placements)`` pair: a leaf of ``shardings``."""
    from torch.distributed.device_mesh import DeviceMesh
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], DeviceMesh))


def _placed_leaves(tree, prefix=()) -> dict:
    """``{name: (mesh, placements)}`` of a ``shardings`` tree, named as
    :func:`leaves` names ``like``'s leaves (None: not placed)."""
    if tree is None:
        return {}
    if _is_placed(tree):
        return {"/".join(prefix): tree}
    out: dict = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_placed_leaves(tree[k], prefix + (str(k),)))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            out.update(_placed_leaves(getattr(tree, f), prefix + (f".{f}",)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_placed_leaves(v, prefix + (str(i),)))
    else:
        raise TypeError(f"shardings leaf {'/'.join(prefix)!r} is {tree!r}, "
                        f"not a (DeviceMesh, placements) pair or None")
    return out


def restore(ckpt_dir: str, like, step: int | None = None, *,
            device="cuda", shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays; only its structure, names and shapes are read).  Every leaf
    becomes a tensor on ``device``.  Returns ``(tree, step, metadata)``.
    A leaf missing from the checkpoint, or of another shape than
    ``like``'s, raises.

    ``shardings``: a tree matching ``like`` whose leaves are
    ``(DeviceMesh, placements)`` pairs (or None): each such leaf is
    loaded onto the mesh's device type and placed as a DTensor
    (``models.sharding.local_block``; every rank reads the whole leaf and
    keeps its block), the reference's reshard-on-restore."""
    path, manifest = _manifest(ckpt_dir, step)
    leaves = manifest["leaves"]
    placed = _placed_leaves(shardings)

    def load(name, leaf):
        if name not in leaves:
            raise KeyError(f"checkpoint step {manifest['step']} in "
                           f"{ckpt_dir!r} has no leaf {name!r}")
        info = leaves[name]
        want = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if tuple(info["shape"]) != want:
            raise ValueError(f"checkpoint leaf {name!r} has shape "
                             f"{tuple(info['shape'])}, expected {want}")
        arr = np.load(os.path.join(path, info["file"]))
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if name in placed:
            from ..models.sharding import local_block
            mesh, plc = placed[name]
            return local_block(t.to(mesh.device_type), mesh, plc)
        return t.to(device)

    return _rebuild(like, load), manifest["step"], manifest["metadata"]


def load_flat(ckpt_dir: str, step: int | None = None):
    """Every leaf the checkpoint recorded, as a flat ``{name: np.ndarray}``
    dict (the manifest is the schema; the engines' ``load_state`` reads
    this form).  Returns ``(tree, step, metadata)``."""
    path, manifest = _manifest(ckpt_dir, step)
    tree = {name: np.load(os.path.join(path, info["file"]))
            for name, info in manifest["leaves"].items()}
    return tree, manifest["step"], manifest["metadata"]


def prune(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` steps."""
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (host copy inline, IO async).

    Construction registers an ``atexit`` hook that flushes the queue and
    joins the thread, so exit never drops a queued write.  ``close()`` is
    idempotent, and a write error surfaces once (``wait()`` or
    ``close()``) and is then cleared."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: Exception | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        atexit.register(self.close)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, metadata = item
            try:
                save(self.ckpt_dir, step, host_tree, metadata)
                prune(self.ckpt_dir, self.keep)
            except Exception as e:      # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree, metadata: dict | None = None):
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        # a real host copy now: the caller may update its tensors in place
        # (a CPU tensor's numpy() would share their memory)
        host_tree = _rebuild(tree, lambda _, x: _host_array(x, copy=True))
        self._q.put((step, host_tree, metadata))

    def _raise_pending(self):
        if self._err:
            err, self._err = self._err, None
            raise err

    def wait(self):
        """Block until every queued write is on disk; surface (and clear)
        the first write error."""
        self._q.join()
        self._raise_pending()

    def close(self):
        """Flush the queued writes and join the writer thread."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        self._q.put(None)               # after the queued items: drains all
        self._q.join()
        self._thread.join()
        self._raise_pending()


__all__ = ["save", "latest_step", "restore", "load_flat", "prune",
           "AsyncCheckpointer", "leaves"]
