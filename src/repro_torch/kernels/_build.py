"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with :mod:`ctypes` — seconds
per build, where ``torch.utils.cpp_extension`` (which includes PyTorch's
headers) takes minutes.  Builds happen at first use, never at import, and
all missing sources compile in parallel (one ``nvcc`` per file, started
together).  Libraries are keyed by a hash of their source, so an edited
kernel is rebuilt and a stale one is never loaded.

The build directory is ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``); ``REPRO_TORCH_BUILD_DIR`` overrides it.

Every kernel launch goes through one funnel, :func:`launch`.  A wrapper
describes the launch as a :class:`Launch` record in plain integers — the
``__global__`` kernel, its grid and block, its dynamic shared memory and
the outputs it writes — and the funnel hands exactly that grid, block and
shared memory to the C entry point, which launches with them on the
stream it is given and returns ``cudaGetLastError()`` (or
``cudaErrorInvalidValue`` where its own guards fail); :func:`check`
raises on a non-zero code.  The static checks (``repro_torch.analysis``)
swap the funnel for a recorder, so the geometry they check is the one
launched.  Each public wrapper counts its own launches in
:data:`LAUNCHES`.  There is no fallback: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

#: elements per tile of the prefix scan (``prefix_positions``): the wrapper
#: sizes its grid with it and ``csrc/frontier_compact.cu`` is compiled with
#: ``-DTILE=`` of it, so the two cannot disagree.  8,192 beat 4,096 and
#: 16,384 on the H100 (``tools/kernel_ab.py --sweep``; PERF.md)
SCAN_TILE = 8192
#: mask bytes per tile of the single-pass compaction (``frontier_compact``),
#: passed as ``-DCOMPACT_TILE=`` in the same way
COMPACT_TILE = 16384
#: ids per row CTA and slots per slot CTA of ``sparse_expand``'s one launch
#: (``expand_lookback``), passed as ``-DEXPAND_ROW_TILE=`` and
#: ``-DEXPAND_SLOT_TILE=``; timed by ``tools/kernel_ab.py --sweep``
EXPAND_ROW_TILE = 256
EXPAND_SLOT_TILE = 1024
#: the scratch word where expand_lookback's row tiles' status words start
#: (the ticket and the total come before them, each on a 128-byte line of
#: its own; the done words follow), passed as ``-DEX_STATUS=``
EXPAND_STATUS_AT = 32
#: per-source preprocessor definitions, part of each library's hash
DEFINES: dict = {}


def _frontier_defines() -> None:
    DEFINES["frontier_compact"] = (
        f"-DTILE={SCAN_TILE}", f"-DCOMPACT_TILE={COMPACT_TILE}",
        f"-DEXPAND_ROW_TILE={EXPAND_ROW_TILE}",
        f"-DEXPAND_SLOT_TILE={EXPAND_SLOT_TILE}",
        f"-DEX_STATUS={EXPAND_STATUS_AT}")


_frontier_defines()

#: kernel launches per public wrapper (a plain int each), counted only where
#: a wrapper actually launches its CUDA kernel — the plain CPU path never
#: counts; ``flash_attention_bwd`` is the one exception, below.
#: Re-exported as ``repro_torch.kernels.ops.LAUNCHES``.
LAUNCHES = {"first_live_scan": 0, "first_live_probe": 0,
            "prefix_positions": 0,
            "frontier_compact": 0, "sparse_expand": 0,
            "frontier_expand": 0, "bucket_peel": 0, "counter_scatter": 0,
            "flash_attention": 0, "segment_sum": 0, "mutant_copy": 0,
            # the one entry that is no kernel: flash_attention's backward
            # in torch ops (kernels.flash_attention.flash_attention_bwd),
            # counted once a backward on the card, so a run can show that
            # training went through it
            "flash_attention_bwd": 0}

#: libraries this process compiled (a one-element list, read and bumped
#: in place): ``EngineBase._dispatch`` tags a dispatch during which it
#: grew ``"build+execute"``
BUILDS = [0]

_LIBS: dict[str, ctypes.CDLL] = {}
#: C entry point name -> (library, its argument types before the geometry)
SIGNATURES: dict[str, tuple] = {}
_ENTRIES: dict[str, object] = {}
#: the geometry every entry point takes last: grid x, y, z, block x, y, z
#: and dynamic shared-memory bytes (``csrc/launch.cuh``)
_GEOMETRY = [ctypes.c_uint] * 7
#: device types a kernel wrapper takes; the static checks' capture adds
#: "meta" while it records launches (nothing is launched then)
ACCEPTED = ("cuda",)


class Launch(NamedTuple):
    """One kernel launch as a wrapper computes it, in plain integers."""

    library: str          # csrc/<library>.cu
    kernel: str           # the __global__ function it launches
    grid: tuple           # (x, y, z) blocks
    block: tuple          # (x, y, z) threads
    smem: int             # dynamic shared-memory bytes
    outputs: dict         # name -> tensor the kernel writes
    scratch: bool = False  # cross-block scratch within the launch


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of repro_torch cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + DEFINES.get(name, ())


def _lib_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(_flags(name)).encode()
                            ).hexdigest()[:12]
    return build_dir() / f"lib{name}.{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns the wall seconds each build
    took (0.0 for a cached library); raises with the compiler's output if
    any build fails.  The compiler's output (``-Xptxas -v``: registers,
    shared memory and spills of every kernel) is kept beside each library
    (:func:`build_log`)."""
    import time

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, t0, took = {}, time.perf_counter(), {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            took[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
        BUILDS[0] += 1
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """The compiler's output of the built ``csrc/<name>.cu``."""
    return _lib_path(name).with_suffix(".log").read_text()


def sass(name: str) -> str:
    """The SASS of the built ``csrc/<name>.cu`` (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every missing
    source first (in parallel) on the first call."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def use_scan_tile(tile: int) -> None:
    """Launch ``prefix_positions`` with ``tile`` elements a scan tile from
    now on: ``frontier_compact.cu`` is built with ``-DTILE=`` of it (a
    library of its own, beside the others) and loaded at its next call.
    For tuning (``tools/kernel_ab.py --sweep``); the static checks'
    declarations keep the tile they were made with."""
    global SCAN_TILE
    SCAN_TILE = tile
    _reload_frontier()


def use_expand_tiles(row_tile: int, slot_tile: int) -> None:
    """Launch ``sparse_expand`` with ``row_tile`` ids a row CTA and
    ``slot_tile`` slots a slot CTA from now on, as :func:`use_scan_tile`
    does for the scan (``row_tile`` divides 2,048 and both are multiples
    of 256)."""
    global EXPAND_ROW_TILE, EXPAND_SLOT_TILE
    EXPAND_ROW_TILE, EXPAND_SLOT_TILE = row_tile, slot_tile
    _reload_frontier()


def _reload_frontier() -> None:
    _frontier_defines()
    _LIBS.pop("frontier_compact", None)
    for entry, (library, _) in SIGNATURES.items():
        if library == "frontier_compact":
            _ENTRIES.pop(entry, None)


def declare(library: str, entries: dict[str, list]) -> None:
    """Register the C entry points of ``csrc/<library>.cu``: name ->
    argument types before the geometry.  Pure Python: nothing is loaded."""
    for name, argtypes in entries.items():
        SIGNATURES[name] = (library, argtypes)


def _entry(name: str, launches: int):
    library, argtypes = SIGNATURES[name]
    fn = getattr(load(library), name)
    fn.argtypes = [*argtypes, *_GEOMETRY * launches]
    fn.restype = ctypes.c_int
    _ENTRIES[name] = fn
    return fn


def launch(spec, entry: str, *args) -> None:
    """Launch ``spec`` through the C entry point ``entry``: it is called
    with ``args``, then the grid, block and shared-memory bytes of
    ``spec``, and raises if the launch fails.  ``spec`` is one
    :class:`Launch`, or a tuple of them for an entry point that launches
    several kernels in order (their geometries follow one another).  The
    only path from a wrapper to the card."""
    if type(spec) is Launch:
        fn = _ENTRIES.get(entry) or _entry(entry, 1)
        code = fn(*args, *spec.grid, *spec.block, spec.smem)
    else:
        fn = _ENTRIES.get(entry) or _entry(entry, len(spec))
        code = fn(*args, *[v for s in spec
                           for v in (*s.grid, *s.block, s.smem)])
        spec = spec[0]
    if code != 0:
        check(_LIBS[spec.library], spec.kernel, code)


#: streaming multiprocessors of the H100 SXM, for launches recorded on
#: meta tensors (the static checks); a CUDA launch reads its device's
META_SMS = 132


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (:data:`META_SMS` for a meta
    tensor's), read once per device."""
    if device.type != "cuda":
        return META_SMS
    import torch
    return _multiprocessors(torch.cuda.current_device() if device.index
                            is None else device.index)


def blocks(work: int, threads: int) -> int:
    """Blocks of ``threads`` that cover ``work`` items (ceil)."""
    return -(-work // threads)


def c_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    if t.device.type != "cuda":     # a meta tensor under capture
        return ctypes.c_void_p(0)
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA
    device (the kernels take nothing else)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type not in ACCEPTED or t.device != dev:
            raise ValueError(f"{name}: the CUDA kernel takes tensors on one "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             "tensors")


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point's ``cudaGetLastError()`` is non-zero."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({code})")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
