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

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.  Each
public wrapper counts its own launches in :data:`LAUNCHES`.  There is no
fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: kernel launches per public wrapper (a plain int each), counted only where
#: a wrapper actually launches its CUDA kernel — the plain CPU path never
#: counts.  Re-exported as ``repro_torch.kernels.ops.LAUNCHES``.
LAUNCHES = {"first_live_scan": 0, "prefix_positions": 0,
            "frontier_compact": 0, "sparse_expand": 0,
            "frontier_expand": 0, "bucket_peel": 0, "counter_scatter": 0,
            "flash_attention": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


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


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}.{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns the wall seconds each build
    took (0.0 for a cached library); raises with the compiler's output if
    any build fails."""
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
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
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
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


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


def c_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA
    device (the kernels take nothing else)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
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
