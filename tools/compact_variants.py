#!/usr/bin/env python3
"""Time the design alternatives of two Hopper kernels on one card, at the
main paths' real shapes, against the kernels the port ships.

    python3 tools/compact_variants.py

1. ``frontier_compact``'s sentinel fill (slots [count, capacity) get n),
   at n = 4,194,304 and capacity 65,536 (the RMAT scale-22 ``auto`` cap),
   with 65,529, 1,024 and 0 members:
   - ``fill CTAs`` (shipped): the fill CTAs after the last tile fill the
     range grid-stride (``kernels/frontier_compact.py``);
   - ``last CTA``: the same kernel launched with no fill CTAs, so the last
     tile's CTA fills the whole range alone;
   - ``second launch``: ``csrc/frontier_compact.cu`` built here with that
     fill taken out, then a small kernel that fills [count, capacity) from
     the device count, both launched in turn;
   - ``release/acquire``: the shipped kernel built here with its status
     words published by ``st.release.gpu`` and read by ``ld.acquire.gpu``
     in place of the relaxed accesses.
2. ``mutant_copy`` at n = 4,194,304: the shipped carry-free kernel (a
   Hopper 1-D bulk copy, ``cp.async.bulk`` global -> shared -> global, 16
   KB a block) against the vector copy (the carry kernel, 16-byte vectors
   4 a thread, with a zero carry word) and ``x.clone()``; warm (x in L2
   from the call before) and cold (L2 flushed before each call).

Every variant is held bit for bit against the plain version first.
Times are device times from the profiler (``chip_smoke.device_ms``,
``cold_device_ms``) and CUDA events over back-to-back calls
(``chip_smoke.time_ms``, host time included).  The variants' sources are
built into ``build/variants/``.  The last line is one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

N = 4_194_304
CAP = 65_536

# the fill of a second launch
EXTRA_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void fill_from_count(int32_t* ids, const int32_t* count,
                                int64_t capacity, int64_t n) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < capacity && s >= count[0]) ids[s] = (int32_t)n;
}

extern "C" int fill_from_count_launch(void* ids, const void* count,
                                      int64_t capacity, int64_t n,
                                      void* stream) {
  fill_from_count<<<(unsigned)((capacity + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>((int32_t*)ids,
                                            (const int32_t*)count, capacity,
                                            n);
  return (int)cudaGetLastError();
}

"""

# the shipped kernel's fill by the last tile's CTA, taken out for the
# second-launch variant (a grid of exactly `tiles` CTAs fills nothing)
LAST_CTA_FILL = """  if (t == tiles - 1 && gridDim.x == tiles)  // no fill CTAs: this one fills
    fill_sentinels(ids, excl + agg, capacity, n, threadIdx.x, LB_THREADS);
"""


# the shipped status-word accesses, and their release/acquire variant
RELAXED = {'asm volatile("st.relaxed.gpu.u64 [%0], %1;"':
           'asm volatile("st.release.gpu.u64 [%0], %1;"',
           'asm volatile("ld.relaxed.gpu.u64 %0, [%1];"':
           'asm volatile("ld.acquire.gpu.u64 %0, [%1];"'}


def build_variants(out: Path):
    """The no-fill and the release/acquire frontier_compact libraries and
    the fill kernel's."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "frontier_compact.cu").read_text()
    if LAST_CTA_FILL not in src or any(k not in src for k in RELAXED):
        raise SystemExit("compact_variants: csrc/frontier_compact.cu does "
                         "not hold the lines this tool replaces")
    ordered = src
    for relaxed, strict in RELAXED.items():
        ordered = ordered.replace(relaxed, strict)
    sources = {"frontier_compact_nofill": src.replace(LAST_CTA_FILL, ""),
               "frontier_compact_ordered": ordered, "extra": EXTRA_CU}
    flags = [*_build._flags("frontier_compact"), "-I", str(_build.CSRC)]
    procs = []
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), *flags, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{log}")
    return [ctypes.CDLL(str(out / f"lib{name}.so")) for name in sources]


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import frontier_compact as fc
    from repro_torch.kernels import mutant_copy as mc
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("compact_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all()
    nofill, ordered, extra = build_variants(ROOT / "build" / "variants")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for lib in (nofill, ordered):
        lib.compact_lookback_launch.argtypes = [
            vp, ctypes.c_int, i64, i64, i64, vp, ctypes.c_uint, vp, vp, vp,
            *[ctypes.c_uint] * 7]
    extra.fill_from_count_launch.argtypes = [vp, vp, i64, i64, vp]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    tiles = _build.blocks(N, _build.COMPACT_TILE)

    def ok(code):
        if code != 0:
            raise SystemExit(f"launch failed: {code}")

    def last_cta(mask):
        ids = torch.empty((CAP,), dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        stream = _build.stream_of(mask)
        scratch, epoch = fc.lookback_scratch(mask.device, stream, tiles)
        spec = _build.Launch("frontier_compact", "compact_lookback",
                             (tiles, 1, 1), (fc.THREADS, 1, 1), 0,
                             {"ids": ids, "count": count}, scratch=True)
        _build.launch(spec, "compact_lookback_launch", _build.c_ptr(mask), 1,
                      N, CAP, tiles, _build.c_ptr(scratch), epoch,
                      _build.c_ptr(ids), _build.c_ptr(count), stream)
        return ids, count

    def built(lib, mask, grid):
        ids = torch.empty((CAP,), dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        stream = _build.stream_of(mask)
        scratch, epoch = fc.lookback_scratch(mask.device, stream, tiles)
        ok(lib.compact_lookback_launch(
            _build.c_ptr(mask), 1, N, CAP, tiles, _build.c_ptr(scratch),
            epoch, _build.c_ptr(ids), _build.c_ptr(count), stream,
            grid, 1, 1, fc.THREADS, 1, 1, 0))
        return ids, count, stream

    def second_launch(mask):
        ids, count, stream = built(nofill, mask, tiles)
        ok(extra.fill_from_count_launch(_build.c_ptr(ids),
                                        _build.c_ptr(count), CAP, N, stream))
        return ids, count

    fill = max(_build.blocks(CAP, fc.FILL_SLOTS) - 1, 0)
    variants = {"fill CTAs": lambda m: fc.frontier_compact(m, CAP),
                "last CTA": last_cta, "second launch": second_launch,
                "release/acquire": lambda m: built(ordered, m,
                                                   tiles + fill)[:2]}
    result = {"card": smi, "frontier_compact": {}, "mutant_copy": {}}
    for members in (CAP - 7, 1024, 0):
        mask = torch.zeros(N, dtype=torch.bool, device=dev)
        mask[torch.as_tensor(rng.choice(N, members, replace=False),
                             device=dev)] = True
        want = ref.frontier_compact_ref(mask, CAP)
        row = {}
        for name, fn in variants.items():
            cs.check(cs.max_abs_err(fn(mask), want) == 0,
                     f"frontier_compact {name}, {members} members")
            row[name] = {"device_ms": cs.device_ms(lambda: fn(mask)),
                         "ms": cs.time_ms(lambda: fn(mask))}
        row["torch.nonzero"] = {
            "device_ms": cs.device_ms(lambda: torch.nonzero(mask))}
        result["frontier_compact"][members] = row
        print(f"frontier_compact, {members} members of {CAP}: "
              + "; ".join(f"{k} device_ms={v['device_ms']:.4f}"
                          + (f" ms={v['ms']:.4f}" if "ms" in v else "")
                          for k, v in row.items()), flush=True)

    x = torch.randint(-2**31, 2**31 - 1, (N,), device=dev, dtype=torch.int32)

    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    copies = {"bulk (shipped)": lambda: mc.mutant_copy(x),
              "vectors": lambda: mc.mutant_copy(x, zero),
              "x.clone()": x.clone}
    for name, fn in copies.items():
        cs.check(torch.equal(fn(), x), f"mutant_copy {name}")
        result["mutant_copy"][name] = {
            "device_ms": cs.device_ms(fn), "cold_device_ms":
            cs.cold_device_ms(fn), "ms": cs.time_ms(fn)}
        print(f"copy n={N:,} {name}: " + " ".join(
            f"{k}={v:.4f}" for k, v in result["mutant_copy"][name].items()),
            flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
