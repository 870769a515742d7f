// first_live_scan: the windowed AC-3/AC-6 probe's masked row scan on Hopper,
// and first_live_probe, the same probe with its liveness gather inside.
//
// Replaces: src/repro/kernels/first_live_scan.py, first_live_scan
//   (the Pallas _scan_kernel), and with first_live_probe also the XLA
//   gather that feeds it (src/repro/core/common.py:204-209).
//
// first_live_scan keeps the Pallas kernel's contract: for each row i of
//   the (n, W) bool tiles, first[i] = least j with flags[i,j] & valid[i,j]
//   (W when none), found[i] = active[i] & first[i] < W; an inactive row
//   gives (W, false).
//   Bound on the H100: bytes.  Per active row it reads 2W flag bytes, per
//   row one active byte, and writes 4 + 1 bytes; there is next to no
//   arithmetic.  At n = 4M, W = 16 that is ~155 MB, ~46 us at 3.35 TB/s.
//   Design: one thread per row.  For W = 16 (the engine's window) the
//   row's flags and valid bytes are one 16-byte load each (the wrapper
//   checks alignment), neighbouring threads read neighbouring 16-byte
//   chunks, so a warp reads 512 contiguous bytes per tile.  The AND of
//   the two vectors is taken bytewise on 32-bit words (bools are 0/1
//   bytes) and the first set byte is found with __ffs.  An inactive row
//   returns before touching its tiles: that is the GPU form of the TPU
//   kernel's block skip, at row granularity.  Other W take a byte loop.
//
// first_live_probe computes the same (first, found) straight from the
//   graph, so no (n, W) tile exists: for a scanning row i with deg =
//   indptr[i+1] - indptr[i] and s = min(start[i], deg), first[i] is the
//   least j < W with s + j < deg and status[indices[a]], a = indptr[i] +
//   s + j clamped to [0, m - 1] (the plain version's clamp; with m = 0 no
//   index is read), else W.  Pallas on the TPU has no dynamic gather, so
//   the reference builds the tile in XLA; a Hopper kernel may gather.
//   Bound on the H100: bytes, counted by 32-byte sectors: every row's
//   scanning byte and its 5 output bytes; for each scanning row the
//   sectors of start and indptr it touches and the 2-3 sectors its window
//   of indices spans (only positions below deg are read); each status
//   sector touched, once (a 4 MB array at n = 4M: its gathers hit L2).
//   On Gᵀ of RMAT scale 22, W = 16, 25% scanning, half the vertices live,
//   that is ~66 MB, ~0.020 ms (chip_smoke.py's count).
//   Design: a thread per row.  It reads the row's scanning byte and
//   returns (W, false) if the row does not scan, touching nothing else;
//   otherwise its start and indptr words, then the window two positions a
//   step: both indices, then both targets' status bytes, so a row whose
//   first live target is its second position waits on one chain of
//   dependent loads, not two.  A half-warp per scanning row (lane j
//   loading window position j, a ballot and __ffs giving the least live
//   j) was timed against it and lost: 0.066-0.069 device ms to the walk's
//   0.038-0.040 on the H100 at n = 4M, W = 16, 25% scanning, since a
//   warp's pairs of rows run one after another, each a chain of dependent
//   loads, while the walk keeps a row's short chain in every thread
//   (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ int first_set_byte(uint32_t w) {
  // bytes are 0 or 1, so bit 8k is set iff byte k is non-zero
  return (__ffs(w) - 1) >> 3;
}

__global__ void first_live_w16(const uint4* __restrict__ flags,
                               const uint4* __restrict__ valid,
                               const uint8_t* __restrict__ active,
                               int32_t* __restrict__ first,
                               uint8_t* __restrict__ found, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!active[i]) {
    first[i] = 16;
    found[i] = 0;
    return;
  }
  uint4 f = __ldg(flags + i);
  uint4 v = __ldg(valid + i);
  uint32_t w[4] = {f.x & v.x, f.y & v.y, f.z & v.z, f.w & v.w};
  int out = 16;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (w[k]) out = 4 * k + first_set_byte(w[k]);
  first[i] = out;
  found[i] = out < 16;
}

__global__ void first_live_any(const uint8_t* __restrict__ flags,
                               const uint8_t* __restrict__ valid,
                               const uint8_t* __restrict__ active,
                               int32_t* __restrict__ first,
                               uint8_t* __restrict__ found, int64_t n,
                               int window) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int out = window;
  if (active[i]) {
    const uint8_t* fr = flags + i * window;
    const uint8_t* vr = valid + i * window;
    for (int j = 0; j < window; ++j)
      if (fr[j] & vr[j]) {
        out = j;
        break;
      }
  }
  first[i] = out;
  found[i] = out < window;
}

// A thread per row: walk the window two positions a step (both indices,
// then both targets, so a row whose first live target is not its first
// position waits on one load chain less) and stop at the first live one.
__global__ void first_live_probe(const uint8_t* __restrict__ status,
                                 const int32_t* __restrict__ indptr,
                                 const int32_t* __restrict__ indices,
                                 const int32_t* __restrict__ start,
                                 const uint8_t* __restrict__ scanning,
                                 int32_t* __restrict__ first,
                                 uint8_t* __restrict__ found, int64_t n,
                                 int64_t m, int window) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int out = window;
  if (scanning[i] && m > 0) {
    const int64_t rb = indptr[i];
    const int64_t deg = indptr[i + 1] - rb;
    const int64_t s = min(static_cast<int64_t>(start[i]), deg);
    for (int j = 0; j < window && s + j < deg; j += 2) {
      const bool two = j + 1 < window && s + j + 1 < deg;
      int64_t a = rb + s + j, b = a + 1;
      a = a < 0 ? 0 : (a > m - 1 ? m - 1 : a);
      b = b < 0 ? 0 : (b > m - 1 ? m - 1 : b);
      const int32_t ta = indices[a];
      const int32_t tb = two ? indices[b] : ta;
      const bool la = status[ta] != 0;
      const bool lb = two && status[tb] != 0;
      if (la || lb) {
        out = la ? j : j + 1;
        break;
      }
    }
  }
  first[i] = out;
  found[i] = out < window;
}

}  // namespace

extern "C" {

// flags, valid: (n, 16) uint8 (torch.bool), row-major, contiguous, 16-byte
// aligned.  One thread per row.
int first_live_w16_launch(const void* flags, const void* valid,
                          const void* active, void* first, void* found,
                          int64_t n, void* stream, REPRO_GEOMETRY) {
  first_live_w16<<<REPRO_GRID, REPRO_BLOCK, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(flags), static_cast<const uint4*>(valid),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(first),
      static_cast<uint8_t*>(found), n);
  return repro_last_error();
}

// flags, valid: (n, window) uint8 (torch.bool), row-major, contiguous.
int first_live_any_launch(const void* flags, const void* valid,
                          const void* active, void* first, void* found,
                          int64_t n, int window, void* stream,
                          REPRO_GEOMETRY) {
  first_live_any<<<REPRO_GRID, REPRO_BLOCK, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(first),
      static_cast<uint8_t*>(found), n, window);
  return repro_last_error();
}

// status, scanning: (n,) uint8 (torch.bool); indptr: (n + 1,) int32;
// indices: (m,) int32; start: (n,) int32; first: (n,) int32 and found:
// (n,) bool out; window >= 1.  One thread per row.
int first_live_probe_launch(const void* status, const void* indptr,
                            const void* indices, const void* start,
                            const void* scanning, void* first, void* found,
                            int64_t n, int64_t m, int window, void* stream,
                            REPRO_GEOMETRY) {
  if (window < 1) return repro_invalid();
  first_live_probe<<<REPRO_GRID, REPRO_BLOCK, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(status), static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(indices), static_cast<const int32_t*>(start),
      static_cast<const uint8_t*>(scanning), static_cast<int32_t*>(first),
      static_cast<uint8_t*>(found), n, m, window);
  return repro_last_error();
}

}  // extern "C"
