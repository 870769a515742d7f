// first_live_scan: the windowed AC-3/AC-6 probe's masked row scan on Hopper.
//
// Replaces: src/repro/kernels/first_live_scan.py, first_live_scan
//   (the Pallas _scan_kernel).  Same contract: for each row i of the
//   (n, W) bool tiles, first[i] = least j with flags[i,j] & valid[i,j]
//   (W when none), found[i] = active[i] & first[i] < W; an inactive row
//   gives (W, false).
//
// Bound on the H100: bytes.  Per active row it reads 2W flag bytes, per
//   row one active byte, and writes 4 + 1 bytes; there is next to no
//   arithmetic.  At n = 4M, W = 16 that is ~155 MB, ~46 us at 3.35 TB/s.
//
// Design: one thread per row.  For W = 16 (the engine's window) the row's
//   flags and valid bytes are one 16-byte load each (the wrapper checks
//   alignment), neighbouring threads read neighbouring 16-byte chunks, so
//   a warp reads 512 contiguous bytes per tile.  The AND of the two
//   vectors is taken bytewise on 32-bit words (bools are 0/1 bytes) and
//   the first set byte is found with __ffs.  An inactive row returns
//   before touching its tiles: that is the GPU form of the TPU kernel's
//   block skip, at row granularity.  Other W take a byte loop.
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

}  // extern "C"
