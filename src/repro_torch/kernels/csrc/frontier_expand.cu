// frontier_expand: one pull round of the windowed reachability sweep on
// Hopper.
//
// Replaces: src/repro/kernels/frontier_expand.py, frontier_expand (the
//   Pallas _expand_kernel).  Same contract: for each row i of the (n, W)
//   bool tiles, hit[i] = pending[i] & OR_j(flags[i,j] & valid[i,j]).  The
//   frontier-membership gather that builds `flags` stays outside the
//   kernel (core/reach.py), so the kernel and the Pallas kernel take the
//   same operands.
//
// Bound on the H100: bytes.  Per pending row it reads 2W tile bytes, per
//   row one pending byte, and writes one hit byte; there is one OR per
//   byte.  At n = 4,194,304, W = 16 with every row pending that is
//   142.6 MB, 42.6 us at 3.35 TB/s; at 25% pending 41.9 MB, 12.5 us.
//
// Design: one thread per row.  A row that is not pending writes false and
//   returns before it loads its tiles: that is the GPU form of the TPU
//   kernel's block skip, at row granularity, and it is what makes late
//   sweep rounds (most vertices visited) cheap.  When W is a multiple of
//   16 and both tiles are 16-byte aligned (the wrapper checks), a row's
//   flags and valid bytes are W/16 16-byte loads each; at the engine's
//   W = 16 neighbouring threads read neighbouring 16-byte chunks, so a
//   warp reads 512 contiguous bytes per tile.  Bools are 0/1 bytes, so the
//   OR-reduction is the bitwise AND of the two vectors tested against 0.
//   Any other W takes a plain byte loop that stops at the first hit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void frontier_expand_vec16(const uint4* __restrict__ flags,
                                      const uint4* __restrict__ valid,
                                      const uint8_t* __restrict__ pending,
                                      uint8_t* __restrict__ hit, int64_t n,
                                      int chunks) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!pending[i]) {
    hit[i] = 0;
    return;
  }
  const uint4* fr = flags + i * chunks;
  const uint4* vr = valid + i * chunks;
  uint32_t any = 0;
  for (int c = 0; c < chunks; ++c) {
    uint4 f = __ldg(fr + c);
    uint4 v = __ldg(vr + c);
    any |= (f.x & v.x) | (f.y & v.y) | (f.z & v.z) | (f.w & v.w);
  }
  hit[i] = any != 0;
}

__global__ void frontier_expand_any(const uint8_t* __restrict__ flags,
                                    const uint8_t* __restrict__ valid,
                                    const uint8_t* __restrict__ pending,
                                    uint8_t* __restrict__ hit, int64_t n,
                                    int window) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t out = 0;
  if (pending[i]) {
    const uint8_t* fr = flags + i * window;
    const uint8_t* vr = valid + i * window;
    for (int j = 0; j < window; ++j)
      if (fr[j] & vr[j]) {
        out = 1;
        break;
      }
  }
  hit[i] = out;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// flags, valid: (n, window) uint8 (torch.bool), row-major, contiguous.
// vec16 != 0 promises window % 16 == 0 and 16-byte aligned flags/valid.
int frontier_expand_launch(const void* flags, const void* valid,
                           const void* pending, void* hit, int64_t n,
                           int window, int vec16, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16) {
    frontier_expand_vec16<<<blocks, threads, 0, s>>>(
        static_cast<const uint4*>(flags), static_cast<const uint4*>(valid),
        static_cast<const uint8_t*>(pending), static_cast<uint8_t*>(hit), n,
        window / 16);
  } else {
    frontier_expand_any<<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(flags), static_cast<const uint8_t*>(valid),
        static_cast<const uint8_t*>(pending), static_cast<uint8_t*>(hit), n,
        window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
