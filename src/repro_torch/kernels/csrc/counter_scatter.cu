// counter_scatter: the stream engine's AC-4 support-counter update on Hopper.
//
// Replaces: src/repro/kernels/counter_scatter.py, counter_scatter_pallas
//   (the Pallas _counter_kernel).  Same contract:
//     new[v]  = counters[v] + sum over b of delta[b] * [src[b] == v]
//     dead[v] = status[v] & (new[v] <= 0)
//   with int32 counters, bool status, int32 src and delta.  Out-of-range
//   sources (negative, or >= n such as the padding sentinel n) and zero
//   deltas add nothing.  The inputs are not modified.
//
// Bound on the H100: bytes.  Each vertex reads a 4-byte counter and a
//   status byte and writes a 4-byte counter and a dead byte; each update
//   reads 8 bytes: (4 + 1 + 4 + 1) n + 8 B.  At n = 4,194,304 and
//   B = 65,536 that is 42.5 MB, 12.7 us at 3.35 TB/s.
//
// Design: the TPU has no scatter-add, so the Pallas kernel builds a
//   (block_u x block_v) membership matrix per grid cell and skips vertex
//   blocks that no update touches.  Hopper has int32 atomics, so:
//   1. out <- counters, one device-to-device copy on the stream (the
//      wrapper clones instead when the batch is empty);
//   2. one thread per update: atomicAdd(&out[src], delta) when the source
//      is in range and the delta is non-zero.  Int32 addition is exact and
//      does not depend on order, so the result is bit-identical to the
//      plain version's whatever order the atomics land in;
//   3. the death pass, a second launch on the same stream so that it reads
//      the final counters: 4 vertices a thread, one 16-byte load of out,
//      one 4-byte load of status, one 4-byte store of dead (the wrapper
//      checks the alignment; unaligned pointers take a scalar kernel).  A
//      quad with no live vertex stores zeros without loading its counters.
//      The n % 4 tail goes to one extra thread, which the wrapper's grid
//      holds only when there is a tail.
//   Many updates on one source (an RMAT hub) serialise their atomics on
//   one address; aggregating them within a warp first is later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void scatter_updates(const int32_t* __restrict__ src,
                                const int32_t* __restrict__ delta,
                                int32_t* __restrict__ out, int64_t b,
                                int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int32_t s = __ldg(src + i);
  const int32_t d = __ldg(delta + i);
  if (d != 0 && s >= 0 && (int64_t)s < n) atomicAdd(out + s, d);
}

__device__ __forceinline__ uint32_t lane_dead(uint32_t live, int j,
                                              int32_t c) {
  // bool bytes are 0 or 1, so byte j is set iff vertex j of the quad lives
  return (((live >> (8 * j)) & 0xffu) != 0u && c <= 0) ? (1u << (8 * j))
                                                       : 0u;
}

__global__ void deaths_vec4(const int4* __restrict__ out4,
                            const uint32_t* __restrict__ status4,
                            uint32_t* __restrict__ dead4,
                            const int32_t* __restrict__ out,
                            const uint8_t* __restrict__ status,
                            uint8_t* __restrict__ dead, int64_t quads,
                            int64_t n) {
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q > quads) return;
  if (q == quads) {  // the ragged tail, n % 4 vertices
    for (int64_t i = quads * 4; i < n; ++i)
      dead[i] = (status[i] != 0 && out[i] <= 0) ? 1 : 0;
    return;
  }
  const uint32_t live = __ldg(status4 + q);
  if (live == 0u) {
    dead4[q] = 0u;
    return;
  }
  const int4 c = __ldg(out4 + q);
  dead4[q] = lane_dead(live, 0, c.x) | lane_dead(live, 1, c.y) |
             lane_dead(live, 2, c.z) | lane_dead(live, 3, c.w);
}

__global__ void deaths_scalar(const int32_t* __restrict__ out,
                              const uint8_t* __restrict__ status,
                              uint8_t* __restrict__ dead, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dead[i] = (status[i] != 0 && out[i] <= 0) ? 1 : 0;
}

}  // namespace

extern "C" {

// counters, out: (n,) int32; src, delta: (b,) int32, b >= 1.  Copies the
// counters into out, then one thread per update adds its delta.
int scatter_updates_launch(const void* counters, const void* src,
                           const void* delta, void* out, int64_t n, int64_t b,
                           void* stream, REPRO_GEOMETRY) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, counters, n * sizeof(int32_t),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_updates<<<REPRO_GRID, REPRO_BLOCK, smem, s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(delta),
      static_cast<int32_t*>(out), b, n);
  return repro_last_error();
}

// out: (n,) int32, 16-byte aligned; status, dead: (n,) uint8
// (torch.bool), 4-byte aligned.  One thread per quad of vertices, plus one
// for the n % 4 tail when there is one.
int deaths_vec4_launch(const void* out, const void* status, void* dead,
                       int64_t n, void* stream, REPRO_GEOMETRY) {
  deaths_vec4<<<REPRO_GRID, REPRO_BLOCK, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(out), static_cast<const uint32_t*>(status),
      static_cast<uint32_t*>(dead), static_cast<const int32_t*>(out),
      static_cast<const uint8_t*>(status), static_cast<uint8_t*>(dead),
      n / 4, n);
  return repro_last_error();
}

// The same without alignment: one thread per vertex.
int deaths_scalar_launch(const void* out, const void* status, void* dead,
                         int64_t n, void* stream, REPRO_GEOMETRY) {
  deaths_scalar<<<REPRO_GRID, REPRO_BLOCK, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(out), static_cast<const uint8_t*>(status),
      static_cast<uint8_t*>(dead), n);
  return repro_last_error();
}

}  // extern "C"
