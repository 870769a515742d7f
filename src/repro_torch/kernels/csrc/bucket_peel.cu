// bucket_peel: one round's bucket extraction of the k-core peel on Hopper.
//
// Replaces: src/repro/kernels/bucket_peel.py, bucket_peel_pallas (the
//   Pallas _bucket_kernel).  Same contract: frontier[v] = alive[v] &
//   (counters[v] <= k), with counters signed int32 (they may be negative)
//   and k the current bucket level.
//
// Bound on the H100: bytes.  It reads 4 counter bytes and 1 alive byte and
//   writes 1 frontier byte per vertex, with one compare: at n = 4,194,304
//   that is 25.2 MB, 7.5 us at 3.35 TB/s.
//
// Design: k advances on the device inside the peel's round loop, so the
//   kernel reads it through a pointer to a 1-element int32 tensor (no
//   host value, no sync to learn it).  Each thread takes 4 vertices: one
//   16-byte load of counters, one 4-byte load of alive, one 4-byte store
//   (the wrapper checks the alignment; unaligned inputs take a scalar
//   kernel).  A quad with no alive vertex stores zeros and never loads its
//   counters: the GPU form of the TPU kernel's block skip, which is what
//   makes late peel rounds (most vertices assigned) cheap.  The n % 4 tail
//   goes to one extra thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t lane_hit(uint32_t alive, int j,
                                             int32_t c, int32_t k) {
  // bool bytes are 0 or 1, so byte j is set iff vertex j of the quad is
  // alive
  return (((alive >> (8 * j)) & 0xffu) != 0u && c <= k) ? (1u << (8 * j))
                                                        : 0u;
}

__global__ void bucket_peel_vec4(const int4* __restrict__ counters4,
                                 const uint32_t* __restrict__ alive4,
                                 const int32_t* __restrict__ k,
                                 uint32_t* __restrict__ out4,
                                 const int32_t* __restrict__ counters,
                                 const uint8_t* __restrict__ alive,
                                 uint8_t* __restrict__ out, int64_t quads,
                                 int64_t n) {
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q > quads) return;
  const int32_t kk = __ldg(k);
  if (q == quads) {  // the ragged tail, n % 4 vertices
    for (int64_t i = quads * 4; i < n; ++i)
      out[i] = (alive[i] != 0 && counters[i] <= kk) ? 1 : 0;
    return;
  }
  const uint32_t a = __ldg(alive4 + q);
  if (a == 0u) {
    out4[q] = 0u;
    return;
  }
  const int4 c = __ldg(counters4 + q);
  out4[q] = lane_hit(a, 0, c.x, kk) | lane_hit(a, 1, c.y, kk) |
            lane_hit(a, 2, c.z, kk) | lane_hit(a, 3, c.w, kk);
}

__global__ void bucket_peel_scalar(const int32_t* __restrict__ counters,
                                   const uint8_t* __restrict__ alive,
                                   const int32_t* __restrict__ k,
                                   uint8_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (alive[i] != 0 && counters[i] <= __ldg(k)) ? 1 : 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counters: (n,) int32; alive, out: (n,) uint8 (torch.bool); k: 1 int32
// on the device.  vec4 != 0 promises counters 16-byte aligned and alive,
// out 4-byte aligned.
int bucket_peel_launch(const void* counters, const void* alive, const void* k,
                       void* out, int64_t n, int vec4, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int64_t quads = n / 4;
    const int64_t work = quads + 1;  // + the tail thread
    const unsigned blocks =
        static_cast<unsigned>((work + threads - 1) / threads);
    bucket_peel_vec4<<<blocks, threads, 0, s>>>(
        static_cast<const int4*>(counters),
        static_cast<const uint32_t*>(alive), static_cast<const int32_t*>(k),
        static_cast<uint32_t*>(out), static_cast<const int32_t*>(counters),
        static_cast<const uint8_t*>(alive), static_cast<uint8_t*>(out), quads,
        n);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    bucket_peel_scalar<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(counters),
        static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(k),
        static_cast<uint8_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
