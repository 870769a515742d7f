// segment_sum: GNN message aggregation on Hopper.
//
// Replaces: src/repro/kernels/segment_reduce.py, segment_sum_pallas (the
//   Pallas _segsum_kernel).  Same contract:
//     out = zeros(num_segments, d) in float32;
//     out[ids[e], :] += float(vals[e, :])  for every e with
//                                          0 <= ids[e] < num_segments.
//   Out-of-range ids, negatives included, are dropped.  vals is f32 or
//   bf16, (m, d) with unit column stride and any row stride >= d (a column
//   slice needs no copy); ids are int32 or int64.
//
// Bound on the H100: bytes.  Each value is read once, each id once and each
//   output written once: m*d*s + 4m read (s = 4 for f32, 2 for bf16; 8m for
//   int64 ids) and 4*n*d written.  At the minibatch_lg shape of
//   MeshGraphNet (m = 168,960, d = 128, n = 169,984, f32) that is 174 MB,
//   0.052 ms at 3.35 TB/s.
//
// Design: the TPU has no atomics, so the Pallas kernel builds a one-hot
//   (block_e x block_n) matrix per grid cell and multiplies it into the
//   output on the MXU, O(m * n * d) work.  Hopper has float atomics in L2,
//   so the sum is a scatter:
//   1. out <- 0, one memset on the stream (the wrapper allocates zeros
//      instead when there are no rows);
//   2. one thread per (row, group of 4 columns): it reads the row's id once,
//      loads its 4 values with one 16-byte (f32) or 8-byte (bf16) load where
//      the wrapper vouches for the alignment, and adds them with one 16-byte
//      vector atomic (atomicAdd on float4, sm_90) where d % 4 == 0, else 4
//      scalar atomics.  The last group of a row with d % 4 != 0 takes the
//      scalar tail.  A warp covers 32 neighbouring groups, so loads and
//      atomics are coalesced along the row.
//   The atomics return nothing, so they compile to fire-and-forget RED
//   operations.  Float addition is not associative and the atomics land in
//   an order that changes from run to run: the result equals the plain
//   version to rounding, not bit for bit.
//   Known weakness: contention at hub segments.  All rows of one segment
//   add into the same d addresses, so a hub with in-degree k serialises k
//   atomics on each of its addresses in L2.  Sorting the rows by segment
//   and reducing in registers before one add per run is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ void add4(float* dst, float4 v, bool vec_out) {
  if (vec_out) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
  atomicAdd(dst + 0, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

__device__ __forceinline__ float4 load4(const float* p, bool vec_in) {
  if (vec_in) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec_in) {
  if (vec_in) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

template <typename T, typename I>
__global__ void scatter_rows(const T* __restrict__ vals,
                             const I* __restrict__ ids,
                             float* __restrict__ out, int64_t m, int64_t d,
                             int64_t row_stride, int64_t n, int64_t groups,
                             int vec_in, int vec_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * groups) return;
  const int64_t row = t / groups;
  const int64_t col = (t - row * groups) * 4;
  const int64_t seg = static_cast<int64_t>(ids[row]);
  if (seg < 0 || seg >= n) return;
  const T* src = vals + row * row_stride + col;
  float* dst = out + seg * d + col;
  if (col + 4 <= d) {
    add4(dst, load4(src, vec_in != 0), vec_out != 0);
  } else {
    for (int64_t j = 0; j < d - col; ++j) atomicAdd(dst + j, load1(src + j));
  }
}

template <typename T, typename I>
void launch(const void* vals, const void* ids, void* out, int64_t m,
            int64_t d, int64_t row_stride, int64_t n, int vec_in, int vec_out,
            cudaStream_t s, dim3 grid, dim3 block, unsigned smem) {
  scatter_rows<T, I><<<grid, block, smem, s>>>(
      static_cast<const T*>(vals), static_cast<const I*>(ids),
      static_cast<float*>(out), m, d, row_stride, n, (d + 3) / 4, vec_in,
      vec_out);
}

}  // namespace

extern "C" {

// vals: (m, d) with row stride row_stride (elements), f32 (bf16 = 0) or
// bf16 (bf16 = 1); ids: (m,) int32 (ids64 = 0) or int64 (ids64 = 1); out:
// (n, d) f32, contiguous; m, n, d >= 1.  Zeroes out, then one thread per
// (row, group of 4 columns).  vec_in != 0 promises vals 16-byte (f32) or
// 8-byte (bf16) aligned with row_stride % 4 == 0; vec_out != 0 promises
// out 16-byte aligned with d % 4 == 0.
int scatter_rows_launch(const void* vals, const void* ids, void* out,
                        int64_t m, int64_t d, int64_t row_stride, int64_t n,
                        int bf16, int ids64, int vec_in, int vec_out,
                        void* stream, REPRO_GEOMETRY) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, n * d * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = REPRO_GRID, block = REPRO_BLOCK;
  if (bf16) {
    if (ids64)
      launch<__nv_bfloat16, int64_t>(vals, ids, out, m, d, row_stride, n,
                                     vec_in, vec_out, s, grid, block, smem);
    else
      launch<__nv_bfloat16, int32_t>(vals, ids, out, m, d, row_stride, n,
                                     vec_in, vec_out, s, grid, block, smem);
  } else {
    if (ids64)
      launch<float, int64_t>(vals, ids, out, m, d, row_stride, n, vec_in,
                             vec_out, s, grid, block, smem);
    else
      launch<float, int32_t>(vals, ids, out, m, d, row_stride, n, vec_in,
                             vec_out, s, grid, block, smem);
  }
  return repro_last_error();
}

}  // extern "C"
