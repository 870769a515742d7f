// flash_attention: causal GQA attention with an online softmax on Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (the
//   Pallas _flash_kernel).  Same contract:
//     q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), f32 or bf16 -> (B, Hq, Sq,
//     D) in q's dtype, f32 arithmetic inside.  Queries are aligned to the
//     end of the keys (q_offset = Sk - Sq); q head h reads kv head
//     h / (Hq / Hkv), never repeated in memory.  The logical blocks are the
//     reference's, block_q = min(128, Sq) and block_k = min(128, Sk): a
//     causal kv block entirely above the diagonal of a row's q block is
//     skipped, masked scores inside a computed block are -1e30 (finite),
//     and a row with a zero denominator comes out 0.  So a row whose q
//     block computes no kv block is 0, and a fully masked row of a computed
//     block is the mean of v over the computed kv blocks (both only when
//     Sq > Sk), exactly as the Pallas kernel gives them.
//
// Bound on the H100: operations.  Causal attention does 2 B Hq S (S+1) D
//   FLOP (QK^T and PV over the lower triangle): at (8, 16, 2048, 128) that
//   is 137.5 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak,
//   against 201 MB of q, k, v and output (0.060 ms at 3.35 TB/s).
//
// Design (simple and exact first; wgmma, TMA and warp specialisation are
//   later work): one thread block of 256 threads per (b, hq, 64-row q
//   tile), heaviest causal tiles scheduled first.  The q tile is staged in
//   shared memory as f32; the block walks the 64-key tiles of its rows'
//   computed kv prefix (kv_end below: whole 128-key logical blocks, so the
//   skip matches the reference's), staging k, then v, through one padded
//   shared buffer.  Each thread computes a 4 x 4 patch of the 64 x 64 score
//   tile with f32 FMAs, four threads a row run the online softmax (running
//   max, denominator and correction in shared memory), and each thread
//   keeps 4 rows x D/16 columns of the output accumulator in f32 registers.
//   Products run on the CUDA cores in f32, so bf16 and f32 inputs get the
//   reference's f32 arithmetic (the tensor cores would round p or the f32
//   inputs).  Inputs are read by strides (the model passes transposed
//   views of its (B, S, H, D) activations); the last dimension must be
//   contiguous.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int TQ = 64;        // q rows per thread block
constexpr int TK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx)
constexpr float NEG_BIG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t b, hq, hkv, sq, sk;
  int64_t q_sb, q_sh, q_ss;  // element strides of dims 0, 1, 2 (dim 3 is 1)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t block_q, block_k, q_offset;
  int causal;
  float sm_scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// End of the computed kv prefix of a row: the reference computes kv block
// ki for q block qi iff q_offset + qi*block_q + block_q - 1 >= ki*block_k.
__device__ __forceinline__ int64_t kv_end(const Params& p, int64_t row) {
  if (!p.causal) return p.sk;
  const int64_t x = p.q_offset + (row / p.block_q) * p.block_q + p.block_q - 1;
  if (x < 0) return 0;
  const int64_t e = (x / p.block_k + 1) * p.block_k;
  return e < p.sk ? e : p.sk;
}

template <int D>
constexpr int smem_floats() {
  // q tile, one k/v tile (both padded to D + 1), scores, m, l, corr
  return TQ * (D + 1) + TK * (D + 1) + TQ * (TK + 1) + 3 * TQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd(Params p) {
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [TQ][D + 1]
  float* kvs = qs + TQ * (D + 1);    // [TK][D + 1]: k, then v
  float* ss = kvs + TK * (D + 1);    // [TQ][TK + 1]: scores, then p
  float* m_s = ss + TQ * (TK + 1);   // running max
  float* l_s = m_s + TQ;             // running denominator
  float* c_s = l_s + TQ;             // this tile's correction

  const int64_t nqt = (p.sq + TQ - 1) / TQ;
  const int64_t bh_count = p.b * p.hq;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t qt = nqt - 1 - blockIdx.x / bh_count;  // heavy tiles first
  const int64_t bi = bh / p.hq, h = bh % p.hq;
  const int64_t hk = h / (p.hq / p.hkv);
  const int64_t q0 = qt * TQ;
  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + bi * p.o_sb + h * p.o_sh;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < TQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int64_t row = q0 + r;
    qs[r * (D + 1) + c] = row < p.sq ? to_f(qg[row * p.q_ss + c]) : 0.f;
  }
  if (tid < TQ) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  int64_t row_end[4];
  for (int i = 0; i < 4; ++i) row_end[i] = kv_end(p, q0 + ty + 16 * i);
  const int64_t last = (q0 + TQ < p.sq ? q0 + TQ : p.sq) - 1;
  const int64_t kv_stop = kv_end(p, last);  // kv_end grows with the row

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int64_t c0 = 0; c0 < kv_stop; c0 += TK) {
    __syncthreads();  // the last tile's readers of kvs and ss are done
    for (int i = tid; i < TK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int64_t col = c0 + r;
      kvs[r * (D + 1) + c] = col < p.sk ? to_f(kg[col * p.k_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = c0 + tx + 16 * j;
        float val;
        if (col >= row_end[i]) {
          val = -INFINITY;  // not in a computed block (or past Sk): no term
        } else {
          val = s[i][j] * p.sm_scale;
          if (p.causal && p.q_offset + row < col) val = NEG_BIG;
        }
        ss[(ty + 16 * i) * (TK + 1) + tx + 16 * j] = val;
      }
    }
    __syncthreads();

    // v into the shared buffer, while four threads a row run the softmax
    for (int i = tid; i < TK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int64_t col = c0 + r;
      kvs[r * (D + 1) + c] = col < p.sk ? to_f(vg[col * p.v_ss + c]) : 0.f;
    }
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = ss + r * (TK + 1);
      float mx = -INFINITY;
      for (int j = part; j < TK; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);  // finite: m starts at -1e30
      float sum = 0.f;
      for (int j = part; j < TK; j += 4) {
        const float e = expf(srow[j] - m_new);
        srow[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * (TK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kvs[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    float l = l_s[ty + 16 * i];
    if (l == 0.f) l = 1.f;  // fully-masked rows -> 0
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[row * p.o_ss + tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

// The wrapper's geometry must be the kernel's: THREADS threads, the
// dynamic shared memory of smem_floats<D>(), and one block per (b, hq,
// q tile) (the kernel decodes blockIdx.x into them).
template <typename T, int D>
int launch(const Params& p, cudaStream_t stream, dim3 grid, dim3 block,
           unsigned smem) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const int64_t tiles = (p.sq + TQ - 1) / TQ * p.b * p.hq;
  if (block.x != THREADS || block.y != 1 || block.z != 1 ||
      smem != static_cast<unsigned>(bytes) ||
      static_cast<int64_t>(grid.x) != tiles || grid.y != 1 || grid.z != 1)
    return repro_invalid();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd<T, D><<<grid, block, smem, stream>>>(p);
  return repro_last_error();
}

template <typename T>
int launch_d(const Params& p, int64_t d, cudaStream_t stream, dim3 grid,
             dim3 block, unsigned smem) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream, grid, block, smem);
    case 32: return launch<T, 32>(p, stream, grid, block, smem);
    case 64: return launch<T, 64>(p, stream, grid, block, smem);
    case 128: return launch<T, 128>(p, stream, grid, block, smem);
    default: return repro_invalid();
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  strides: 12
// element strides, dims 0-2 of q, k, v and out in that order (dim 3 has
// stride 1).  d in {16, 32, 64, 128}; b * hq * sq >= 1; the wrapper checks
// shapes and blocks.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     int64_t b, int64_t hq, int64_t hkv, int64_t sq,
                     int64_t sk, int64_t d, const int64_t* strides,
                     int64_t block_q, int64_t block_k, int causal,
                     float sm_scale, int dtype, void* stream,
                     REPRO_GEOMETRY) {
  Params p{q, k, v, out, b, hq, hkv, sq, sk,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], block_q, block_k, sk - sq, causal,
           sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(p, d, s, REPRO_GRID, REPRO_BLOCK, smem);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(p, d, s, REPRO_GRID, REPRO_BLOCK, smem);
  return repro_invalid();
}

}  // extern "C"
