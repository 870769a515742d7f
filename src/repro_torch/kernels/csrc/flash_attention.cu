// flash_attention: causal GQA attention with an online softmax on Hopper,
// as two kernels: flash_fwd_wgmma (bf16 at D in {64, 128}: tensor cores
// fed by TMA) and flash_fwd (f32, and bf16 at D in {16, 32}: f32 products
// on the CUDA cores).  The wrapper (kernels/flash_attention.py) picks one
// from (dtype, D) alone.
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
// flash_fwd (f32, and bf16 at D in {16, 32}): one thread block of 256
//   threads per (b, hq, 64-row q tile), heaviest causal tiles scheduled
//   first.  The q tile is staged in shared memory as f32; the block walks
//   the 64-key tiles of its rows' computed kv prefix (kv_end below: whole
//   128-key logical blocks, so the skip matches the reference's), staging
//   k, then v, through one padded shared buffer.  Each thread computes a 4 x 4
//   patch of the 64 x 64 score tile with f32 FMAs, four threads a row run
//   the online softmax (running max, denominator and correction in shared
//   memory), and each thread keeps 4 rows x D/16 columns of the output
//   accumulator in f32 registers.  Products run on the CUDA cores in f32,
//   so bf16 and f32 inputs get the reference's f32 arithmetic.  Inputs are
//   read by strides (the model passes transposed views of its (B, S, H, D)
//   activations); the last dimension must be contiguous.  Its products
//   reach a third of the f32 SIMT peak, far below the bf16 tensor cores,
//   so bf16 at D in {64, 128} (every published config's D is 128) runs
//   the kernel below.
//
// flash_fwd_wgmma (bf16, D in {64, 128}): the same contract on the tensor
//   cores.  bf16 x bf16 products are exact in f32 and wgmma accumulates in
//   f32, so Q K^T keeps the reference's f32 arithmetic.  Only p would be
//   rounded on its way to the PV product: it is split into two bf16 halves,
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both are multiplied by V
//   into the same f32 accumulator, which leaves p's error near 2^-17 of p
//   (one bf16 rounding would be 2^-9) for 1.5x the tensor work of PV.  One
//   CTA of three warpgroups per (b, hq, 128-row q tile), heaviest causal
//   tiles first.  Warpgroup 0 is the producer: one thread loads the Q tile
//   once and a 2-stage ring of 128-key K and V tiles by TMA (128-byte
//   swizzle, 64-column boxes, zero fill past Sq and Sk) and the group gives
//   up registers (setmaxnreg).  Warpgroups 1 and 2 each own 64 q rows: per
//   kv tile, S = Q K^T by wgmma m64n128k16 from shared memory, scale and
//   mask in registers, row max and sum by quad shuffles over the
//   accumulator layout, rescale O, then O += p_hi V + p_lo V by register-A
//   wgmma (V is MN-major in shared memory: the transpose bit), and release
//   the stage.  The 128-row q tile and 128-key kv tile are the reference's
//   logical blocks, so the causal skip is tile-exact and only tiles on the
//   diagonal (or past Sk) take an element mask.  The epilogue divides by l
//   (l == 0 -> 1) and stores bf16 by strides.  Not yet done: pingpong
//   scheduling of the two consumers, overlap of one tile's softmax with
//   the next tile's Q K^T, persistent CTAs.
#include <cstdint>
#include <type_traits>

#include <cuda.h>
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
// (Params or WgParams: both kernels' parameters carry these fields.)
template <typename P>
__device__ __forceinline__ int64_t kv_end(const P& p, int64_t row) {
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
  if (d == 16) return launch<T, 16>(p, stream, grid, block, smem);
  if (d == 32) return launch<T, 32>(p, stream, grid, block, smem);
  // bf16 at D in {64, 128} runs flash_fwd_wgmma, never this kernel
  if constexpr (std::is_same_v<T, float>) {
    if (d == 64) return launch<T, 64>(p, stream, grid, block, smem);
    if (d == 128) return launch<T, 128>(p, stream, grid, block, smem);
  }
  return repro_invalid();
}

// ---- flash_fwd_wgmma: bf16 on the tensor cores (wgmma, TMA) -------------

constexpr int WG_ROWS = 128;    // q rows per CTA = keys per kv tile
constexpr int WG_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int WG_STAGES = 2;     // K/V ring depth
constexpr int BOX_COLS = 64;     // head columns per TMA box (128 bytes)
constexpr int BOX_BYTES = WG_ROWS * BOX_COLS * 2;  // one 128 x 64 bf16 box
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: Q, K[stage], V[stage] (each 128 x D bf16, 1024-byte
// aligned for the 128-byte swizzle), then the barriers q_full, full[2],
// empty[2]; 1024 bytes of slack align the dynamic base.
template <int D>
struct WgSmem {
  static constexpr int TILE = WG_ROWS * D * 2;
  static constexpr int K = TILE;
  static constexpr int V = K + WG_STAGES * TILE;
  static constexpr int BAR = V + WG_STAGES * TILE;
  static constexpr int BYTES = BAR + 64 + 1024;
};

struct WgParams {
  void* o;
  int64_t b, hq, hkv, sq, sk;
  int64_t o_sb, o_sh, o_ss;
  int64_t block_q, block_k, q_offset;
  int causal;
  float sm_scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-column box of a (D, S, H, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(s),
      "r"(h), "r"(b)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128B swizzle.  K-major (Q, K): 8-row groups 1024 bytes apart (stride),
// the leading offset unused.  MN-major (V): 8-key groups 1024 bytes apart
// (stride), 64-column boxes BOX_BYTES apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) += A (64 x 16 bf16, shared, K-major) * B (16 x 128
// bf16, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16 bf16, registers) * B (16 x 128 bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, b);
  else
    wgmma_rs_n64(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, WgParams p) {
  using L = WgSmem<D>;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_k = base + L::K, s_v = base + L::V;
  const uint32_t q_full = base + L::BAR;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 + 8 * WG_STAGES;

  const int64_t nqt = (p.sq + WG_ROWS - 1) / WG_ROWS;
  const int64_t bh_count = p.b * p.hq;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t qt = nqt - 1 - blockIdx.x / bh_count;  // heavy tiles first
  const int bi = static_cast<int>(bh / p.hq), h = static_cast<int>(bh % p.hq);
  const int hk = static_cast<int>(h / (p.hq / p.hkv));
  const int64_t q0 = qt * WG_ROWS;
  // every row of the tile lies in one reference q block (block_q divides
  // 128 or equals Sq < 128), so the computed kv prefix is the tile's
  const int64_t kv_stop = kv_end(p, q0);
  const int n_tiles = static_cast<int>((kv_stop + WG_ROWS - 1) / WG_ROWS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int c = 0; c < D / BOX_COLS; ++c)
        tma_load(s_q + c * BOX_BYTES, &tq, q_full, c * BOX_COLS,
                 static_cast<int>(q0), h, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES)  // the consumers released tile i - STAGES
          mbar_wait(empty0 + 8 * s, ((i / WG_STAGES) - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < D / BOX_COLS; ++c) {
          tma_load(s_k + s * L::TILE + c * BOX_BYTES, &tk, bar, c * BOX_COLS,
                   i * WG_ROWS, hk, bi);
          tma_load(s_v + s * L::TILE + c * BOX_BYTES, &tv, bar, c * BOX_COLS,
                   i * WG_ROWS, hk, bi);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int quad = lane % 4;
    // accumulator layout: this thread holds rows r0 and r0 + 8 of its
    // warpgroup's 64, columns 8 j + 2 quad + {0, 1} of every 8-column block j
    const int64_t row0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const uint32_t q_rows = s_q + cw * 64 * 128;  // 64 rows of 128 bytes
    constexpr int NO = D / 2;                      // O registers

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % WG_STAGES;
      mbar_wait(full0 + 8 * s, (i / WG_STAGES) & 1);
      const uint32_t k_tile = s_k + s * L::TILE, v_tile = s_v + s * L::TILE;

      // S = Q K^T: D / 16 steps of 16 head columns (32 bytes inside a box);
      // the zeros end the last tile's scores' lifetime (the first step
      // overwrites them)
      float sc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * BOX_BYTES + (ks % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_rows + off, 16, 1024),
                      sw128_desc(k_tile + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale after the product, as the reference does; then the masks
      const int64_t c0 = static_cast<int64_t>(i) * WG_ROWS;
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] *= p.sm_scale;
      if (c0 + WG_ROWS > p.sk ||
          (p.causal && c0 + WG_ROWS - 1 > p.q_offset + q0)) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int64_t col = c0 + 8 * j + 2 * quad + e;
              float& x = sc[4 * j + 2 * hh + e];
              if (col >= p.sk)
                x = -INFINITY;  // past the keys: no term
              else if (p.causal && p.q_offset + row0 + 8 * hh < col)
                x = NEG_BIG;
            }
      }

      // online softmax over the quad's 128 columns of each row
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);  // finite: m starts at -1e30
        corr[hh] = ex2((m[hh] - m_new) * LOG2E);
        m[hh] = m_new;
      }
      // p, its row sums (this thread's columns; summed over the quad at
      // the end) and the split into the A fragments of the PV product:
      // k-slice t holds keys 16 t .. 16 t + 15, register r of it the
      // accumulator pair 8 t + 2 r, 8 t + 2 r + 1 (rows r0, r0 + 8, r0,
      // r0 + 8 for r = 0..3)
      uint32_t p_hi[8][4], p_lo[8][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hh = r & 1;
          const float x0 = ex2((sc[8 * t + 2 * r] - m[hh]) * LOG2E);
          const float x1 = ex2((sc[8 * t + 2 * r + 1] - m[hh]) * LOG2E);
          sum[hh] += x0 + x1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              x0 - __low2float(hi), x1 - __high2float(hi));
          p_hi[t][r] = bf16x2_bits(hi);
          p_lo[t][r] = bf16x2_bits(lo);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + sum[hh];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += p_hi V + p_lo V: 8 k-slices of 16 keys (16 rows of 128 bytes)
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint64_t vd = sw128_desc(v_tile + t * 16 * 128, BOX_BYTES, 1024);
        wgmma_rs<D>(o, p_hi[t], vd);
        wgmma_rs<D>(o, p_lo[t], vd);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: O / l (l == 0 -> 1), bf16, stored by strides
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tot = l[hh];
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      const float inv = 1.f / (tot == 0.f ? 1.f : tot);
      const int64_t row = row0 + 8 * hh;
      if (row >= p.sq) continue;
      __nv_bfloat16* orow = og + row * p.o_ss + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                  o[4 * j + 2 * hh + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no libcuda at link time.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D bf16 map (D, S, H, B) over a tensor read by its own element
// strides (sb, sh, ss; D contiguous), 64 x 128 boxes, 128-byte swizzle,
// zero fill out of bounds.  A dimension of length 1 is never stepped, so
// its stride is set to one the encoder accepts.
bool make_map(CUtensorMap* map, const void* ptr, int64_t b, int64_t h,
              int64_t s, int64_t d, const int64_t* st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t len[3] = {s, h, b};
  const int64_t el[3] = {st[2], st[1], st[0]};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(len[i]);
    strides[i] = static_cast<cuuint64_t>(len[i] == 1 ? d : el[i]) * 2;
  }
  cuuint32_t box[4] = {BOX_COLS, WG_ROWS, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wrapper's geometry must be the kernel's: WG_THREADS threads,
// WgSmem<D>::BYTES of dynamic shared memory and one CTA per (b, hq,
// 128-row q tile).
template <int D>
int launch_wgmma(const WgParams& p, const CUtensorMap& tq,
                 const CUtensorMap& tk, const CUtensorMap& tv,
                 cudaStream_t stream, dim3 grid, dim3 block, unsigned smem) {
  constexpr int bytes = WgSmem<D>::BYTES;
  const int64_t tiles = (p.sq + WG_ROWS - 1) / WG_ROWS * p.b * p.hq;
  if (block.x != WG_THREADS || block.y != 1 || block.z != 1 ||
      smem != static_cast<unsigned>(bytes) ||
      static_cast<int64_t>(grid.x) != tiles || grid.y != 1 || grid.z != 1)
    return repro_invalid();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_wgmma<D><<<grid, block, smem, stream>>>(tq, tk, tv, p);
  return repro_last_error();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  strides: 12
// element strides, dims 0-2 of q, k, v and out in that order (dim 3 has
// stride 1).  d in {16, 32, 64, 128} for f32, {16, 32} for bf16;
// b * hq * sq >= 1; the wrapper checks shapes and blocks.
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

// bf16 q, k, v and out, d in {64, 128}, on flash_fwd_wgmma.  strides as
// for flash_fwd; q, k and v must have 16-byte aligned bases and strides
// that are multiples of 8 elements (dims of length 1 aside), which the
// wrapper ensures (TMA's rule).
int flash_wgmma_launch(const void* q, const void* k, const void* v,
                       void* out, int64_t b, int64_t hq, int64_t hkv,
                       int64_t sq, int64_t sk, int64_t d,
                       const int64_t* strides, int64_t block_q,
                       int64_t block_k, int causal, float sm_scale,
                       void* stream, REPRO_GEOMETRY) {
  if (d != 64 && d != 128) return repro_invalid();
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, hq, sq, d, strides) ||
      !make_map(&tk, k, b, hkv, sk, d, strides + 3) ||
      !make_map(&tv, v, b, hkv, sk, d, strides + 6))
    return repro_invalid();
  WgParams p{out, b, hq, hkv, sq, sk, strides[9], strides[10], strides[11],
             block_q, block_k, sk - sq, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_wgmma<64>(p, tq, tk, tv, s, REPRO_GRID, REPRO_BLOCK, smem);
  return launch_wgmma<128>(p, tq, tk, tv, s, REPRO_GRID, REPRO_BLOCK, smem);
}

}  // extern "C"
