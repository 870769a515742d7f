// flash_attention: causal GQA attention with an online softmax on Hopper's
// tensor cores, as two kernels fed by TMA: flash_fwd_wgmma (bf16, every D)
// and flash_fwd_tf32x3 (f32, every D, a 3xTF32 split).
// The wrapper (kernels/flash_attention.py) picks one from the dtype alone.
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
//     Sq > Sk), exactly as the Pallas kernel gives them.  Both kernels take
//     128-row q tiles, each in one logical q block (block_q is 128, or Sq
//     when shorter), so a tile's computed kv prefix is its first row's and
//     only tiles on the diagonal (or past Sk) take an element mask.
//     Neither uses atomics: each output row is reduced in a fixed order,
//     and reruns give the same bits.
//
// Bound on the H100 at (8, 16, 8, 2048, D) causal: QK^T and PV over the
//   lower triangle are 2 B Hq S (S+1) D FLOP (137.5 GFLOP at D = 128).
//   bf16: the products at 989 TFLOP/s, 0.139 ms at D = 128 and 0.017 /
//   0.035 ms at D 16 / 32 (the bytes take 0.008 / 0.015).  Every unmasked
//   score also takes one exponential (268.6 M); they are left out of the
//   bound, since exp2 runs on the SFU (16 a clock an SM) and, as a
//   polynomial, on the FMA pipes at once, but on the SFU alone at 1.83 GHz
//   they would take 0.070 ms, which is what D 16 and 32 run against here.
//   f32: three TF32 products for each product, 0.834 ms at 494.7 TFLOP/s
//   at D = 128 (on the CUDA cores' f32 FMAs the same work would take 2.05
//   ms).
//
// flash_fwd_wgmma (bf16, D in {16, 32, 64, 128}): bf16 x bf16 products are
//   exact in f32 and wgmma accumulates in f32, so Q K^T keeps the
//   reference's f32 arithmetic.  Only p would be rounded on its way to the
//   PV product: it is split into two bf16 halves, p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi), and both are multiplied by V into the same f32
//   accumulator, which leaves p's error near 2^-17 of p (one bf16 rounding
//   would be 2^-9) for 1.5x the tensor work of PV.  One CTA of three
//   warpgroups per (b, hq, 128-row q tile), heaviest causal tiles first.
//   Warpgroup 0 is the producer: one thread loads the Q tile once and a
//   2-stage ring of 128-key K and V tiles by TMA (zero fill past Sq and Sk)
//   and the group gives up registers (setmaxnreg).  A TMA box is 128 rows
//   of min(D, 64) head columns, swizzled over its whole row: 128-byte
//   swizzle at D 64 and 128 (two boxes a tile at D = 128), 64-byte at D =
//   32, 32-byte at D = 16; the wgmma descriptors name the same swizzle.
//   Warpgroups 1 and 2 each own 64 q rows: per kv tile, S = Q K^T by wgmma
//   m64n128k16 from shared memory, scale and mask in registers, row max and
//   sum by quad shuffles over the accumulator layout, rescale O, then O +=
//   p_hi V + p_lo V by register-A wgmma m64nDk16 (V is MN-major in shared
//   memory: the transpose bit), and release the stage.  The epilogue
//   divides by l (l == 0 -> 1) and stores bf16 by strides.  At D 16 and 32
//   a CTA holds 21 and 37 KB of shared memory but its consumers keep 240
//   registers a thread, so one CTA runs an SM.  Not yet done: pingpong
//   scheduling of the two consumers, overlap of one tile's softmax with
//   the next tile's Q K^T, persistent CTAs, more CTAs an SM at small D.
//
// flash_fwd_tf32x3 (f32, D in {16, 32, 64, 128}): the f32 contract on the
//   tensor cores.  One TF32 pass keeps 10 mantissa bits of each operand,
//   far from the f32 contract, so each operand x is split into hi = x
//   truncated to TF32 and lo = x - hi (exact in f32; a TF32 product reads
//   its top 19 bits), and every product a b is taken as lo_a hi_b + hi_a
//   lo_b + hi_a hi_b, small terms first, into f32 accumulators: the dropped
//   lo lo term and lo's truncation leave about 2^-19 of each product.  The
//   structure is flash_fwd_wgmma's: one CTA of three warpgroups per (b, hq,
//   128-row q tile), heaviest causal tiles first, but TF32 wgmma reads
//   only K-major operands and needs its operands split, so the producer
//   warpgroup does more than load.  Its first thread loads Q once and the
//   64-key K and V tiles by TMA (f32 boxes of min(D, 32) columns, swizzled
//   over a box row); the whole warpgroup then splits K in place (hi) and
//   into a lo tile, and V into the hi and lo tiles of V^T (rows d, keys
//   K-major, the keys of each group of 8 permuted to the P fragments'
//   order), and signals the consumers by mbarriers; K_{i+1} is split while
//   the consumers run tile i's softmax and P V, V_{i+1} while they run
//   tile i+1's Q K^T.  Each consumer warpgroup owns 64 q rows: it splits
//   its Q rows once, keeping hi in registers (the A fragments) and lo in
//   place, then per tile runs S = Q K^T as m64n64k8 wgmmas (Q lo from
//   shared memory, Q hi from registers), the masks and online softmax of
//   flash_fwd_wgmma, p split into register A fragments whose columns t, t
//   + 4 stand for keys 2t, 2t + 1, and O += P V^T as m64nDk8 wgmmas, each
//   k-step's fragments written as it is issued into one of two register
//   sets (so P takes 16 registers, not 64).  The warpgroups never wait for
//   each other, only for the producer's tiles.  A warpgroup skips a tile
//   wholly above its 64 rows once each of them has seen a key (exact: such
//   a tile only adds exp(-1e30 - m) = 0).  The producer keeps 72
//   registers a thread for the splits, the consumers 216.  Shared memory
//   is 1,792 D bytes (224 KB at D = 128), so one CTA runs an SM.  Not yet
//   done: double-buffered split tiles (they do not fit at D = 128),
//   pingpong scheduling of the consumers, the D = 128 build's 120 bytes of
//   spills.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int WG_ROWS = 128;     // q rows a CTA; flash_fwd_wgmma's keys a tile
constexpr int WG_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups

// ---- flash_fwd_wgmma: bf16 on the tensor cores (wgmma, TMA) -------------

constexpr int WG_STAGES = 2;     // K/V ring depth (128-key tiles)

// Shared memory: Q, K[stage], V[stage] (each 128 x D bf16, 1024-byte
// aligned for the swizzle), then the barriers q_full, full[2], empty[2];
// 1024 bytes of slack align the dynamic base.  A TMA box is 128 rows of
// BOX_COLS head columns (ROW bytes, the swizzle's span); a tile is D /
// BOX_COLS boxes, BOX bytes apart.
template <int D>
struct WgSmem {
  static constexpr int BOX_COLS = D < 64 ? D : 64;
  static constexpr int ROW = BOX_COLS * 2;
  static constexpr int BOX = WG_ROWS * ROW;
  // wgmma's layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int TILE = WG_ROWS * D * 2;
  static constexpr int K = TILE;
  static constexpr int V = K + WG_STAGES * TILE;
  static constexpr int BAR = V + WG_STAGES * TILE;
  static constexpr int BYTES = BAR + 64 + 1024;
};

// Both kernels' parameters: q, k and v come by tensor maps
struct WgParams {
  void* o;
  int64_t b, hq, hkv, sq, sk;
  int64_t o_sb, o_sh, o_ss;
  int64_t block_q, block_k, q_offset;
  int causal;
  float sm_scale;
};

// End of the computed kv prefix of a row: the reference computes kv block
// ki for q block qi iff q_offset + qi*block_q + block_q - 1 >= ki*block_k.
__device__ __forceinline__ int64_t kv_end(const WgParams& p, int64_t row) {
  if (!p.causal) return p.sk;
  const int64_t x = p.q_offset + (row / p.block_q) * p.block_q + p.block_q - 1;
  if (x < 0) return 0;
  const int64_t e = (x / p.block_k + 1) * p.block_k;
  return e < p.sk ? e : p.sk;
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

// One box of a (D, S, H, B) tensor map into shared memory.
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

// A wgmma shared-memory descriptor for a swizzled operand: start address,
// leading and stride byte offsets (16-byte units), the layout type.
// K-major (Q, K): 8-row groups 8 ROW bytes apart (stride), the leading
// offset unused.  MN-major (V): 8-key groups 8 ROW bytes apart (stride),
// boxes BOX bytes apart (leading).
template <uint64_t LAYOUT>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lead,
                                            uint32_t stride) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) |
         (LAYOUT << 62);
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
// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// D (64 x N, f32) += A (64 x 16 bf16, registers) * B (16 x N bf16, shared,
// MN-major: the transpose bit is set), N in {16, 32, 64, 128}.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, b);
  else if constexpr (D == 32)
    wgmma_rs_n32(d, a, b);
  else
    wgmma_rs_n16(d, a, b);
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
      for (int c = 0; c < D / L::BOX_COLS; ++c)
        tma_load(s_q + c * L::BOX, &tq, q_full, c * L::BOX_COLS,
                 static_cast<int>(q0), h, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES)  // the consumers released tile i - STAGES
          mbar_wait(empty0 + 8 * s, ((i / WG_STAGES) - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < D / L::BOX_COLS; ++c) {
          tma_load(s_k + s * L::TILE + c * L::BOX, &tk, bar,
                   c * L::BOX_COLS, i * WG_ROWS, hk, bi);
          tma_load(s_v + s * L::TILE + c * L::BOX, &tv, bar,
                   c * L::BOX_COLS, i * WG_ROWS, hk, bi);
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
    const uint32_t q_rows = s_q + cw * 64 * L::ROW;  // 64 rows of a box
    constexpr int NO = D / 2;                         // O registers

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % WG_STAGES;
      mbar_wait(full0 + 8 * s, (i / WG_STAGES) & 1);
      const uint32_t k_tile = s_k + s * L::TILE, v_tile = s_v + s * L::TILE;

      // S = Q K^T: D / 16 steps of 16 head columns (32 bytes inside a
      // box's row); the zeros end the last tile's scores' lifetime (the
      // first step overwrites them)
      float sc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        constexpr int STEPS = L::BOX_COLS / 16;  // k-steps a box row
        const uint32_t off = (ks / STEPS) * L::BOX + (ks % STEPS) * 32;
        wgmma_ss_n128(sc, sw_desc<L::LAYOUT>(q_rows + off, 16, 8 * L::ROW),
                      sw_desc<L::LAYOUT>(k_tile + off, 16, 8 * L::ROW),
                      ks > 0);
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

      // O += p_hi V + p_lo V: 8 k-slices of 16 keys (16 rows of a box)
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint64_t vd = sw_desc<L::LAYOUT>(v_tile + t * 16 * L::ROW,
                                               L::BOX, 8 * L::ROW);
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

// ---- flash_fwd_tf32x3: f32 on the tensor cores (wgmma, 3xTF32, TMA) ----

constexpr int T3_KEYS = 64;  // keys per kv tile

// Shared memory (1024-byte aligned): the Q tile (128 x D: its lo, split in
// place), the K tile (64 x D: raw, then its hi in place), K's lo, the raw
// V tile (64 x D), and V^T's hi and lo (D x 64), then the barriers q_full,
// k_raw, v_raw, k_ready, v_ready, k_empty, v_empty.  Q, K and V are TMA
// boxes of QC = min(D, 32) columns, swizzled over a box row (128 bytes, or
// 64 at D = 16); V^T is in boxes of 32 keys, 128-byte swizzle.  1024 bytes
// of slack align the dynamic base.
template <int D>
struct T3Smem {
  static constexpr int QC = D < 32 ? D : 32;
  static constexpr int ROWB = QC * 4;
  // wgmma's layout type: 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 2;
  static constexpr int K = WG_ROWS * D * 4;
  static constexpr int KL = K + T3_KEYS * D * 4;
  static constexpr int V = KL + T3_KEYS * D * 4;
  static constexpr int VH = V + T3_KEYS * D * 4;
  static constexpr int VL = VH + D * T3_KEYS * 4;
  static constexpr int BAR = VL + D * T3_KEYS * 4;
  static constexpr int BYTES = BAR + 64 + 1024;
};

// Byte offset of element (r, c) of a tile of R rows in boxes of ROWB / 4
// f32 columns, each box row swizzled over ROWB bytes as TMA writes it and
// wgmma reads it.
template <int ROWB, int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int QC = ROWB / 4;
  const int box = c / QC, cc = c % QC;
  const int unit = (cc >> 2) ^ (((r * ROWB) >> 7) & (ROWB / 16 - 1));
  return box * (R * ROWB) + r * ROWB + unit * 16 + (cc & 3) * 4;
}

// Make the generic proxy's writes to shared memory visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x truncated to TF32; x - tf32(x) is exact in f32, and a TF32 product
// reads the top 19 bits of its operands
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// D (64 x 64, f32) += A (64 x 8 tf32) * B (8 x 64 tf32, shared, K-major),
// A from shared memory (K-major) or registers; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 8 tf32, registers) * B (8 x N tf32, shared,
// K-major), N in {16, 32, 64, 128}.
__device__ __forceinline__ void wgmma_tf32_rs_acc_n16(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_acc_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_acc_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_acc_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_tf32_pv(float (&o)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (D == 128)
    wgmma_tf32_rs_acc_n128(o, a, b);
  else if constexpr (D == 64)
    wgmma_tf32_rs_acc_n64(o, a, b);
  else if constexpr (D == 32)
    wgmma_tf32_rs_acc_n32(o, a, b);
  else
    wgmma_tf32_rs_acc_n16(o, a, b);
}

// The producer warpgroup's split of the raw K tile: hi in place, lo into
// KL at the same offset, 16 bytes a step.
template <int D>
__device__ __forceinline__ void split_k(unsigned char* k, unsigned char* kl,
                                        int pt) {
#pragma unroll
  for (int it = 0; it < T3_KEYS * D / 4 / 128; ++it) {
    const int u = pt + 128 * it;
    float4* x = reinterpret_cast<float4*>(k + 16 * u);
    const float4 v = *x;
    const float4 hv = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
    *x = hv;
    *reinterpret_cast<float4*>(kl + 16 * u) =
        make_float4(v.x - hv.x, v.y - hv.y, v.z - hv.z, v.w - hv.w);
  }
}

// The producer warpgroup's split of the raw V tile into V^T's hi and lo,
// the keys of each group of 8 permuted to the P fragments' order: key 2a
// at position a, key 2a + 1 at 4 + a.  A thread takes one column d of one
// group, so the 8 threads of a quarter warp store to 8 swizzled units.
template <int D, int ROWB>
__device__ __forceinline__ void split_v(const unsigned char* v,
                                        unsigned char* vh, unsigned char* vl,
                                        int pt) {
#pragma unroll
  for (int it = 0; it < (D * 8 + 127) / 128; ++it) {
    const int pr = pt + 128 * it;
    if (D * 8 % 128 != 0 && pr >= D * 8) break;
    const int d = pr % D, kt = pr / D;
    float x[8], h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = *reinterpret_cast<const float*>(
          v + swz<ROWB, T3_KEYS>(8 * kt + j, d));
      h[j] = tf32(x[j]);
    }
    const uint32_t o0 = swz<128, D>(d, 8 * kt);
    const uint32_t o1 = swz<128, D>(d, 8 * kt + 4);
    *reinterpret_cast<float4*>(vh + o0) = make_float4(h[0], h[2], h[4], h[6]);
    *reinterpret_cast<float4*>(vh + o1) = make_float4(h[1], h[3], h[5], h[7]);
    *reinterpret_cast<float4*>(vl + o0) =
        make_float4(x[0] - h[0], x[2] - h[2], x[4] - h[4], x[6] - h[6]);
    *reinterpret_cast<float4*>(vl + o1) =
        make_float4(x[1] - h[1], x[3] - h[3], x[5] - h[5], x[7] - h[7]);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_tf32x3(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, WgParams p) {
  using L = T3Smem<D>;
  constexpr int ROWB = L::ROWB, QC = L::QC;
  constexpr int KS = D / 8;  // k-steps of Q K^T
  extern __shared__ unsigned char t3_smem[];
  const uint32_t base = (smem_u32(t3_smem) + 1023u) & ~1023u;
  unsigned char* sm = t3_smem + (base - smem_u32(t3_smem));
  const uint32_t s_q = base, s_k = base + L::K, s_kl = base + L::KL,
                 s_v = base + L::V, s_vh = base + L::VH, s_vl = base + L::VL;
  const uint32_t q_full = base + L::BAR, k_raw = q_full + 8,
                 v_raw = q_full + 16, k_ready = q_full + 24,
                 v_ready = q_full + 32, k_empty = q_full + 40,
                 v_empty = q_full + 48;

  const int64_t nqt = (p.sq + WG_ROWS - 1) / WG_ROWS;
  const int64_t bh_count = p.b * p.hq;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t qt = nqt - 1 - blockIdx.x / bh_count;  // heavy tiles first
  const int bi = static_cast<int>(bh / p.hq), h = static_cast<int>(bh % p.hq);
  const int hk = static_cast<int>(h / (p.hq / p.hkv));
  const int64_t q0 = qt * WG_ROWS;
  const int n_tiles =
      static_cast<int>((kv_end(p, q0) + T3_KEYS - 1) / T3_KEYS);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(q_full + 8 * i, 1);
    mbar_init(k_empty, 8);  // one arrive per consumer warp
    mbar_init(v_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 0) {
    // ---- producer: TMA loads, and the K and V splits --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const int pt = threadIdx.x;
    if (n_tiles == 0) return;
    if (pt == 0) {
      mbar_expect_tx(q_full, WG_ROWS * D * 4);
#pragma unroll
      for (int c = 0; c < D / QC; ++c)
        tma_load(s_q + c * WG_ROWS * ROWB, &tq, q_full, c * QC,
                 static_cast<int>(q0), h, bi);
      mbar_expect_tx(v_raw, T3_KEYS * D * 4);
#pragma unroll
      for (int c = 0; c < D / QC; ++c)
        tma_load(s_v + c * T3_KEYS * ROWB, &tv, v_raw, c * QC, 0, hk, bi);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int par = i & 1;
      // K_i into the K tile once every consumer warp is done with K_{i-1}
      if (i > 0) mbar_wait(k_empty, par ^ 1);
      if (pt == 0) {
        mbar_expect_tx(k_raw, T3_KEYS * D * 4);
#pragma unroll
        for (int c = 0; c < D / QC; ++c)
          tma_load(s_k + c * T3_KEYS * ROWB, &tk, k_raw, c * QC,
                   i * T3_KEYS, hk, bi);
      }
      mbar_wait(k_raw, par);
      split_k<D>(sm + L::K, sm + L::KL, pt);
      fence_async_smem();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (pt == 0) mbar_arrive(k_ready);
      // V_i (loaded after V_{i-1}'s split) into V^T once every consumer
      // warp is done with V_{i-1}
      if (i > 0) mbar_wait(v_empty, par ^ 1);
      mbar_wait(v_raw, par);
      split_v<D, ROWB>(sm + L::V, sm + L::VH, sm + L::VL, pt);
      fence_async_smem();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (pt == 0) {
        mbar_arrive(v_ready);
        if (i + 1 < n_tiles) {
          mbar_expect_tx(v_raw, T3_KEYS * D * 4);
#pragma unroll
          for (int c = 0; c < D / QC; ++c)
            tma_load(s_v + c * T3_KEYS * ROWB, &tv, v_raw, c * QC,
                     (i + 1) * T3_KEYS, hk, bi);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each ---------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // accumulator layout: this thread holds rows r0 and r0 + 8 of the tile,
  // columns 8 j + 2 t + {0, 1} of every 8-column group j
  const int r0 = 64 * cw + 16 * warp + g;
  const int64_t row0 = q0 + r0;
  const int64_t wg0 = q0 + 64 * cw;  // the warpgroup's first row

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  // Q, split once: this thread's A fragments (rows r0, r0 + 8, r0, r0 + 8
  // of columns t, t, t + 4, t + 4 of each k-step) keep their hi in
  // registers and leave their lo in place for the shared-memory operand
  uint32_t q_hi[KS][4];
  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* x = reinterpret_cast<float*>(
            sm + swz<ROWB, WG_ROWS>(r0 + 8 * (e & 1),
                                    8 * ks + t + 4 * (e >> 1)));
        const float hx = tf32(*x);
        q_hi[ks][e] = __float_as_uint(hx);
        *x -= hx;
      }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int64_t c0 = static_cast<int64_t>(i) * T3_KEYS;
    const int par = i & 1;
    // a warpgroup skips a tile above its last row once each of its rows
    // has seen a key (q_offset + wg0 >= 0): the tile is all -1e30 and adds
    // nothing
    const bool busy = !(p.causal && p.q_offset + wg0 >= 0 &&
                        c0 > p.q_offset + wg0 + 63);

    // S = Q K^T: per 8-column k-step, Q lo K hi + Q hi K lo + Q hi K hi
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    mbar_wait(k_ready, par);
    if (busy) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        constexpr int STEPS = QC / 8;  // k-steps a box row
        const uint32_t kb = (ks / STEPS) * T3_KEYS * ROWB + (ks % STEPS) * 32;
        const uint32_t qb = (ks / STEPS) * WG_ROWS * ROWB + cw * 64 * ROWB +
                            (ks % STEPS) * 32;
        const uint64_t k_hi = sw_desc<L::LAYOUT>(s_k + kb, 16, 8 * ROWB);
        wgmma_tf32_ss_n64(sc, sw_desc<L::LAYOUT>(s_q + qb, 16, 8 * ROWB),
                          k_hi, ks > 0);
        wgmma_tf32_rs_n64(sc, q_hi[ks],
                          sw_desc<L::LAYOUT>(s_kl + kb, 16, 8 * ROWB), 1);
        wgmma_tf32_rs_n64(sc, q_hi[ks], k_hi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty);

    float corr[2];
    if (busy) {
      // scale after the product, as the reference does; then the masks
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] *= p.sm_scale;
      if (c0 + T3_KEYS > p.sk ||
          (p.causal && c0 + T3_KEYS - 1 > p.q_offset + wg0)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int64_t col = c0 + 8 * j + 2 * t + e;
              float& x = sc[4 * j + 2 * hh + e];
              if (col >= p.sk)
                x = -INFINITY;  // past the keys: no term
              else if (p.causal && p.q_offset + row0 + 8 * hh < col)
                x = NEG_BIG;
            }
      }
      // online softmax over the quad's 64 columns of each row
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);  // finite: m starts at -1e30
        corr[hh] = ex2((m[hh] - m_new) * LOG2E);
        m[hh] = m_new;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    }

    // O += P V: per 8-key k-step j, P lo V hi + P hi V lo + P hi V hi.  p
    // is split into the A fragments of k-step j as the step is issued,
    // into two alternating register sets (the set of step j - 2 is free
    // once at most one group is in flight): register r takes the
    // accumulator entry (r0 + 8 (r & 1), 2 t + (r >> 1)) of key group j, so
    // the fragment's columns t, t + 4 stand for keys 2t, 2t + 1 (V^T's
    // columns are permuted to match)
    mbar_wait(v_ready, par);
    if (busy) {
      float sum[2] = {0.f, 0.f};
      uint32_t p_hi[2][4], p_lo[2][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t(&ph)[4] = p_hi[j & 1];
        uint32_t(&pl)[4] = p_lo[j & 1];
        if (j >= 2) {
          wgmma_wait<1>();
#pragma unroll
          for (int r = 0; r < 4; ++r)
            asm volatile("" : "+r"(ph[r]), "+r"(pl[r])::"memory");
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = (r >> 1) | ((r & 1) << 1);
          const float x = ex2((sc[4 * j + e] - m[r & 1]) * LOG2E);
          sum[r & 1] += x;
          const float hx = tf32(x);
          ph[r] = __float_as_uint(hx);
          pl[r] = __float_as_uint(x - hx);
        }
        const uint32_t vb = (j / 4) * D * 128 + (j % 4) * 32;
        const uint64_t v_hi = sw_desc<1>(s_vh + vb, 16, 1024);
        wgmma_fence();
        wgmma_tf32_pv<D>(o, pl, v_hi);
        wgmma_tf32_pv<D>(o, ph, sw_desc<1>(s_vl + vb, 16, 1024));
        wgmma_tf32_pv<D>(o, ph, v_hi);
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(o);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + sum[hh];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty);
  }

  // epilogue: O / l (l == 0 -> 1), f32, stored by strides
  float* og = static_cast<float*>(p.o) + bi * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float tot = l[hh];
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    const float inv = 1.f / (tot == 0.f ? 1.f : tot);
    const int64_t row = row0 + 8 * hh;
    if (row >= p.sq) continue;
    float* orow = og + row * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
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

// A 4-D map (D, S, H, B) over a tensor read by its own element strides
// (sb, sh, ss; D contiguous) of `elem`-byte elements, boxes of `cols`
// columns by `rows` rows swizzled over the box's row (128, 64 or 32
// bytes), zero fill out of bounds.  A dimension of length 1 is never
// stepped, so its stride is set to one the encoder accepts.
bool make_map(CUtensorMap* map, const void* ptr, int64_t b, int64_t h,
              int64_t s, int64_t d, const int64_t* st,
              CUtensorMapDataType type, int elem, int cols, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t len[3] = {s, h, b};
  const int64_t el[3] = {st[2], st[1], st[0]};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(len[i]);
    strides[i] = static_cast<cuuint64_t>(len[i] == 1 ? d : el[i]) * elem;
  }
  const int row_bytes = cols * elem;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                       static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wrapper's geometry must be the kernel's: WG_THREADS threads, the
// kernel's shared memory (WgSmem<D>::BYTES or T3Smem<D>::BYTES) and one CTA
// per (b, hq, 128-row q tile).
template <typename Kernel>
int launch_wg(Kernel kernel, int bytes, const WgParams& p,
              const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, cudaStream_t stream, dim3 grid,
              dim3 block, unsigned smem) {
  const int64_t tiles = (p.sq + WG_ROWS - 1) / WG_ROWS * p.b * p.hq;
  if (block.x != WG_THREADS || block.y != 1 || block.z != 1 ||
      smem != static_cast<unsigned>(bytes) ||
      static_cast<int64_t>(grid.x) != tiles || grid.y != 1 || grid.z != 1)
    return repro_invalid();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, stream>>>(tq, tk, tv, p);
  return repro_last_error();
}

template <int D>
int launch_wgmma(const WgParams& p, const CUtensorMap& tq,
                 const CUtensorMap& tk, const CUtensorMap& tv,
                 cudaStream_t stream, dim3 grid, dim3 block, unsigned smem) {
  return launch_wg(flash_fwd_wgmma<D>, WgSmem<D>::BYTES, p, tq, tk, tv,
                   stream, grid, block, smem);
}

template <int D>
int launch_tf32x3(const WgParams& p, const CUtensorMap& tq,
                  const CUtensorMap& tk, const CUtensorMap& tv,
                  cudaStream_t stream, dim3 grid, dim3 block, unsigned smem) {
  return launch_wg(flash_fwd_tf32x3<D>, T3Smem<D>::BYTES, p, tq, tk, tv,
                   stream, grid, block, smem);
}

}  // namespace

extern "C" {

// f32 q, k, v and out, d in {16, 32, 64, 128}, on flash_fwd_tf32x3.
// strides: 12 element strides, dims 0-2 of q, k, v and out in that order
// (dim 3 has stride 1); q, k and v must have 16-byte aligned bases and
// strides that are multiples of 4 elements (dims of length 1 aside), and
// out's strides must be even, which the wrapper ensures (TMA's rule).
// b * hq * sq >= 1; the wrapper checks shapes and blocks.
int flash_tf32x3_launch(const void* q, const void* k, const void* v,
                        void* out, int64_t b, int64_t hq, int64_t hkv,
                        int64_t sq, int64_t sk, int64_t d,
                        const int64_t* strides, int64_t block_q,
                        int64_t block_k, int causal, float sm_scale,
                        void* stream, REPRO_GEOMETRY) {
  if (d != 16 && d != 32 && d != 64 && d != 128) return repro_invalid();
  const int cols = d < 32 ? static_cast<int>(d) : 32;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, hq, sq, d, strides, f32, 4, cols, WG_ROWS) ||
      !make_map(&tk, k, b, hkv, sk, d, strides + 3, f32, 4, cols, T3_KEYS) ||
      !make_map(&tv, v, b, hkv, sk, d, strides + 6, f32, 4, cols, T3_KEYS))
    return repro_invalid();
  WgParams p{out, b, hq, hkv, sq, sk, strides[9], strides[10], strides[11],
             block_q, block_k, sk - sq, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = REPRO_GRID, block = REPRO_BLOCK;
  if (d == 16) return launch_tf32x3<16>(p, tq, tk, tv, s, grid, block, smem);
  if (d == 32) return launch_tf32x3<32>(p, tq, tk, tv, s, grid, block, smem);
  if (d == 64) return launch_tf32x3<64>(p, tq, tk, tv, s, grid, block, smem);
  return launch_tf32x3<128>(p, tq, tk, tv, s, grid, block, smem);
}

// bf16 q, k, v and out, d in {16, 32, 64, 128}, on flash_fwd_wgmma.
// strides as for flash_tf32x3_launch; q, k and v must have 16-byte aligned
// bases and strides that are multiples of 8 elements (dims of length 1
// aside), which the wrapper ensures (TMA's rule).
int flash_wgmma_launch(const void* q, const void* k, const void* v,
                       void* out, int64_t b, int64_t hq, int64_t hkv,
                       int64_t sq, int64_t sk, int64_t d,
                       const int64_t* strides, int64_t block_q,
                       int64_t block_k, int causal, float sm_scale,
                       void* stream, REPRO_GEOMETRY) {
  if (d != 16 && d != 32 && d != 64 && d != 128) return repro_invalid();
  const int cols = d < 64 ? static_cast<int>(d) : 64;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, hq, sq, d, strides, bf16, 2, cols, WG_ROWS) ||
      !make_map(&tk, k, b, hkv, sk, d, strides + 3, bf16, 2, cols, WG_ROWS) ||
      !make_map(&tv, v, b, hkv, sk, d, strides + 6, bf16, 2, cols, WG_ROWS))
    return repro_invalid();
  WgParams p{out, b, hq, hkv, sq, sk, strides[9], strides[10], strides[11],
             block_q, block_k, sk - sq, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = REPRO_GRID, block = REPRO_BLOCK;
  if (d == 16) return launch_wgmma<16>(p, tq, tk, tv, s, grid, block, smem);
  if (d == 32) return launch_wgmma<32>(p, tq, tk, tv, s, grid, block, smem);
  if (d == 64) return launch_wgmma<64>(p, tq, tk, tv, s, grid, block, smem);
  return launch_wgmma<128>(p, tq, tk, tv, s, grid, block, smem);
}

}  // extern "C"
