// mutant_copy: the well-formed geometry of the static checks' mutation
// corpus, a 1-D blocked int32 copy on Hopper.
//
// Replaces: src/repro/analysis/mutants.py, _mutant_pallas (the Pallas
//   copy of grid (n // block,) with BlockSpec((block,), i -> i) in and
//   out, and an optional one-word SMEM carry added to every element).  The
//   corpus there never executes it; it records its geometry.  The port's
//   corpus does the same with this kernel's launch record, and its six
//   broken twins (repro_torch/analysis/mutants.py) are never launched:
//   only this well-formed geometry runs on the card.
//
// Bound on the H100: bytes.  Each element is read once and written once:
//   8 n bytes, at n = 4,194,304 33.6 MB, 0.010 ms at 3.35 TB/s.  A copy
//   whose input is still in the 50 MB L2 from the call before is not held
//   to that bound: it reads from L2.
//
// Design: enough bytes in flight.  A block of `block` threads owns
//   4 * VECS * block consecutive elements (4,096 at block = 256), the
//   n % 4 tail going to the block whose range holds it (the wrapper's grid
//   counts a slot for the tail only when there is one).
//   mutant_copy (no carry, x and out 16-byte aligned) is a Hopper 1-D
//   bulk copy: one thread moves the block's whole range, 16 * VECS *
//   block bytes, global -> shared -> global with cp.async.bulk (the TMA
//   engine; an mbarrier counts the bytes in), so no register holds the
//   data and each SM keeps several blocks' ranges in flight.  The carry
//   variant must add a word to every lane, so its threads move VECS
//   16-byte vectors (int4) each, all loads issued before the first store;
//   vector v of a block is thread v % block's (v / block)-th, so every
//   round of a warp is one contiguous 512-byte run.  A slice that is not
//   16-byte aligned (x[1:]) takes the scalar kernels, one element a
//   thread.  The carry word is a one-word device input (the TPU kernel's
//   carry): every block reads it and none writes it, so it carries
//   nothing between blocks, which run in no order.
//   The bulk copy is kept because it measured faster than the vector
//   copy, warm and cold (tools/compact_variants.py times it against the
//   carry kernel with a zero word and against x.clone(); PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

// 16-byte vectors a thread (kernels/mutant_copy.py VECS)
constexpr int VECS = 4;

// The block's range of whole 16-byte vectors, [first, end), through
// dynamic shared memory of that size; then the n % 4 tail, if it is ours.
__global__ void mutant_copy(const int32_t* __restrict__ x,
                            int32_t* __restrict__ out, int64_t quads,
                            int64_t n) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int64_t span = (int64_t)blockDim.x * VECS;  // vectors a block
  const int64_t first = (int64_t)blockIdx.x * span;
  const int64_t end = first + span < quads ? first + span : quads;
  if (first < end) {
    const unsigned len = static_cast<unsigned>((end - first) * 16);
    const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(buf));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(len)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(s),
        "l"(x + first * 4), "r"(len), "r"(b)
        : "memory");
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], 0; selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(b)
          : "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            out + first * 4),
        "r"(s), "r"(len)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  if (first <= quads && quads < first + span)  // the ragged tail
    for (int64_t i = quads * 4; i < n; ++i) out[i] = x[i];
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// VECS vectors a thread, all loads before the first store; the thread of
// vector slot quads copies the n % 4 tail.
__global__ void mutant_copy_carry(const int4* __restrict__ x4,
                                  const int32_t* __restrict__ carry,
                                  int4* __restrict__ out4,
                                  const int32_t* __restrict__ x,
                                  int32_t* __restrict__ out, int64_t quads,
                                  int64_t n) {
  const int32_t add = __ldg(carry);
  const int64_t first = (int64_t)blockIdx.x * blockDim.x * VECS + threadIdx.x;
  int4 v[VECS];
#pragma unroll
  for (int r = 0; r < VECS; ++r) {
    const int64_t q = first + (int64_t)r * blockDim.x;
    if (q < quads) v[r] = __ldg(x4 + q);
  }
#pragma unroll
  for (int r = 0; r < VECS; ++r) {
    const int64_t q = first + (int64_t)r * blockDim.x;
    if (q < quads) {
      out4[q] = make_int4(v[r].x + add, v[r].y + add, v[r].z + add,
                          v[r].w + add);
    } else if (q == quads) {
      for (int64_t i = quads * 4; i < n; ++i) out[i] = x[i] + add;
    }
  }
}

__global__ void mutant_copy_scalar(const int32_t* __restrict__ x,
                                   int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i];
}

__global__ void mutant_copy_carry_scalar(const int32_t* __restrict__ x,
                                         const int32_t* __restrict__ carry,
                                         int32_t* __restrict__ out,
                                         int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + __ldg(carry);
}

}  // namespace

extern "C" {

// x, out: (n,) int32, contiguous, 16-byte aligned.  A block per 4 VECS
// block elements, the n % 4 tail in the block whose range holds vector
// slot n / 4; smem = 16 VECS block bytes, the block's range.
int mutant_copy_launch(const void* x, void* out, int64_t n, void* stream,
                       REPRO_GEOMETRY) {
  if (smem != 16u * VECS * block_x || block_y != 1 || block_z != 1)
    return repro_invalid();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mutant_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mutant_copy<<<REPRO_GRID, REPRO_BLOCK, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n / 4, n);
  return repro_last_error();
}

// The same with carry: (1,) int32 on the device added to every element.
int mutant_copy_carry_launch(const void* x, const void* carry, void* out,
                             int64_t n, void* stream, REPRO_GEOMETRY) {
  mutant_copy_carry<<<REPRO_GRID, REPRO_BLOCK, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<const int32_t*>(carry),
      static_cast<int4*>(out), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(out), n / 4, n);
  return repro_last_error();
}

// x, out: (n,) int32 at any 4-byte alignment.  One thread per element.
int mutant_copy_scalar_launch(const void* x, void* out, int64_t n,
                              void* stream, REPRO_GEOMETRY) {
  mutant_copy_scalar<<<REPRO_GRID, REPRO_BLOCK, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return repro_last_error();
}

int mutant_copy_carry_scalar_launch(const void* x, const void* carry,
                                    void* out, int64_t n, void* stream,
                                    REPRO_GEOMETRY) {
  mutant_copy_carry_scalar<<<REPRO_GRID, REPRO_BLOCK, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(carry),
      static_cast<int32_t*>(out), n);
  return repro_last_error();
}

}  // extern "C"
