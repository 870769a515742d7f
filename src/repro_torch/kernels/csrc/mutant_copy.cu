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
//   8 n bytes, at n = 4,194,304 33.6 MB, 0.010 ms at 3.35 TB/s.
//
// Design: one block of `block` threads per `block` elements, one element a
//   thread, the ragged tail masked.  mutant_copy_carry adds a one-word
//   device input to every element (the TPU kernel's carry word): every
//   block reads it and none writes it, so it carries nothing between
//   blocks, which run in no order.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void mutant_copy(const int32_t* __restrict__ x,
                            int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i];
}

__global__ void mutant_copy_carry(const int32_t* __restrict__ x,
                                  const int32_t* __restrict__ carry,
                                  int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + __ldg(carry);
}

}  // namespace

extern "C" {

// x, out: (n,) int32, contiguous.  One thread per element.
int mutant_copy_launch(const void* x, void* out, int64_t n, void* stream,
                       REPRO_GEOMETRY) {
  mutant_copy<<<REPRO_GRID, REPRO_BLOCK, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return repro_last_error();
}

// x, out: (n,) int32; carry: (1,) int32 on the device.
int mutant_copy_carry_launch(const void* x, const void* carry, void* out,
                             int64_t n, void* stream, REPRO_GEOMETRY) {
  mutant_copy_carry<<<REPRO_GRID, REPRO_BLOCK, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(carry),
      static_cast<int32_t*>(out), n);
  return repro_last_error();
}

}  // extern "C"
