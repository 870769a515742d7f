// The epoch-tagged status words of the single-pass kernels (scan_lookback
// and compact_lookback in frontier_compact.cu, segment_rows in
// segment_sum.cu).  They share one scratch buffer per (device, stream):
// word 0 the ticket counter, words 1.. a status word per ticket
// (kernels/frontier_compact.py lookback_scratch).
//
// A status word: the call's epoch and a flag in the high 32 bits, a value
// in the low 32, written by one 64-bit store.  A word of another epoch
// reads as kInvalid, so the words are never cleared between calls.  The
// scans' flags: kAggregate, the tile's own sum; kPrefix, the sum of tiles
// 0..k.  segment_rows gives the two flags its own meaning.
#pragma once
#include <cstdint>

namespace {

enum : uint32_t { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

// Strong, relaxed, GPU scope: a reader that uses only the word needs no
// release or acquire (frontier_compact.cu's note); one that reads data
// written before the word fences on both sides (segment_sum.cu's note).
__device__ __forceinline__ void publish(uint64_t* word, uint32_t epoch,
                                        uint32_t flag, int32_t value) {
  const uint64_t w = (static_cast<uint64_t>(epoch << 2 | flag) << 32) |
                     static_cast<uint32_t>(value);
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

__device__ __forceinline__ uint64_t peek(const uint64_t* word) {
  uint64_t w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
               : "=l"(w)
               : "l"(word)
               : "memory");
  return w;
}

__device__ __forceinline__ uint32_t flag_of(uint64_t w, uint32_t epoch) {
  const uint32_t hi = static_cast<uint32_t>(w >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : kInvalid;
}

}  // namespace
