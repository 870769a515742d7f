// Frontier compaction on Hopper: prefix_positions, frontier_compact and
// sparse_expand — the sparse-frontier substrate of AC-4's decrement rounds.
//
// Replaces: src/repro/kernels/frontier_compact.py
//   prefix_positions        (the sequential-grid Pallas _scan_kernel with
//                            its SMEM carry),
//   frontier_compact_pallas (the scan + position scatter),
//   sparse_expand_pallas    (degree gather, scan, boundary-marker owner
//                            scan, edge gather).
//
// Bound on the H100: bytes, for all three.  There is one add per element
// and a few compares; what costs is reading each input once and writing
// each output once (3.35 TB/s).
//
// Design:
//   prefix_positions — reduce-then-scan: (1) every TILE-element tile sums
//     itself, (2) one block scans the tile sums into tile offsets and
//     writes `total` on the device (no host sync), (3) every tile scans
//     itself from its offset.  Tiles are staged through padded shared
//     memory so both the load and the store are coalesced; each thread
//     scans 16 contiguous items, a warp-shuffle scan joins the threads.
//     The input is int32 or a bool mask read as bytes, so a mask is never
//     widened in memory.  Traffic: 2 reads of the input and 1 write of the
//     output.
//   frontier_compact — compact_lookback, one launch and one pass over the
//     mask: a single-pass stream compaction with decoupled look-back, the
//     GPU form of the TPU kernel's sequential carry.  Each CTA handles one
//     COMPACT_TILE-byte tile:
//     1. Tile ticket.  The CTA takes its tile from an atomic counter, not
//        from blockIdx.x, so tile k is taken only after tiles 0..k-1 were
//        taken by CTAs that are already resident.  A CTA waits only on
//        lower tickets, and tile 0 waits on nothing, so by induction every
//        wait ends, whatever order the hardware schedules the blocks in:
//        that is the kernel's deadlock argument.  The counter is bumped
//        with atomicInc(.., gridDim.x - 1), which wraps to 0 at the last
//        ticket, so it is clear again for the next launch.
//     2. Load.  Each thread reads LB_ROUNDS 16-byte vectors of mask bytes
//        (a CTA's loads of one round are one contiguous 4 KB run).  A mask
//        whose base is not 16-byte aligned (a slice such as mask[1:])
//        takes the <false> instantiation, which reads the same bytes one
//        at a time.  Bytes are normalised to 0/1 and counted with popc.
//     3. Count and scan.  The per-thread counts of the four rounds are
//        packed into one 64-bit word, 16 bits a round (a round's block
//        total is at most 4,096, so no lane carries into the next), and
//        one block scan gives every thread its offsets in all four rounds.
//        Warp 0 publishes the tile's aggregate, looks back over the
//        predecessors 32 status words at a time (one warp lane a word)
//        until it meets an inclusive prefix, and publishes its own
//        inclusive prefix (lookback(), meant to be reused by any
//        single-pass scan of this file).  A status word is one 64-bit word
//        (epoch << 2 | flag, value) written by one store, so no reader can
//        see a flag with a stale value.  Memory order: strong relaxed
//        accesses at GPU scope, st.relaxed.gpu on publish and
//        ld.relaxed.gpu on read.  That is enough because the word carries
//        everything a reader uses: an aligned 64-bit access is
//        single-copy atomic, and no reader reads any other data that the
//        publisher wrote before it (the ids and the count are read only
//        after the launch).  A tile's two publishes go to one address
//        from one thread, so coherence keeps the prefix after the
//        aggregate.  st.release.gpu / ld.acquire.gpu would order nothing
//        more and put a fence on the look-back chain twice a tile
//        (tools/compact_variants.py times that variant; PERF.md).
//     4. Write.  Round by round, each thread stages its members' ids in
//        shared memory at its scanned offset, then the CTA writes the
//        round's run to ids[excl + ...] with coalesced stores, only the
//        slots below capacity.  Rounds that start at or past capacity are
//        skipped.
//     5. Count and sentinels.  The last tile's CTA knows `count` (its
//        inclusive prefix) and writes it.  Slots [count, capacity) get the
//        sentinel n, written by FILL CTAs that take the tickets after the
//        last tile (grid = tiles + FILL, FILL = ceil(capacity / 4,096) - 1):
//        they wait for the last tile's inclusive prefix and fill the range
//        grid-stride; with FILL = 0 (capacity <= 4,096) the last tile's CTA
//        fills it.  The fill CTAs hold later tickets than every tile, so
//        their wait cannot hold a tile back.  Measured against two
//        alternatives (the last tile's CTA filling a 256 KB range alone,
//        or a second launch) by tools/compact_variants.py; see PERF.md.
//     6. Scratch.  The status words and the ticket live in one persistent
//        buffer per (device, stream) that the wrapper keeps
//        (kernels/frontier_compact.py).  Nothing clears it between calls:
//        the ticket clears itself (1) and every status word carries the
//        call's epoch, so a word left by an earlier call reads as "not
//        published yet".  The wrapper zeroes the buffer only when it is
//        made or when the 30-bit epoch wraps.  Safe on one stream: the
//        launches that share a buffer run one after another in stream
//        order, so no two calls are in flight on it at once.  No host
//        sync: count stays on the device.  The epoch is an argument fixed
//        at launch, so a CUDA graph that captured this launch would replay
//        one epoch over its own stale words: such a capture needs the
//        status words cleared inside the graph first.
//     Traffic: the mask once, the ids and the count once; the status words
//     (8 bytes a tile) stay in L2.
//   sparse_expand — slot-parallel: after the degree gather and the scan
//     over the C compacted rows, every edge slot e finds its owning row by
//     a binary search over the exclusive degree sums (the last row whose
//     start is <= e, which skips zero-degree rows exactly as the TPU
//     kernel's boundary-marker scan does).  The search touches an (C,)
//     array that stays in L2; the slot writes are coalesced and the load
//     is even whatever the degree skew, which a row-parallel expansion
//     over RMAT's hubs would not be.  Slots e >= total are written as
//     src = tgt = pos = 0, valid = false.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

// TILE (elements per scan tile) comes from the build, -DTILE=, the same
// constant the wrapper sizes its grid with (kernels/_build.py SCAN_TILE)
#ifndef TILE
#error "frontier_compact.cu is compiled with -DTILE=<elements per tile>"
#endif
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = TILE / SCAN_THREADS;
static_assert(SCAN_ITEMS * SCAN_THREADS == TILE,
              "TILE must be a multiple of 256");
constexpr int SUM_THREADS = 1024;

// compact_lookback: COMPACT_TILE (elements per tile) comes from the build,
// -DCOMPACT_TILE=, the constant the wrapper sizes its grid with
// (kernels/_build.py COMPACT_TILE)
#ifndef COMPACT_TILE
#error "frontier_compact.cu is compiled with -DCOMPACT_TILE=<bytes a tile>"
#endif
constexpr int LB_THREADS = 256;
constexpr int LB_ROUNDS = 4;                  // 16-byte vectors a thread
constexpr int LB_ROUND = LB_THREADS * 16;     // mask bytes a round
static_assert(LB_ROUNDS * LB_ROUND == COMPACT_TILE,
              "COMPACT_TILE must be 4 rounds of 256 threads x 16 bytes");
static_assert(LB_ROUNDS * 16 <= 64, "a round's counts are 16-bit lanes");

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Inclusive scan of one value per thread across a block of NT threads.
// Every thread of the block must call it.  `warp_tot` holds NT/32 ints.
template <int NT>
__device__ __forceinline__ int32_t block_inclusive_scan(int32_t v,
                                                        int32_t* warp_tot,
                                                        int32_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int32_t t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int32_t t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < NT / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  *block_total = warp_tot[NT / 32 - 1];
  __syncthreads();  // warp_tot may be reused by the caller's next scan
  return v;
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
tile_reduce(const T* __restrict__ x, int64_t n, int32_t* __restrict__ sums) {
  __shared__ int32_t warp_tot[SCAN_THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int64_t i = base + k * SCAN_THREADS + threadIdx.x;
    if (i < n) s += static_cast<int32_t>(x[i]);
  }
  int32_t total;
  block_inclusive_scan<SCAN_THREADS>(s, warp_tot, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: tile sums -> exclusive tile offsets (in place) + the total.
__global__ void __launch_bounds__(SUM_THREADS)
scan_tile_sums(int32_t* __restrict__ sums, int64_t num,
               int32_t* __restrict__ total) {
  __shared__ int32_t warp_tot[SUM_THREADS / 32];
  int32_t carry = 0;
  for (int64_t base = 0; base < num; base += SUM_THREADS) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < num ? sums[i] : 0;
    int32_t chunk;
    const int32_t incl = block_inclusive_scan<SUM_THREADS>(v, warp_tot, &chunk);
    if (i < num) sums[i] = carry + incl - v;
    carry += chunk;
  }
  if (threadIdx.x == 0) total[0] = carry;
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan(const T* __restrict__ x, int64_t n,
          const int32_t* __restrict__ offsets, int32_t* __restrict__ out) {
  __shared__ int32_t s[TILE + TILE / 32];
  __shared__ int32_t warp_tot[SCAN_THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * TILE;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int idx = k * SCAN_THREADS + threadIdx.x;
    const int64_t i = base + idx;
    s[padded(idx)] = i < n ? static_cast<int32_t>(x[i]) : 0;
  }
  __syncthreads();
  int32_t local[SCAN_ITEMS];
  int32_t sum = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    local[k] = s[padded(threadIdx.x * SCAN_ITEMS + k)];
    sum += local[k];
  }
  int32_t tile_total;
  const int32_t incl =
      block_inclusive_scan<SCAN_THREADS>(sum, warp_tot, &tile_total);
  int32_t run = offsets[blockIdx.x] + incl - sum;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    s[padded(threadIdx.x * SCAN_ITEMS + k)] = run;
    run += local[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int idx = k * SCAN_THREADS + threadIdx.x;
    const int64_t i = base + idx;
    if (i < n) out[i] = s[padded(idx)];
  }
}

// -- single-pass scan with decoupled look-back ---------------------------
//
// A tile's status word: the call's epoch and a flag in the high 32 bits,
// the value in the low 32.  kAggregate: the tile's own sum; kPrefix: the
// sum of tiles 0..k.  A word of another epoch reads as kInvalid.
enum : uint32_t { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

// Strong, relaxed, GPU scope: see the note at the top for why no release
// or acquire is needed.
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

// The exclusive prefix of tile `tile` > 0: the sum of tiles [0, tile).
// Called by all 32 lanes of one warp after the tile published its
// aggregate; lane l reads the status word of tile end - 1 - l, the warp
// waits until all 32 are published, sums the words up to the nearest
// inclusive prefix and stops there, or steps 32 tiles further back.
__device__ int32_t lookback(const uint64_t* status, int64_t tile,
                            uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  int32_t excl = 0;
  for (int64_t end = tile;; end -= 32) {
    const int64_t idx = end - 1 - lane;
    uint32_t flag, value;
    do {
      flag = kPrefix;  // before tile 0: an empty prefix
      value = 0;
      if (idx >= 0) {
        const uint64_t w = peek(status + idx);
        flag = flag_of(w, epoch);
        value = static_cast<uint32_t>(w);
      }
    } while (__any_sync(0xffffffffu, flag == kInvalid));
    const unsigned prefix = __ballot_sync(0xffffffffu, flag == kPrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    excl += static_cast<int32_t>(
        __reduce_add_sync(0xffffffffu, lane <= stop ? value : 0u));
    if (prefix) return excl;
  }
}

// ids[s] = n for the slots s in [from, capacity) that this thread owns:
// first, first + stride, ...
__device__ __forceinline__ void fill_sentinels(int32_t* __restrict__ ids,
                                               int64_t from, int64_t capacity,
                                               int64_t n, int64_t first,
                                               int64_t stride) {
  for (int64_t s = from + first; s < capacity; s += stride)
    ids[s] = static_cast<int32_t>(n);
}

// mask bytes [at, at + 16) (zero past n) as four words of 0/1 bytes
template <bool kAligned>
__device__ __forceinline__ void load16(const uint8_t* __restrict__ mask,
                                       int64_t at, int64_t n, uint32_t w[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (kAligned && at + 16 <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + at));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (at + j < n) w[j >> 2] |= static_cast<uint32_t>(mask[at + j])
                                   << (8 * (j & 3));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __vcmpne4(w[k], 0u) & 0x01010101u;
}

// One CTA per ticket: tickets [0, tiles) compact one COMPACT_TILE-byte
// tile each, tickets [tiles, gridDim.x) fill the sentinels (see the note
// at the top).  scratch: word 0 the ticket counter, words 1.. the tiles'
// status words.
template <bool kAligned>
__global__ void __launch_bounds__(LB_THREADS)
compact_lookback(const uint8_t* __restrict__ mask, int64_t n,
                 int64_t capacity, int64_t tiles,
                 unsigned long long* __restrict__ scratch, uint32_t epoch,
                 int32_t* __restrict__ ids, int32_t* __restrict__ count) {
  __shared__ int32_t stage[LB_ROUND];
  __shared__ unsigned long long warp_tot[LB_THREADS / 32];
  __shared__ int64_t s_ticket;
  __shared__ int32_t s_excl;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch) + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const int64_t t = s_ticket;

  if (t >= tiles) {  // a fill CTA: wait for the count, then the sentinels
    if (threadIdx.x == 0) {
      uint64_t w;
      do {
        w = peek(status + tiles - 1);
      } while (flag_of(w, epoch) != kPrefix);
      s_excl = static_cast<int32_t>(w);
    }
    __syncthreads();
    fill_sentinels(ids, s_excl, capacity, n,
                   (t - tiles) * LB_THREADS + threadIdx.x,
                   (gridDim.x - tiles) * LB_THREADS);
    return;
  }

  // load and count: round r, thread i holds bytes [r * LB_ROUND + 16 i,
  // + 16) of the tile
  const int64_t base = t * COMPACT_TILE;
  uint32_t w[LB_ROUNDS][4];
  unsigned long long packed = 0;
#pragma unroll
  for (int r = 0; r < LB_ROUNDS; ++r) {
    load16<kAligned>(mask, base + r * LB_ROUND + threadIdx.x * 16, n, w[r]);
    const uint32_t c = __popc(w[r][0]) + __popc(w[r][1]) +
                       __popc(w[r][2]) + __popc(w[r][3]);
    packed |= static_cast<unsigned long long>(c) << (16 * r);
  }

  // block scan of the packed counts (lane-wise: no lane carries)
  unsigned long long incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long v = lane < LB_THREADS / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long o = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += o;
    }
    if (lane < LB_THREADS / 32) warp_tot[lane] = v;
  }
  __syncthreads();
  if (warp > 0) incl += warp_tot[warp - 1];
  const unsigned long long total = warp_tot[LB_THREADS / 32 - 1];
  const unsigned long long mine = incl - packed;
  int32_t round_total[LB_ROUNDS];
  int32_t agg = 0;
#pragma unroll
  for (int r = 0; r < LB_ROUNDS; ++r) {
    round_total[r] = static_cast<int32_t>((total >> (16 * r)) & 0xffffu);
    agg += round_total[r];
  }

  // publish, look back, publish
  if (warp == 0) {
    int32_t excl = 0;
    if (t == 0) {
      if (lane == 0) publish(status, epoch, kPrefix, agg);
    } else {
      if (lane == 0) publish(status + t, epoch, kAggregate, agg);
      excl = lookback(status, t, epoch);
      if (lane == 0) publish(status + t, epoch, kPrefix, excl + agg);
    }
    if (lane == 0) {
      s_excl = excl;
      if (t == tiles - 1) count[0] = excl + agg;
    }
  }
  __syncthreads();
  const int64_t excl = s_excl;

  // write: round by round through shared memory, coalesced
  int64_t run = excl;
#pragma unroll
  for (int r = 0; r < LB_ROUNDS; ++r) {
    if (run >= capacity) break;
    if (round_total[r] > 0) {
      int32_t off = static_cast<int32_t>((mine >> (16 * r)) & 0xffffu);
      const int64_t at = base + r * LB_ROUND + threadIdx.x * 16;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t bits = w[r][k];
        while (bits) {
          const int b = __ffs(bits) - 1;
          stage[off++] = static_cast<int32_t>(at + 4 * k + (b >> 3));
          bits &= bits - 1;
        }
      }
      __syncthreads();
      const int64_t lim = capacity - run < round_total[r]
                              ? capacity - run : round_total[r];
      for (int64_t j = threadIdx.x; j < lim; j += LB_THREADS)
        ids[run + j] = stage[j];
      __syncthreads();
    }
    run += round_total[r];
  }
  if (t == tiles - 1 && gridDim.x == tiles)  // no fill CTAs: this one fills
    fill_sentinels(ids, excl + agg, capacity, n, threadIdx.x, LB_THREADS);
}

__global__ void expand_rows(const int32_t* __restrict__ indptr,
                            const int32_t* __restrict__ ids,
                            int32_t* __restrict__ row_base,
                            int32_t* __restrict__ deg, int64_t C, int64_t n) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int32_t id = ids[c];
  const bool ok = id >= 0 && id < n;
  const int32_t rb = ok ? indptr[id] : 0;
  row_base[c] = rb;
  deg[c] = ok ? indptr[id + 1] - rb : 0;
}

__global__ void expand_slots(const int32_t* __restrict__ ids,
                             const int32_t* __restrict__ row_base,
                             const int32_t* __restrict__ excl,
                             const int32_t* __restrict__ total,
                             const int32_t* __restrict__ indices,
                             int32_t* __restrict__ src,
                             int32_t* __restrict__ tgt,
                             int32_t* __restrict__ pos,
                             uint8_t* __restrict__ valid, int64_t C,
                             int64_t ecap, int64_t m) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ecap) return;
  if (e >= total[0]) {
    src[e] = 0;
    tgt[e] = 0;
    pos[e] = 0;
    valid[e] = 0;
    return;
  }
  // first row whose exclusive start exceeds e; the owner is the one before
  int64_t lo = 0, hi = C;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (excl[mid] <= e) lo = mid + 1;
    else hi = mid;
  }
  const int64_t owner = lo - 1;
  int64_t p = row_base[owner] + (e - excl[owner]);
  p = p < 0 ? 0 : (p > m - 1 ? m - 1 : p);
  src[e] = ids[owner];
  pos[e] = static_cast<int32_t>(p);
  tgt[e] = indices[p];
  valid[e] = 1;
}

template <typename T>
int prefix_positions_impl(const T* x, int64_t n, int64_t tiles,
                          int32_t* sums, int32_t* total, int32_t* out,
                          cudaStream_t s, dim3 g0, dim3 b0, unsigned m0,
                          dim3 g1, dim3 b1, unsigned m1, dim3 g2, dim3 b2,
                          unsigned m2) {
  tile_reduce<T><<<g0, b0, m0, s>>>(x, n, sums);
  scan_tile_sums<<<g1, b1, m1, s>>>(sums, tiles, total);
  tile_scan<T><<<g2, b2, m2, s>>>(x, n, sums, out);
  return repro_last_error();
}

}  // namespace

extern "C" {

// x: (n,) int32 (x_is_u8 == 0) or uint8/bool (x_is_u8 != 0); sums:
// scratch of tiles = ceil(n / TILE) int32; total: (1,) int32; out: (n,)
// int32 exclusive prefix.  Three launches in order: tile_reduce (one
// SCAN_THREADS-thread block per tile), scan_tile_sums (one SUM_THREADS-
// thread block) and tile_scan (as tile_reduce).
int prefix_positions_launch(const void* x, int x_is_u8, int64_t n,
                            int64_t tiles, void* sums, void* total,
                            void* out, void* stream, REPRO_GEOMETRY_K(0),
                            REPRO_GEOMETRY_K(1), REPRO_GEOMETRY_K(2)) {
  if (block_x0 != SCAN_THREADS || block_x1 != SUM_THREADS ||
      block_x2 != SCAN_THREADS || block_y0 != 1 || block_z0 != 1 ||
      block_y1 != 1 || block_z1 != 1 || block_y2 != 1 || block_z2 != 1)
    return repro_invalid();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* sp = static_cast<int32_t*>(sums);
  int32_t* tp = static_cast<int32_t*>(total);
  int32_t* op = static_cast<int32_t*>(out);
  if (x_is_u8)
    return prefix_positions_impl(static_cast<const uint8_t*>(x), n, tiles,
                                 sp, tp, op, s, REPRO_GRID_K(0),
                                 REPRO_BLOCK_K(0), smem0, REPRO_GRID_K(1),
                                 REPRO_BLOCK_K(1), smem1, REPRO_GRID_K(2),
                                 REPRO_BLOCK_K(2), smem2);
  return prefix_positions_impl(static_cast<const int32_t*>(x), n, tiles, sp,
                               tp, op, s, REPRO_GRID_K(0), REPRO_BLOCK_K(0),
                               smem0, REPRO_GRID_K(1), REPRO_BLOCK_K(1),
                               smem1, REPRO_GRID_K(2), REPRO_BLOCK_K(2),
                               smem2);
}

// mask: (n,) bool, n >= 1 (aligned != 0: 16-byte aligned); scratch: the
// wrapper's persistent buffer of 1 + tiles words, ticket clear, no status
// word of `epoch` (1 <= epoch < 2^30); ids: (capacity,) int32 and count:
// (1,) int32 out.  One LB_THREADS-thread CTA per tile of COMPACT_TILE
// bytes, plus the fill CTAs (grid x - tiles).
int compact_lookback_launch(const void* mask, int aligned, int64_t n,
                            int64_t capacity, int64_t tiles, void* scratch,
                            unsigned epoch, void* ids, void* count,
                            void* stream, REPRO_GEOMETRY) {
  if (block_x != LB_THREADS || block_y != 1 || block_z != 1 ||
      grid_y != 1 || grid_z != 1 || grid_x < tiles || tiles < 1 ||
      epoch == 0 || epoch >= (1u << 30))
    return repro_invalid();
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* ip = static_cast<int32_t*>(ids);
  auto* cp = static_cast<int32_t*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  if (aligned)
    compact_lookback<true><<<REPRO_GRID, REPRO_BLOCK, smem, s>>>(
        m, n, capacity, tiles, sc, epoch, ip, cp);
  else
    compact_lookback<false><<<REPRO_GRID, REPRO_BLOCK, smem, s>>>(
        m, n, capacity, tiles, sc, epoch, ip, cp);
  return repro_last_error();
}

// ids: (C,) compacted rows (sentinel n); row_base, deg: (C,) int32 out.
// One thread per row.
int expand_rows_launch(const void* indptr, const void* ids, void* row_base,
                       void* deg, int64_t C, int64_t n, void* stream,
                       REPRO_GEOMETRY) {
  expand_rows<<<REPRO_GRID, REPRO_BLOCK, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(ids),
      static_cast<int32_t*>(row_base), static_cast<int32_t*>(deg), C, n);
  return repro_last_error();
}

// excl, total: prefix_positions of deg; src/tgt/pos: (ecap,) int32 out,
// valid: (ecap,) bool out; m >= 1.  One thread per edge slot.
int expand_slots_launch(const void* ids, const void* row_base,
                        const void* excl, const void* total,
                        const void* indices, void* src, void* tgt, void* pos,
                        void* valid, int64_t C, int64_t ecap, int64_t m,
                        void* stream, REPRO_GEOMETRY) {
  expand_slots<<<REPRO_GRID, REPRO_BLOCK, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(row_base),
      static_cast<const int32_t*>(excl), static_cast<const int32_t*>(total),
      static_cast<const int32_t*>(indices), static_cast<int32_t*>(src),
      static_cast<int32_t*>(tgt), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(valid), C, ecap, m);
  return repro_last_error();
}

}  // extern "C"
