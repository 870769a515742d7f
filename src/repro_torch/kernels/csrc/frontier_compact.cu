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
//   prefix_positions — scan_lookback, one launch and one pass: the same
//     single-pass protocol as frontier_compact's (tile tickets, decoupled
//     look-back over epoch-tagged status words, steps 1, 3 and 6 below)
//     on TILE-element tiles.  Each warp owns SCAN_ROUNDS runs of 128
//     elements of its tile; in each round a lane loads the 4 consecutive
//     elements it owns (one 16-byte vector of int32, or 4 mask bytes
//     normalised to 0/1, so a mask is never widened in memory; a base
//     that is not aligned, such as x[1:], takes the <false> instantiation
//     and element loads), and a warp-shuffle scan gives each lane its
//     offset within the round.  Warp 0 scans the warps' sums, publishes
//     the tile's aggregate, looks back with lookback() and publishes the
//     inclusive prefix; every lane then writes its quads, in place, as
//     16-byte stores.  The last tile's CTA writes `total` (no host sync).
//     The scratch is frontier_compact's own buffer: launches on one
//     stream run in order, so the two kernels never hold it at once, and
//     the epoch tells each call's words from the other kernel's.
//     Traffic: 1 read of the input and 1 write of the output.
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
#include "status_word.cuh"

namespace {

// TILE (elements per scan tile) comes from the build, -DTILE=, the same
// constant the wrapper sizes its grid with (kernels/_build.py SCAN_TILE)
#ifndef TILE
#error "frontier_compact.cu is compiled with -DTILE=<elements per tile>"
#endif
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
// quads (4 consecutive elements) a lane scans: round r of warp w covers
// tile elements [w * WARP_SPAN + 128 r, + 128), lane l the quad at 4 l
constexpr int SCAN_ROUNDS = TILE / (SCAN_THREADS * 4);
constexpr int WARP_SPAN = 128 * SCAN_ROUNDS;
static_assert(SCAN_ROUNDS * SCAN_THREADS * 4 == TILE,
              "TILE must be a multiple of 1024");

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

// -- single-pass scan with decoupled look-back ---------------------------
//
// The status words: status_word.cuh (publish, peek, flag_of).

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

// x[at, at + 4) as int32 (zero past n); a mask's bytes normalised to 0/1.
// kAligned: x is 16-byte (int32) or 4-byte (mask) aligned, so a quad that
// lies below n is one vector load; otherwise (a slice such as x[1:]) the
// quad is read an element at a time.
template <bool kAligned>
__device__ __forceinline__ int4 load_quad(const int32_t* __restrict__ x,
                                          int64_t at, int64_t n) {
  if (kAligned && at + 4 <= n)
    return __ldg(reinterpret_cast<const int4*>(x + at));
  int4 q = make_int4(0, 0, 0, 0);
  if (at < n) q.x = x[at];
  if (at + 1 < n) q.y = x[at + 1];
  if (at + 2 < n) q.z = x[at + 2];
  if (at + 3 < n) q.w = x[at + 3];
  return q;
}

template <bool kAligned>
__device__ __forceinline__ int4 load_quad(const uint8_t* __restrict__ x,
                                          int64_t at, int64_t n) {
  uint32_t w = 0u;
  if (kAligned && at + 4 <= n) {
    w = __ldg(reinterpret_cast<const uint32_t*>(x + at));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (at + j < n) w |= static_cast<uint32_t>(x[at + j]) << (8 * j);
  }
  w = __vcmpne4(w, 0u) & 0x01010101u;
  return make_int4(w & 1u, (w >> 8) & 1u, (w >> 16) & 1u, w >> 24);
}

// prefix_positions in one launch: the exclusive prefix sum of x and its
// total, single-pass with decoupled look-back (see the note at the top).
// One CTA per ticket, a tile of TILE elements each.  scratch: the same
// buffer as compact_lookback's (word 0 the ticket, words 1.. the status
// words).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_lookback(const T* __restrict__ x, int64_t n, int64_t tiles,
              unsigned long long* __restrict__ scratch, uint32_t epoch,
              int32_t* __restrict__ out, int32_t* __restrict__ total) {
  __shared__ int32_t warp_excl[SCAN_WARPS];
  __shared__ int64_t s_ticket;
  __shared__ int32_t s_excl;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch) + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const int64_t t = s_ticket;
  const int64_t base = t * TILE + warp * WARP_SPAN + 4 * lane;

  // load and scan round by round: each round is one coalesced 2 KB (int32)
  // or 512-byte (mask) run of the warp; a lane's offset in its warp is the
  // rounds before plus its lanes before
  int4 q[SCAN_ROUNDS];
  int32_t lane_excl[SCAN_ROUNDS];
  int32_t warp_sum = 0;
#pragma unroll
  for (int r = 0; r < SCAN_ROUNDS; ++r) {
    q[r] = load_quad<kAligned>(x, base + 128 * r, n);
    const int32_t s = q[r].x + q[r].y + q[r].z + q[r].w;
    int32_t incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    lane_excl[r] = warp_sum + incl - s;
    warp_sum += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) warp_excl[warp] = warp_sum;
  __syncthreads();

  // warp 0: the warps' offsets, then publish, look back, publish
  if (warp == 0) {
    const int32_t v = lane < SCAN_WARPS ? warp_excl[lane] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < SCAN_WARPS; d <<= 1) {
      const int32_t o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    const int32_t agg = __shfl_sync(0xffffffffu, incl, SCAN_WARPS - 1);
    if (lane < SCAN_WARPS) warp_excl[lane] = incl - v;
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
      if (t == tiles - 1) total[0] = excl + agg;
    }
  }
  __syncthreads();

  // write: each lane its quads at the positions it read (out is 16-byte
  // aligned and every quad starts at a multiple of 4)
  const int32_t off = s_excl + warp_excl[warp];
#pragma unroll
  for (int r = 0; r < SCAN_ROUNDS; ++r) {
    const int64_t at = base + 128 * r;
    int4 o;
    o.x = off + lane_excl[r];
    o.y = o.x + q[r].x;
    o.z = o.y + q[r].y;
    o.w = o.z + q[r].z;
    if (at + 4 <= n) {
      *reinterpret_cast<int4*>(out + at) = o;
    } else {
      if (at < n) out[at] = o.x;
      if (at + 1 < n) out[at + 1] = o.y;
      if (at + 2 < n) out[at + 2] = o.z;
    }
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
void scan(const void* x, int aligned, int64_t n, int64_t tiles,
          unsigned long long* scratch, unsigned epoch, int32_t* out,
          int32_t* total, cudaStream_t s, dim3 grid, dim3 block,
          unsigned smem) {
  const T* xp = static_cast<const T*>(x);
  if (aligned)
    scan_lookback<T, true><<<grid, block, smem, s>>>(xp, n, tiles, scratch,
                                                     epoch, out, total);
  else
    scan_lookback<T, false><<<grid, block, smem, s>>>(xp, n, tiles, scratch,
                                                      epoch, out, total);
}

}  // namespace

extern "C" {

// x: (n,) int32 (x_is_u8 == 0) or uint8/bool (x_is_u8 != 0), n >= 1
// (aligned != 0: 16-byte aligned for int32, 4-byte for a mask); scratch:
// the wrapper's persistent buffer of 1 + tiles words, shared with
// compact_lookback, ticket clear, no status word of `epoch` (1 <= epoch <
// 2^30); out: (n,) int32 exclusive prefix and total: (1,) int32 out.  One
// launch of scan_lookback, one SCAN_THREADS-thread CTA per tile of TILE
// elements.
int scan_lookback_launch(const void* x, int x_is_u8, int aligned, int64_t n,
                         int64_t tiles, void* scratch, unsigned epoch,
                         void* out, void* total, void* stream,
                         REPRO_GEOMETRY) {
  if (block_x != SCAN_THREADS || block_y != 1 || block_z != 1 ||
      grid_x != tiles || grid_y != 1 || grid_z != 1 || tiles < 1 ||
      epoch == 0 || epoch >= (1u << 30))
    return repro_invalid();
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* op = static_cast<int32_t*>(out);
  auto* tp = static_cast<int32_t*>(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_u8)
    scan<uint8_t>(x, aligned, n, tiles, sc, epoch, op, tp, s, REPRO_GRID,
                  REPRO_BLOCK, smem);
  else
    scan<int32_t>(x, aligned, n, tiles, sc, epoch, op, tp, s, REPRO_GRID,
                  REPRO_BLOCK, smem);
  return repro_last_error();
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
