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
//   sparse_expand — expand_lookback, one launch: the degree gather, its
//     scan and the slot expansion, with the same tickets, look-back and
//     scratch as above (1, 3, 6).  A CTA is one of two kinds, by ticket:
//     7. Row CTAs, tickets [0, R), R = ceil(C / EXPAND_ROW_TILE).  Each
//        gathers (row_base, deg) of its tile of ids from indptr (an id
//        outside [0, n), such as the sentinel n, has deg 0), scans the
//        degrees (warp-shuffle scans, as scan_lookback), looks back for its
//        exclusive edge base and publishes its inclusive prefix as the
//        scans do (self-contained words); the last row tile also writes
//        the total.  Then it writes (excl, row_base) of its rows to the
//        call's (C,) int2 buffer `rows` and publishes a done word.
//     8. Slot CTAs, tickets [R, R + W), W = min(S, the wrapper's
//        EXPAND_SLOT_CTAS_PER_SM x SMs), S = ceil(ecap / EXPAND_SLOT_TILE)
//        slot tiles.  Each waits once for the total (a word the last row
//        tile writes right after its look-back), polling with a backoff,
//        then takes slot tiles from a counter in order until none is left,
//        so the tiles below total (real work) go out first and the zero
//        padding after them spreads over whichever CTAs are free.  Slots
//        at or past total are zero padding, written with 16-byte stores.
//        For a tile below total, two warps find the row tiles that own its
//        first and last slot by a 32-ary search over the row tiles'
//        prefixes (one step at R <= 32, two at R <= 1,024); the CTA stages
//        those row tiles' (excl, row_base), at most EXPAND_STAGE rows at a
//        time, in shared memory, and each thread finds the owners of its
//        slots e (the last staged row with excl <= e, which skips
//        zero-degree rows) by binary searches there, then issues all its
//        slots' gathers at once: src = ids[owner], pos = row_base + e -
//        excl clamped to [0, m - 1], tgt = indices[pos], valid = 1, stored
//        coalesced (consecutive lanes take consecutive slots, so the slots
//        of one row gather a contiguous run of indices).  A hub row spreads
//        over as many slot tiles as its edges fill.
//     Deadlock: slot CTAs hold later tickets than every row tile and wait
//     only on them, as the fill CTAs of compact_lookback do (5).
//     Memory order.  Unlike the scans, a slot CTA reads data that other
//     CTAs wrote before they published: `rows`.  The prefixes and the
//     total are self-contained (relaxed, as in 3), but the done word is a
//     release: every thread of a row tile fences (__threadfence) after its
//     writes to `rows`, the CTA meets at a barrier, and thread 0 fences
//     again and publishes the word (st.relaxed.gpu: fence + strong store
//     is a release pattern).  A slot CTA's lanes poll the done words of the
//     row tiles it stages (ld.relaxed.gpu) until they carry kPrefix, fence
//     (an acquire pattern), meet the CTA at a barrier, and only then read
//     `rows`, through L2 (ld.global.cg).  tools/kernel_ab.py --sweep times
//     the row and slot tiles; PERF.md records them and the fences' cost.
//     Traffic: ids, two indptr words per real id, the indices of the
//     total slots, and the (ecap,) outputs once; `rows` (8 bytes a row)
//     and the status words stay in L2.
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

// expand_lookback: EXPAND_ROW_TILE ids a row CTA and EXPAND_SLOT_TILE slots
// a slot CTA come from the build (-DEXPAND_ROW_TILE=, -DEXPAND_SLOT_TILE=,
// kernels/_build.py), as the wrapper sizes its grid with them
#if !defined(EXPAND_ROW_TILE) || !defined(EXPAND_SLOT_TILE)
#error "frontier_compact.cu is compiled with -DEXPAND_ROW_TILE=, -DEXPAND_SLOT_TILE="
#endif
constexpr int EX_THREADS = 256;
constexpr int EX_WARPS = EX_THREADS / 32;
// ids a lane gathers: round r of warp w covers tile rows
// [w * EX_WARP_SPAN + 32 r, + 32), lane l the row at 32 r + l
constexpr int EX_ROUNDS = EXPAND_ROW_TILE / EX_THREADS;
constexpr int EX_WARP_SPAN = 32 * EX_ROUNDS;
static_assert(EX_ROUNDS * EX_THREADS == EXPAND_ROW_TILE,
              "EXPAND_ROW_TILE must be a multiple of 256");
// rows a slot CTA stages at once: whole row tiles, 16 KB of shared memory
constexpr int EXPAND_STAGE = 2048;
constexpr int EX_STAGE_TILES = EXPAND_STAGE / EXPAND_ROW_TILE;
static_assert(EX_STAGE_TILES >= 1 && EXPAND_STAGE % EXPAND_ROW_TILE == 0,
              "EXPAND_ROW_TILE must divide 2048");
// scratch words of expand_lookback: the ticket (word 0; its high half
// counts the slot tiles handed out, which no other kernel touches), the
// total (word EX_TOTAL) and the row tiles' status words from EX_STATUS,
// then their done words; the total and the status words each on a
// 128-byte line of their own, so the CTAs that wait for the total do not
// poll the line that the look-back reads.  EX_STATUS comes from the build
// (-DEX_STATUS=, kernels/_build.py EXPAND_STATUS_AT), as the wrapper sizes
// the scratch with it
#ifndef EX_STATUS
#error "frontier_compact.cu is compiled with -DEX_STATUS=<first status word>"
#endif
constexpr int EX_TOTAL = 16;
static_assert(EX_STATUS % 16 == 0 && EX_STATUS >= EX_TOTAL + 16,
              "the status words start on a 128-byte line after the total's");
static_assert(EXPAND_SLOT_TILE % EX_THREADS == 0,
              "EXPAND_SLOT_TILE must be a multiple of 256");
// slots of a slot tile a thread takes: e0 + threadIdx.x + EX_THREADS r
constexpr int EX_SLOTS = EXPAND_SLOT_TILE / EX_THREADS;

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

// the inclusive prefix of row tile `idx` once it is published: polls with
// a backoff that doubles from 32 ns to 1 us, so that hundreds of slot CTAs
// waiting on one word leave its L2 slice to the row tiles' look-back
__device__ __forceinline__ int64_t wait_prefix(const uint64_t* status,
                                               int64_t idx, uint32_t epoch) {
  uint64_t w = peek(status + idx);
  for (unsigned ns = 32; flag_of(w, epoch) != kPrefix;
       ns = min(2 * ns, 1024u)) {
    __nanosleep(ns);
    w = peek(status + idx);
  }
  return static_cast<int64_t>(static_cast<uint32_t>(w));
}

// The least row tile k in [0, R] whose inclusive prefix exceeds e (R when
// none): a 32-ary search over the published prefixes, by all 32 lanes of
// one warp.  Each step waits only for the words it probes.
__device__ int64_t tile_of(const uint64_t* status, int64_t R, uint32_t epoch,
                           int64_t e) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = R;
  while (lo < hi) {
    const int64_t stride = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * stride - 1;
    const bool above = p < hi && wait_prefix(status, p, epoch) > e;
    const unsigned b = __ballot_sync(0xffffffffu, above);
    if (b) {
      const int l = __ffs(b) - 1;
      hi = lo + (l + 1) * stride - 1;
      lo += l * stride;
    } else {
      const int64_t probed = (hi - lo) / stride;
      lo += (probed < 32 ? probed : 32) * stride;
    }
  }
  return lo;
}

// src, tgt, pos, valid = 0 on the slots [a, b): 16-byte stores between
// scalar heads and tails (the four outputs are 16-byte aligned)
__device__ void zero_slots(int32_t* __restrict__ src, int32_t* __restrict__ tgt,
                           int32_t* __restrict__ pos,
                           uint8_t* __restrict__ valid, int64_t a, int64_t b) {
  if (a >= b) return;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  int64_t lo = (a + 3) & ~int64_t(3), hi = b & ~int64_t(3);
  if (lo > hi) lo = hi = b;
  for (int64_t e = a + threadIdx.x; e < lo; e += blockDim.x)
    src[e] = tgt[e] = pos[e] = 0;
  for (int64_t e = hi + threadIdx.x; e < b; e += blockDim.x)
    src[e] = tgt[e] = pos[e] = 0;
  for (int64_t q = lo / 4 + threadIdx.x; q < hi / 4; q += blockDim.x) {
    reinterpret_cast<uint4*>(src)[q] = z;
    reinterpret_cast<uint4*>(tgt)[q] = z;
    reinterpret_cast<uint4*>(pos)[q] = z;
  }
  lo = (a + 15) & ~int64_t(15);
  hi = b & ~int64_t(15);
  if (lo > hi) lo = hi = b;
  for (int64_t e = a + threadIdx.x; e < lo; e += blockDim.x) valid[e] = 0;
  for (int64_t e = hi + threadIdx.x; e < b; e += blockDim.x) valid[e] = 0;
  for (int64_t q = lo / 16 + threadIdx.x; q < hi / 16; q += blockDim.x)
    reinterpret_cast<uint4*>(valid)[q] = z;
}

// The slots [e0, real_end) of one slot tile, all below total: the owning
// row tiles by tile_of(), then chunks of at most EX_STAGE_TILES row tiles
// staged in shared memory, the owner of each slot by a binary search
// there.  Called by the whole CTA.
__device__ void expand_slots(const uint64_t* status, const uint64_t* done,
                             int64_t R, uint32_t epoch,
                             const int32_t* __restrict__ ids,
                             const int32_t* __restrict__ indices, int64_t m,
                             int64_t C, const int2* __restrict__ rows,
                             int32_t* __restrict__ src,
                             int32_t* __restrict__ tgt,
                             int32_t* __restrict__ pos,
                             uint8_t* __restrict__ valid, int64_t e0,
                             int64_t real_end, int32_t* s_excl,
                             int32_t* s_base, int64_t* s_tile, int64_t& s_lo,
                             int64_t& s_hi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the CTA's last tile is done with the shared words
  if (warp < 2) {     // warp 0 the first slot's row tile, warp 1 the last's
    const int64_t k = tile_of(status, R, epoch, warp ? real_end - 1 : e0);
    if (lane == 0) s_tile[warp] = k;
  }
  __syncthreads();
  const int64_t t_first = s_tile[0], t_last = s_tile[1];
  for (int64_t k = t_first; k <= t_last; k += EX_STAGE_TILES) {
    const int64_t k_end = min(k + EX_STAGE_TILES, t_last + 1);
    if (warp == 0) {
      // acquire: the staged tiles' done words and the one before them
      const int64_t w = k - 1 + lane;
      int64_t v = 0;
      if (w >= 0 && w < k_end) v = wait_prefix(done, w, epoch);
      __threadfence();
      const int64_t lo = __shfl_sync(0xffffffffu, v, 0);
      const int64_t hi = __shfl_sync(0xffffffffu, v,
                                     static_cast<int>(k_end - k));
      if (lane == 0) {
        s_lo = lo;  // excl of the first staged row (0 before tile 0)
        s_hi = hi;  // excl of the row after the staged ones
      }
    }
    __syncthreads();
    const int64_t r_lo = k * EXPAND_ROW_TILE;
    const int64_t cnt = min(k_end * EXPAND_ROW_TILE, C) - r_lo;
    for (int64_t q = threadIdx.x; q < cnt; q += EX_THREADS) {
      const int2 v = __ldcg(rows + r_lo + q);
      s_excl[q] = v.x;
      s_base[q] = v.y;
    }
    __syncthreads();
    // the thread's slots e0 + threadIdx.x + EX_THREADS r of this chunk:
    // every owner first (shared memory only), then all their gathers at
    // once, then the stores
    const int64_t lo = max(s_lo, e0), hi = min(s_hi, real_end);
    int32_t own[EX_SLOTS];
    int64_t at[EX_SLOTS];
#pragma unroll
    for (int r = 0; r < EX_SLOTS; ++r) {
      const int64_t e = e0 + threadIdx.x + EX_THREADS * r;
      own[r] = -1;
      if (e >= lo && e < hi) {
        // the last staged row whose excl <= e
        int32_t a = 0, b = static_cast<int32_t>(cnt);
        while (b - a > 1) {
          const int32_t mid = (a + b) >> 1;
          if (s_excl[mid] <= e) a = mid;
          else b = mid;
        }
        const int64_t p = s_base[a] + (e - s_excl[a]);
        at[r] = p < 0 ? 0 : (p > m - 1 ? m - 1 : p);
        own[r] = a;
      }
    }
    int32_t who[EX_SLOTS], to[EX_SLOTS];
#pragma unroll
    for (int r = 0; r < EX_SLOTS; ++r)
      if (own[r] >= 0) {
        who[r] = ids[r_lo + own[r]];
        to[r] = indices[at[r]];
      }
#pragma unroll
    for (int r = 0; r < EX_SLOTS; ++r)
      if (own[r] >= 0) {
        const int64_t e = e0 + threadIdx.x + EX_THREADS * r;
        src[e] = who[r];
        pos[e] = static_cast<int32_t>(at[r]);
        tgt[e] = to[r];
        valid[e] = 1;
      }
    __syncthreads();
  }
}

// sparse_expand in one launch (steps 7 and 8 of the note at the top).  One
// CTA per ticket: tickets [0, R) are row tiles, [R, gridDim.x) slot tiles.
// scratch: compact_lookback's buffer (word 0 the ticket, words 1.. the row
// tiles' status words); rows: the call's (C,) (excl, row_base) buffer.
__global__ void __launch_bounds__(EX_THREADS)
expand_lookback(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const int32_t* __restrict__ ids, int64_t n, int64_t m,
                int64_t C, int64_t ecap, int64_t R,
                unsigned long long* __restrict__ scratch, uint32_t epoch,
                int2* __restrict__ rows, int32_t* __restrict__ src,
                int32_t* __restrict__ tgt, int32_t* __restrict__ pos,
                uint8_t* __restrict__ valid) {
  __shared__ int32_t s_excl[EXPAND_STAGE];
  __shared__ int32_t s_base[EXPAND_STAGE];
  __shared__ int32_t warp_excl[EX_WARPS];
  __shared__ int64_t s_ticket, s_total, s_lo, s_hi, s_tile[2];
  __shared__ int32_t s_excl0;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  uint64_t* total_word = reinterpret_cast<uint64_t*>(scratch) + EX_TOTAL;
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch) + EX_STATUS;
  uint64_t* done = status + R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const int64_t t = s_ticket;

  if (t < R) {  // a row tile
    const int64_t row0 = t * EXPAND_ROW_TILE + warp * EX_WARP_SPAN + lane;
    int32_t id[EX_ROUNDS], rb[EX_ROUNDS], dg[EX_ROUNDS];
#pragma unroll
    for (int r = 0; r < EX_ROUNDS; ++r) {
      const int64_t c = row0 + 32 * r;
      id[r] = c < C ? ids[c] : -1;
    }
#pragma unroll
    for (int r = 0; r < EX_ROUNDS; ++r) {
      const bool ok = id[r] >= 0 && id[r] < n;
      rb[r] = ok ? indptr[id[r]] : 0;
      dg[r] = ok ? indptr[id[r] + 1] - rb[r] : 0;
    }
    int32_t lane_excl[EX_ROUNDS];
    int32_t warp_sum = 0;
#pragma unroll
    for (int r = 0; r < EX_ROUNDS; ++r) {
      int32_t incl = dg[r];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      lane_excl[r] = warp_sum + incl - dg[r];
      warp_sum += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) warp_excl[warp] = warp_sum;
    __syncthreads();
    if (warp == 0) {
      const int32_t v = lane < EX_WARPS ? warp_excl[lane] : 0;
      int32_t incl = v;
#pragma unroll
      for (int d = 1; d < EX_WARPS; d <<= 1) {
        const int32_t o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      const int32_t agg = __shfl_sync(0xffffffffu, incl, EX_WARPS - 1);
      if (lane < EX_WARPS) warp_excl[lane] = incl - v;
      int32_t excl = 0;
      if (t > 0) {
        if (lane == 0) publish(status + t, epoch, kAggregate, agg);
        excl = lookback(status, t, epoch);
      }
      if (lane == 0) {
        publish(status + t, epoch, kPrefix, excl + agg);
        if (t == R - 1) publish(total_word, epoch, kPrefix, excl + agg);
        s_excl0 = excl;
        s_lo = excl + agg;
      }
    }
    __syncthreads();
    const int32_t off = s_excl0 + warp_excl[warp];
#pragma unroll
    for (int r = 0; r < EX_ROUNDS; ++r) {
      const int64_t c = row0 + 32 * r;
      if (c < C) rows[c] = make_int2(off + lane_excl[r], rb[r]);
    }
    // release: the rows before the done word (see the note at the top)
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      publish(done + t, epoch, kPrefix, static_cast<int32_t>(s_lo));
    }
    return;
  }

  // a slot CTA: slot tiles from the counter, in order, until none is left
  if (threadIdx.x == 0) s_total = wait_prefix(total_word, 0, epoch);
  const int64_t tiles = (ecap + EXPAND_SLOT_TILE - 1) / EXPAND_SLOT_TILE;
  unsigned* next = ticket + 1;  // the ticket word's high half
  for (;;) {
    __syncthreads();  // s_total set; s_ticket free again
    if (threadIdx.x == 0)
      s_ticket = atomicInc(next, static_cast<unsigned>(tiles + gridDim.x - R
                                                       - 1));
    __syncthreads();
    const int64_t st = s_ticket;
    if (st >= tiles) break;
    const int64_t total = s_total;
    const int64_t e0 = st * EXPAND_SLOT_TILE;
    const int64_t e_end = min(e0 + EXPAND_SLOT_TILE, ecap);
    const int64_t real_end = min(e_end, total);
    if (e0 < real_end)
      expand_slots(status, done, R, epoch, ids, indices, m, C, rows, src,
                   tgt, pos, valid, e0, real_end, s_excl, s_base, s_tile,
                   s_lo, s_hi);
    zero_slots(src, tgt, pos, valid, max(e0, total), e_end);
  }
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

// indptr: (n + 1,) int32, n >= 1; indices: (m,) int32, m >= 1; ids: (C,)
// int32 compacted rows (sentinel n), C >= 1; R = ceil(C / EXPAND_ROW_TILE)
// row tiles; scratch: the wrapper's persistent buffer of EX_STATUS + 2 R
// words,
// ticket clear, no status word of `epoch` (1 <= epoch < 2^30); rows: (C,)
// int2 scratch of the call; src, tgt, pos: (ecap,) int32 and valid:
// (ecap,) bool out, each 16-byte aligned, ecap >= 1.  One EX_THREADS-thread
// CTA per row tile, then grid x - R slot CTAs (at most one per slot tile of
// EXPAND_SLOT_TILE), each taking every (grid x - R)-th slot tile.
int expand_lookback_launch(const void* indptr, const void* indices,
                           const void* ids, int64_t n, int64_t m, int64_t C,
                           int64_t ecap, int64_t R, void* scratch,
                           unsigned epoch, void* rows, void* src, void* tgt,
                           void* pos, void* valid, void* stream,
                           REPRO_GEOMETRY) {
  const int64_t slots = (ecap + EXPAND_SLOT_TILE - 1) / EXPAND_SLOT_TILE;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(tgt) |
                         reinterpret_cast<uintptr_t>(pos) |
                         reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
  if (block_x != EX_THREADS || block_y != 1 || block_z != 1 ||
      grid_y != 1 || grid_z != 1 || n < 1 || m < 1 || C < 1 || ecap < 1 ||
      R != (C + EXPAND_ROW_TILE - 1) / EXPAND_ROW_TILE || grid_x <= R ||
      grid_x > R + slots || !aligned || epoch == 0 || epoch >= (1u << 30))
    return repro_invalid();
  expand_lookback<<<REPRO_GRID, REPRO_BLOCK, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(indices), static_cast<const int32_t*>(ids),
      n, m, C, ecap, R, static_cast<unsigned long long*>(scratch), epoch,
      static_cast<int2*>(rows), static_cast<int32_t*>(src),
      static_cast<int32_t*>(tgt), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(valid));
  return repro_last_error();
}

}  // extern "C"
