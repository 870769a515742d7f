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
//   prefix_positions — the TPU carries the running sum from one grid step
//     to the next in SMEM.  Hopper blocks run in no order, so that becomes
//     reduce-then-scan: (1) every TILE-element tile sums itself, (2) one
//     block scans the tile sums into tile offsets and writes `total` on
//     the device (no host sync), (3) every tile scans itself from its
//     offset.  Tiles are staged through padded shared memory so both the
//     load and the store are coalesced; each thread scans 16 contiguous
//     items, a warp-shuffle scan joins the threads.  The input is int32 or
//     a bool mask read as bytes, so a mask is never widened in memory.
//     Traffic: 2 reads of the input and 1 write of the output.
//   frontier_compact — one kernel after the scan: slot j >= count gets the
//     sentinel n, member i writes ids[pos[i]] = i when pos[i] < capacity.
//     The two sets of writes never overlap, so there is no ordering to
//     enforce and no separate fill pass.
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

__global__ void compact_fill(const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ pos,
                             const int32_t* __restrict__ count,
                             int32_t* __restrict__ ids, int64_t n,
                             int64_t capacity) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < capacity && t >= count[0]) ids[t] = static_cast<int32_t>(n);
  if (t < n && mask[t]) {
    const int32_t p = pos[t];
    if (p < capacity) ids[p] = static_cast<int32_t>(t);
  }
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

// mask: (n,) bool; pos, count: prefix_positions of the mask; ids:
// (capacity,) int32 output.  One thread per slot of max(n, capacity).
int compact_fill_launch(const void* mask, const void* pos, const void* count,
                        void* ids, int64_t n, int64_t capacity, void* stream,
                        REPRO_GEOMETRY) {
  compact_fill<<<REPRO_GRID, REPRO_BLOCK, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(count), static_cast<int32_t*>(ids), n,
      capacity);
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
