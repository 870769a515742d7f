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
//     reduce-then-scan: (1) every 4096-element tile sums itself, (2) one
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

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;  // 4096 elements
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

template <typename T>
void prefix_positions_impl(const T* x, int32_t* out, int32_t* total,
                           int32_t* tile_sums, int64_t n, cudaStream_t s) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  tile_reduce<T><<<static_cast<unsigned>(tiles), SCAN_THREADS, 0, s>>>(
      x, n, tile_sums);
  scan_tile_sums<<<1, SUM_THREADS, 0, s>>>(tile_sums, tiles, total);
  tile_scan<T><<<static_cast<unsigned>(tiles), SCAN_THREADS, 0, s>>>(
      x, n, tile_sums, out);
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

inline unsigned blocks_for(int64_t work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (n,) int32 (x_is_u8 == 0) or uint8/bool (x_is_u8 != 0); out: (n,)
// int32 exclusive prefix; total: (1,) int32; tile_sums: scratch of
// ceil(n / 4096) int32.  n >= 1.
int prefix_positions_launch(const void* x, int x_is_u8, void* out,
                            void* total, void* tile_sums, int64_t n,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_u8)
    prefix_positions_impl(static_cast<const uint8_t*>(x),
                          static_cast<int32_t*>(out),
                          static_cast<int32_t*>(total),
                          static_cast<int32_t*>(tile_sums), n, s);
  else
    prefix_positions_impl(static_cast<const int32_t*>(x),
                          static_cast<int32_t*>(out),
                          static_cast<int32_t*>(total),
                          static_cast<int32_t*>(tile_sums), n, s);
  return static_cast<int>(cudaGetLastError());
}

int prefix_positions_tile() { return TILE; }

// mask: (n,) bool; pos, count: prefix_positions of the mask; ids:
// (capacity,) int32 output.  n >= 1, capacity >= 1.
int frontier_compact_launch(const void* mask, const void* pos,
                            const void* count, void* ids, int64_t n,
                            int64_t capacity, void* stream) {
  const int threads = 256;
  const int64_t work = n > capacity ? n : capacity;
  compact_fill<<<blocks_for(work, threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(count), static_cast<int32_t*>(ids), n,
      capacity);
  return static_cast<int>(cudaGetLastError());
}

// ids: (C,) compacted rows (sentinel n); row_base, deg: (C,) int32 out.
int sparse_expand_rows_launch(const void* indptr, const void* ids,
                              void* row_base, void* deg, int64_t C, int64_t n,
                              void* stream) {
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  expand_rows<<<blocks_for(C, threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(ids),
      static_cast<int32_t*>(row_base), static_cast<int32_t*>(deg), C, n);
  return static_cast<int>(cudaGetLastError());
}

// excl, total: prefix_positions of deg; src/tgt/pos: (ecap,) int32 out,
// valid: (ecap,) bool out.  m >= 1, ecap >= 1.
int sparse_expand_slots_launch(const void* ids, const void* row_base,
                               const void* excl, const void* total,
                               const void* indices, void* src, void* tgt,
                               void* pos, void* valid, int64_t C, int64_t ecap,
                               int64_t m, void* stream) {
  const int threads = 256;
  expand_slots<<<blocks_for(ecap, threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(row_base),
      static_cast<const int32_t*>(excl), static_cast<const int32_t*>(total),
      static_cast<const int32_t*>(indices), static_cast<int32_t*>(src),
      static_cast<int32_t*>(tgt), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(valid), C, ecap, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
