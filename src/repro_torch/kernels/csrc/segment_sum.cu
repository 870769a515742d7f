// segment_sum: GNN message aggregation on Hopper.
//
// Replaces: src/repro/kernels/segment_reduce.py, segment_sum_pallas (the
//   Pallas _segsum_kernel).  Same contract:
//     out = zeros(num_segments, d) in float32;
//     out[ids[e], :] += float(vals[e, :])  for every e with
//                                          0 <= ids[e] < num_segments.
//   Out-of-range ids, negatives included, are dropped.  vals is f32 or
//   bf16, (m, d) with unit column stride and any row stride >= d (a column
//   slice needs no copy).
//
// Bound on the H100: bytes.  Each value is read once, each id once and each
//   output written once: m*d*s + 4m read (s = 4 for f32, 2 for bf16; 8m for
//   int64 ids) and 4*n*d written.  At the minibatch_lg shape of
//   MeshGraphNet (m = 168,960, d = 128, n = 169,984, f32) that is 174 MB,
//   0.052 ms at 3.35 TB/s.
//
// Design: the TPU has no atomics, so the Pallas kernel builds a one-hot
//   (block_e x block_n) matrix per grid cell and multiplies it into the
//   output on the MXU, O(m * n * d) work.  Here the rows are reduced in
//   segment order instead, in one launch of segment_rows, with no memset
//   and no atomic into the output:
//   0. The index (kernels/segment_sum.py segment_index, plain PyTorch, once
//      per graph and reused by every aggregation over it): `order`, the
//      rows with in-range ids stably sorted by id, and `offsets`, where
//      segment s owns order[offsets[s], offsets[s + 1]).
//   1. Split.  The merge path of the segments' ends (offsets[1..n]) and
//      the sorted rows (0..R-1, R = offsets[n]) has R + n items, a row or
//      the end of a segment; a worker takes `items` consecutive ones
//      (Merrill & Garland's merge-based SpMV split), so empty segments and
//      RMAT hubs cost the same per item and every worker does equal work.
//      A worker is a group of `lanes` threads (the power of two >= d / 4,
//      at most 32) holding one column group of 4 per lane: at d = 128 a
//      warp, at d <= 4 one thread; wider rows take more column chunks.  A
//      CTA takes a ticket from the scratch's counter (as compact_lookback
//      does in frontier_compact.cu): ticket t is column chunk t / gridDim.x
//      and CTA c = t % gridDim.x of it, which holds workers [c G, (c + 1)
//      G), G = THREADS / lanes.  Warp 0 finds the CTA's two ends on the
//      path by 16-ary searches (a half-warp and a ballot a step: 3 steps at
//      3,840 segments, 6 at 2.4 million), so each worker's own binary
//      search runs only over the CTA's slice of offsets.
//   2. Rows.  A worker walks its rows in order, four at a time (their
//      values are loaded before they are added: 16-byte f32 or 8-byte bf16
//      vectors, a scalar tail for d % 4), sums in f32 registers, and at
//      each segment end writes the segment's row once with plain stores:
//      zeros for an empty one.  The one exception is its head: the first
//      segment it ends, where that segment's rows began in an earlier
//      worker.  Every output row is written by exactly one worker, the one
//      whose range holds the segment's end.
//   3. Carries, in the same launch.  A worker leaves the partial sum of
//      the segment it is inside at its range's end (its tail) in shared
//      memory.  After a barrier, a worker with a head adds to it the tails
//      of the workers before it, nearest first, for as long as the segment
//      runs through them; where it runs back past the CTA's first worker,
//      it goes on with the carries of the CTAs before, nearest first.  A
//      CTA's carry is its trailing segment's sum over its workers, in the
//      same order: its last worker writes it to carry[t] and fences; after
//      a barrier thread 0 publishes a status word (status_word.cuh) for
//      ticket t, kPrefix where the segment runs through the whole CTA (the
//      reader goes one CTA further back), else kAggregate.  A CTA publishes
//      before it waits, and waits only on lower tickets, which hold CTAs
//      that are resident or done: no deadlock, and no wait on a wait.  The
//      reader polls the word (ld.relaxed.gpu), fences, and reads the carry
//      through L2 (ld.global.cg): the writer's fence before its barrier and
//      the reader's after the word order the carry before the word.  The
//      status words are the scratch's, epoch-tagged, shared with
//      frontier_compact.cu's kernels on the same stream and never cleared.
//   The order of every addition is fixed by the split, so two calls on the
//   same inputs give the same bits.  The sums run in another order than
//   the plain version's index_add_, so the two agree to rounding, not bit
//   for bit.  Carries cost one row write per CTA and a read where a head
//   crosses a CTA: kilobytes against the output's 87 MB at minibatch_lg.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "status_word.cuh"

namespace {

constexpr int THREADS = 256;
// a worker's flags in shared memory: its first segment began in an earlier
// worker; its range holds no segment end; it ends inside a segment
constexpr uint8_t kHeadCut = 1, kPass = 2, kTail = 4;
// a worker through which its tail's segment runs back to an earlier one
constexpr uint8_t kThrough = kHeadCut | kPass;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// columns [0, cnt) of a group of 4 (cnt in 1..4, zero past it); vec: the
// group is a whole 4 at a 16-byte (f32) or 8-byte (bf16) aligned address
__device__ __forceinline__ float4 load4(const float* p, int cnt, bool vec) {
  if (vec && cnt == 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(__ldg(p), 0.f, 0.f, 0.f);
  if (cnt > 1) v.y = __ldg(p + 1);
  if (cnt > 2) v.z = __ldg(p + 2);
  if (cnt > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int cnt,
                                        bool vec) {
  if (vec && cnt == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 v = make_float4(__bfloat162float(p[0]), 0.f, 0.f, 0.f);
  if (cnt > 1) v.y = __bfloat162float(p[1]);
  if (cnt > 2) v.z = __bfloat162float(p[2]);
  if (cnt > 3) v.w = __bfloat162float(p[3]);
  return v;
}

__device__ __forceinline__ void store4(float* p, const float4& v, int cnt,
                                       bool vec) {
  if (vec && cnt == 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (cnt > 1) p[1] = v.y;
  if (cnt > 2) p[2] = v.z;
  if (cnt > 3) p[3] = v.w;
}

// The merge-path coordinate of diagonal D: the x segment ends before it
// (so D - x rows), searched in [lo, hi).  The end of segment s lies before
// D iff offsets[s + 1] + s + 1 <= D.
__device__ __forceinline__ int64_t ends_before(
    const int32_t* __restrict__ offsets, int64_t D, int64_t lo, int64_t hi) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid + 1) + mid + 1 <= D) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The same for all 32 lanes of a warp, a half-warp per diagonal (lanes
// 0-15 theirs, 16-31 theirs): each step the 16 lanes test 16 points of the
// interval and a ballot keeps the piece between the last true and the
// first false.
__device__ __forceinline__ int64_t ends_before_warp(
    const int32_t* __restrict__ offsets, int64_t n, int64_t rows,
    int64_t D) {
  const int lane = threadIdx.x & 31, k = lane & 15;
  int64_t lo = D > rows ? D - rows : 0, hi = D < n ? D : n;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int64_t len = hi - lo;
    const int64_t at = lo + (k + 1) * len / 17;
    const bool below = lo < hi && __ldg(offsets + at + 1) + at + 1 <= D;
    const unsigned votes = __ballot_sync(0xffffffffu, below) >> (lane & 16);
    const int c = __popc(votes & 0xffffu);
    if (lo < hi) {
      const int64_t next_lo = c > 0 ? lo + c * len / 17 + 1 : lo;
      hi = c < 16 ? lo + (c + 1) * len / 17 : hi;
      lo = next_lo;
    }
  }
  return lo;
}

// One CTA per ticket (see the note at the top).  out: (n, d); carry:
// (tickets, 4 lanes) f32, a CTA's carry per ticket; scratch: word 0 the
// ticket counter, words 1.. the status words.
template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_rows(const T* __restrict__ vals, const int32_t* __restrict__ order,
             const int32_t* __restrict__ offsets, float* __restrict__ out,
             float* __restrict__ carry,
             unsigned long long* __restrict__ scratch, uint32_t epoch,
             int64_t n, int64_t d, int64_t row_stride, int64_t items,
             int lanes_log2, int vec_in, int vec_out) {
  __shared__ int64_t s_ticket;
  __shared__ int64_t s_x[THREADS + 1];  // workers' first coordinates, end
  __shared__ float4 s_tail[THREADS];
  __shared__ uint8_t s_flags[THREADS];
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch) + 1;
  if (threadIdx.x == 0)
    s_ticket = atomicInc(ticket, gridDim.x * gridDim.y - 1);
  __syncthreads();
  const int64_t t = s_ticket;
  const int64_t cta = t % gridDim.x, chunk = t / gridDim.x;
  const int lanes = 1 << lanes_log2, groups = THREADS >> lanes_log2;
  const int g = threadIdx.x >> lanes_log2, lane = threadIdx.x & (lanes - 1);
  const int64_t col = (chunk << (lanes_log2 + 2)) + 4 * lane;
  const bool on = col < d;  // lanes past d add zeros and write nothing
  const int cnt = d - col < 4 ? static_cast<int>(d - col) : 4;
  const bool vi = vec_in != 0, vo = vec_out != 0;
  const int64_t rows = __ldg(offsets + n);
  const int64_t path = rows + n;
  const int64_t c0 = cta * groups * items < path ? cta * groups * items
                                                  : path;
  const int64_t c1 = c0 + groups * items < path ? c0 + groups * items : path;
  if (threadIdx.x < 32) {
    const int64_t x = ends_before_warp(offsets, n, rows,
                                       threadIdx.x < 16 ? c0 : c1);
    if (threadIdx.x == 0) s_x[0] = x;
    if (threadIdx.x == 16) s_x[groups] = x;
  }
  __syncthreads();
  const int64_t d0 = c0 + g * items < path ? c0 + g * items : path;
  const int64_t d1 = d0 + items < path ? d0 + items : path;
  if (g > 0 && lane == 0) {
    const int64_t lo = d0 - rows > s_x[0] ? d0 - rows : s_x[0];
    const int64_t hi = d0 < s_x[groups] ? d0 : s_x[groups];
    s_x[g] = ends_before(offsets, d0, lo, hi);
  }
  __syncthreads();
  int64_t x = s_x[g];
  const int64_t x_head = x, x1 = s_x[g + 1];
  const int64_t y0 = d0 - x, y1 = d1 - x1;  // this worker's rows
  const bool head_cut = x < n && __ldg(offsets + x) < y0;
  const T* src = vals + col;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero, head = zero;
  bool first = true, partial = false;  // no end yet; acc holds rows of x
  auto close = [&]() {  // the end of segment x
    if (first && head_cut) head = acc;
    else if (on) store4(out + x * d + col, acc, cnt, vo);
    first = false;
    acc = zero;
    partial = false;
  };
  int64_t end = x < n ? __ldg(offsets + x + 1) : 0;
  for (int64_t r = y0; r < y1; r += 4) {
    const int k = y1 - r < 4 ? static_cast<int>(y1 - r) : 4;
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = j < k && on ? load4(src + (int64_t)__ldg(order + r + j) *
                                            row_stride,
                                  cnt, vi)
                         : zero;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= k) break;
      while (end <= r + j) {  // segment x ends before row r + j
        close();
        end = __ldg(offsets + (++x) + 1);
      }
      add4(acc, v[j]);
      partial = true;
    }
  }
  for (; x < x1; ++x) close();  // the segment ends after the last row
  s_tail[threadIdx.x] = acc;
  if (lane == 0)
    s_flags[g] = (head_cut ? kHeadCut : 0) | (first ? kPass : 0) |
                 (partial ? kTail : 0);
  __syncthreads();

  // the CTA's carry: its trailing segment's tails, last worker first
  const int last = groups - 1;
  const bool cta_tail = (s_flags[last] & kTail) != 0;
  if (g == last && cta_tail) {
    float4 sum = acc;
    for (int j = last; j > 0 && (s_flags[j] & kThrough) == kThrough;) {
      --j;
      add4(sum, s_tail[(j << lanes_log2) + lane]);
    }
    reinterpret_cast<float4*>(carry)[t * lanes + lane] = sum;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && cta_tail) {
    __threadfence();
    int j = last;
    while (j > 0 && (s_flags[j] & kThrough) == kThrough) --j;
    publish(status + t, epoch,
            (s_flags[j] & kThrough) == kThrough ? kPrefix : kAggregate, 0);
  }

  // the head: the tails of this CTA's workers before, then the carries of
  // the CTAs before, as far back as the segment runs
  if (head_cut && !first) {
    bool back = true;
    for (int j = g; back && j > 0;) {
      --j;
      add4(head, s_tail[(j << lanes_log2) + lane]);
      back = (s_flags[j] & kThrough) == kThrough;
    }
    for (int64_t u = t - 1; back; --u) {  // same chunk: CTA 0 has no head
      uint32_t flag;
      do {
        flag = flag_of(peek(status + u), epoch);
      } while (flag == kInvalid);
      __threadfence();
      add4(head, __ldcg(reinterpret_cast<const float4*>(carry) + u * lanes +
                        lane));
      back = flag == kPrefix;
    }
    if (on) store4(out + x_head * d + col, head, cnt, vo);
  }
}

}  // namespace

extern "C" {

// vals: (m, d) with row stride row_stride (elements), f32 (bf16 = 0) or
// bf16 (bf16 = 1); order: (m,) int32 and offsets: (n + 1,) int32, the
// index (segment s owns order[offsets[s], offsets[s + 1])); out: (n, d)
// f32, contiguous, every row written; carry: (grid x * grid y, 4 <<
// lanes_log2) f32; scratch: the single-pass kernels' buffer, 1 + grid x *
// grid y int64 words at least, its ticket word clear; epoch: this call's; m, n,
// d >= 1; workers * items >= m + n.  One launch of segment_rows, THREADS
// threads a block, a worker per 1 << lanes_log2 threads, grid (ceil(workers
// / (THREADS >> lanes_log2)), chunks).  vec_in != 0 promises vals 16-byte
// (f32) or 8-byte (bf16) aligned with row_stride % 4 == 0; vec_out != 0
// promises out 16-byte aligned with d % 4 == 0.
int segment_sum_launch(const void* vals, const void* order,
                       const void* offsets, void* out, void* carry,
                       void* scratch, unsigned epoch, int64_t n, int64_t d,
                       int64_t row_stride, int64_t items, int64_t workers,
                       int lanes_log2, int bf16, int vec_in, int vec_out,
                       void* stream, REPRO_GEOMETRY) {
  if (lanes_log2 < 0 || lanes_log2 > 5 || block_x != THREADS ||
      block_y != 1 || block_z != 1 || grid_z != 1 || items < 1)
    return repro_invalid();
  const int64_t per_block = THREADS >> lanes_log2;
  const int64_t chunks = (d + (4 << lanes_log2) - 1) >> (lanes_log2 + 2);
  if (grid_x * per_block < workers ||
      (static_cast<int64_t>(grid_x) - 1) * per_block >= workers ||
      grid_y != chunks)
    return repro_invalid();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const int32_t*>(order);
  const auto* fp = static_cast<const int32_t*>(offsets);
  auto* outp = static_cast<float*>(out);
  auto* cp = static_cast<float*>(carry);
  auto* sp = static_cast<unsigned long long*>(scratch);
  if (bf16)
    segment_rows<__nv_bfloat16><<<REPRO_GRID, REPRO_BLOCK, smem, s>>>(
        static_cast<const __nv_bfloat16*>(vals), op, fp, outp, cp, sp, epoch,
        n, d, row_stride, items, lanes_log2, vec_in, vec_out);
  else
    segment_rows<float><<<REPRO_GRID, REPRO_BLOCK, smem, s>>>(
        static_cast<const float*>(vals), op, fp, outp, cp, sp, epoch, n, d,
        row_stride, items, lanes_log2, vec_in, vec_out);
  return repro_last_error();
}

}  // extern "C"
