// Sorted segment sum for Hopper (sm_90a): the transpose of the dedup
// expansion (K4).
//
// Replaces the TPU kernel gnnflow_tpu/ops/segment_pallas.py:
// sorted_segment_sum -> _seg_sum_kernel (pallas_call at
// segment_pallas.py:165, body :49-116).  For dhs [L, D] f32 and segment
// ids seg [L] i32, non-decreasing, in [0, cap):
//
//   out[r, :] = sum over i with seg[i] == r of dhs[i, :]
//
// and out[r, :] = 0 for a rank no row carries.
//
// Bound on the H100: at the TGN dedup path (L = 132,000, D = 100,
// cap = 46,336) the function reads dhs (52.8 MB) and seg (0.5 MB) and
// writes out (18.5 MB): ~72 MB, 0.0215 ms at 3.35 TB/s; its 13 M adds are
// negligible, so it is memory-bound.  The TPU kernel carries partial sums
// across a sequential grid in a VMEM window; blocks here run in no order,
// so nothing is carried between them.  Segment lengths are skewed: the
// dedup's invalid instances (empty neighbour slots) all join its last
// rank, 90,528 of the 132,000 rows of an early REDDIT-shaped batch, so a
// warp per output row would sum one segment serially.  Three passes over
// fixed chunks of kChunk rows instead:
//
//   1. chunk_ends: a warp per chunk sums the rows of its first and of its
//      last segment, where that segment crosses the chunk's edge, into
//      part_first[c] and part_last[c] (the whole chunk into both when one
//      segment covers it).
//   2. rows: a warp per output row finds the row's range [lo, hi) in seg
//      by binary search; it writes 0 when the range is empty and the sum
//      of dhs[lo:hi] when the range lies in one chunk, and leaves a
//      segment that crosses a chunk edge to pass 3.
//   3. spans: a block per chunk edge; the block at the first edge a
//      segment crosses sums that segment's chunk partials, its 8 warps
//      over interleaved partials, then the warps' sums in warp order.
//
// Every output row is written once, by one thread per value, from sums
// taken in one fixed order; no atomics, so two launches give identical
// bits.  Lanes run over the columns, so each row is one contiguous warp
// load; a warp keeps 4 rows' loads in flight and adds them in row order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;        // rows per chunk (passes 1 and 3)
constexpr int kWarpsPerBlock = 8;
constexpr int kColsPerLane = 4;
constexpr int kPass = 32 * kColsPerLane;  // columns a warp sums per pass
constexpr int kBatch = 4;         // rows whose loads a warp keeps in flight

// First i in [0, n) with s[i] >= r, else n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ s, int n,
                                           int r) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// acc[j] += rows first, first + stride, ... (count rows, in that order) of
// src at columns c0 + lane + 32 j.
__device__ __forceinline__ void add_rows(const float* __restrict__ src,
                                         long long first, long long stride,
                                         int count, int D, int c0, int lane,
                                         float acc[kColsPerLane]) {
  int k = 0;
  for (; k + kBatch <= count; k += kBatch) {
    float v[kBatch][kColsPerLane];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float* row = src + (first + (k + u) * stride) * D + c0;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int d = lane + 32 * j;
        v[u][j] = c0 + d < D ? __ldg(row + d) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[j] += v[u][j];
  }
  for (; k < count; ++k) {
    const float* row = src + (first + k * stride) * D + c0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int d = lane + 32 * j;
      if (c0 + d < D) acc[j] += __ldg(row + d);
    }
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ dst, int D,
                                          int c0, int lane,
                                          const float acc[kColsPerLane]) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int d = c0 + lane + 32 * j;
    if (d < D) dst[d] = acc[j];
  }
}

// The sum of dhs rows [lo, hi) into dst, and into dst2 unless it is null
// (rows of D values).
__device__ __forceinline__ void sum_range(const float* __restrict__ dhs,
                                          int lo, int hi, int D, int lane,
                                          float* dst, float* dst2) {
  for (int c0 = 0; c0 < D; c0 += kPass) {
    float acc[kColsPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
    add_rows(dhs, lo, 1, hi - lo, D, c0, lane, acc);
    store_row(dst, D, c0, lane, acc);
    if (dst2 != nullptr) store_row(dst2, D, c0, lane, acc);
  }
}

// Pass 1: a warp per chunk of rows [r0, r1).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
chunk_ends_kernel(const float* __restrict__ dhs, const int* __restrict__ seg,
                  float* __restrict__ part_first,
                  float* __restrict__ part_last, int L, int D, int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int r0 = c * kChunk;
  const int r1 = min(r0 + kChunk, L);
  const int f = __ldg(seg + r0), l = __ldg(seg + r1 - 1);
  const bool f_crosses = r0 > 0 && __ldg(seg + r0 - 1) == f;
  const bool l_crosses = r1 < L && __ldg(seg + r1) == l;
  float* first = part_first + (long long)c * D;
  float* last = part_last + (long long)c * D;
  if (f == l) {
    if (f_crosses || l_crosses) sum_range(dhs, r0, r1, D, lane, first, last);
    return;
  }
  if (f_crosses)
    sum_range(dhs, r0, r0 + lower_bound(seg + r0, r1 - r0, f + 1), D, lane,
              first, nullptr);
  if (l_crosses)
    sum_range(dhs, r0 + lower_bound(seg + r0, r1 - r0, l), r1, D, lane,
              last, nullptr);
}

// Pass 2: a warp per output row r.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rows_kernel(const float* __restrict__ dhs, const int* __restrict__ seg,
            float* __restrict__ out, int L, int D, int cap) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= cap) return;
  const int lo = lower_bound(seg, L, r);
  const int hi = lower_bound(seg, L, r + 1);
  if (lo < hi && lo / kChunk != (hi - 1) / kChunk) return;  // pass 3's
  sum_range(dhs, lo, hi, D, lane, out + (long long)r * D, nullptr);
}

// Pass 3: a block per chunk edge e (between chunks e - 1 and e).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spans_kernel(const int* __restrict__ seg,
             const float* __restrict__ part_first,
             const float* __restrict__ part_last, float* __restrict__ out,
             int L, int D, int cap) {
  __shared__ float warp_sums[kWarpsPerBlock][kPass];
  const int e = blockIdx.x + 1;
  const int b = e * kChunk;
  const int s = __ldg(seg + b);
  // only the first edge a segment crosses owns it
  if (__ldg(seg + b - 1) != s || s < 0 || s >= cap) return;
  if (e > 1 && __ldg(seg + b - kChunk - 1) == s) return;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c_a = e - 1;
  const int c_b = (lower_bound(seg, L, s + 1) - 1) / kChunk;
  // terms in row order: part_last[c_a], then part_first[c_a + 1 .. c_b];
  // warp w takes terms w, w + 8, ...
  const int n_terms = c_b - c_a + 1;
  const int mine = n_terms > w ? (n_terms - w + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock
                               : 0;
  for (int c0 = 0; c0 < D; c0 += kPass) {
    float acc[kColsPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (mine > 0) {
      if (w == 0) {
        add_rows(part_last, c_a, 1, 1, D, c0, lane, acc);
        add_rows(part_first, c_a + kWarpsPerBlock, kWarpsPerBlock, mine - 1,
                 D, c0, lane, acc);
      } else {
        add_rows(part_first, c_a + w, kWarpsPerBlock, mine, D, c0, lane,
                 acc);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      warp_sums[w][lane + 32 * j] = acc[j];
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        float total = warp_sums[0][lane + 32 * j];
        for (int k = 1; k < kWarpsPerBlock; ++k)
          total += warp_sums[k][lane + 32 * j];
        acc[j] = total;
      }
      store_row(out + (long long)s * D, D, c0, lane, acc);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// dhs: [L, D] f32 contiguous; seg: [L] i32 contiguous, non-decreasing;
// out: [cap, D] f32 contiguous, every value written; part_first,
// part_last: [ceil(L / 64), D] f32 scratch.  L >= 1, cap >= 1.
// Returns cudaError_t.
int sorted_segment_sum(const float* dhs, const int* seg, float* out,
                       float* part_first, float* part_last, int L, int D,
                       int cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const int threads = kWarpsPerBlock * 32;
  chunk_ends_kernel<<<(n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                      threads, 0, st>>>(dhs, seg, part_first, part_last, L, D,
                                        n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<<<(cap + kWarpsPerBlock - 1) / kWarpsPerBlock, threads, 0,
                st>>>(dhs, seg, out, L, D, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks < 2) return err;
  spans_kernel<<<n_chunks - 1, threads, 0, st>>>(seg, part_first, part_last,
                                                  out, L, D, cap);
  return cudaGetLastError();
}

int segment_sum_chunk_rows() { return kChunk; }

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
