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
// dedup's invalid instances (empty neighbour slots) all join the last
// valid rank, n_uniq - 1: 90,528 of the 132,000 rows of an early
// REDDIT-shaped batch, while the median segment has a few rows.
//
// Two launches over fixed tiles of kTile = 512 rows:
//
//   1. tiles: a block per tile reads the tile's seg once into shared
//      memory; each of its 16 warps walks 32 rows in order, lanes over the
//      columns in 16-byte vectors, 8 rows' loads in flight, and writes
//      every segment that starts and ends inside its rows straight to
//      out, with zeros for ranks skipped between two rows.  The pieces of
//      segments that cross a warp's edge go to shared memory, and warp 0
//      joins them in warp order: a segment inside the tile is written to
//      out; the piece of one that crosses the tile's left edge (or the
//      whole tile, if one segment covers it) goes to part_l[tile], the
//      piece of one that starts in the tile and crosses its right edge to
//      part_r[tile].  All blocks also share the zeros of ranks below
//      seg[0] and above seg[L-1] (the dedup leaves cap - n_uniq of them,
//      34,000 rows on the first batch, too many for one block).
//   2. spans: a block per tile edge; the block at the first edge a
//      segment crosses finds, with one load per thread, the tile where it
//      ends, and sums part_r of the tile where it starts and part_l of
//      the tiles after it, its 16 warps over interleaved terms, then the
//      warps' sums in warp order.  The 90,528-row segment has ~177 terms.
//
// So every output row is written once, from sums taken in one fixed
// order; no atomics on values, and two launches give identical bits.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kRowsPerWarp = 32;
constexpr int kTile = kWarps * kRowsPerWarp;
constexpr int kBatch = 8;          // rows whose loads a lane keeps in flight

template <int VW>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};

struct Args {
  const float* dhs;
  const int* seg;
  float* out;
  float* part_l;
  float* part_r;
  int L, D, cap;
};

// vector column c of row r of a [*, D] array, D = DV * VW
template <int VW>
__device__ __forceinline__ typename Vec<VW>::T* at(float* base, long long r,
                                                   int DV, int c) {
  return reinterpret_cast<typename Vec<VW>::T*>(base) + r * DV + c;
}
template <int VW>
__device__ __forceinline__ typename Vec<VW>::T load(const float* base,
                                                    long long r, int DV,
                                                    int c) {
  return __ldg(reinterpret_cast<const typename Vec<VW>::T*>(base) + r * DV
               + c);
}

// Zero rows [lo, hi) of out, the vectors split evenly over the grid.
template <int VW>
__device__ __forceinline__ void zero_rows(float* out, long long lo,
                                          long long hi, int DV) {
  using V = Vec<VW>;
  if (hi <= lo) return;
  const long long n = (hi - lo) * DV;
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long a = blockIdx.x * per;
  const long long b = a + per < n ? a + per : n;
  typename V::T* dst = at<VW>(out, lo, DV, 0);
  for (long long i = a + threadIdx.x; i < b; i += blockDim.x)
    dst[i] = V::zero();
}

template <int VW>
__global__ void __launch_bounds__(kWarps * 32) tiles_kernel(Args a) {
  using V = Vec<VW>;
  using T = typename V::T;
  __shared__ int s_seg[kTile + 2];             // rows t0 - 1 .. t1
  __shared__ T s_pl[kWarps][32];
  __shared__ T s_pr[kWarps][32];
  const int DV = a.D / VW;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(t0 + kTile, a.L);
  zero_rows<VW>(a.out, 0, __ldg(a.seg), DV);
  zero_rows<VW>(a.out, __ldg(a.seg + a.L - 1) + 1, a.cap, DV);
  for (int i = threadIdx.x; i < t1 - t0 + 2; i += blockDim.x) {
    const int r = t0 - 1 + i;
    s_seg[i] = (r >= 0 && r < a.L) ? __ldg(a.seg + r) : -1;
  }
  __syncthreads();
  const int* S = s_seg + 1 - t0;               // S[r] for r in [t0-1, t1]
  const int lo = t0 + w * kRowsPerWarp;
  const int hi = min(lo + kRowsPerWarp, t1);
  // a piece is open on a side when its segment goes on across that edge
  const bool open_l = lo < hi && S[lo - 1] == S[lo];
  const bool open_r = lo < hi && S[hi] == S[hi - 1];
  for (int c0 = 0; c0 < DV; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < DV;
    if (lo < hi) {
      int cur = S[lo];
      bool first = true;                       // cur is the rows' first
      T acc = V::zero();
      if (lo > 0 && col)                       // ranks skipped before lo
        for (int r = S[lo - 1] + 1; r < cur; ++r)
          *at<VW>(a.out, r, DV, c) = V::zero();
      for (int i0 = lo; i0 < hi; i0 += kBatch) {
        T x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          x[u] = (i0 + u < hi && col) ? load<VW>(a.dhs, i0 + u, DV, c)
                                      : V::zero();
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u;
          if (i < hi) {
            const int s = S[i];
            if (s != cur) {                    // the same in every lane
              if (col) {
                if (first && open_l)
                  s_pl[w][lane] = acc;
                else
                  *at<VW>(a.out, cur, DV, c) = acc;
                for (int r = cur + 1; r < s; ++r)
                  *at<VW>(a.out, r, DV, c) = V::zero();
              }
              acc = V::zero();
              cur = s;
              first = false;
            }
            acc = V::add(acc, x[u]);
          }
        }
      }
      if (col) {
        if (first && open_l)
          s_pl[w][lane] = acc;
        else if (open_r)
          s_pr[w][lane] = acc;
        else
          *at<VW>(a.out, cur, DV, c) = acc;
      }
    }
    __syncthreads();
    if (w == 0 && col) {
      // join the pieces in row order: carry holds the open segment
      bool active = S[t0 - 1] == S[t0];        // from the previous tile
      bool from_prev = active;
      T carry = V::zero();
      for (int w2 = 0; w2 < kWarps; ++w2) {
        const int l2 = t0 + w2 * kRowsPerWarp;
        const int h2 = min(l2 + kRowsPerWarp, t1);
        if (l2 >= h2) break;
        const bool ol = S[l2 - 1] == S[l2];
        const bool orr = S[h2] == S[h2 - 1];
        const bool whole = S[l2] == S[h2 - 1];
        if (ol) {
          carry = V::add(carry, s_pl[w2][lane]);
          if (whole && orr) continue;          // goes on through
          if (from_prev)
            *at<VW>(a.part_l, blockIdx.x, DV, c) = carry;
          else
            *at<VW>(a.out, S[l2], DV, c) = carry;
          active = false;
        }
        if (orr && !(whole && ol)) {
          carry = s_pr[w2][lane];
          active = true;
          from_prev = false;
        }
      }
      if (active)
        *at<VW>(from_prev ? a.part_l : a.part_r, blockIdx.x, DV, c) = carry;
    }
    __syncthreads();
  }
}

template <int VW>
__global__ void __launch_bounds__(kWarps * 32) spans_kernel(Args a) {
  using V = Vec<VW>;
  using T = typename V::T;
  __shared__ T s_sum[kWarps][32];
  __shared__ int s_end;
  const int e = blockIdx.x + 1;                // edge between tiles e-1, e
  const int b = e * kTile;
  const int s = __ldg(a.seg + b);
  // only the first edge a segment crosses owns it
  if (__ldg(a.seg + b - 1) != s) return;
  if (e > 1 && __ldg(a.seg + b - kTile - 1) == s) return;
  // the tile where the segment ends: the first t >= e whose right edge it
  // does not cross
  if (threadIdx.x == 0) s_end = INT_MAX;
  __syncthreads();
  for (int base = e;; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const long long r = (long long)(t + 1) * kTile;
    if (r >= a.L || __ldg(a.seg + r) != s) atomicMin(&s_end, t);
    __syncthreads();
    const bool done = s_end != INT_MAX;
    __syncthreads();
    if (done) break;
  }
  const int n_terms = s_end - e + 2;   // part_r[e-1], part_l[e .. end]
  const int DV = a.D / VW;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int c0 = 0; c0 < DV; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < DV;
    T acc = V::zero();
    for (int k0 = w; k0 < n_terms; k0 += kWarps * kBatch) {
      T x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u * kWarps;
        x[u] = (k < n_terms && col)
                   ? (k == 0 ? load<VW>(a.part_r, e - 1, DV, c)
                             : load<VW>(a.part_l, e - 1 + k, DV, c))
                   : V::zero();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc = V::add(acc, x[u]);
    }
    if (col) s_sum[w][lane] = acc;
    __syncthreads();
    if (w == 0 && col) {
      T total = s_sum[0][lane];
      for (int k = 1; k < kWarps; ++k) total = V::add(total, s_sum[k][lane]);
      *at<VW>(a.out, s, DV, c) = total;
    }
    __syncthreads();
  }
}

template <int VW>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int n_tiles = (a.L + kTile - 1) / kTile;
  tiles_kernel<VW><<<n_tiles, kWarps * 32, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles < 2) return err;
  spans_kernel<VW><<<n_tiles - 1, kWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dhs: [L, D] f32 contiguous; seg: [L] i32 contiguous, non-decreasing,
// values in [0, cap); out: [cap, D] f32 contiguous, every value written;
// part_l, part_r: [ceil(L / segment_sum_tile_rows()), D] f32 scratch.
// L >= 1, cap >= 1, D >= 1.  vec4 != 0: D % 4 == 0 and every pointer
// 16-byte aligned (16-byte loads and stores).  Returns cudaError_t.
int sorted_segment_sum(const float* dhs, const int* seg, float* out,
                       float* part_l, float* part_r, int L, int D, int cap,
                       int vec4, void* stream) {
  const Args a{dhs, seg, out, part_l, part_r, L, D, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<4>(a, st) : launch<1>(a, st);
}

int segment_sum_tile_rows() { return kTile; }

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
