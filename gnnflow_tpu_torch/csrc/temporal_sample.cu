// Temporal neighbour sampling of one layer for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package samples in XLA
// (gnnflow_tpu/ops/sampling.py: sample_layer, sample_layer_snapshots).
// It was added because launch overhead, not bytes, bounds this layer on
// the card.  The port's plain version (ops/sampling.py:
// sample_runs_ref) searches each root's run with `search_iters` rounds of
// about a dozen elementwise launches, then gathers the picks with ~20
// more: ~115 launches a layer sample whatever the number of roots, each
// issued by a host that sets the pace.  The work itself is small: 12,000
// roots x 10 slots read ~1.7 MB and write 3.0 MB, ~1.4 us at 3.35 TB/s.
// One launch here does the whole layer sample.
//
// For each row r = (s, b) of S x B roots:
//
//   run      off = row_off[root], len = row_len[root]; a root below 0, or
//            past the node table, has len 0
//   bounds   e_idx = the first i in [0, len) with e_ts[off + i] >= end[r],
//            else len (an edge at exactly the end is excluded); s_idx the
//            same for start[r], or 0 without start (the full history)
//   recent   slot k takes pick = e_idx - 1 - k, valid where pick >= s_idx
//   uniform  nc = e_idx - s_idx; slot k takes
//            pick = e_idx - 1 - min(trunc(u[r, k] * nc), max(nc - 1, 0)),
//            u * nc an f32 product; every slot is valid where nc > 0
//   fields   at idx = clamp(off + pick, 0, pool - 1): nbr_nids = e_dst[idx],
//            nbr_ts = e_ts[idx] (root_ts[r] with prop_time),
//            nbr_dts = root_ts[r] - e_ts[idx], nbr_eids = e_eid[idx],
//            nbr_mask = 1; an invalid slot holds -1, 0, 0, 0, 0
//
// which is the plain version's arithmetic, rounding for rounding, so the
// two give the same bits.  Runs are sorted by timestamp (the store keeps
// them so), hence every correct search finds the same bound.
//
// Design: one warp per row.  A search step probes 32 evenly spaced slots
// of the open range [lo, hi) and takes __ballot_sync of
// e_ts[off + probe] < target; the count of probes below the target
// narrows the range ~33x.  A run of up to 32 takes one step, up to 1,024
// two, and a hub of 10^5 edges four, where the plain version takes 17
// rounds.  The lanes then write the row's F slots, neighbouring lanes on
// neighbouring slots, in a loop when F > 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // rows (warps) per block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* row_off;
  const int* row_len;
  long long num_nodes;
  const int* e_dst;
  const float* e_ts;
  const int* e_eid;
  long long pool;
  const long long* roots;
  long long roots_stride;             // elements between rows s and s + 1
  const float* root_ts;
  long long ts_stride;
  const float* start;                 // null: the full history
  long long start_stride;
  const float* end;
  long long end_stride;
  const float* u;                     // [S * B, F]; null: recent
  int S, B, F, prop_time;
  long long* nbr_nids;                // [S * B, F] each
  float* nbr_ts;
  float* nbr_dts;
  long long* nbr_eids;
  bool* nbr_mask;
};

// The first i in [0, len) with ts[i] >= target, else len; every lane of
// the warp calls it with the same arguments and gets the same answer.
__device__ __forceinline__ int lower_bound(const float* __restrict__ ts,
                                           int len, float target, int lane) {
  int lo = 0, hi = len;   // ts[i] < target below lo, >= target from hi on
  while (hi - lo > 32) {
    const long long n = hi - lo;
    // probe k of 32 sits at lo + (k + 1)·n/33: distinct, inside [lo, hi)
    const int p = lo + static_cast<int>((lane + 1) * n / 33);
    const int c = __popc(__ballot_sync(kFull, __ldg(ts + p) < target));
    const int new_lo = c > 0 ? lo + static_cast<int>(c * n / 33) + 1 : lo;
    hi = c < 32 ? lo + static_cast<int>((c + 1) * n / 33) : hi;
    lo = new_lo;
  }
  const bool below = lane < hi - lo && __ldg(ts + lo + lane) < target;
  return lo + __popc(__ballot_sync(kFull, below));
}

__global__ void __launch_bounds__(kWarps * 32)
temporal_sample_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(a.S) * a.B) return;   // warp-uniform
  const long long s = row / a.B, b = row - s * a.B;

  const long long root = __ldg(a.roots + s * a.roots_stride + b);
  const float rts = __ldg(a.root_ts + s * a.ts_stride + b);
  long long off = 0;
  int len = 0;
  if (root >= 0 && root < a.num_nodes) {
    off = __ldg(a.row_off + root);
    len = __ldg(a.row_len + root);
  }
  const float* run = a.e_ts + off;
  const int e_idx = lower_bound(run, len,
                                __ldg(a.end + s * a.end_stride + b), lane);
  const int s_idx =
      a.start ? lower_bound(run, len, __ldg(a.start + s * a.start_stride + b),
                            lane)
              : 0;

  const long long nc = static_cast<long long>(e_idx) - s_idx;
  const long long last = nc - 1 > 0 ? nc - 1 : 0;
  for (int k = lane; k < a.F; k += 32) {
    const long long o = row * a.F + k;
    long long pick;
    bool valid;
    if (a.u) {
      // u * nc in f32, truncated toward zero, as the plain version's
      // (u * nc.float()).long()
      const float x = __fmul_rn(__ldg(a.u + o), static_cast<float>(nc));
      const long long r = static_cast<long long>(x);
      pick = e_idx - 1 - (r < last ? r : last);
      valid = nc > 0;
    } else {
      pick = static_cast<long long>(e_idx) - 1 - k;
      valid = pick >= s_idx;
    }
    if (valid) {
      long long idx = off + pick;
      idx = idx < 0 ? 0 : (idx > a.pool - 1 ? a.pool - 1 : idx);
      const float ets = __ldg(a.e_ts + idx);
      a.nbr_nids[o] = __ldg(a.e_dst + idx);
      a.nbr_ts[o] = a.prop_time ? rts : ets;
      a.nbr_dts[o] = __fsub_rn(rts, ets);
      a.nbr_eids[o] = __ldg(a.e_eid + idx);
      a.nbr_mask[o] = true;
    } else {
      a.nbr_nids[o] = -1;
      a.nbr_ts[o] = 0.f;
      a.nbr_dts[o] = 0.f;
      a.nbr_eids[o] = 0;
      a.nbr_mask[o] = false;
    }
  }
}

}  // namespace

extern "C" {

// One layer sample of S x B roots, as the header says.  The graph arrays
// are contiguous: row_off, row_len [num_nodes] i32; e_dst, e_eid [pool]
// i32; e_ts [pool] f32.  roots (i64), root_ts, start and end (f32) are
// [S, B] with contiguous rows, row s at s * <name>_stride (0: one row
// shared by all); start may be null.  u: [S * B, F] f32 contiguous, null
// for recent picks.  Outputs [S * B, F] contiguous, every value written.
// S, B, F >= 1.  Launches on `stream`; returns cudaError_t.
int temporal_sample(const int* row_off, const int* row_len,
                    long long num_nodes, const int* e_dst, const float* e_ts,
                    const int* e_eid, long long pool, const long long* roots,
                    long long roots_stride, const float* root_ts,
                    long long ts_stride, const float* start,
                    long long start_stride, const float* end,
                    long long end_stride, const float* u, int S, int B,
                    int F, int prop_time, long long* nbr_nids, float* nbr_ts,
                    float* nbr_dts, long long* nbr_eids, bool* nbr_mask,
                    void* stream) {
  const Args a{row_off, row_len, num_nodes, e_dst, e_ts, e_eid, pool,
               roots, roots_stride, root_ts, ts_stride, start, start_stride,
               end, end_stride, u, S, B, F, prop_time, nbr_nids, nbr_ts,
               nbr_dts, nbr_eids, nbr_mask};
  const long long rows = static_cast<long long>(S) * B;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  temporal_sample_kernel<<<blocks, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
