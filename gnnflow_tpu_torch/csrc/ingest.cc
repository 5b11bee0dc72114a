// Host-side ingestion helper of the dynamic graph store
// (gnnflow_tpu_torch/dynamic_graph.py): the grouping sort of a batch of
// incoming edges, the per-range lower bound of eviction and the re-sort
// of one vertex region after an out-of-order insertion.
//
// Plain C ABI, loaded with ctypes by gnnflow_tpu_torch/ops/ingest.py,
// which also holds the plain NumPy version of each function.  Built with
// the host C++ compiler at first use (ops/_build.py:build_host).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Stable argsort of the pairs (src[i], ts[i]): edges grouped by source
// vertex in ascending id, time-sorted inside a group, ties in arrival
// order; the order of numpy's lexsort((ts, src)).  src must be
// non-negative.  out_order holds n entries.
//
// A stable counting sort by source, O(n + max_src), then a stable sort by
// time only inside the groups that arrive out of time order: a stream is
// (nearly) chronological, so most groups need none.
void group_sort_edges(int64_t n, const int64_t* src, const float* ts,
                      int64_t* out_order) {
  if (n == 0) return;
  const int64_t max_src = *std::max_element(src, src + n);
  std::vector<int64_t> start(max_src + 2, 0);
  for (int64_t i = 0; i < n; ++i) ++start[src[i] + 1];
  std::partial_sum(start.begin(), start.end(), start.begin());
  std::vector<int64_t> pos(start.begin(), start.end() - 1);
  for (int64_t i = 0; i < n; ++i) out_order[pos[src[i]]++] = i;
  const auto by_ts = [ts](int64_t a, int64_t b) { return ts[a] < ts[b]; };
  for (int64_t v = 0; v <= max_src; ++v) {
    int64_t* lo = out_order + start[v];
    int64_t* hi = out_order + start[v + 1];
    if (!std::is_sorted(lo, hi, by_ts)) std::stable_sort(lo, hi, by_ts);
  }
}

// For each range i of the time-sorted pool, the count of its entries
// below target: the first j in [0, len[i]) with
// pool_ts[off[i] + j] >= target, or len[i].
void ranged_lower_bound(int64_t n, const float* pool_ts, const int64_t* off,
                        const int64_t* len, float target, int64_t* out_idx) {
  for (int64_t i = 0; i < n; ++i) {
    const float* first = pool_ts + off[i];
    out_idx[i] = std::lower_bound(first, first + len[i], target) - first;
  }
}

// Stable re-sort by time of the region [off, off + len) of the pool, in
// place, carrying the parallel dst and eid entries along.
void resort_range(int64_t off, int64_t len, float* pool_ts,
                  int32_t* pool_dst, int32_t* pool_eid) {
  float* ts = pool_ts + off;
  int32_t* dst = pool_dst + off;
  int32_t* eid = pool_eid + off;
  std::vector<int64_t> idx(len);
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(),
                   [ts](int64_t a, int64_t b) { return ts[a] < ts[b]; });
  const std::vector<float> old_ts(ts, ts + len);
  const std::vector<int32_t> old_dst(dst, dst + len), old_eid(eid, eid + len);
  for (int64_t i = 0; i < len; ++i) {
    ts[i] = old_ts[idx[i]];
    dst[i] = old_dst[idx[i]];
    eid[i] = old_eid[idx[i]];
  }
}

}  // extern "C"
