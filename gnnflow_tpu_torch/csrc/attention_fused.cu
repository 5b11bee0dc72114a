// Fused masked neighbourhood attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnflow_tpu/ops/attention_pallas.py:
// _forward_pallas -> _make_kernel (pallas_call at attention_pallas.py:114,
// body :58-96).  Per destination b and head h, over F neighbour slots:
//
//   s_f   = LeakyReLU_0.2(q_bh . k_bfh)          (f32 accumulation)
//   s_f   = -1e30 where mask[b, f] is false
//   e_f   = exp(s_f - max_f s_f) * mask[b, f]
//   att_f = e_f / max(sum_f e_f, 1e-10)           (rows with no valid slot: 0)
//   out   = sum_f att_f * v_bfh                   (f32, stored in v's type)
//
// Bound on the H100: at the TGN main path (B = 12,000, F = 10, H = 2,
// dh = 50, bf16, ~70% of slots valid) the function reads q, the mask and
// the k and v rows of valid slots and writes out, ~38 MB, 0.0114 ms at
// 3.35 TB/s; its 0.02 GFLOP are negligible, so it is memory-bound.  Each
// destination's data is small (q 200 bytes, k|v 400 bytes a slot), so
// the bandwidth is reached only with many independent loads in flight:
// about 20 KB per SM at ~1 us of memory latency.
//
// Design for that (the staged path):
// - A warp owns a whole destination (every head) and reads its mask once,
//   one byte a lane, turned into a bit set with a ballot.
// - Before any arithmetic, the warp copies the destination's q row and
//   the k|v rows of its valid slots into shared memory with cp.async,
//   16 bytes a lane where alignment allows.  In the layer, k and v of a
//   slot are adjacent column slices of one fused projection, so one copy
//   of 2*H*dh values a slot fetches both.  Masked slots are never read.
// - A warp takes a few destinations (4 on the main path) and is
//   double-buffered: it issues the copies of its next destination before
//   it computes the current one, so its next loads overlap its current
//   softmax.  With 12-24 warps an SM (the shared memory of two stages a
//   warp sets the count; the kernel asks for the largest shared-memory
//   carveout) this keeps ~50-100 KB in flight.  The mask byte of the
//   destination after next is loaded one round ahead, so the ballot that
//   plans a copy never waits.
// - Arithmetic reads shared memory.  In bf16 the warp's lanes form two
//   slot groups of 16 (each taking every other slot) where a group holds
//   every head at 8 columns a lane (H = 2, dh = 50: 8 lanes a head,
//   column pairs by two-value loads), else one group of 32 at 4 columns a
//   lane (f32: 16 lanes a head on the main path).
//   So a head boundary that falls inside a 16-byte vector (at dh = 50 in
//   bf16 a head is 100 bytes) costs nothing, and all lanes of a group
//   read the same staged row at once, which needs no padded pitch.
//   Scores reduce with shuffles over the lanes of one head and stay in
//   registers, as does the softmax, all in f32; the output row is
//   assembled in the q buffer and leaves in vector stores.
// - What held the first versions back was the warp's arithmetic, not its
//   loads: on the H100, versions with the arithmetic or the copies taken
//   out each ran for more than half of the whole kernel's time, and the
//   two did not overlap.  So the arithmetic is straight-line over the
//   slots (F unrolled: 10 on the main path) with no branch per slot, so
//   that the slots' loads and shuffle reductions overlap; two slot groups
//   take 3 shuffle rounds a score for two slots at once, not 4 for one; a
//   masked slot's score is -inf, so its weight is 0 with no select; exp
//   and the division by the sum are one exp2 and one reciprocal; and the
//   copy loops stay rolled, so that the hot loop fits the instruction
//   cache.
//
// Inputs whose rows do not allow 4-byte copies (bf16 with an odd H*dh or
// an odd row stride), or whose staged rows do not fit twice in shared
// memory, take the direct path: the same arithmetic, a warp a destination,
// reading k and v straight from global memory.  The wrapper plans the
// path, the copy widths and the layout (ops/attention_fused.py:plan).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory of a block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* out;
  int B, F, H, dh;
  long long k_row, v_row;     // row strides of k and v, in elements
  int lanes_per_head;         // G, a power of two
  // staged path
  int fused;                  // one copy of 2*H*dh values a slot
  int w_kv, w_q;              // copy widths in bytes: 16, 8 or 4
  int pitch;                  // bytes of a staged slot row
  int v_off;                  // elements from a staged row's k to its v
  int q_pitch;                // bytes of the staged q row
  int stage;                  // bytes of a stage: q_pitch + slots * pitch
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a lane's share of copying `bytes` from global src to shared address dst
// (a 32-bit shared-space address), `w` bytes a lane per step
__device__ __forceinline__ void copy_async(unsigned dst,
                                           const unsigned char* src,
                                           int bytes, int w, int lane) {
  // loops kept rolled: the kernel's hot loop must stay small enough for
  // the instruction cache
  if (w == 16) {
#pragma unroll 1
    for (int o = lane * 16; o < bytes; o += 32 * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst + o), "l"(src + o) : "memory");
  } else if (w == 8) {
#pragma unroll 1
    for (int o = lane * 8; o < bytes; o += 32 * 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :: "r"(dst + o), "l"(src + o) : "memory");
  } else {
#pragma unroll 1
    for (int o = lane * 4; o < bytes; o += 32 * 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(dst + o), "l"(src + o) : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// lane f < F: the mask byte of slot f of destination b (0 past the end)
__device__ __forceinline__ int mask_byte(const Params& p, long long b,
                                         int lane) {
  return (b < p.B && lane < p.F) ? __ldg(p.mask + b * p.F + lane) : 0;
}

__device__ __forceinline__ float2 to_f32x2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 to_f32x2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}
__device__ __forceinline__ void from_f32x2(float* x, float a, float b) {
  *reinterpret_cast<float2*>(x) = make_float2(a, b);
}
__device__ __forceinline__ void from_f32x2(__nv_bfloat16* x, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(x) = __floats2bfloat162_rn(a, b);
}

// A lane's columns of a head: j = sub + G * t, or with PAIR the pairs
// 2 * (sub + G * u) and the column after (two-value loads; dh even and
// rows aligned to two values).
template <bool PAIR>
__device__ __forceinline__ int column(int sub, int G, int t) {
  return PAIR ? 2 * (sub + G * (t >> 1)) + (t & 1) : sub + G * t;
}

// x[t] = row[column t] where use[t], else 0
template <typename T, bool PAIR, int COLS>
__device__ __forceinline__ void load_cols(const T* row, int sub, int G,
                                          const bool (&use)[COLS],
                                          float (&x)[COLS]) {
#pragma unroll
  for (int t = 0; t < COLS; t += PAIR ? 2 : 1) {
    if (PAIR) {
      const float2 y = use[t] ? to_f32x2(row + column<true>(sub, G, t))
                              : make_float2(0.0f, 0.0f);
      x[t] = y.x;
      x[t + 1] = y.y;
    } else {
      x[t] = use[t] ? to_f32(row[column<false>(sub, G, t)]) : 0.0f;
    }
  }
}

// The row slot f reads: a stage holds MAXF rows, so slots past F read
// stale rows there; in global memory they read row F - 1, their loads
// predicated off like those of masked slots.
template <bool STAGED>
__device__ __forceinline__ int slot_row(int f, int F) {
  return STAGED || f < F ? f : F - 1;
}

// The attention of one destination.  qb: its q row; kb, vb: k and v of
// slot 0, slot f at + f * kp, vb + f * vp (elements; shared or global
// memory); valid: bit f set for a valid slot; ob: where the output row
// goes (shared or global memory).  A stage has MAXF slot rows (the plan's
// `slots`).
//
// SG slot groups of 32 / SG lanes split the slots (group g takes slots
// g, g + SG, ...), each lane holding 4 * SG columns of a head: with SG = 2
// a head of 50 columns takes 8 lanes, so a slot's score needs 3 shuffle
// rounds instead of 4 and serves two slots at once, and each lane
// computes half the weights; the groups' maxima, sums and outputs are
// joined by one shuffle each.
//
// The code is straight-line over the slots, so that their loads,
// products and shuffle reductions overlap: a warp's dependent chains set
// the time of a first version that branched on every slot.  Invalid
// slots and slots past F are computed and dropped by selects (a select,
// unlike a multiply by 0, also drops a NaN).  STAGED: k and v are in
// shared memory, where rows of masked slots hold stale values and may be
// read; else they are in global memory, and their loads are predicated
// on the mask, so masked rows are never read.
template <typename T, int MAXF, bool STAGED, bool PAIR, int SG, typename I>
__device__ __forceinline__ void attend(const Params& p, const T* qb,
                                       const T* kb, const T* vb, I kp, I vp,
                                       unsigned valid, T* ob, int lane) {
  constexpr int COLS = 4 * SG;           // columns of a head a lane holds
  constexpr int NS = MAXF / SG;          // slots a lane takes
  const int G = p.lanes_per_head;
  const int HP = 32 / SG / G;            // heads a pass
  const int grp = lane / (32 / SG);      // slot group
  const int r = lane - grp * (32 / SG);
  const int hl = r / G, sub = r - hl * G;
  const int dh = p.dh, F = p.F;
  for (int h0 = 0; h0 < p.H; h0 += HP) {
    const int h = h0 + hl;
    const bool act = h < p.H;
    const int base = h * dh;
    bool col[COLS];
#pragma unroll
    for (int t = 0; t < COLS; ++t)
      col[t] = act && column<PAIR>(sub, G, t) < dh;
    float qr[COLS];
    load_cols<T, PAIR, COLS>(qb + base, sub, G, col, qr);
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int f = grp + SG * i;
      bool use[COLS];
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        use[t] = col[t] && (STAGED || ((valid >> f) & 1u));
      float x[COLS];
      load_cols<T, PAIR, COLS>(kb + slot_row<STAGED>(f, F) * kp + base, sub,
                               G, use, x);
      s[i] = 0.0f;
#pragma unroll
      for (int t = 0; t < COLS; ++t) s[i] = fmaf(qr[t], x[t], s[i]);
    }
    // sums over the G lanes of a head, then LeakyReLU, the max over valid
    // slots and the softmax, the same in every lane of the head
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < G) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          s[i] += __shfl_xor_sync(kFull, s[i], o);
      }
    }
    // LeakyReLU(0.2) is max(s, 0.2 s); a masked slot's score is -inf, so
    // its weight exp(-inf) = 0 needs no select
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int f = grp + SG * i;
      s[i] = ((valid >> f) & 1u) ? fmaxf(s[i], 0.2f * s[i]) : -INFINITY;
      m = fmaxf(m, s[i]);
    }
    if (SG == 2) m = fmaxf(m, __shfl_xor_sync(kFull, m, 16));
    if (m == -INFINITY) m = 0.0f;        // no valid slot: every weight 0
    // exp(x) as exp2(x * log2(e)): the rounded product moves the result
    // by |x| * 6e-8 relative, well inside the f32 tolerance, at a fifth
    // of expf's instructions (each lane of a head computes its slots')
    float den = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = exp2f((s[i] - m) * 1.4426950408889634f);
      den += s[i];
    }
    if (SG == 2) den += __shfl_xor_sync(kFull, den, 16);
    const float inv = 1.0f / fmaxf(den, 1e-10f);
    float acc[COLS];
#pragma unroll
    for (int t = 0; t < COLS; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int f = grp + SG * i;
      const bool ok = (valid >> f) & 1u;
      bool use[COLS];
#pragma unroll
      for (int t = 0; t < COLS; ++t) use[t] = col[t] && (STAGED || ok);
      float x[COLS];
      load_cols<T, PAIR, COLS>(vb + slot_row<STAGED>(f, F) * vp + base, sub,
                               G, use, x);
      const float a = s[i] * inv;
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        acc[t] = ok ? fmaf(a, x[t], acc[t]) : acc[t];
    }
    if (SG == 2) {
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        acc[t] += __shfl_xor_sync(kFull, acc[t], 16);
    }
    __syncwarp();                        // ob may be where q was read
#pragma unroll
    for (int t = 0; t < COLS; t += PAIR ? 2 : 1) {
      if (!col[t] || grp != 0) continue;
      if (PAIR)
        from_f32x2(ob + base + column<true>(sub, G, t), acc[t], acc[t + 1]);
      else
        ob[base + column<false>(sub, G, t)] = from_f32<T>(acc[t]);
    }
  }
  __syncwarp();
}

// Copy destination b's q row and the k|v rows of its valid slots into a
// stage: [q | slot 0 | slot 1 | ...], slot f at q_pitch + f * pitch.  The
// 64-bit source addresses are formed once a destination.
template <typename T>
__device__ __forceinline__ void stage_in(const Params& p, long long b,
                                         unsigned valid, unsigned char* dst,
                                         int lane) {
  constexpr int es = sizeof(T);
  const int row = p.H * p.dh * es;
  const unsigned d0 = smem_u32(dst);
  copy_async(d0, static_cast<const unsigned char*>(p.q) + b * row, row,
             p.w_q, lane);
  const long long slot0 = b * p.F;
  const unsigned char* k0 =
      static_cast<const unsigned char*>(p.k) + slot0 * p.k_row * es;
  const unsigned char* v0 =
      static_cast<const unsigned char*>(p.v) + slot0 * p.v_row * es;
  for (unsigned m = valid; m; m &= m - 1) {
    const int f = __ffs(m) - 1;
    const unsigned d = d0 + p.q_pitch + f * p.pitch;
    if (p.fused) {
      copy_async(d, k0 + f * p.k_row * es, 2 * row, p.w_kv, lane);
    } else {
      copy_async(d, k0 + f * p.k_row * es, row, p.w_kv, lane);
      copy_async(d + p.v_off * es, v0 + f * p.v_row * es, row, p.w_kv,
                 lane);
    }
  }
}

// the output row from shared memory to out, w_q bytes a lane per step
__device__ __forceinline__ void stage_out(const Params& p, long long b,
                                          const unsigned char* src,
                                          int row, int lane) {
  unsigned char* dst = static_cast<unsigned char*>(p.out) + b * row;
  if (p.w_q == 16) {
#pragma unroll 1
    for (int o = lane * 16; o < row; o += 32 * 16)
      *reinterpret_cast<uint4*>(dst + o) =
          *reinterpret_cast<const uint4*>(src + o);
  } else if (p.w_q == 8) {
#pragma unroll 1
    for (int o = lane * 8; o < row; o += 32 * 8)
      *reinterpret_cast<uint2*>(dst + o) =
          *reinterpret_cast<const uint2*>(src + o);
  } else {
#pragma unroll 1
    for (int o = lane * 4; o < row; o += 32 * 4)
      *reinterpret_cast<unsigned*>(dst + o) =
          *reinterpret_cast<const unsigned*>(src + o);
  }
}

// Staged path: a warp takes destinations b, b + (warps in the grid), ...
// (the plan gives it a few), with two stages.
template <typename T, int MAXF, bool PAIR, int SG>
__global__ void __launch_bounds__(128)
attention_staged_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned char* stages = smem + wib * 2 * p.stage;
  const long long stride = (long long)gridDim.x * nw;
  long long b = (long long)blockIdx.x * nw + wib;
  if (b >= p.B) return;
  const int row = p.H * p.dh * (int)sizeof(T);
  unsigned cur_valid = __ballot_sync(kFull, mask_byte(p, b, lane) != 0);
  stage_in<T>(p, b, cur_valid, stages, lane);
  cp_commit();
  long long nb = b + stride;
  int next_byte = mask_byte(p, nb, lane);
  for (int it = 0; b < p.B; ++it) {
    unsigned char* cur = stages + (it & 1) * p.stage;
    unsigned char* nxt = stages + ((it + 1) & 1) * p.stage;
    const unsigned next_valid = __ballot_sync(kFull, next_byte != 0);
    if (nb < p.B) stage_in<T>(p, nb, next_valid, nxt, lane);
    cp_commit();
    const long long nnb = nb + stride;
    next_byte = mask_byte(p, nnb, lane);
    cp_wait<1>();                        // the current stage has landed
    __syncwarp();
    const T* qs = reinterpret_cast<const T*>(cur);
    const T* ks = reinterpret_cast<const T*>(cur + p.q_pitch);
    const int pe = p.pitch / (int)sizeof(T);
    // the output of head h replaces q of head h, which its pass has read
    attend<T, MAXF, true, PAIR, SG>(p, qs, ks, ks + p.v_off, pe, pe,
                                    cur_valid, reinterpret_cast<T*>(cur),
                                    lane);
    stage_out(p, b, cur, row, lane);
    __syncwarp();                        // before cur is refilled
    b = nb;
    nb = nnb;
    cur_valid = next_valid;
  }
  cp_wait<0>();
}

// Direct path: a warp a destination, k and v read from global memory.
template <typename T, int MAXF>
__global__ void __launch_bounds__(128)
attention_direct_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= p.B) return;
  const unsigned valid = __ballot_sync(kFull, mask_byte(p, b, lane) != 0);
  const long long hd = (long long)p.H * p.dh;
  attend<T, MAXF, false, false, 1>(p, static_cast<const T*>(p.q) + b * hd,
                  static_cast<const T*>(p.k) + b * p.F * p.k_row,
                  static_cast<const T*>(p.v) + b * p.F * p.v_row, p.k_row,
                  p.v_row, valid, static_cast<T*>(p.out) + b * hd, lane);
}

template <typename T, int MAXF, bool PAIR, int SG>
cudaError_t launch_staged(const Params& p, int warps, int smem,
                          long long blocks, cudaStream_t stream) {
  // once per kernel: allow the plan's shared-memory budget, and prefer
  // the largest shared-memory carveout, so that as many blocks as the
  // shared memory holds (not as the default L1 split leaves) share an SM
  static bool configured = false;
  if (!configured) {
    auto kernel = attention_staged_kernel<T, MAXF, PAIR, SG>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  attention_staged_kernel<T, MAXF, PAIR, SG>
      <<<(unsigned)blocks, warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int MAXF>
cudaError_t launch(const Params& p, int staged, int slot_groups, int warps,
                   int smem, long long blocks, cudaStream_t stream) {
  if (!staged) {
    if (slot_groups != 1) return cudaErrorInvalidValue;
    attention_direct_kernel<T, MAXF>
        <<<(unsigned)blocks, warps * 32, 0, stream>>>(p);
    return cudaGetLastError();
  }
  // staged rows are 16-byte aligned: with dh even, every head's columns
  // pair up on two-value boundaries
  if (p.dh % 2 != 0)
    return slot_groups == 1
               ? launch_staged<T, MAXF, false, 1>(p, warps, smem, blocks,
                                                  stream)
               : cudaErrorInvalidValue;
  return slot_groups == 2
             ? launch_staged<T, MAXF, true, 2>(p, warps, smem, blocks, stream)
             : launch_staged<T, MAXF, true, 1>(p, warps, smem, blocks, stream);
}

}  // namespace

extern "C" {

// q, out: [B, H, dh] contiguous; k, v: rows of H*dh contiguous values, row
// (b, f) starting at (b*F + f) * {k,v}_row elements; mask: [B, F] bytes.
// F <= 32, dh <= 128.  bf16 != 0 selects bf16 tensors (else f32).  The
// layout arguments come from the wrapper's plan (ops/attention_fused.py):
// staged selects the staged path; `slots` (8, 10, 16 or 32, >= F) is the
// slots' unrolled width and a stage's rows; `slot_groups` (1, or 2 on the
// staged path with dh even) splits the slots over lane groups, each lane
// holding 4 * slot_groups columns of a head of lanes_per_head lanes;
// `blocks` of `warps` warps, each block with `smem` bytes of dynamic
// shared memory.
// Returns cudaError_t.
int attention_fwd(int bf16, const void* q, const void* k, const void* v,
                  const uint8_t* mask, void* out, int B, int F, int H, int dh,
                  long long k_row, long long v_row, int lanes_per_head,
                  int staged, int fused, int w_kv, int w_q, int pitch,
                  int v_off, int q_pitch, int slots, int slot_groups,
                  int warps, int smem, long long blocks, void* stream) {
  const Params p{q, k, v, mask, out, B, F, H, dh, k_row, v_row,
                 lanes_per_head, fused, w_kv, w_q, pitch, v_off, q_pitch,
                 q_pitch + slots * pitch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots < F || (slot_groups != 1 && slot_groups != 2))
    return cudaErrorInvalidValue;
  // the slots' unrolled width: 8, 10 (the TGN main path's fanout), 16, 32
#define K3_LAUNCH(T)                                                  \
  switch (slots) {                                                    \
    case 8:                                                           \
      return launch<T, 8>(p, staged, slot_groups, warps, smem, blocks, s); \
    case 10:                                                          \
      return launch<T, 10>(p, staged, slot_groups, warps, smem, blocks, s); \
    case 16:                                                          \
      return launch<T, 16>(p, staged, slot_groups, warps, smem, blocks, s); \
    case 32:                                                          \
      return launch<T, 32>(p, staged, slot_groups, warps, smem, blocks, s); \
    default:                                                          \
      return cudaErrorInvalidValue;                                   \
  }
  if (bf16) K3_LAUNCH(__nv_bfloat16);
  K3_LAUNCH(float);
#undef K3_LAUNCH
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
