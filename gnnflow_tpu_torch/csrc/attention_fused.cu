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
// dh = 50, bf16) the function reads q, k, v and the mask and writes out,
// ~53 MB, 0.016 ms at 3.35 TB/s; its 0.05 GFLOP are negligible, so it is
// memory-bound.  Design for that: one warp per (b, h) reads each k and v
// element once (lanes stride over dh, so each 100-byte head row is one
// contiguous warp load), reduces the dot products with shuffles, keeps the
// F scores one per lane and the softmax in registers, and skips the k and
// v rows of masked slots (their weight is exactly 0).  The [B, F, H]
// scores never reach device memory.  k and v may be column slices of one
// fused [.., 2*H*dh] projection: the kernel takes their row stride.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxDPerLane = 4;  // dh <= 128
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, int B, int F, int H, int dh,
                     long long k_row, long long v_row) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)B * H) return;
  const long long b = w / H;
  const int h = (int)(w - b * H);

  float qr[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < dh ? to_f32(q[w * dh + d]) : 0.0f;
  }

  // lane f keeps score f
  const uint8_t* mrow = mask + b * F;
  float my_s = -INFINITY;
  for (int f = 0; f < F; ++f) {
    float s = -1e30f;
    if (mrow[f]) {
      const T* kr = k + (b * F + f) * k_row + (long long)h * dh;
      float p = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) p = fmaf(qr[i], to_f32(kr[d]), p);
      }
      p = warp_sum(p);
      s = p >= 0.0f ? p : 0.2f * p;
    }
    if (lane == f) my_s = s;
  }
  const float m = warp_max(my_s);
  const float e = (lane < F && mrow[lane]) ? expf(my_s - m) : 0.0f;
  const float den = fmaxf(warp_sum(e), 1e-10f);

  float acc[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) acc[i] = 0.0f;
  for (int f = 0; f < F; ++f) {
    const float a = __shfl_sync(kFull, e, f) / den;
    if (!mrow[f]) continue;
    const T* vr = v + (b * F + f) * v_row + (long long)h * dh;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) acc[i] = fmaf(a, to_f32(vr[d]), acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) out[w * dh + d] = from_f32<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, int B, int F, int H,
                   int dh, long long k_row, long long v_row,
                   cudaStream_t stream) {
  const long long warps = (long long)B * H;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  attention_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), B, F, H, dh,
      k_row, v_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [B, H, dh] contiguous; k, v: rows of H*dh contiguous values, row
// (b, f) starting at (b*F + f) * {k,v}_row elements; mask: [B, F] bytes.
// F <= 32, dh <= 128.  bf16 != 0 selects bf16 tensors (else f32).
// Returns cudaError_t.
int attention_fwd(int bf16, const void* q, const void* k, const void* v,
                  const uint8_t* mask, void* out, int B, int F, int H, int dh,
                  long long k_row, long long v_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, F, H, dh, k_row,
                                 v_row, s);
  return launch<float>(q, k, v, mask, out, B, F, H, dh, k_row, v_row, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
