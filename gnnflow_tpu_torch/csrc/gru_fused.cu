// Fused TimeEncode + GRU memory update, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnnflow_tpu/ops/gru_pallas.py:_call_fwd ->
// _fwd_kernel (pallas_call at gru_pallas.py:192, body :58-81).  Per row:
//
//   tf = cos(dts * tw + tb)                     (f32, precise cosf)
//   x  = [mail | tf]  rounded to the operand type
//   gi = x @ ki + bi,   gh = mem @ kh + bh      (f32 accumulation)
//   r  = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n  = tanh(gi_n + r * gh_n)
//   h  = (1 - z) * n + z * mem                  (mem as it arrived, in f32)
//
// Only h (f32) is written: the [N, 3F] gate pre-activations and the
// [N, DT] time encoding never reach device memory.
//
// Bound on the H100: at the TGN main path (N = 132,000, DR = 372,
// DT = F = 100, bf16 operands) the function moves ~178 MB (mem and mail in
// bf16, dts, h in f32), 0.053 ms at 3.35 TB/s, and does 45 GFLOP, 0.046 ms
// on bf16 tensor cores -- memory-bound if the products ran on tensor cores.
// This first version runs the products as f32 FMAs on CUDA cores (67
// TFLOP/s peak, 0.68 ms), so it is bound by operations.  Design for that:
// a block stages 32 rows of [mail | tf] and mem in shared memory as f32
// values already rounded to the operand type (so the inner loop has no
// conversions on the activations); each thread owns one gate column j and
// 16 rows, keeps 4 accumulators per row (r and z merge gi + gh; n keeps
// gi_n and gh_n apart), reads the activations as broadcast float4 loads and
// the weight columns (ki is 283 KB in bf16, L2-resident) with coalesced
// __ldg.  The time encoding is computed once per element while staging.
// A tensor-core (wgmma / mma.sync) version is later work.
//
// Numerics: dts * tw and + tb are rounded separately (__fmul_rn,
// __fadd_rn) as the plain PyTorch version does; the argument reaches ~1e6
// on real streams, so contracting them into an FMA, or using __cosf, would
// change cos by up to ~0.1.  Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kRowsPerThread = 16;
constexpr int kRowGroups = kRowsPerBlock / kRowsPerThread;
constexpr int kColLanes = 128;  // gate columns per pass
constexpr int kThreads = kColLanes * kRowGroups;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// TIn: type of mem/mail as stored; TOp: matmul operand type.
template <typename TIn, typename TOp>
__global__ void __launch_bounds__(kThreads)
gru_fused_fwd_kernel(const TIn* __restrict__ mem, const TIn* __restrict__ mail,
                     const float* __restrict__ dts,
                     const TOp* __restrict__ ki, const float* __restrict__ bi,
                     const TOp* __restrict__ kh, const float* __restrict__ bh,
                     const float* __restrict__ tw, const float* __restrict__ tb,
                     float* __restrict__ h, int n, int f, int dr, int dt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k_in = dr + dt;
  const int kp = (k_in + 3) & ~3;     // padded row stride of xs
  const int fp = (f + 3) & ~3;        // padded row stride of hs
  float* xs = smem;                   // [kRowsPerBlock][kp]
  float* hs = smem + kRowsPerBlock * kp;  // [kRowsPerBlock][fp]
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;

  // ---- stage [mail | tf] and mem, rounded to the operand type ----------
  for (int i = tid; i < kRowsPerBlock * dr; i += kThreads) {
    const int r = i / dr, c = i - r * dr;
    const int row = row0 + r;
    const float v = row < n ? to_f32(mail[(size_t)row * dr + c]) : 0.0f;
    xs[r * kp + c] = round_to<TOp>(v);
  }
  for (int i = tid; i < kRowsPerBlock * dt; i += kThreads) {
    const int r = i / dt, c = i - r * dt;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < n) v = cosf(__fadd_rn(__fmul_rn(dts[row], tw[c]), tb[c]));
    xs[r * kp + dr + c] = round_to<TOp>(v);
  }
  for (int i = tid; i < kRowsPerBlock * (kp - k_in); i += kThreads) {
    const int pad = kp - k_in;
    xs[(i / pad) * kp + k_in + i % pad] = 0.0f;
  }
  for (int i = tid; i < kRowsPerBlock * f; i += kThreads) {
    const int r = i / f, c = i - r * f;
    const int row = row0 + r;
    const float v = row < n ? to_f32(mem[(size_t)row * f + c]) : 0.0f;
    hs[r * fp + c] = round_to<TOp>(v);
  }
  __syncthreads();

  const int rg = tid / kColLanes;
  const int tc = tid - rg * kColLanes;
  const int f3 = 3 * f;
  const float* xr = xs + rg * kRowsPerThread * kp;
  const float* hr = hs + rg * kRowsPerThread * fp;
  const int k4 = k_in & ~3;
  const int f4 = f & ~3;

  for (int j0 = 0; j0 < f; j0 += kColLanes) {
    const int j = j0 + tc;
    const int jj = j < f ? j : f - 1;  // idle lanes load a valid column
    float acc_r[kRowsPerThread], acc_z[kRowsPerThread];
    float acc_in[kRowsPerThread], acc_hn[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      acc_r[r] = acc_z[r] = acc_in[r] = acc_hn[r] = 0.0f;
    }

    // gi: [mail | tf] @ ki
    const TOp* wcol = ki + jj;
    for (int k = 0; k < k4; k += 4) {
      float w[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w[u][g] = to_f32(__ldg(wcol + (size_t)(k + u) * f3 + g * f));
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xr + r * kp + k);
        acc_r[r] = fmaf(x.x, w[0][0], acc_r[r]);
        acc_z[r] = fmaf(x.x, w[0][1], acc_z[r]);
        acc_in[r] = fmaf(x.x, w[0][2], acc_in[r]);
        acc_r[r] = fmaf(x.y, w[1][0], acc_r[r]);
        acc_z[r] = fmaf(x.y, w[1][1], acc_z[r]);
        acc_in[r] = fmaf(x.y, w[1][2], acc_in[r]);
        acc_r[r] = fmaf(x.z, w[2][0], acc_r[r]);
        acc_z[r] = fmaf(x.z, w[2][1], acc_z[r]);
        acc_in[r] = fmaf(x.z, w[2][2], acc_in[r]);
        acc_r[r] = fmaf(x.w, w[3][0], acc_r[r]);
        acc_z[r] = fmaf(x.w, w[3][1], acc_z[r]);
        acc_in[r] = fmaf(x.w, w[3][2], acc_in[r]);
      }
    }
    for (int k = k4; k < k_in; ++k) {
      const float w0 = to_f32(__ldg(wcol + (size_t)k * f3));
      const float w1 = to_f32(__ldg(wcol + (size_t)k * f3 + f));
      const float w2 = to_f32(__ldg(wcol + (size_t)k * f3 + 2 * f));
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float x = xr[r * kp + k];
        acc_r[r] = fmaf(x, w0, acc_r[r]);
        acc_z[r] = fmaf(x, w1, acc_z[r]);
        acc_in[r] = fmaf(x, w2, acc_in[r]);
      }
    }

    // gh: mem @ kh
    const TOp* hcol = kh + jj;
    for (int k = 0; k < f4; k += 4) {
      float w[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w[u][g] = to_f32(__ldg(hcol + (size_t)(k + u) * f3 + g * f));
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(hr + r * fp + k);
        acc_r[r] = fmaf(x.x, w[0][0], acc_r[r]);
        acc_z[r] = fmaf(x.x, w[0][1], acc_z[r]);
        acc_hn[r] = fmaf(x.x, w[0][2], acc_hn[r]);
        acc_r[r] = fmaf(x.y, w[1][0], acc_r[r]);
        acc_z[r] = fmaf(x.y, w[1][1], acc_z[r]);
        acc_hn[r] = fmaf(x.y, w[1][2], acc_hn[r]);
        acc_r[r] = fmaf(x.z, w[2][0], acc_r[r]);
        acc_z[r] = fmaf(x.z, w[2][1], acc_z[r]);
        acc_hn[r] = fmaf(x.z, w[2][2], acc_hn[r]);
        acc_r[r] = fmaf(x.w, w[3][0], acc_r[r]);
        acc_z[r] = fmaf(x.w, w[3][1], acc_z[r]);
        acc_hn[r] = fmaf(x.w, w[3][2], acc_hn[r]);
      }
    }
    for (int k = f4; k < f; ++k) {
      const float w0 = to_f32(__ldg(hcol + (size_t)k * f3));
      const float w1 = to_f32(__ldg(hcol + (size_t)k * f3 + f));
      const float w2 = to_f32(__ldg(hcol + (size_t)k * f3 + 2 * f));
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float x = hr[r * fp + k];
        acc_r[r] = fmaf(x, w0, acc_r[r]);
        acc_z[r] = fmaf(x, w1, acc_z[r]);
        acc_hn[r] = fmaf(x, w2, acc_hn[r]);
      }
    }

    if (j < f) {
      // biases are added in f32 after the products
      const float b_r = bi[j] + bh[j];
      const float b_z = bi[f + j] + bh[f + j];
      const float b_in = bi[2 * f + j];
      const float b_hn = bh[2 * f + j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = row0 + rg * kRowsPerThread + r;
        if (row < n) {
          const float rr = sigmoid(acc_r[r] + b_r);
          const float zz = sigmoid(acc_z[r] + b_z);
          const float nn = tanhf(acc_in[r] + b_in + rr * (acc_hn[r] + b_hn));
          const float m = to_f32(mem[(size_t)row * f + j]);
          h[(size_t)row * f + j] = (1.0f - zz) * nn + zz * m;
        }
      }
    }
  }
}

template <typename TIn, typename TOp>
cudaError_t launch(const void* mem, const void* mail, const float* dts,
                   const void* ki, const float* bi, const void* kh,
                   const float* bh, const float* tw, const float* tb,
                   float* h, int n, int f, int dr, int dt,
                   cudaStream_t stream) {
  const int kp = (dr + dt + 3) & ~3;
  const int fp = (f + 3) & ~3;
  const size_t smem = sizeof(float) * kRowsPerBlock * (kp + fp);
  auto kernel = gru_fused_fwd_kernel<TIn, TOp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(mem), static_cast<const TIn*>(mail), dts,
      static_cast<const TOp*>(ki), bi, static_cast<const TOp*>(kh), bh, tw,
      tb, h, n, f, dr, dt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in_bf16: mem and mail are bf16 (else f32); op_bf16: ki and kh are bf16
// and the activations are rounded to bf16 (else f32).  bf16 rows come only
// with bf16 operands (the bf16 memory pull).  Returns cudaError_t.
int gru_fused_fwd(int in_bf16, int op_bf16, const void* mem, const void* mail,
                  const float* dts, const void* ki, const float* bi,
                  const void* kh, const float* bh, const float* tw,
                  const float* tb, float* h, int n, int f, int dr, int dt,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && op_bf16)
    return launch<bf16, bf16>(mem, mail, dts, ki, bi, kh, bh, tw, tb, h, n,
                              f, dr, dt, s);
  if (in_bf16) return cudaErrorInvalidValue;
  if (op_bf16)
    return launch<float, bf16>(mem, mail, dts, ki, bi, kh, bh, tw, tb, h, n,
                               f, dr, dt, s);
  return launch<float, float>(mem, mail, dts, ki, bi, kh, bh, tw, tb, h, n, f,
                              dr, dt, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
