// Fused TimeEncode + GRU memory update, forward (K1) and backward (K2), for
// Hopper (sm_90a).
//
// K1 replaces the TPU kernel gnnflow_tpu/ops/gru_pallas.py:_call_fwd ->
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
// K2 replaces gnnflow_tpu/ops/gru_pallas.py:_call_bwd -> _bwd_kernel
// (pallas_call at gru_pallas.py:210, body :84-145): the parameter
// gradients of K1 for an incoming dh [N, F] (mem, mail and dts get none).
// It recomputes the gates with K1's staging and products (the same code,
// so the same numerics), then
//
//   da_n = dh (1 - z)(1 - n^2),  da_z = dh (mem - n) z (1 - z),
//   da_r = da_n gh_n r (1 - r),  dah = (da_r, da_z, da_n r)
//   dKi = [mail | tf]^T da,  dKh = mem^T dah   (operands in the operand
//        type, f32 sums)
//   dbi = sum da,  dbh = sum dah                (from the f32 da)
//   dtf = da kt^T,  darg = -sin(dts tw + tb) dtf,
//   dtw = sum darg dts,  dtb = sum darg
//
// A dKi partial (472 x 300 f32, 566 KB) does not fit a block's shared
// memory, so K2 runs as six launches on the caller's stream: (1) kt
// transposed to [3F, DT] so that the dtf loop reads it coalesced; (2) a
// row-tile kernel over a fixed grid that walks the 32-row tiles, recomputes
// the gates, writes da/dah [N, 4F] and the time encoding [N, DT] in the
// operand type, computes dtf and keeps the bias and dtw/dtb sums of its
// tiles in shared memory, then writes one partial per block; (3, 4) a
// tiled X^T D product per weight gradient, each block owning a 64 x 64
// output tile over one chunk of rows and writing a partial; (5, 6) sums of
// the partials in a fixed order.  No float atomics: two runs on the same
// inputs give bit-identical gradients.  Rows >= N are zero before any
// product, so garbage rows can never become NaN * 0.
//
// K2 bound at the main path: ~98 GFLOP (45 to recompute, 45 for dK, 8 for
// dtf), 0.10 ms on bf16 tensor cores; ~178 MB of inputs plus dh, 0.053 ms.
// Here everything runs as f32 FMAs on CUDA cores (1.5 ms at 67 TFLOP/s),
// and the da and tf intermediates (~130 MB in bf16) make a round trip
// through device memory that the TPU kernel avoids.  Fusing them away and
// tensor cores are later work.
//
// Numerics: dts * tw and + tb are rounded separately (__fmul_rn,
// __fadd_rn) as the plain PyTorch version does, for cos and for sin; the
// argument reaches ~1e6 on real streams, so contracting them into an FMA,
// or using __cosf / __sinf, would change the result by up to ~0.1.  Build
// without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kRowsPerThread = 16;
constexpr int kRowGroups = kRowsPerBlock / kRowsPerThread;
constexpr int kColLanes = 128;  // gate columns per pass
constexpr int kThreads = kColLanes * kRowGroups;

// X^T D product tiles (K2)
constexpr int kTileM = 64;
constexpr int kTileP = 64;
constexpr int kTileK = 32;
constexpr int kProductThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

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

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// four consecutive values as f32 (16-byte or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float time_arg(float dts, float w, float b) {
  return __fadd_rn(__fmul_rn(dts, w), b);
}

// Stage rows [row0, row0 + 32) of [mail | cos(dts*tw+tb)] into xs and of
// mem into hs, as f32 values rounded to the operand type; rows >= n are 0.
template <typename TIn, typename TOp>
__device__ __forceinline__ void stage_tile(
    const TIn* __restrict__ mem, const TIn* __restrict__ mail,
    const float* __restrict__ dts, const float* __restrict__ tw,
    const float* __restrict__ tb, float* xs, float* hs, int row0, int n,
    int f, int dr, int dt, int kp, int fp) {
  const int tid = threadIdx.x;
  const int k_in = dr + dt;
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
    if (row < n) v = cosf(time_arg(dts[row], tw[c], tb[c]));
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
}

// Gate sums of gate column jj for the 16 staged rows at xr / hr:
// acc_r = gi_r + gh_r, acc_z = gi_z + gh_z, acc_in = gi_n, acc_hn = gh_n,
// all without biases.
template <typename TOp>
__device__ __forceinline__ void gate_sums(
    const float* xr, const float* hr, const TOp* __restrict__ ki,
    const TOp* __restrict__ kh, int jj, int f, int k_in, int kp, int fp,
    float (&acc_r)[kRowsPerThread], float (&acc_z)[kRowsPerThread],
    float (&acc_in)[kRowsPerThread], float (&acc_hn)[kRowsPerThread]) {
  const int f3 = 3 * f;
  const int k4 = k_in & ~3;
  const int f4 = f & ~3;
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
}

// ---- K1: forward ---------------------------------------------------------

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

  stage_tile<TIn, TOp>(mem, mail, dts, tw, tb, xs, hs, row0, n, f, dr, dt,
                       kp, fp);
  __syncthreads();

  const int rg = threadIdx.x / kColLanes;
  const int tc = threadIdx.x - rg * kColLanes;
  const float* xr = xs + rg * kRowsPerThread * kp;
  const float* hr = hs + rg * kRowsPerThread * fp;

  for (int j0 = 0; j0 < f; j0 += kColLanes) {
    const int j = j0 + tc;
    const int jj = j < f ? j : f - 1;  // idle lanes load a valid column
    float acc_r[kRowsPerThread], acc_z[kRowsPerThread];
    float acc_in[kRowsPerThread], acc_hn[kRowsPerThread];
    gate_sums<TOp>(xr, hr, ki, kh, jj, f, k_in, kp, fp, acc_r, acc_z, acc_in,
                   acc_hn);

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
cudaError_t launch_fwd(const void* mem, const void* mail, const float* dts,
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

// ---- K2: backward --------------------------------------------------------

// ktt[k][c] = ki[dr + c][k]: the time rows of ki, transposed.
template <typename TOp>
__global__ void transpose_time_rows_kernel(const TOp* __restrict__ ki,
                                           TOp* __restrict__ ktt, int f3,
                                           int dr, int dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f3 * dt) return;
  const int k = i / dt, c = i - k * dt;
  ktt[i] = ki[(size_t)(dr + c) * f3 + k];
}

// Shared memory of the row-tile kernel: xs [32][kp] and hs [32][fp] (f32),
// das [32][gp] (operand type), then the block's running sums, f32:
// [row group][dbi_r | dbi_z | dbi_n | dbh_n] (4F each) and
// [row group][dtw | dtb] (2DT each).
template <typename TOp>
size_t bwd_rows_smem(int f, int dr, int dt) {
  const int kp = (dr + dt + 3) & ~3;
  const int fp = (f + 3) & ~3;
  const int gp = (3 * f + 3) & ~3;
  return sizeof(float) * kRowsPerBlock * (kp + fp)
      + sizeof(TOp) * kRowsPerBlock * gp
      + sizeof(float) * kRowGroups * (4 * f + 2 * dt);
}

// Grid-stride over 32-row tiles.  Writes d_out [n][4F] = (da_r, da_z, da_n,
// da_n * r) and tf_out [n][DT] in the operand type, and this block's
// partial [dbi (3F) | dbh (3F) | dtw (DT) | dtb (DT)].
template <typename TIn, typename TOp>
__global__ void __launch_bounds__(kThreads)
gru_bwd_rows_kernel(const TIn* __restrict__ mem, const TIn* __restrict__ mail,
                    const float* __restrict__ dts,
                    const TOp* __restrict__ ki, const float* __restrict__ bi,
                    const TOp* __restrict__ kh, const float* __restrict__ bh,
                    const float* __restrict__ tw, const float* __restrict__ tb,
                    const float* __restrict__ dh,
                    const TOp* __restrict__ ktt, TOp* __restrict__ d_out,
                    TOp* __restrict__ tf_out, float* __restrict__ part,
                    int n, int f, int dr, int dt) {
  extern __shared__ float4 smem4[];
  const int k_in = dr + dt;
  const int kp = (k_in + 3) & ~3;
  const int fp = (f + 3) & ~3;
  const int f3 = 3 * f;
  const int gp = (f3 + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + kRowsPerBlock * kp;
  TOp* das = reinterpret_cast<TOp*>(hs + kRowsPerBlock * fp);
  float* sacc = reinterpret_cast<float*>(das + kRowsPerBlock * gp);
  float* tacc = sacc + kRowGroups * 4 * f;
  const int tid = threadIdx.x;
  const int rg = tid / kColLanes;
  const int tc = tid - rg * kColLanes;
  for (int i = tid; i < kRowGroups * (4 * f + 2 * dt); i += kThreads)
    sacc[i] = 0.0f;  // sacc and tacc are contiguous
  const float* xr = xs + rg * kRowsPerThread * kp;
  const float* hr = hs + rg * kRowsPerThread * fp;
  const TOp* dar = das + rg * kRowsPerThread * gp;
  const int ntiles = (n + kRowsPerBlock - 1) / kRowsPerBlock;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * kRowsPerBlock;
    stage_tile<TIn, TOp>(mem, mail, dts, tw, tb, xs, hs, row0, n, f, dr, dt,
                         kp, fp);
    __syncthreads();
    // the tile's time encoding, the second operand part of dKi
    for (int i = tid; i < kRowsPerBlock * dt; i += kThreads) {
      const int r = i / dt, c = i - r * dt;
      const int row = row0 + r;
      if (row < n)
        tf_out[(size_t)row * dt + c] = from_f32<TOp>(xs[r * kp + dr + c]);
    }

    for (int j0 = 0; j0 < f; j0 += kColLanes) {
      const int j = j0 + tc;
      const int jj = j < f ? j : f - 1;
      float acc_r[kRowsPerThread], acc_z[kRowsPerThread];
      float acc_in[kRowsPerThread], acc_hn[kRowsPerThread];
      gate_sums<TOp>(xr, hr, ki, kh, jj, f, k_in, kp, fp, acc_r, acc_z,
                     acc_in, acc_hn);
      if (j < f) {
        const float b_r = bi[j] + bh[j];
        const float b_z = bi[f + j] + bh[f + j];
        const float b_in = bi[2 * f + j];
        const float b_hn = bh[2 * f + j];
        float s_r = 0.0f, s_z = 0.0f, s_n = 0.0f, s_hn = 0.0f;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int lr = rg * kRowsPerThread + r;
          const int row = row0 + lr;
          float da_r = 0.0f, da_z = 0.0f, da_n = 0.0f, dah_n = 0.0f;
          if (row < n) {
            const float rr = sigmoid(acc_r[r] + b_r);
            const float zz = sigmoid(acc_z[r] + b_z);
            const float ghn = acc_hn[r] + b_hn;
            const float nn = tanhf(acc_in[r] + b_in + rr * ghn);
            const float g = dh[(size_t)row * f + j];
            const float m = to_f32(mem[(size_t)row * f + j]);
            const float dn = g * (1.0f - zz);
            da_n = dn * (1.0f - nn * nn);
            da_z = g * (m - nn) * zz * (1.0f - zz);
            da_r = da_n * ghn * rr * (1.0f - rr);
            dah_n = da_n * rr;
            TOp* drow = d_out + (size_t)row * 4 * f;
            drow[j] = from_f32<TOp>(da_r);
            drow[f + j] = from_f32<TOp>(da_z);
            drow[2 * f + j] = from_f32<TOp>(da_n);
            drow[3 * f + j] = from_f32<TOp>(dah_n);
          }
          das[lr * gp + j] = from_f32<TOp>(da_r);
          das[lr * gp + f + j] = from_f32<TOp>(da_z);
          das[lr * gp + 2 * f + j] = from_f32<TOp>(da_n);
          s_r += da_r;
          s_z += da_z;
          s_n += da_n;
          s_hn += dah_n;
        }
        float* sa = sacc + rg * 4 * f;
        sa[j] += s_r;
        sa[f + j] += s_z;
        sa[2 * f + j] += s_n;
        sa[3 * f + j] += s_hn;
      }
    }
    __syncthreads();

    // dtf = da @ kt^T for this thread's 16 rows and time column c; then
    // darg = -sin(dts * tw + tb) * dtf summed into dtw and dtb
    for (int c0 = 0; c0 < dt; c0 += kColLanes) {
      const int c = c0 + tc;
      const int cc = c < dt ? c : dt - 1;
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;
      const TOp* kcol = ktt + cc;
      const int k4 = f3 & ~3;
      for (int k = 0; k < k4; k += 4) {
        const float w0 = to_f32(__ldg(kcol + (size_t)k * dt));
        const float w1 = to_f32(__ldg(kcol + (size_t)(k + 1) * dt));
        const float w2 = to_f32(__ldg(kcol + (size_t)(k + 2) * dt));
        const float w3 = to_f32(__ldg(kcol + (size_t)(k + 3) * dt));
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float4 a = load4(dar + r * gp + k);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
      for (int k = k4; k < f3; ++k) {
        const float w = to_f32(__ldg(kcol + (size_t)k * dt));
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = fmaf(to_f32(dar[r * gp + k]), w, acc[r]);
      }
      if (c < dt) {
        const float w = tw[c], b = tb[c];
        float s_w = 0.0f, s_b = 0.0f;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int row = row0 + rg * kRowsPerThread + r;
          if (row < n) {
            const float t = dts[row];
            const float darg = -sinf(time_arg(t, w, b)) * acc[r];
            s_w += darg * t;
            s_b += darg;
          }
        }
        float* ta = tacc + rg * 2 * dt;
        ta[c] += s_w;
        ta[dt + c] += s_b;
      }
    }
    __syncthreads();  // xs, hs and das are restaged by the next tile
  }
  __syncthreads();

  // the two row groups, in a fixed order
  float* out = part + (size_t)blockIdx.x * (6 * f + 2 * dt);
  for (int i = tid; i < f3; i += kThreads) {
    out[i] = sacc[i] + sacc[4 * f + i];                  // dbi: r, z, n
    const int s = i < 2 * f ? i : i + f;                 // dbh: r, z, hn
    out[f3 + i] = sacc[s] + sacc[4 * f + s];
  }
  for (int i = tid; i < 2 * dt; i += kThreads)
    out[6 * f + i] = tacc[i] + tacc[2 * dt + i];
}

// part[m][p] over the rows of this block's chunk (blockIdx.z):
//   sum_row A[row][m] * B[row][bcol(p)],
// A = [a1 (TIn, m1 columns) | a2 (TOp, m2 columns)] rounded to TOp,
// bcol(p) = p < bsplit ? p : p + bshift.  Each block owns one 64 x 64
// output tile; partial z starts at part + z * split_stride.
template <typename TIn, typename TOp>
__global__ void __launch_bounds__(kProductThreads)
rows_t_product_kernel(const TIn* __restrict__ a1, int m1,
                      const TOp* __restrict__ a2, int m2,
                      const TOp* __restrict__ b, int ldb, int np, int bsplit,
                      int bshift, float* __restrict__ part,
                      size_t split_stride, int n, int rows_per_split) {
  __shared__ __align__(16) float as[kTileK][kTileM];
  __shared__ __align__(16) float bs[kTileK][kTileP];
  const int m = m1 + m2;
  const int m0 = blockIdx.x * kTileM;
  const int p0 = blockIdx.y * kTileP;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tp = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = r0; k0 < r1; k0 += kTileK) {
    for (int i = tid; i < kTileK * kTileM; i += kProductThreads) {
      const int k = i / kTileM, c = i - k * kTileM;
      const int row = k0 + k, col = m0 + c;
      float v = 0.0f;
      if (row < r1 && col < m)
        v = col < m1 ? round_to<TOp>(to_f32(a1[(size_t)row * m1 + col]))
                     : to_f32(a2[(size_t)row * m2 + (col - m1)]);
      as[k][c] = v;
    }
    for (int i = tid; i < kTileK * kTileP; i += kProductThreads) {
      const int k = i / kTileP, c = i - k * kTileP;
      const int row = k0 + k, col = p0 + c;
      float v = 0.0f;
      if (row < r1 && col < np) {
        const int bc = col < bsplit ? col : col + bshift;
        v = to_f32(b[(size_t)row * ldb + bc]);
      }
      bs[k][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][tm * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&bs[k][tp * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tm * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tp * 4 + j;
      if (col < np) out[(size_t)row * np + col] = acc[i][j];
    }
  }
}

// out[i] = sum_{s < splits} part[s * len + i], s in order
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    int splits, size_t len,
                                    float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * len + i];
  out[i] = acc;
}

cudaError_t launch_sum(const float* part, int splits, size_t len, float* out,
                       cudaStream_t stream) {
  const int threads = 256;
  sum_partials_kernel<<<(unsigned)((len + threads - 1) / threads), threads,
                        0, stream>>>(part, splits, len, out);
  return cudaGetLastError();
}

template <typename TIn, typename TOp>
cudaError_t launch_bwd(const void* mem_, const void* mail_, const float* dts,
                       const void* ki_, const float* bi, const void* kh_,
                       const float* bh, const float* tw, const float* tb,
                       const float* dh, void* ktt_, void* d_buf_,
                       void* tf_buf_, float* part_rows, int row_blocks,
                       float* part_dk, int splits, float* dk, float* small,
                       int n, int f, int dr, int dt, cudaStream_t stream) {
  const TIn* mem = static_cast<const TIn*>(mem_);
  const TIn* mail = static_cast<const TIn*>(mail_);
  const TOp* ki = static_cast<const TOp*>(ki_);
  const TOp* kh = static_cast<const TOp*>(kh_);
  TOp* ktt = static_cast<TOp*>(ktt_);
  TOp* d_buf = static_cast<TOp*>(d_buf_);
  TOp* tf_buf = static_cast<TOp*>(tf_buf_);
  const int f3 = 3 * f;
  const int k_in = dr + dt;
  cudaError_t err;

  transpose_time_rows_kernel<TOp><<<(f3 * dt + 255) / 256, 256, 0, stream>>>(
      ki, ktt, f3, dr, dt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = bwd_rows_smem<TOp>(f, dr, dt);
  auto rows = gru_bwd_rows_kernel<TIn, TOp>;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  rows<<<row_blocks, kThreads, smem, stream>>>(
      mem, mail, dts, ki, bi, kh, bh, tw, tb, dh, ktt, d_buf, tf_buf,
      part_rows, n, f, dr, dt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dKi = [mail | tf]^T [da_r | da_z | da_n]; dKh = mem^T [da_r | da_z | dah_n]
  const int rows_per_split =
      (((n + splits - 1) / splits) + kTileK - 1) / kTileK * kTileK;
  const size_t stride = (size_t)(k_in + f) * f3;
  auto product = rows_t_product_kernel<TIn, TOp>;
  const dim3 gi((k_in + kTileM - 1) / kTileM, (f3 + kTileP - 1) / kTileP,
                splits);
  product<<<gi, kProductThreads, 0, stream>>>(
      mail, dr, tf_buf, dt, d_buf, 4 * f, f3, f3, 0, part_dk, stride, n,
      rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 gh((f + kTileM - 1) / kTileM, (f3 + kTileP - 1) / kTileP, splits);
  product<<<gh, kProductThreads, 0, stream>>>(
      mem, f, static_cast<const TOp*>(nullptr), 0, d_buf, 4 * f, f3, 2 * f, f,
      part_dk + (size_t)k_in * f3, stride, n, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = launch_sum(part_dk, splits, stride, dk, stream)) != cudaSuccess)
    return err;
  return launch_sum(part_rows, row_blocks, (size_t)(6 * f + 2 * dt), small,
                    stream);
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
    return launch_fwd<bf16, bf16>(mem, mail, dts, ki, bi, kh, bh, tw, tb, h,
                                  n, f, dr, dt, s);
  if (in_bf16) return cudaErrorInvalidValue;
  if (op_bf16)
    return launch_fwd<float, bf16>(mem, mail, dts, ki, bi, kh, bh, tw, tb, h,
                                   n, f, dr, dt, s);
  return launch_fwd<float, float>(mem, mail, dts, ki, bi, kh, bh, tw, tb, h,
                                  n, f, dr, dt, s);
}

// Parameter gradients for dh [n, f] f32.  Scratch, allocated by the
// caller: ktt [3f, dt], d_buf [n, 4f] and tf_buf [n, dt] in the operand
// type; part_rows [row_blocks, 6f + 2dt] and part_dk [splits,
// (dr + dt + f) * 3f] f32.  Outputs (f32): dk = [dKi (dr + dt, 3f) | dKh
// (f, 3f)] and small = [dbi (3f) | dbh (3f) | dtw (dt) | dtb (dt)].
// Returns cudaError_t.
int gru_fused_bwd(int in_bf16, int op_bf16, const void* mem, const void* mail,
                  const float* dts, const void* ki, const float* bi,
                  const void* kh, const float* bh, const float* tw,
                  const float* tb, const float* dh, void* ktt, void* d_buf,
                  void* tf_buf, float* part_rows, int row_blocks,
                  float* part_dk, int splits, float* dk, float* small, int n,
                  int f, int dr, int dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (row_blocks < 1 || splits < 1) return cudaErrorInvalidValue;
  if (in_bf16 && op_bf16)
    return launch_bwd<bf16, bf16>(mem, mail, dts, ki, bi, kh, bh, tw, tb, dh,
                                  ktt, d_buf, tf_buf, part_rows, row_blocks,
                                  part_dk, splits, dk, small, n, f, dr, dt, s);
  if (in_bf16) return cudaErrorInvalidValue;
  if (op_bf16)
    return launch_bwd<float, bf16>(mem, mail, dts, ki, bi, kh, bh, tw, tb,
                                   dh, ktt, d_buf, tf_buf, part_rows,
                                   row_blocks, part_dk, splits, dk, small, n,
                                   f, dr, dt, s);
  return launch_bwd<float, float>(mem, mail, dts, ki, bi, kh, bh, tw, tb, dh,
                                  ktt, d_buf, tf_buf, part_rows, row_blocks,
                                  part_dk, splits, dk, small, n, f, dr, dt, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
