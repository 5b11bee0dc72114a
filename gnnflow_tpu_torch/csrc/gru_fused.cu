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
// Bounds on the H100 at the TGN main path (N = 132,000, DR = 372,
// DT = F = 100, bf16 operands): K1 moves ~178 MB (0.053 ms at 3.35 TB/s)
// and does 45 GFLOP (0.046 ms on bf16 tensor cores); K2 does ~98 GFLOP
// (45 to recompute, 45 for dK, 8 for dtf), 0.10 ms, on ~231 MB.
//
// bf16 operands run on tensor cores (namespace tc), with mma.sync
// m16n8k16 (bf16 in, f32 accumulate):
// - A pack launch puts ki and kh, zero-padded (K to 16, each gate's
//   columns to 8), into mma B-fragment order, so that one k16 step of
//   every weight column is one contiguous slab.
// - A block owns a 64-row tile and every gate column.  It stages
//   [mail | tf | 0 | mem | 0] for the tile in shared memory in bf16 (bf16
//   rows by 8-byte cp.async; f32 rows rounded while staging; tf computed
//   once per element), then streams the weight slabs through a cp.async
//   ring of two slots of four k16 steps each (one barrier per slot).  The
//   block has two m groups of 32 rows; warp (mg, wj) of 2 x ceil(JT / 2),
//   JT = ceil(F / 8), at most 2 x 7, owns j8 tiles wj and wj + warps_j of
//   its 32 rows: A from ldmatrix, B as 8-byte shared loads, four
//   accumulators per fragment (gi_r + gh_r, gi_z + gh_z, gi_n, gh_n), so
//   the epilogue has r, z and n of one (row, j) in one thread's
//   registers.  Biases are added in f32 after the products.  Widths above
//   7 warps' tiles take more column passes over the staged rows.
// - K2's row-tile kernel walks 64-row tiles over a fixed grid (one block
//   per SM), recomputes the gates with the same code, writes the staged
//   bf16 rows (x_buf [N, KT]) and da/dah (d_buf [N, 4 JP]) for the
//   products, keeps da in shared memory for dtf = da kt^T (tensor cores,
//   kt's fragments loaded into the idle ring in one piece), and sums the
//   bias and dtw/dtb terms in f32 in a fixed order (shuffles, then one
//   owner per column and m group, the two groups added last).
//   The two weight gradients are one launch of 128 x 64 output tiles over
//   fixed row chunks (cp.async 3-deep ring, ldmatrix.trans for both
//   operands, which lie row-major over rows); partials are summed in a
//   fixed order.  No float atomics: two runs give identical bits.
//
// f32 operands stay full f32 on CUDA cores (no TF32): K1 stages 32 rows as
// f32 and gives each thread one gate column and 16 rows; K2 runs its
// row-tile kernel likewise, writes da and tf, and takes its products as
// 128 x 64 tiles with 8 x 8 outputs a thread.
//
// Left for later: mma.sync keeps the products far below the tensor cores'
// bf16 peak; K1 and K2 keep one 64-row tile per SM in flight (163 and
// 210 KB of shared memory at the main path's widths), so
// the staging and the epilogues do not overlap the products (wgmma with
// TMA and a warp-specialised producer would do both); the x_buf/d_buf
// round trip of K2 (~0.5 GB of HBM traffic at the main path) could be
// fused into the products.
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
constexpr int kTileM = 128;
constexpr int kTileP = 64;
constexpr int kTileK = 16;
constexpr int kProductThreads = 128;  // 16 x 8 threads, 8 x 8 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive floats (16-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// precise expf, as the plain version: with __expf the CPU-against-card
// train steps of chip_smoke.py parted ~10x further (f32 gradients)
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float time_arg(float dts, float w, float b) {
  return __fadd_rn(__fmul_rn(dts, w), b);
}

// The per-element math of the epilogues, out of line: one copy serves the
// unrolled fragment loops of every kernel here, which would otherwise
// inline tanhf and sinf's range reduction 16 to 32 times each.
__device__ __noinline__ float gru_h(float s_r, float s_z, float s_in,
                                    float s_hn, float m) {
  const float rr = sigmoid(s_r);
  const float zz = sigmoid(s_z);
  const float nn = tanhf(s_in + rr * s_hn);
  return (1.0f - zz) * nn + zz * m;
}

// (da_r, da_z, da_n, dah_n) for gate sums with biases and dh = gd
__device__ __noinline__ float4 gru_da(float s_r, float s_z, float s_in,
                                      float ghn, float gd, float m) {
  const float rr = sigmoid(s_r);
  const float zz = sigmoid(s_z);
  const float nn = tanhf(s_in + rr * ghn);
  const float da_n = gd * (1.0f - zz) * (1.0f - nn * nn);
  return make_float4(da_n * ghn * rr * (1.0f - rr),
                     gd * (m - nn) * zz * (1.0f - zz), da_n, da_n * rr);
}

__device__ __noinline__ float neg_sin_time(float t, float w, float b) {
  return -sinf(time_arg(t, w, b));
}

__device__ __noinline__ float cos_time(float t, float w, float b) {
  return cosf(time_arg(t, w, b));
}

// Stage rows [row0, row0 + 32) of [mail | cos(dts*tw+tb)] into xs and of
// mem into hs, as f32 values rounded to the operand type; rows >= n are 0.
__device__ __forceinline__ void stage_tile(
    const float* __restrict__ mem, const float* __restrict__ mail,
    const float* __restrict__ dts, const float* __restrict__ tw,
    const float* __restrict__ tb, float* xs, float* hs, int row0, int n,
    int f, int dr, int dt, int kp, int fp) {
  const int tid = threadIdx.x;
  const int k_in = dr + dt;
  for (int i = tid; i < kRowsPerBlock * dr; i += kThreads) {
    const int r = i / dr, c = i - r * dr;
    const int row = row0 + r;
    const float v = row < n ? to_f32(mail[(size_t)row * dr + c]) : 0.0f;
    xs[r * kp + c] = v;
  }
  for (int i = tid; i < kRowsPerBlock * dt; i += kThreads) {
    const int r = i / dt, c = i - r * dt;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < n) v = cosf(time_arg(dts[row], tw[c], tb[c]));
    xs[r * kp + dr + c] = v;
  }
  for (int i = tid; i < kRowsPerBlock * (kp - k_in); i += kThreads) {
    const int pad = kp - k_in;
    xs[(i / pad) * kp + k_in + i % pad] = 0.0f;
  }
  for (int i = tid; i < kRowsPerBlock * f; i += kThreads) {
    const int r = i / f, c = i - r * f;
    const int row = row0 + r;
    const float v = row < n ? to_f32(mem[(size_t)row * f + c]) : 0.0f;
    hs[r * fp + c] = v;
  }
}

// Gate sums of gate column jj for the 16 staged rows at xr / hr:
// acc_r = gi_r + gh_r, acc_z = gi_z + gh_z, acc_in = gi_n, acc_hn = gh_n,
// all without biases.
__device__ __forceinline__ void gate_sums(
    const float* xr, const float* hr, const float* __restrict__ ki,
    const float* __restrict__ kh, int jj, int f, int k_in, int kp, int fp,
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
  const float* wcol = ki + jj;
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
  const float* hcol = kh + jj;
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

__global__ void __launch_bounds__(kThreads)
gru_fused_fwd_kernel(const float* __restrict__ mem,
                     const float* __restrict__ mail,
                     const float* __restrict__ dts,
                     const float* __restrict__ ki, const float* __restrict__ bi,
                     const float* __restrict__ kh, const float* __restrict__ bh,
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

  stage_tile(mem, mail, dts, tw, tb, xs, hs, row0, n, f, dr, dt,
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
    gate_sums(xr, hr, ki, kh, jj, f, k_in, kp, fp, acc_r, acc_z, acc_in,
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
          h[(size_t)row * f + j] =
              gru_h(acc_r[r] + b_r, acc_z[r] + b_z, acc_in[r] + b_in,
                    acc_hn[r] + b_hn, to_f32(mem[(size_t)row * f + j]));
        }
      }
    }
  }
}

cudaError_t launch_fwd(const void* mem, const void* mail, const float* dts,
                       const void* ki, const float* bi, const void* kh,
                       const float* bh, const float* tw, const float* tb,
                       float* h, int n, int f, int dr, int dt,
                       cudaStream_t stream) {
  const int kp = (dr + dt + 3) & ~3;
  const int fp = (f + 3) & ~3;
  const size_t smem = sizeof(float) * kRowsPerBlock * (kp + fp);
  auto kernel = gru_fused_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(mem), static_cast<const float*>(mail), dts,
      static_cast<const float*>(ki), bi, static_cast<const float*>(kh), bh,
      tw,
      tb, h, n, f, dr, dt);
  return cudaGetLastError();
}

// ---- K2: backward --------------------------------------------------------

// ktt[k][c] = ki[dr + c][k]: the time rows of ki, transposed.
__global__ void transpose_time_rows_kernel(const float* __restrict__ ki,
                                           float* __restrict__ ktt, int f3,
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
size_t bwd_rows_smem(int f, int dr, int dt) {
  const int kp = (dr + dt + 3) & ~3;
  const int fp = (f + 3) & ~3;
  const int gp = (3 * f + 3) & ~3;
  return sizeof(float) * kRowsPerBlock * (kp + fp)
      + sizeof(float) * kRowsPerBlock * gp
      + sizeof(float) * kRowGroups * (4 * f + 2 * dt);
}

// Grid-stride over 32-row tiles.  Writes d_out [n][4F] = (da_r, da_z, da_n,
// da_n * r) and tf_out [n][DT] in the operand type, and this block's
// partial [dbi (3F) | dbh (3F) | dtw (DT) | dtb (DT)].
__global__ void __launch_bounds__(kThreads)
gru_bwd_rows_kernel(const float* __restrict__ mem,
                    const float* __restrict__ mail,
                    const float* __restrict__ dts,
                    const float* __restrict__ ki, const float* __restrict__ bi,
                    const float* __restrict__ kh, const float* __restrict__ bh,
                    const float* __restrict__ tw, const float* __restrict__ tb,
                    const float* __restrict__ dh,
                    const float* __restrict__ ktt, float* __restrict__ d_out,
                    float* __restrict__ tf_out, float* __restrict__ part,
                    int n, int f, int dr, int dt) {
  extern __shared__ float4 smem4[];
  const int k_in = dr + dt;
  const int kp = (k_in + 3) & ~3;
  const int fp = (f + 3) & ~3;
  const int f3 = 3 * f;
  const int gp = (f3 + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + kRowsPerBlock * kp;
  float* das = reinterpret_cast<float*>(hs + kRowsPerBlock * fp);
  float* sacc = reinterpret_cast<float*>(das + kRowsPerBlock * gp);
  float* tacc = sacc + kRowGroups * 4 * f;
  const int tid = threadIdx.x;
  const int rg = tid / kColLanes;
  const int tc = tid - rg * kColLanes;
  for (int i = tid; i < kRowGroups * (4 * f + 2 * dt); i += kThreads)
    sacc[i] = 0.0f;  // sacc and tacc are contiguous
  const float* xr = xs + rg * kRowsPerThread * kp;
  const float* hr = hs + rg * kRowsPerThread * fp;
  const float* dar = das + rg * kRowsPerThread * gp;
  const int ntiles = (n + kRowsPerBlock - 1) / kRowsPerBlock;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * kRowsPerBlock;
    stage_tile(mem, mail, dts, tw, tb, xs, hs, row0, n, f, dr, dt,
                         kp, fp);
    __syncthreads();
    // the tile's time encoding, the second operand part of dKi
    for (int i = tid; i < kRowsPerBlock * dt; i += kThreads) {
      const int r = i / dt, c = i - r * dt;
      const int row = row0 + r;
      if (row < n)
        tf_out[(size_t)row * dt + c] = xs[r * kp + dr + c];
    }

    for (int j0 = 0; j0 < f; j0 += kColLanes) {
      const int j = j0 + tc;
      const int jj = j < f ? j : f - 1;
      float acc_r[kRowsPerThread], acc_z[kRowsPerThread];
      float acc_in[kRowsPerThread], acc_hn[kRowsPerThread];
      gate_sums(xr, hr, ki, kh, jj, f, k_in, kp, fp, acc_r, acc_z,
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
            const float4 da = gru_da(acc_r[r] + b_r, acc_z[r] + b_z,
                                     acc_in[r] + b_in, acc_hn[r] + b_hn,
                                     dh[(size_t)row * f + j],
                                     to_f32(mem[(size_t)row * f + j]));
            da_r = da.x;
            da_z = da.y;
            da_n = da.z;
            dah_n = da.w;
            float* drow = d_out + (size_t)row * 4 * f;
            drow[j] = da_r;
            drow[f + j] = da_z;
            drow[2 * f + j] = da_n;
            drow[3 * f + j] = dah_n;
          }
          das[lr * gp + j] = da_r;
          das[lr * gp + f + j] = da_z;
          das[lr * gp + 2 * f + j] = da_n;
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
      const float* kcol = ktt + cc;
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
            const float darg = neg_sin_time(t, w, b) * acc[r];
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
// A = [a1 (m1 columns) | a2 (m2 columns)],
// bcol(p) = p < bsplit ? p : p + bshift.  Each block owns one 128 x 64
// output tile; thread (tm, tp) owns rows tm * 4 + {0..3, 64..67} and
// columns tp * 4 + {0..3, 32..35}, so its float4 reads of a k row are
// conflict-free.  The next 16-row k tile is loaded into registers while
// the current one is multiplied (two shared-memory buffers, one barrier a
// tile).  Partial z starts at part + z * split_stride.
__global__ void __launch_bounds__(kProductThreads)
rows_t_product_kernel(const float* __restrict__ a1, int m1,
                      const float* __restrict__ a2, int m2,
                      const float* __restrict__ b, int ldb, int np, int bsplit,
                      int bshift, float* __restrict__ part,
                      size_t split_stride, int n, int rows_per_split) {
  __shared__ __align__(16) float as[2][kTileK][kTileM];
  __shared__ __align__(16) float bs[2][kTileK][kTileP];
  constexpr int kA = kTileK * kTileM / kProductThreads;  // 16
  constexpr int kB = kTileK * kTileP / kProductThreads;  // 8
  const int m = m1 + m2;
  const int m0 = blockIdx.x * kTileM;
  const int p0 = blockIdx.y * kTileP;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int tid = threadIdx.x;
  const int tm = tid / 8, tp = tid % 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // thread tid loads A column tid % 128 and B column tid % 64 of each row
  const int ca = m0 + tid, cb = p0 + tid % kTileP;
  const int bc = cb < bsplit ? cb : cb + bshift;
  float ra[kA], rb[kB];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kA; ++u) {
      const int row = k0 + u;
      float v = 0.0f;
      if (row < r1 && ca < m)
        v = ca < m1 ? a1[(size_t)row * m1 + ca]
                    : a2[(size_t)row * m2 + (ca - m1)];
      ra[u] = v;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int row = k0 + 2 * u + tid / kTileP;
      rb[u] = row < r1 && cb < np ? to_f32(b[(size_t)row * ldb + bc]) : 0.0f;
    }
  };

  if (r0 < r1) load(r0);
  int buf = 0;
  for (int k0 = r0; k0 < r1; k0 += kTileK, buf ^= 1) {
#pragma unroll
    for (int u = 0; u < kA; ++u) as[buf][u][tid] = ra[u];
#pragma unroll
    for (int u = 0; u < kB; ++u)
      bs[buf][2 * u + tid / kTileP][tid % kTileP] = rb[u];
    __syncthreads();
    if (k0 + kTileK < r1) load(k0 + kTileK);
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&as[buf][k][tm * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&as[buf][k][tm * 4 + 64]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&bs[buf][k][tp * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&bs[buf][k][tp * 4 + 32]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                           b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = part + (size_t)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tm * 4 + (i & 3) + (i >> 2) * 64;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p0 + tp * 4 + (j & 3) + (j >> 2) * 32;
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

cudaError_t launch_bwd(const void* mem_, const void* mail_, const float* dts,
                       const void* ki_, const float* bi, const void* kh_,
                       const float* bh, const float* tw, const float* tb,
                       const float* dh, void* ktt_, void* d_buf_,
                       void* tf_buf_, float* part_rows, int row_blocks,
                       float* part_dk, int splits, float* dk, float* small,
                       int n, int f, int dr, int dt, cudaStream_t stream) {
  const float* mem = static_cast<const float*>(mem_);
  const float* mail = static_cast<const float*>(mail_);
  const float* ki = static_cast<const float*>(ki_);
  const float* kh = static_cast<const float*>(kh_);
  float* ktt = static_cast<float*>(ktt_);
  float* d_buf = static_cast<float*>(d_buf_);
  float* tf_buf = static_cast<float*>(tf_buf_);
  const int f3 = 3 * f;
  const int k_in = dr + dt;
  cudaError_t err;

  transpose_time_rows_kernel<<<(f3 * dt + 255) / 256, 256, 0, stream>>>(
      ki, ktt, f3, dr, dt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = bwd_rows_smem(f, dr, dt);
  auto rows = gru_bwd_rows_kernel;
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
  auto product = rows_t_product_kernel;
  const dim3 gi((k_in + kTileM - 1) / kTileM, (f3 + kTileP - 1) / kTileP,
                splits);
  product<<<gi, kProductThreads, 0, stream>>>(
      mail, dr, tf_buf, dt, d_buf, 4 * f, f3, f3, 0, part_dk, stride, n,
      rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 gh((f + kTileM - 1) / kTileM, (f3 + kTileP - 1) / kTileP, splits);
  product<<<gh, kProductThreads, 0, stream>>>(
      mem, f, static_cast<const float*>(nullptr), 0, d_buf, 4 * f, f3,
      2 * f, f,
      part_dk + (size_t)k_in * f3, stride, n, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = launch_sum(part_dk, splits, stride, dk, stream)) != cudaSuccess)
    return err;
  return launch_sum(part_rows, row_blocks, (size_t)(6 * f + 2 * dt), small,
                    stream);
}

// ---- bf16 operands on tensor cores --------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows of a tile: 4 m16 tiles
constexpr int kMG = 2;         // m groups: warps split the 64 rows in two
constexpr int kMT = kRows / 16 / kMG;  // m16 tiles a warp owns
constexpr int kNJ = 2;         // j8 tiles a warp owns in a column pass
constexpr int kMaxWarpsJ = 7;  // warps along the gate columns
constexpr int kMaxThreads = kMG * kMaxWarpsJ * 32;
constexpr int kStages = 2;     // cp.async ring of weight slots
constexpr int kSlotSteps = 4;  // k16 steps of weight fragments a slot
constexpr int kFrag = 128;     // bf16 values of one packed B fragment
constexpr int kRowBlocks = 132;  // K2 row-tile grid: one block per SM
constexpr int kSplitRows = 8192;  // K2's weight-gradient row chunks
constexpr int kMaxSplits = 16;

__host__ __device__ inline int up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }

// Shapes shared by the launch code and the kernels.  The operand row of a
// tile is [mail | tf | 0 pad to KX | mem | 0 pad to KH]; gate columns are
// padded per gate to JP = 8 JT.
struct Geo {
  int n, f, dr, dt, k_in;
  int kx, kh, kt;      // kx = up(k_in, 16), kh = up(f, 16), kt = kx + kh
  int jt, jp;          // j8 tiles of a gate, padded gate width
  int warps_j, warps, pass_tiles, passes;
  int k3, ct, dtp;     // dtf product: K = up(3 JP, 16), c8 tiles, DT pad
  int slab;            // bf16 values of one k16 step's B fragments
};

__host__ __device__ inline Geo make_geo(int n, int f, int dr, int dt) {
  Geo g;
  g.n = n; g.f = f; g.dr = dr; g.dt = dt; g.k_in = dr + dt;
  g.kx = up(g.k_in, 16); g.kh = up(f, 16); g.kt = g.kx + g.kh;
  g.jt = cdiv(f, 8); g.jp = 8 * g.jt;
  g.warps_j = cdiv(g.jt, kNJ) < kMaxWarpsJ ? cdiv(g.jt, kNJ) : kMaxWarpsJ;
  g.warps = kMG * g.warps_j;
  g.pass_tiles = kNJ * g.warps_j;
  g.passes = cdiv(g.jt, g.pass_tiles);
  g.k3 = up(3 * g.jp, 16); g.ct = cdiv(dt, 8); g.dtp = 8 * g.ct;
  g.slab = (3 * g.pass_tiles > g.ct ? 3 * g.pass_tiles : g.ct) * kFrag;
  return g;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Packs the weights into mma B-fragment order, zero-padded:
//   wp [KT/16][JT][3][32 lanes][4]: B[k][g JP + j] = ki[k][g F + j] for
//     k < k_in, kh[k - KX][g F + j] for KX <= k < KX + F;
//   ktp [K3/16][CT][32][4] (backward only):
//     B[g JP + j][c] = ki[dr + c][g F + j].
// Lane l of a fragment holds B[k][n] at n = l / 4, k = 2 (l % 4) + {0, 1}
// and + 8, so a warp reads one fragment as 32 coalesced 8-byte loads.
__global__ void pack_kernel(const bf16* __restrict__ ki,
                            const bf16* __restrict__ kh, Geo g,
                            bf16* __restrict__ wp, bf16* __restrict__ ktp) {
  const int nw = g.kt / 16 * g.jt * 3 * kFrag;
  const int nt = ktp ? g.k3 / 16 * g.ct * kFrag : 0;
  const int f3 = 3 * g.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nw + nt;
       i += gridDim.x * blockDim.x) {
    const int e = (i < nw ? i : i - nw) % kFrag;
    const int frag = (i < nw ? i : i - nw) / kFrag;
    const int lane = e / 4, v = e % 4;
    const int kk = 2 * (lane % 4) + (v & 1) + (v >> 1) * 8;
    const int nn = lane / 4;
    float x = 0.0f;
    if (i < nw) {
      const int gate = frag % 3, jt = frag / 3 % g.jt, s = frag / 3 / g.jt;
      const int k = s * 16 + kk, j = jt * 8 + nn;
      if (j < g.f) {
        if (k < g.k_in)
          x = __bfloat162float(ki[(size_t)k * f3 + gate * g.f + j]);
        else if (k >= g.kx && k - g.kx < g.f)
          x = __bfloat162float(kh[(size_t)(k - g.kx) * f3 + gate * g.f + j]);
      }
      wp[i] = __float2bfloat16_rn(x);
    } else {
      const int ct = frag % g.ct, s = frag / g.ct;
      const int k = s * 16 + kk, c = ct * 8 + nn;
      const int gate = k / g.jp, j = k % g.jp;
      if (gate < 3 && j < g.f && c < g.dt)
        x = __bfloat162float(ki[(size_t)(g.dr + c) * f3 + gate * g.f + j]);
      ktp[i - nw] = __float2bfloat16_rn(x);
    }
  }
}

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
// Value q of the 16 bytes u as f32: a float, or a bf16 (exact).
__device__ __forceinline__ float lane_value(const uint4& u, int q, float*) {
  return __uint_as_float(word(u, q));
}
__device__ __forceinline__ float lane_value(const uint4& u, int q, bf16*) {
  const unsigned w = word(u, q / 2);
  return __uint_as_float(q % 2 ? (w & 0xffff0000u) : (w << 16));
}

// Copy `rows` rows of a row-major [*, width] array from src (a contiguous
// range) into columns [col0, col0 + width) of as, rounded to bf16.  Where
// src is 16-byte aligned it is read as 16-byte vectors, four in flight per
// thread, so that the staging is not bound by load latency.
template <typename TIn>
__device__ __forceinline__ void stage_block(bf16* as, int lda, int col0,
                                            const TIn* __restrict__ src,
                                            int width, int rows) {
  constexpr int V = 16 / sizeof(TIn);
  constexpr int U = 4;
  const int total = rows * width;
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const int nvec = total / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += U * blockDim.x) {
      uint4 u[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int v = v0 + k * blockDim.x;
        if (v < nvec) u[k] = __ldg(s4 + v);
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int v = v0 + k * blockDim.x;
        if (v >= nvec) break;
        int r = v * V / width, c = v * V - r * width;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          as[r * lda + col0 + c] =
              __float2bfloat16_rn(lane_value(u[k], q, (TIn*)nullptr));
          if (++c == width) {
            c = 0;
            ++r;
          }
        }
      }
    }
    done = nvec * V;
  }
  for (int i = done + threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / width, c = i - r * width;
    as[r * lda + col0 + c] = __float2bfloat16_rn(to_f32(src[i]));
  }
}

// bf16 rows whose width is a multiple of 4 are copied as they are, with
// 8-byte cp.async (the caller commits and waits); returns false for any
// other rows.
template <typename TIn>
__device__ __forceinline__ bool stage_async(bf16* as, int lda, int col0,
                                            const TIn* __restrict__ src,
                                            int width, int rows) {
  if (sizeof(TIn) != 2 || width % 4 != 0
      || (reinterpret_cast<size_t>(src) & 7) != 0)
    return false;
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    cp_async8(as + r * lda + col0 + c, src + (size_t)r * width + c);
  }
  return true;
}

// Zero the pad columns [k_in, KX) and [KX + F, KT) of all 64 staged rows;
// no staging writes them, so once per block is enough.
__device__ __forceinline__ void zero_pads(bf16* as, int lda, const Geo& g) {
  const int p1 = g.kx - g.k_in, p2 = g.kt - g.kx - g.f;
  for (int i = threadIdx.x; i < kRows * (p1 + p2); i += blockDim.x) {
    const int r = i / (p1 + p2), c = i - r * (p1 + p2);
    as[r * lda + (c < p1 ? g.k_in + c : g.kx + g.f + c - p1)] =
        __float2bfloat16_rn(0.0f);
  }
}

// Stage rows [row0, row0 + 64) of [mail | tf | 0 | mem | 0] into as (row
// stride lda) in bf16; rows >= n are 0.  tf is computed here, once per
// element, and f32 rows are rounded to bf16 here.  bf16 rows may arrive by
// cp.async: the caller waits for all groups before reading as.
template <typename TIn>
__device__ __forceinline__ void stage_rows(
    bf16* as, int lda, const TIn* __restrict__ mem,
    const TIn* __restrict__ mail, const float* __restrict__ dts,
    const float* __restrict__ tw, const float* __restrict__ tb, int row0,
    const Geo& g) {
  const int rows = min(kRows, g.n - row0);
  const TIn* mail0 = mail + (size_t)row0 * g.dr;
  const TIn* mem0 = mem + (size_t)row0 * g.f;
  if (!stage_async<TIn>(as, lda, 0, mail0, g.dr, rows))
    stage_block<TIn>(as, lda, 0, mail0, g.dr, rows);
  if (!stage_async<TIn>(as, lda, g.kx, mem0, g.f, rows))
    stage_block<TIn>(as, lda, g.kx, mem0, g.f, rows);
  cp_commit();
  constexpr int U = 4;  // loads of U elements in flight before their cos
  for (int i0 = threadIdx.x; i0 < rows * g.dt; i0 += U * blockDim.x) {
    float t[U], w[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= rows * g.dt) break;
      const int r = i / g.dt, c = i - r * g.dt;
      t[u] = dts[row0 + r];
      w[u] = tw[c];
      b[u] = tb[c];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= rows * g.dt) break;
      const int r = i / g.dt, c = i - r * g.dt;
      as[r * lda + g.dr + c] = __float2bfloat16_rn(cos_time(t[u], w[u], b[u]));
    }
  }
  for (int i = threadIdx.x; i < (kRows - rows) * g.kt; i += blockDim.x)
    as[(rows + i / g.kt) * lda + i % g.kt] = __float2bfloat16_rn(0.0f);
}

// Copy `count` bf16 values (a multiple of 8) into a ring slot.
__device__ __forceinline__ void load_slab(bf16* slot, const bf16* src,
                                          int count) {
  for (int i = threadIdx.x; i < count / 8; i += blockDim.x)
    cp_async16(slot + i * 8, src + i * 8, true);
}

// The gate products of the staged 64 rows for column pass p, without
// biases: acc_r = gi_r + gh_r, acc_z = gi_z + gh_z, acc_in = gi_n,
// acc_hn = gh_n.  Warp (mg, wj) owns the pass's local j8 tiles wj + i *
// warps_j (i < kNJ) for the 32 rows of m group mg; fragment [mt][i][e] is
// row (mg kMT + mt) * 16 + lane / 4 + 8 (e / 2), column 2 (lane % 4) + e %
// 2 of its tile.  The weight slabs
// stream through a kStages-deep cp.async ring; every thread of the block
// takes part.  Ends with the ring drained and a barrier.
__device__ __forceinline__ void gate_products(
    const bf16* as, int lda, const bf16* __restrict__ wp, bf16* ring,
    const Geo& g, int p, float (&acc_r)[kMT][kNJ][4],
    float (&acc_z)[kMT][kNJ][4], float (&acc_in)[kMT][kNJ][4],
    float (&acc_hn)[kMT][kNJ][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mg = warp / g.warps_j, wj = warp % g.warps_j;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < kNJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_r[mt][i][e] = acc_z[mt][i][e] = acc_in[mt][i][e] =
            acc_hn[mt][i][e] = 0.0f;
  const int pt = min(g.pass_tiles, g.jt - p * g.pass_tiles);
  const int steps = g.kt / 16, xsteps = g.kx / 16;
  const int slots = cdiv(steps, kSlotSteps);
  // slot si holds steps kSlotSteps si + u; each step's fragments of this
  // pass (pt j8 tiles x 3 gates) are contiguous in wp
  auto load_slot = [&](int si) {
    bf16* dst = ring + (si % kStages) * kSlotSteps * g.slab;
#pragma unroll
    for (int u = 0; u < kSlotSteps; ++u) {
      const int s = si * kSlotSteps + u;
      if (s < steps)
        load_slab(dst + u * g.slab,
                  wp + ((size_t)s * g.jt + p * g.pass_tiles) * 3 * kFrag,
                  pt * 3 * kFrag);
    }
  };
#pragma unroll
  for (int si = 0; si < kStages - 1; ++si) {
    if (si < slots) load_slot(si);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (s % kSlotSteps == 0) {
      const int si = s / kSlotSteps;
      cp_wait<kStages - 2>();
      __syncthreads();
      if (si + kStages - 1 < slots) load_slot(si + kStages - 1);
      cp_commit();
    }
    unsigned a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      ldsm_x4(a[mt], as + ((mg * kMT + mt) * 16 + lane % 16) * lda + s * 16
                         + (lane / 16) * 8);
    const bf16* slot = ring + (s / kSlotSteps % kStages) * kSlotSteps * g.slab
                       + (s % kSlotSteps) * g.slab;
    const bool hidden = s >= xsteps;
#pragma unroll
    for (int i = 0; i < kNJ; ++i) {
      const int lt = wj + i * g.warps_j;
      if (lt >= pt) continue;
      const uint2* fr = reinterpret_cast<const uint2*>(slot + lt * 3 * kFrag)
                        + lane;
      const uint2 br = fr[0], bz = fr[32], bn = fr[64];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma(acc_r[mt][i], a[mt], br.x, br.y);
        mma(acc_z[mt][i], a[mt], bz.x, bz.y);
        if (hidden) mma(acc_hn[mt][i], a[mt], bn.x, bn.y);
        else mma(acc_in[mt][i], a[mt], bn.x, bn.y);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

inline size_t rows_smem(const Geo& g) {  // staged rows and the ring
  return sizeof(bf16) * ((size_t)kRows * (g.kt + 8)
                         + (size_t)kStages * kSlotSteps * g.slab);
}

template <typename TIn>
__global__ void __launch_bounds__(kMaxThreads)
fwd_kernel(const TIn* __restrict__ mem, const TIn* __restrict__ mail,
           const float* __restrict__ dts, const bf16* __restrict__ wp,
           const float* __restrict__ bi, const float* __restrict__ bh,
           const float* __restrict__ tw, const float* __restrict__ tb,
           float* __restrict__ h, Geo g) {
  extern __shared__ uint4 smem_tc[];
  const int lda = g.kt + 8;
  bf16* as = reinterpret_cast<bf16*>(smem_tc);
  bf16* ring = as + kRows * lda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mg = warp / g.warps_j, wj = warp % g.warps_j;
  const int row0 = blockIdx.x * kRows;
  zero_pads(as, lda, g);
  stage_rows<TIn>(as, lda, mem, mail, dts, tw, tb, row0, g);
  for (int p = 0; p < g.passes; ++p) {
    float acc_r[kMT][kNJ][4], acc_z[kMT][kNJ][4], acc_in[kMT][kNJ][4],
        acc_hn[kMT][kNJ][4];
    gate_products(as, lda, wp, ring, g, p, acc_r, acc_z, acc_in, acc_hn);
#pragma unroll
    for (int i = 0; i < kNJ; ++i) {
      const int jt = p * g.pass_tiles + wj + i * g.warps_j;
      if (jt >= g.jt) continue;  // warp-uniform
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = jt * 8 + 2 * (lane % 4) + c;
        if (j >= g.f) continue;
        // biases are added in f32 after the products
        const float b_r = bi[j] + bh[j];
        const float b_z = bi[g.f + j] + bh[g.f + j];
        const float b_in = bi[2 * g.f + j];
        const float b_hn = bh[2 * g.f + j];
        // mem as it arrived, all loads in flight before the math
        float m[kMT][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = row0 + (mg * kMT + mt) * 16 + lane / 4 + 8 * hf;
            m[mt][hf] = row < g.n ? to_f32(mem[(size_t)row * g.f + j]) : 0.0f;
          }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = row0 + (mg * kMT + mt) * 16 + lane / 4 + 8 * hf;
            const int e = 2 * hf + c;
            if (row >= g.n) continue;
            h[(size_t)row * g.f + j] =
                gru_h(acc_r[mt][i][e] + b_r, acc_z[mt][i][e] + b_z,
                      acc_in[mt][i][e] + b_in, acc_hn[mt][i][e] + b_hn,
                      m[mt][hf]);
          }
      }
    }
  }
}

// sum over the 8 lanes that share lane % 4, in a fixed order
__device__ __forceinline__ float quad_column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Shared memory of the row-tile kernel: the staged rows and the ring,
// das [64][K3 + 8] bf16, then f32 running sums per m group: sacc [2][4][JP]
// (da_r, da_z, da_n, dah_n) and tacc [2][2][DTP] (dtw, dtb).
inline size_t bwd_rows_smem_tc(const Geo& g) {
  return rows_smem(g) + sizeof(bf16) * (size_t)kRows * (g.k3 + 8)
         + sizeof(float) * (size_t)kMG * (4 * g.jp + 2 * g.dtp);
}

// Grid-stride over 64-row tiles.  Writes x_buf [n][KT] (the staged bf16
// rows, the products' A operand) and d_buf [n][4 JP] = (da_r | da_z | da_n
// | dah_n) per padded gate, in bf16, and this block's partial [dbi (3F) |
// dbh (3F) | dtw (DT) | dtb (DT)].
template <typename TIn>
__global__ void __launch_bounds__(kMaxThreads)
bwd_rows_kernel(const TIn* __restrict__ mem, const TIn* __restrict__ mail,
                const float* __restrict__ dts, const bf16* __restrict__ wp,
                const bf16* __restrict__ ktp, const float* __restrict__ bi,
                const float* __restrict__ bh, const float* __restrict__ tw,
                const float* __restrict__ tb, const float* __restrict__ dh,
                bf16* __restrict__ x_buf, bf16* __restrict__ d_buf,
                float* __restrict__ part, Geo g) {
  extern __shared__ uint4 smem_tc[];
  const int lda = g.kt + 8, ldd = g.k3 + 8;
  bf16* as = reinterpret_cast<bf16*>(smem_tc);
  bf16* ring = as + kRows * lda;
  bf16* das = ring + kStages * kSlotSteps * g.slab;
  float* sacc = reinterpret_cast<float*>(das + kRows * ldd);
  float* tacc = sacc + kMG * 4 * g.jp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mg = warp / g.warps_j, wj = warp % g.warps_j;
  const int f = g.f, jp = g.jp;
  for (int i = threadIdx.x; i < kMG * (4 * jp + 2 * g.dtp); i += blockDim.x)
    sacc[i] = 0.0f;  // sacc and tacc are contiguous
  for (int i = threadIdx.x; i < kRows * (g.k3 - 3 * jp); i += blockDim.x) {
    const int w = g.k3 - 3 * jp;
    das[(i / w) * ldd + 3 * jp + i % w] = __float2bfloat16_rn(0.0f);
  }
  zero_pads(as, lda, g);
  const int ntiles = cdiv(g.n, kRows);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    stage_rows<TIn>(as, lda, mem, mail, dts, tw, tb, row0, g);
    cp_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * (g.kt / 8); i += blockDim.x) {
      const int r = i / (g.kt / 8), c8 = i % (g.kt / 8);
      if (row0 + r < g.n)
        reinterpret_cast<uint4*>(x_buf + (size_t)(row0 + r) * g.kt)[c8] =
            *reinterpret_cast<const uint4*>(as + r * lda + c8 * 8);
    }

    for (int p = 0; p < g.passes; ++p) {
      float acc_r[kMT][kNJ][4], acc_z[kMT][kNJ][4], acc_in[kMT][kNJ][4],
          acc_hn[kMT][kNJ][4];
      gate_products(as, lda, wp, ring, g, p, acc_r, acc_z, acc_in, acc_hn);
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
        const int jt = p * g.pass_tiles + wj + i * g.warps_j;
        if (jt >= g.jt) continue;  // warp-uniform
        const int j0 = jt * 8 + 2 * (lane % 4);  // this thread's j0, j0 + 1
        float b_r[2], b_z[2], b_in[2], b_hn[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + c;
          const bool col = j < f;
          b_r[c] = col ? bi[j] + bh[j] : 0.0f;
          b_z[c] = col ? bi[f + j] + bh[f + j] : 0.0f;
          b_in[c] = col ? bi[2 * f + j] : 0.0f;
          b_hn[c] = col ? bh[2 * f + j] : 0.0f;
        }
        // dh and mem as it arrived, all loads in flight before the math
        float gd[kMT][2][2], m[kMT][2][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int row = row0 + (mg * kMT + mt) * 16 + lane / 4 + 8 * hf;
              const bool ok = j0 + c < f && row < g.n;
              const size_t at = (size_t)row * f + j0 + c;
              gd[mt][hf][c] = ok ? dh[at] : 0.0f;
              m[mt][hf][c] = ok ? to_f32(mem[at]) : 0.0f;
            }
        float sum[4][2] = {};  // da_r, da_z, da_n, dah_n
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int lr = (mg * kMT + mt) * 16 + lane / 4 + 8 * hf;
            const int row = row0 + lr;
            float d[4][2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = j0 + c, e = 2 * hf + c;
              d[0][c] = d[1][c] = d[2][c] = d[3][c] = 0.0f;
              if (j < f && row < g.n) {
                const float4 da = gru_da(
                    acc_r[mt][i][e] + b_r[c], acc_z[mt][i][e] + b_z[c],
                    acc_in[mt][i][e] + b_in[c], acc_hn[mt][i][e] + b_hn[c],
                    gd[mt][hf][c], m[mt][hf][c]);
                d[0][c] = da.x;
                d[1][c] = da.y;
                d[2][c] = da.z;
                d[3][c] = da.w;
              }
            }
            if (row < g.n) {
              bf16* drow = d_buf + (size_t)row * 4 * jp + j0;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                *reinterpret_cast<__nv_bfloat162*>(drow + q * jp) =
                    __floats2bfloat162_rn(d[q][0], d[q][1]);
            }
#pragma unroll
            for (int q = 0; q < 3; ++q)
              *reinterpret_cast<__nv_bfloat162*>(das + lr * ldd + q * jp
                                                 + j0) =
                  __floats2bfloat162_rn(d[q][0], d[q][1]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              sum[q][0] += d[q][0];
              sum[q][1] += d[q][1];
            }
          }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = quad_column_sum(sum[q][c]);
            // this warp alone owns column j of its m group
            if (lane < 4) sacc[(mg * 4 + q) * jp + j0 + c] += v;
          }
      }
    }

    // dtf = da kt^T on tensor cores; then darg = -sin(dts tw + tb) dtf
    // summed into dtw and dtb.  kt's fragments (ktp) fill the free ring in
    // chunks of as many k16 steps as it holds (all of them at the main
    // path's widths), so the products of a chunk need no barrier.  Round
    // rd gives warp (mg, wj) the c8 tile pair rd * warps_j + wj for the rows
    // of its m group.
    const int cpairs = cdiv(g.ct, 2);
    const int steps = g.k3 / 16;
    const int chunk = kStages * kSlotSteps * g.slab / (g.ct * kFrag);
    for (int rd = 0; rd < cdiv(cpairs, g.warps_j); ++rd) {
      const int cp = rd * g.warps_j + wj;
      const bool mine = cp < cpairs;  // warp-uniform
      float acc[kMT][2][4] = {};
      for (int s0 = 0; s0 < steps; s0 += chunk) {
        const int ns = min(chunk, steps - s0);
        __syncthreads();  // the ring is free; das is complete
        load_slab(ring, ktp + (size_t)s0 * g.ct * kFrag, ns * g.ct * kFrag);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (!mine) continue;
        for (int s = 0; s < ns; ++s) {
          unsigned a[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            ldsm_x4(a[mt], das + ((mg * kMT + mt) * 16 + lane % 16) * ldd
                               + (s0 + s) * 16 + (lane / 16) * 8);
          const uint2* fr =
              reinterpret_cast<const uint2*>(ring + s * g.ct * kFrag) + lane;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (2 * cp + q >= g.ct) continue;
            const uint2 b = fr[(2 * cp + q) * 32];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma(acc[mt][q], a[mt], b.x, b.y);
          }
        }
      }
      if (!mine) continue;
      float t[kMT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + (mg * kMT + mt) * 16 + lane / 4 + 8 * hf;
          t[mt][hf] = row < g.n ? dts[row] : 0.0f;
        }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int c = (2 * cp + q) * 8 + 2 * (lane % 4) + c2;
          float s_w = 0.0f, s_b = 0.0f;
          if (c < g.dt) {
            const float w = tw[c], b = tb[c];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int row = row0 + (mg * kMT + mt) * 16 + lane / 4 + 8 * hf;
                if (row < g.n) {
                  const float darg = neg_sin_time(t[mt][hf], w, b)
                                     * acc[mt][q][2 * hf + c2];
                  s_w += darg * t[mt][hf];
                  s_b += darg;
                }
              }
          }
          s_w = quad_column_sum(s_w);
          s_b = quad_column_sum(s_b);
          if (lane < 4 && c < g.dt) {
            tacc[mg * 2 * g.dtp + c] += s_w;
            tacc[(mg * 2 + 1) * g.dtp + c] += s_b;
          }
        }
    }
    // the next tile restages as; its gate products' first barrier orders
    // this tile's das reads before its das writes
  }
  __syncthreads();

  float* out = part + (size_t)blockIdx.x * (6 * f + 2 * g.dt);
  // the m groups' sums, in a fixed order
  for (int i = threadIdx.x; i < 3 * f; i += blockDim.x) {
    const int gate = i / f, j = i % f;
    const int hq = gate == 2 ? 3 : gate;
    out[i] = sacc[gate * jp + j] + sacc[(4 + gate) * jp + j];   // dbi
    out[3 * f + i] = sacc[hq * jp + j] + sacc[(4 + hq) * jp + j];  // dbh
  }
  for (int c = threadIdx.x; c < g.dt; c += blockDim.x) {
    out[6 * f + c] = tacc[c] + tacc[2 * g.dtp + c];
    out[6 * f + g.dt + c] = tacc[g.dtp + c] + tacc[3 * g.dtp + c];
  }
}

// Weight-gradient products: a 128 (m) x 64 (p) output tile over one chunk
// of rows (blockIdx.z), 4 warps of 64 x 32, 32-row k tiles in a 3-deep
// cp.async ring.  blockIdx.x < mblocks_i: dKi = x_buf[:, :k_in]^T d_buf
// gates (0, 1, 2); else dKh = x_buf[:, KX:KX+F]^T d_buf gates (0, 1, 3).
// p runs over the padded gate columns g JP + j; rows of the output that
// are padding are dropped when storing.
constexpr int kPM = 128, kPP = 64, kPK = 32, kPStages = 3, kPThreads = 128;

__global__ void __launch_bounds__(kPThreads)
product_kernel(const bf16* __restrict__ x_buf, const bf16* __restrict__ d_buf,
               float* __restrict__ part, size_t split_stride, Geo g,
               int mblocks_i, int rows_per_split) {
  __shared__ __align__(128) bf16 sa[kPStages][kPK][kPM + 8];
  __shared__ __align__(128) bf16 sb[kPStages][kPK][kPP + 8];
  const bool is_h = blockIdx.x >= mblocks_i;
  const int m0 = (is_h ? blockIdx.x - mblocks_i : blockIdx.x) * kPM;
  const int p0 = blockIdx.y * kPP;
  const int acol0 = is_h ? g.kx : 0;
  const int M = is_h ? g.f : g.k_in;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(g.n, r0 + rows_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wq = warp % 2;
  const int ld_d = 4 * g.jp;

  auto load = [&](int st, int k0) {
    for (int i = threadIdx.x; i < kPK * kPM / 8; i += kPThreads) {
      const int k = i / (kPM / 8), c8 = i % (kPM / 8);
      const int row = k0 + k, col = acol0 + m0 + c8 * 8;
      const bool ok = row < r1 && col + 8 <= g.kt;
      cp_async16(&sa[st][k][c8 * 8],
                 x_buf + (ok ? (size_t)row * g.kt + col : 0), ok);
    }
    for (int i = threadIdx.x; i < kPK * kPP / 8; i += kPThreads) {
      const int k = i / (kPP / 8), c8 = i % (kPP / 8);
      const int row = k0 + k, p = p0 + c8 * 8;
      const int gate = p / g.jp;
      const bool ok = row < r1 && gate < 3;
      const int dcol = (is_h && gate == 2) ? p + g.jp : p;
      cp_async16(&sb[st][k][c8 * 8],
                 d_buf + (ok ? (size_t)row * ld_d + dcol : 0), ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;

  const int nk = r1 > r0 ? cdiv(r1 - r0, kPK) : 0;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < nk) load(s, r0 + s * kPK);
    cp_commit();
  }
  const int q = lane >> 3;
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kPStages - 2>();
    __syncthreads();
    const int nx = kt + kPStages - 1;
    if (nx < nk) load(nx % kPStages, r0 + nx * kPK);
    cp_commit();
    const int st = kt % kPStages;
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(a[mt], &sa[st][kk * 16 + (q >> 1) * 8 + (lane & 7)]
                            [wm * 64 + mt * 16 + (q & 1) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(b[np], &sb[st][kk * 16 + (q & 1) * 8 + (lane & 7)]
                            [wq * 32 + np * 16 + (q >> 1) * 8]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], a[mt], b[nt / 2][(nt % 2) * 2],
              b[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
  cp_wait<0>();

  float* out = part + (size_t)blockIdx.z * split_stride
               + (size_t)(is_h ? g.k_in : 0) * 3 * g.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + mt * 16 + lane / 4 + 8 * (e / 2);
        const int p = p0 + wq * 32 + nt * 8 + 2 * (lane % 4) + e % 2;
        const int gate = p / g.jp, j = p % g.jp;
        if (m < M && gate < 3 && j < g.f)
          out[(size_t)m * 3 * g.f + gate * g.f + j] = acc[mt][nt][e];
      }
}

// Launch geometry, from the shapes alone: K2's row-tile grid and row
// splits, and the scratch layout (each part 256-byte aligned).
inline int balanced_blocks(int tiles, int cap) {
  return cdiv(tiles, cdiv(tiles, cap));
}
inline int product_splits(int n) {
  const int s = cdiv(n, kSplitRows);
  return s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
}
inline size_t carve(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 255) / 256 * 256;
  return at;
}

struct BwdScratch {
  size_t wp, ktp, x_buf, d_buf, part_rows, part_dk, total;
  int row_blocks, splits;
};

inline BwdScratch bwd_scratch(const Geo& g) {
  BwdScratch s;
  size_t off = 0;
  s.row_blocks = balanced_blocks(cdiv(g.n, kRows), kRowBlocks);
  s.splits = product_splits(g.n);
  s.wp = carve(off, sizeof(bf16) * (size_t)g.kt / 16 * g.jt * 3 * kFrag);
  s.ktp = carve(off, sizeof(bf16) * (size_t)g.k3 / 16 * g.ct * kFrag);
  s.x_buf = carve(off, sizeof(bf16) * (size_t)g.n * g.kt);
  s.d_buf = carve(off, sizeof(bf16) * (size_t)g.n * 4 * g.jp);
  s.part_rows = carve(off, sizeof(float) * (size_t)s.row_blocks
                               * (6 * g.f + 2 * g.dt));
  s.part_dk = carve(off, sizeof(float) * (size_t)s.splits
                             * (g.k_in + g.f) * 3 * g.f);
  s.total = off;
  return s;
}

inline size_t fwd_scratch(const Geo& g) {
  return sizeof(bf16) * (size_t)g.kt / 16 * g.jt * 3 * kFrag;
}

inline cudaError_t launch_pack(const bf16* ki, const bf16* kh, const Geo& g,
                               bf16* wp, bf16* ktp, cudaStream_t stream) {
  pack_kernel<<<2 * 132, 256, 0, stream>>>(ki, kh, g, wp, ktp);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_fwd(const void* mem, const void* mail, const float* dts,
                       const void* ki, const float* bi, const void* kh,
                       const float* bh, const float* tw, const float* tb,
                       float* h, void* scratch, const Geo& g,
                       cudaStream_t stream) {
  bf16* wp = static_cast<bf16*>(scratch);
  cudaError_t err = launch_pack(static_cast<const bf16*>(ki),
                                static_cast<const bf16*>(kh), g, wp, nullptr,
                                stream);
  if (err != cudaSuccess) return err;
  const size_t smem = rows_smem(g);
  auto kernel = fwd_kernel<TIn>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<cdiv(g.n, kRows), 32 * g.warps, smem, stream>>>(
      static_cast<const TIn*>(mem), static_cast<const TIn*>(mail), dts, wp,
      bi, bh, tw, tb, h, g);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_bwd(const void* mem, const void* mail, const float* dts,
                       const void* ki, const float* bi, const void* kh,
                       const float* bh, const float* tw, const float* tb,
                       const float* dh, void* scratch, float* dk,
                       float* small, const Geo& g, cudaStream_t stream) {
  const BwdScratch s = bwd_scratch(g);
  char* base = static_cast<char*>(scratch);
  bf16* wp = reinterpret_cast<bf16*>(base + s.wp);
  bf16* ktp = reinterpret_cast<bf16*>(base + s.ktp);
  bf16* x_buf = reinterpret_cast<bf16*>(base + s.x_buf);
  bf16* d_buf = reinterpret_cast<bf16*>(base + s.d_buf);
  float* part_rows = reinterpret_cast<float*>(base + s.part_rows);
  float* part_dk = reinterpret_cast<float*>(base + s.part_dk);
  cudaError_t err = launch_pack(static_cast<const bf16*>(ki),
                                static_cast<const bf16*>(kh), g, wp, ktp,
                                stream);
  if (err != cudaSuccess) return err;

  const size_t smem = bwd_rows_smem_tc(g);
  auto rows = bwd_rows_kernel<TIn>;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  rows<<<s.row_blocks, 32 * g.warps, smem, stream>>>(
      static_cast<const TIn*>(mem), static_cast<const TIn*>(mail), dts, wp,
      ktp, bi, bh, tw, tb, dh, x_buf, d_buf, part_rows, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int rows_per_split = up(cdiv(g.n, s.splits), kPK);
  const size_t stride = (size_t)(g.k_in + g.f) * 3 * g.f;
  const int mblocks_i = cdiv(g.k_in, kPM);
  const dim3 grid(mblocks_i + cdiv(g.f, kPM), cdiv(3 * g.jp, kPP), s.splits);
  product_kernel<<<grid, kPThreads, 0, stream>>>(
      x_buf, d_buf, part_dk, stride, g, mblocks_i, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = launch_sum(part_dk, s.splits, stride, dk, stream)) != cudaSuccess)
    return err;
  return launch_sum(part_rows, s.row_blocks, (size_t)(6 * g.f + 2 * g.dt),
                    small, stream);
}

}  // namespace tc

// K2's f32 geometry: at most 264 row-tile blocks (two per SM), and the
// same row splits as the bf16 products.  Scratch: ktt [3F, DT], d_buf
// [N, 4F] and tf_buf [N, DT] f32, part_rows, part_dk.
struct F32Scratch {
  size_t ktt, d_buf, tf_buf, part_rows, part_dk, total;
  int row_blocks, splits;
};

inline F32Scratch f32_scratch(int n, int f, int dr, int dt) {
  F32Scratch s;
  size_t off = 0;
  const int k_in = dr + dt;
  s.row_blocks = tc::balanced_blocks(tc::cdiv(n, kRowsPerBlock), 264);
  s.splits = tc::product_splits(n);
  s.ktt = tc::carve(off, sizeof(float) * (size_t)3 * f * dt);
  s.d_buf = tc::carve(off, sizeof(float) * (size_t)n * 4 * f);
  s.tf_buf = tc::carve(off, sizeof(float) * (size_t)n * dt);
  s.part_rows = tc::carve(off, sizeof(float) * (size_t)s.row_blocks
                                   * (6 * f + 2 * dt));
  s.part_dk = tc::carve(off, sizeof(float) * (size_t)s.splits * (k_in + f)
                                 * 3 * f);
  s.total = off;
  return s;
}

}  // namespace

extern "C" {

// Bytes of device scratch the caller allocates for one call of
// gru_fused_fwd (0 for f32 operands) or gru_fused_bwd; they depend only on
// the operand type and the shapes.
size_t gru_fused_fwd_scratch(int op_bf16, int n, int f, int dr, int dt) {
  return op_bf16 ? tc::fwd_scratch(tc::make_geo(n, f, dr, dt)) : 0;
}

size_t gru_fused_bwd_scratch(int op_bf16, int n, int f, int dr, int dt) {
  return op_bf16 ? tc::bwd_scratch(tc::make_geo(n, f, dr, dt)).total
                 : f32_scratch(n, f, dr, dt).total;
}

// in_bf16: mem and mail are bf16 (else f32); op_bf16: ki and kh are bf16
// and the activations are rounded to bf16 (else f32).  bf16 rows come only
// with bf16 operands (the bf16 memory pull).  Returns cudaError_t.
int gru_fused_fwd(int in_bf16, int op_bf16, const void* mem, const void* mail,
                  const float* dts, const void* ki, const float* bi,
                  const void* kh, const float* bh, const float* tw,
                  const float* tb, float* h, void* scratch, int n, int f,
                  int dr, int dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && !op_bf16) return cudaErrorInvalidValue;
  if (op_bf16) {
    const tc::Geo g = tc::make_geo(n, f, dr, dt);
    return in_bf16 ? tc::launch_fwd<__nv_bfloat16>(mem, mail, dts, ki, bi, kh,
                                                   bh, tw, tb, h, scratch, g, s)
                   : tc::launch_fwd<float>(mem, mail, dts, ki, bi, kh, bh, tw,
                                           tb, h, scratch, g, s);
  }
  return launch_fwd(mem, mail, dts, ki, bi, kh, bh, tw, tb, h,
                                  n, f, dr, dt, s);
}

// Parameter gradients for dh [n, f] f32, with scratch of
// gru_fused_bwd_scratch bytes.  Outputs (f32): dk = [dKi (dr + dt, 3f) |
// dKh (f, 3f)] and small = [dbi (3f) | dbh (3f) | dtw (dt) | dtb (dt)].
// Returns cudaError_t.
int gru_fused_bwd(int in_bf16, int op_bf16, const void* mem, const void* mail,
                  const float* dts, const void* ki, const float* bi,
                  const void* kh, const float* bh, const float* tw,
                  const float* tb, const float* dh, void* scratch, float* dk,
                  float* small, int n, int f, int dr, int dt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && !op_bf16) return cudaErrorInvalidValue;
  if (op_bf16) {
    const tc::Geo g = tc::make_geo(n, f, dr, dt);
    return in_bf16 ? tc::launch_bwd<__nv_bfloat16>(mem, mail, dts, ki, bi, kh,
                                                   bh, tw, tb, dh, scratch, dk,
                                                   small, g, s)
                   : tc::launch_bwd<float>(mem, mail, dts, ki, bi, kh, bh, tw,
                                           tb, dh, scratch, dk, small, g, s);
  }
  const F32Scratch sc = f32_scratch(n, f, dr, dt);
  char* base = static_cast<char*>(scratch);
  return launch_bwd(
      mem, mail, dts, ki, bi, kh, bh, tw, tb, dh, base + sc.ktt,
      base + sc.d_buf, base + sc.tf_buf,
      reinterpret_cast<float*>(base + sc.part_rows), sc.row_blocks,
      reinterpret_cast<float*>(base + sc.part_dk), sc.splits, dk, small, n, f,
      dr, dt, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
