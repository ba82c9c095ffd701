// Tiled GEMMs of the fused attention blocks, shared by attn_block_fwd.cu,
// attn_block_bwd.cu and the per-head variant (attn_block_perhead_*.cu).
//
// Two orientations, both with f32 accumulation and one rounding of the
// result to the activation dtype:
//   * "NT" with a bias epilogue: C_z = A (M, K) . W_z^T + b_z, W_z stored
//     (N, K) row-major -- the nn.Linear (out, in) layout. This is x . W for a
//     flax (in, out) kernel W: the QKV and out projections of the forward,
//     and the q/k/v recompute of the backward. blockIdx.z picks z. The bias
//     may be absent, and C may be written head-banked, (B, heads, L, N /
//     heads), instead of (M, N) row-major.
//   * "NN" summed over pairs: C = sum_z A_z (M, K) . W_z (K, N), W_z stored
//     (K, N) row-major. With W_z a Linear's (out, in) weight this is
//     g . W^T for the flax kernel: dctx = dO . Wo^T and
//     dx = dq . Wq^T + dk . Wk^T + dv . Wv^T of the backward, the three
//     products of dx accumulated in the same registers.
//
// bf16 runs on the tensor cores through mma.sync.m16n8k16 (128 x 64 x 32
// block tiles, a 3-stage cp.async pipeline, fragments through ldmatrix; the
// NN variant reads its K-major B tile with ldmatrix.trans); float32 is plain
// FMA on the CUDA cores and only serves --dtype float32.

#pragma once

#include <stdint.h>

#include "sdpa_core.cuh"

namespace {

struct GemmArgs {
  const void* a;        // (M, K) row-major
  const void* w[3];     // (N, K) row-major
  const void* bias[3];  // (N,), or nullptr for none
  void* c[3];           // (M, N) row-major; head-banked when heads > 0
  int m, n, k;
  int len, heads;       // heads > 0: row m = b * len + l, column n = h * d + c of
                        // C land at ((b * heads + h) * len + l) * d + c, d = N / heads
};

// Offset of C's element (row, col) in the layout GemmArgs names.
__device__ __forceinline__ size_t gemm_c_offset(const GemmArgs& g, int row, int col) {
  if (g.heads == 0) return (size_t)row * g.n + col;
  const int d = g.n / g.heads;
  return (((size_t)(row / g.len) * g.heads + col / d) * g.len + row % g.len) * d + col % d;
}

// ---- bf16: tensor cores through mma.sync, a 3-stage cp.async pipeline -----
//
// Block tile 128 x 64 (4 warps, 64 x 32 each), 32-deep k-steps; while the
// warps multiply one stage, cp.async fills the next two. Operand fragments
// come from shared memory through ldmatrix; rows are padded to 40 bf16 (80 B)
// so the eight 16-byte rows of each 8x8 matrix fall in distinct banks.

constexpr int kGM = 128, kGN = 64, kGK = 32, kStages = 3, kGLd = kGK + 8;
constexpr int kGThreads = 128;

// the copy and fragment loads of the SDPA tensor-core kernels (sdpa_core.cuh)
using smtc::cp_async16;
using smtc::ldmatrix_x4;
using smtc::ldmatrix_x4_trans;

__global__ void __launch_bounds__(kGThreads) gemm_bias_bf16(GemmArgs g) {
  __shared__ __align__(128) __nv_bfloat16 As[kStages][kGM][kGLd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][kGN][kGLd];
  const int z = blockIdx.z;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(g.w[z]);
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(g.bias[z]);
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(g.c[z]);
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps, 64 x 32 each
  const int grp = lane >> 2, t4 = lane & 3;
  const int nk = (g.k + kGK - 1) / kGK;

  // one stage: 128 + 64 rows of 4 16-byte chunks; rows or chunks past the
  // matrix are zero-filled (k % 8 == 0, so a chunk is all in or all out)
  auto load_stage = [&](int stage, int k0) {
    for (int e = tid; e < (kGM + kGN) * (kGK / 8); e += kGThreads) {
      const int r = e / (kGK / 8), c = (e % (kGK / 8)) * 8;
      const bool kin = k0 + c < g.k;
      if (r < kGM) {
        const bool ok = kin && m0 + r < g.m;
        cp_async16(&As[stage][r][c], ok ? A + (size_t)(m0 + r) * g.k + k0 + c : A, ok);
      } else {
        const int rn = r - kGM;
        const bool ok = kin && n0 + rn < g.n;
        cp_async16(&Bs[stage][rn][c], ok ? W + (size_t)(n0 + rn) * g.k + k0 + c : W, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kGK);
    asm volatile("cp.async.commit_group;\n");
  }

  float acc[4][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // stage kt has landed; stage kt - 1 is free again
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, (kt + kStages - 1) * kGK);
    asm volatile("cp.async.commit_group;\n");
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &As[st][wm * 64 + mi * 16 + (lane % 16)][kk + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)  // two n8 tiles per ldmatrix
        ldmatrix_x4(bfr[nj], &Bs[st][wn * 32 + nj * 16 + (lane / 16) * 8 + (lane % 8)]
                                   [kk + ((lane / 8) % 2) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          smtc::mma_16816(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],
                          bfr[ni / 2][(ni % 2) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  // epilogue: (f32 sum + bias) rounded once to bf16; col and col + 1 are in
  // one row of C in either layout (n and the head dim are even)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (col >= g.n) continue;  // n % 8 == 0, so col + 1 < n too
    const float b0 = bias ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + grp + half * 8;
        if (row >= g.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(C + gemm_c_offset(g, row, col)) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half] + b0, acc[mi][ni][2 * half + 1] + b1);
      }
  }
}

// ---- float32: FMA on the CUDA cores -----------------------------------------

constexpr int kBM = 64, kBN = 64, kBKf = 16;

__global__ void __launch_bounds__(256) gemm_bias_f32(GemmArgs g) {
  __shared__ __align__(16) float As[kBKf][kBM];  // k-major
  __shared__ __align__(16) float Bs[kBKf][kBN];
  const int z = blockIdx.z;
  const float* A = static_cast<const float*>(g.a);
  const float* W = static_cast<const float*>(g.w[z]);
  const float* bias = static_cast<const float*>(g.bias[z]);
  float* C = static_cast<float*>(g.c[z]);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.k; k0 += kBKf) {
    for (int e = tid; e < kBM * kBKf; e += 256) {
      const int r = e / kBKf, c = e % kBKf;
      const bool kin = k0 + c < g.k;
      As[c][r] = (kin && m0 + r < g.m) ? A[(size_t)(m0 + r) * g.k + k0 + c] : 0.f;
      Bs[c][r] = (kin && n0 + r < g.n) ? W[(size_t)(n0 + r) * g.k + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kBKf; ++c) {
      const float4 a4 = reinterpret_cast<const float4*>(As[c])[ty];
      const float4 b4 = reinterpret_cast<const float4*>(Bs[c])[tx];
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(ar[r], bc[cc], acc[r][cc]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= g.m) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = n0 + tx * 4 + cc;
      if (col < g.n) C[gemm_c_offset(g, row, col)] = acc[r][cc] + (bias ? bias[col] : 0.f);
    }
  }
}

cudaError_t launch_gemm(const GemmArgs& g, int count, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    gemm_bias_bf16<<<dim3((g.n + kGN - 1) / kGN, (g.m + kGM - 1) / kGM, count), kGThreads, 0,
                     stream>>>(g);
  else
    gemm_bias_f32<<<dim3((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM, count), 256, 0,
                    stream>>>(g);
  return cudaGetLastError();
}

// ---- NN, summed over up to three (A_z, W_z) pairs ---------------------------

struct GemmNNArgs {
  const void* a[3];  // (M, K) row-major
  const void* w[3];  // (K, N) row-major
  void* c;           // (M, N) row-major
  int m, n, k, count;
};

// The k-steps of all pairs form one sequence (pair z, then z + 1), so the
// cp.async pipeline runs across the pair boundaries and the three products
// of dx share one f32 accumulator, rounded once.
__global__ void __launch_bounds__(kGThreads) gemm_nn_bf16(GemmNNArgs g) {
  constexpr int kBLd = kGN + 8;  // 144 B rows: ldmatrix rows in distinct banks
  __shared__ __align__(128) __nv_bfloat16 As[kStages][kGM][kGLd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][kGK][kBLd];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int grp = lane >> 2, t4 = lane & 3;
  const int nk = (g.k + kGK - 1) / kGK;
  const int steps = nk * g.count;

  // A: 128 rows x 4 chunks; B: 32 k-rows x 8 chunks of 8 columns
  auto load_stage = [&](int stage, int t) {
    const int z = t / nk, k0 = (t % nk) * kGK;
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a[z]);
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(g.w[z]);
    for (int e = tid; e < kGM * (kGK / 8) + kGK * (kGN / 8); e += kGThreads) {
      if (e < kGM * (kGK / 8)) {
        const int r = e / (kGK / 8), c = (e % (kGK / 8)) * 8;
        const bool ok = k0 + c < g.k && m0 + r < g.m;
        cp_async16(&As[stage][r][c], ok ? A + (size_t)(m0 + r) * g.k + k0 + c : A, ok);
      } else {
        const int f = e - kGM * (kGK / 8);
        const int r = f / (kGN / 8), c = (f % (kGN / 8)) * 8;
        const bool ok = k0 + r < g.k && n0 + c < g.n;
        cp_async16(&Bs[stage][r][c], ok ? W + (size_t)(k0 + r) * g.n + n0 + c : W, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n");
  }

  float acc[4][4][4] = {};
  for (int kt = 0; kt < steps; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    if (kt + kStages - 1 < steps) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    asm volatile("cp.async.commit_group;\n");
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &As[st][wm * 64 + mi * 16 + (lane % 16)][kk + (lane / 16) * 8]);
      // B stored k-major: the transposing load gives the .col fragments;
      // lanes 0-15 address k rows of the first n8 tile, 16-31 of the next
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], &Bs[st][kk + (lane & 15)][wn * 32 + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          smtc::mma_16816(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],
                          bfr[ni / 2][(ni % 2) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(g.c);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (col >= g.n) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + grp + half * 8;
        if (row >= g.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * g.n + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
  }
}

__global__ void __launch_bounds__(256) gemm_nn_f32(GemmNNArgs g) {
  __shared__ __align__(16) float As[kBKf][kBM];  // k-major
  __shared__ __align__(16) float Bs[kBKf][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int z = 0; z < g.count; ++z) {
    const float* A = static_cast<const float*>(g.a[z]);
    const float* W = static_cast<const float*>(g.w[z]);
    for (int k0 = 0; k0 < g.k; k0 += kBKf) {
      for (int e = tid; e < kBM * kBKf; e += 256) {
        const int r = e / kBKf, c = e % kBKf;
        As[c][r] = (k0 + c < g.k && m0 + r < g.m) ? A[(size_t)(m0 + r) * g.k + k0 + c] : 0.f;
        const int cb = e / kBN, rb = e % kBN;
        Bs[cb][rb] = (k0 + cb < g.k && n0 + rb < g.n) ? W[(size_t)(k0 + cb) * g.n + n0 + rb] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kBKf; ++c) {
        const float4 a4 = reinterpret_cast<const float4*>(As[c])[ty];
        const float4 b4 = reinterpret_cast<const float4*>(Bs[c])[tx];
        const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(ar[r], bc[cc], acc[r][cc]);
      }
      __syncthreads();
    }
  }
  float* C = static_cast<float*>(g.c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= g.m) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = n0 + tx * 4 + cc;
      if (col < g.n) C[(size_t)row * g.n + col] = acc[r][cc];
    }
  }
}

cudaError_t launch_gemm_nn(const GemmNNArgs& g, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    gemm_nn_bf16<<<dim3((g.n + kGN - 1) / kGN, (g.m + kGM - 1) / kGM), kGThreads, 0, stream>>>(g);
  else
    gemm_nn_f32<<<dim3((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
