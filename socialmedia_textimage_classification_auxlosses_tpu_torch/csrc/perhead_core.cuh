// The head-ordered product of the per-head fused attention block, shared by
// attn_block_perhead_fwd.cu and attn_block_perhead_bwd.cu.
//
//   C = round( sum over heads h in order, and within a head over the pairs
//              z in order, of  A_z[h] (M, d) . W_z[h] (d, N)  + bias )
//
// A_z is head-banked, (B, heads, L, d), so A_z[h] is the head's own (L, d)
// block of every batch row; W_z is (K = heads * d, N) row-major, so W_z[h] is
// its contiguous row block h * d .. h * d + d - 1. Each (h, z) product is
// taken into a fresh f32 partial and then added to the block's f32
// accumulator: the sums run in the order of the JAX Pallas kernels'
// `acc += jnp.dot(ctx, wo_ref[h])` (ops/attn_block.py::_fwd_kernel, the
// out-projection, one pair) and `dx += dot(g, w_ref[h]^T)` for q, k, v
// (::_bwd_kernel, three pairs). TPU grid steps run in order and Hopper blocks
// do not, so the order lives inside one block: every block owns an output
// tile and walks all heads itself. No atomics, no scratch of partials.
//
// bf16 runs on the tensor cores (mma.sync.m16n8k16, the head walk as the
// k-step sequence); float32 is FMA on the CUDA cores (gemm_core.cuh's tiles).

#pragma once

#include "gemm_core.cuh"

namespace {

// bf16: block tile 128 x 64 (4 warps, 64 x 32 each), 32-deep k-steps in a
// 3-stage cp.async pipeline; while the warps multiply one stage, cp.async
// fills the next two. Operand fragments come from shared memory through
// ldmatrix; rows are padded to 40 bf16 (80 B) so the eight 16-byte rows of
// each 8x8 matrix fall in distinct banks.
constexpr int kGM = 128, kGN = 64, kGK = 32, kStages = 3, kGLd = kGK + 8;
constexpr int kGThreads = 128;

// the copy and fragment loads of the SDPA tensor-core kernels (sdpa_core.cuh)
using smtc::cp_async16;
using smtc::ldmatrix_x4;
using smtc::ldmatrix_x4_trans;

struct HeadSumArgs {
  const void* a[3];  // A_z: (B, heads, len, d) bf16 or f32
  const void* w[3];  // W_z: (heads * d, N) row-major
  const void* bias;  // (N,), or nullptr for none
  void* c;           // (M = B * len, N) row-major
  int m, n, len, heads, d, count;
};

__device__ __forceinline__ size_t banked_row(const HeadSumArgs& g, int row, int h) {
  return (((size_t)(row / g.len) * g.heads + h) * g.len + row % g.len) * g.d;
}

// k-steps of kGK walk (head, pair, depth) in that order; a head's depth d is
// split into ceil(d / kGK) steps, zero-filled past d (d % 8 == 0, so a
// 16-byte chunk is all in or all out).
__global__ void __launch_bounds__(kGThreads) headsum_bf16(HeadSumArgs g) {
  constexpr int kBLd = kGN + 8;
  __shared__ __align__(128) __nv_bfloat16 As[kStages][kGM][kGLd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][kGK][kBLd];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int grp = lane >> 2, t4 = lane & 3;
  const int per = (g.d + kGK - 1) / kGK;
  const int steps = g.heads * g.count * per;

  auto load_stage = [&](int stage, int t) {
    const int h = t / (g.count * per), z = (t / per) % g.count, c0 = (t % per) * kGK;
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a[z]);
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(g.w[z]);
    for (int e = tid; e < kGM * (kGK / 8) + kGK * (kGN / 8); e += kGThreads) {
      if (e < kGM * (kGK / 8)) {
        const int r = e / (kGK / 8), c = (e % (kGK / 8)) * 8;
        const bool ok = c0 + c < g.d && m0 + r < g.m;
        cp_async16(&As[stage][r][c], ok ? A + banked_row(g, m0 + r, h) + c0 + c : A, ok);
      } else {
        const int f = e - kGM * (kGK / 8);
        const int r = f / (kGN / 8), c = (f % (kGN / 8)) * 8;
        const bool ok = c0 + r < g.d && n0 + c < g.n;
        cp_async16(&Bs[stage][r][c], ok ? W + ((size_t)h * g.d + c0 + r) * g.n + n0 + c : W,
                   ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n");
  }

  float acc[4][4][4] = {}, part[4][4][4] = {};
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
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], &Bs[st][kk + (lane & 15)][wn * 32 + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          smtc::mma_16816(part[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],
                          bfr[ni / 2][(ni % 2) * 2 + 1]);
    }
    if ((kt + 1) % per == 0) {  // the (head, pair) product is whole: fold it in
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += part[mi][ni][e];
            part[mi][ni][e] = 0.f;
          }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(g.bias);
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(g.c);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (col >= g.n) continue;
    const float b0 = bias ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + grp + half * 8;
        if (row >= g.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * g.n + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half] + b0, acc[mi][ni][2 * half + 1] + b1);
      }
  }
}

__global__ void __launch_bounds__(256) headsum_f32(HeadSumArgs g) {
  __shared__ __align__(16) float As[kBKf][kBM];  // k-major
  __shared__ __align__(16) float Bs[kBKf][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int h = 0; h < g.heads; ++h)
    for (int z = 0; z < g.count; ++z) {
      const float* A = static_cast<const float*>(g.a[z]);
      const float* W = static_cast<const float*>(g.w[z]) + (size_t)h * g.d * g.n;
      float part[4][4] = {};
      for (int c0 = 0; c0 < g.d; c0 += kBKf) {
        for (int e = tid; e < kBM * kBKf; e += 256) {
          const int r = e / kBKf, c = e % kBKf;
          As[c][r] = (c0 + c < g.d && m0 + r < g.m) ? A[banked_row(g, m0 + r, h) + c0 + c] : 0.f;
          const int cb = e / kBN, rb = e % kBN;
          Bs[cb][rb] = (c0 + cb < g.d && n0 + rb < g.n) ? W[(size_t)(c0 + cb) * g.n + n0 + rb] : 0.f;
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
            for (int cc = 0; cc < 4; ++cc) part[r][cc] = fmaf(ar[r], bc[cc], part[r][cc]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] += part[r][cc];
    }
  const float* bias = static_cast<const float*>(g.bias);
  float* C = static_cast<float*>(g.c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= g.m) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = n0 + tx * 4 + cc;
      if (col < g.n) C[(size_t)row * g.n + col] = acc[r][cc] + (bias ? bias[col] : 0.f);
    }
  }
}

cudaError_t launch_headsum(const HeadSumArgs& g, int dtype, cudaStream_t stream) {
  if (g.d <= 0 || g.d % 8 || g.n % 8 || g.count < 1 || g.count > 3) return cudaErrorInvalidValue;
  if (dtype == 1)
    headsum_bf16<<<dim3((g.n + kGN - 1) / kGN, (g.m + kGM - 1) / kGM), kGThreads, 0, stream>>>(g);
  else
    headsum_f32<<<dim3((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
