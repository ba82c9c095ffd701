// Kernel 2: fused self-attention block forward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attn_block.py
// ::_fwd_kernel2 (the Pallas TPU kernel reached from _run_fwd2, used by
// `--attn_impl fused`). It computes, with the same casts:
//   q|k|v = (x Wq|Wk|Wv  accumulated in f32  + b) rounded to x's dtype
//   ctx   = per-head SDPA on column slices of q, k, v (sdpa_core.cuh)
//   out   = (ctx Wo  accumulated in f32  + bo) rounded to x's dtype
//
// Design. The TPU kernel did all of this inside one grid step per batch
// element, with the four 768x768 weights resident in VMEM. A Hopper block
// cannot hold them (4.5 MB in bf16 against 227 KB of shared memory), so this
// first port is a chain of three launches of the port's own kernels on one
// stream, all behind one C entry point and one launch count:
//   1. a tiled GEMM with a bias epilogue, blockIdx.z choosing Q, K or V;
//   2. the SDPA kernel of sdpa_core.cuh, reading heads as column slices of
//      the packed (B, L, H) q/k/v, so no head transpose is materialised;
//   3. the same GEMM for the out-projection.
// q, k, v and ctx make one round trip through device memory each (scratch
// the wrapper allocates); a single kernel per (batch, query tile) that keeps
// them on chip is later work.
//
// What bounds it on the H100. At the serving shapes (x of 16x128x768 and
// 16x197x768 in bf16) the work is the four projections, 9.7 and 14.9 GFLOP,
// so the bound is the bf16 tensor-core rate (about 10.6 and 17 us at
// 989 TFLOP/s). The bf16 GEMM therefore runs on the tensor cores through
// mma.sync.m16n8k16 (f32 accumulation), 128x64x32 block tiles fed by a
// 3-stage cp.async pipeline; wgmma and TMA, the only way to the card's full
// rate, are later work. The float32 GEMM is plain FMA: it only serves
// --dtype float32.
//
// Weights arrive as (out, in) row-major, the nn.Linear layout; ops/attn_block.py
// takes them in the flax (in, out) layout and passes the transpose.

#include <stdint.h>

#include "sdpa_core.cuh"

namespace {

struct GemmArgs {
  const void* a;        // (M, K) row-major
  const void* w[3];     // (N, K) row-major
  const void* bias[3];  // (N,)
  void* c[3];           // (M, N) row-major
  int m, n, k;
};

// ---- bf16: tensor cores through mma.sync, a 3-stage cp.async pipeline -----
//
// Block tile 128 x 64 (4 warps, 64 x 32 each), 32-deep k-steps; while the
// warps multiply one stage, cp.async fills the next two. Operand fragments
// come from shared memory through ldmatrix; rows are padded to 40 bf16 (80 B)
// so the eight 16-byte rows of each 8x8 matrix fall in distinct banks.

constexpr int kGM = 128, kGN = 64, kGK = 32, kStages = 3, kGLd = kGK + 8;
constexpr int kGThreads = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

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

  // epilogue: (f32 sum + bias) rounded once to bf16
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (col >= g.n) continue;  // n % 8 == 0, so col + 1 < n too
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
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
      if (col < g.n) C[(size_t)row * g.n + col] = acc[r][cc] + bias[col];
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

}  // namespace

extern "C" {

// x: (B, L, H); mask: (B, L) int32 or nullptr; w*: (H, H) as (out, in);
// b*: (H,); q, k, v, ctx: (B, L, H) scratch; out: (B, L, H). One dtype for
// all (0 = float32, 1 = bfloat16).
int smtc_attn_block_fwd(const void* x, const int* mask, const void* wq, const void* bq,
                        const void* wk, const void* bk, const void* wv, const void* bv,
                        const void* wo, const void* bo, void* q, void* k, void* v, void* ctx,
                        void* out, int batch, int len, int hidden, int heads, float scale,
                        int dtype, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs g = {};
  g.a = x;
  g.w[0] = wq, g.w[1] = wk, g.w[2] = wv;
  g.bias[0] = bq, g.bias[1] = bk, g.bias[2] = bv;
  g.c[0] = q, g.c[1] = k, g.c[2] = v;
  g.m = batch * len;
  g.n = hidden;
  g.k = hidden;
  err = launch_gemm(g, 3, dtype, s);
  if (err != cudaSuccess) return (int)err;

  const int d = hidden / heads;
  smtc::SdpaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o = ctx;
  a.heads = heads;
  a.lq = len;
  a.lk = len;
  a.d = d;
  a.q_sb = (long long)len * hidden;
  a.q_sh = d;
  a.q_sl = hidden;
  a.k_sb = a.v_sb = a.o_sb = a.q_sb;
  a.k_sh = a.v_sh = a.o_sh = a.q_sh;
  a.k_sl = a.v_sl = a.o_sl = a.q_sl;
  a.scale = scale;
  err = dtype == 1 ? smtc::launch_sdpa<__nv_bfloat16>(a, batch, s)
                   : smtc::launch_sdpa<float>(a, batch, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs go = {};
  go.a = ctx;
  go.w[0] = wo;
  go.bias[0] = bo;
  go.c[0] = out;
  go.m = batch * len;
  go.n = hidden;
  go.k = hidden;
  return (int)launch_gemm(go, 1, dtype, s);
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
