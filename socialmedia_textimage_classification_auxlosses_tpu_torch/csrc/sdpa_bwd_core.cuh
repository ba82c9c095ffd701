// Scaled-dot-product attention backward, shared by sdpa_bwd.cu and
// attn_block_bwd.cu.
//
// Computes exactly the JAX package's Pallas backward
// (ops/attention.py::_bwd_kernel, and the per-head body of
// ops/attn_block.py::_bwd_kernel2), with its rounding points:
//   * P is recomputed with the forward's numerics (sdpa_core.cuh): scores
//     q.k in f32, times scale, masked keys at -1e30, max / exp / sum in f32;
//   * dV = round(P) ^T dO: P rounded to the input dtype for this product only;
//   * dP = dO V^T in f32;
//   * dS = P (dP - rowsum(dP P)) from the f32, unrounded P, then rounded to
//     the input dtype;
//   * dQ = (dS K) * scale and dK = (dS^T Q) * scale, scaled after the f32
//     product;
//   * optionally ctx = round(P) V, the forward output (the fused block's
//     backward needs it for the out-projection's weight gradient);
//   * every output rounded once to the input dtype.
//
// Two kernels, chosen by launch_sdpa_bwd:
//   * the block kernel: one block per (batch, head) holds the whole Lq x Lk
//     problem, the f32 P and dP/dS row sets in shared memory (2 x 66 KB at
//     Lq = Lk = 128), like the Pallas kernel's grid over batch rows, so dK and
//     dV sum over every query row inside the block: no atomics, no second
//     pass. The six products are 64 x 64 output tiles of 4 x 4 f32 FMA
//     micro-tiles per thread; Q, K, V and dO stream from device memory
//     through 64 x 64 staging tiles. It takes any head dim, float32 or
//     bfloat16, and Lq, Lk up to what the two row sets leave room for
//     (smtc_sdpa_bwd_fits).
//   * the row kernel, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K or V per batch
//     row, far beyond shared memory): one block per (batch, head) streams K
//     and V from device memory, one warp per key for the scores and dP,
//     reduces dQ with one thread per column, and writes dK and dV directly
//     as the outer products dS^T q and round(P)^T dO.
//
// What bounds it on the H100. At the training shapes (text 32x12x128x64 in
// bf16; fusion 32x1x1x768 over 197 keys in f32) the least time is set by the
// bytes of q, k, v, dO and the three gradients (about 6 us and 24 us at
// 3.35 TB/s); the text shape's 2.4 GFLOP would take 2.4 us on the bf16 tensor
// cores. The block kernel keeps P and dS on chip, so only those bytes cross
// device memory, but its products run on the CUDA cores in f32 FMA: on the
// text shape it is bound by FMA issue and shared-memory bandwidth, not by
// device memory. mma.sync/wgmma for the six products is the next step.

#pragma once

#include "sdpa_core.cuh"

namespace smtc {

struct SdpaBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* mask;  // (B, Lk) 1 = keep, or nullptr for no mask
  void* dq;
  void* dk;
  void* dv;
  void* o;  // ctx = round(P) V, or nullptr
  int heads, lq, lk, d;
  // element strides of batch, head and position; the head dim has stride 1.
  // q, dout, dq and o share q's; k, v, dk and dv share k's.
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  float scale;
};

constexpr int kBwdThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBT = 64;           // output tile rows and columns, staging depth
constexpr int kBTLd = kBT + 4;    // staging row stride (floats)

__host__ __device__ inline int sdpa_bwd_rows(int lq) { return (lq + kBT - 1) / kBT * kBT; }

__host__ inline size_t sdpa_bwd_smem_bytes(int lq, int lk) {
  return sizeof(float) * (2 * (size_t)sdpa_bwd_rows(lq) * sdpa_row_stride(lk) +
                          2 * (size_t)kBT * kBTLd);
}

__host__ inline size_t sdpa_bwd_row_smem_bytes(int lq, int lk, int d) {
  return sizeof(float) * 2 * (size_t)lq * ((size_t)d + lk);
}

// dst[i][j] = epi(sum_c A[i][c] B[j][c], i, j) for i < rows_pad(na) and
// j < the key tiles of nb: rows of A and B (row stride a_sl, b_sl) stream
// through d-major staging tiles.
template <typename T, typename Epi>
__device__ __forceinline__ void bwd_nt_product(float* dst, int ld, const T* A, long long a_sl,
                                               int na, const T* B, long long b_sl, int nb, int d,
                                               float* As, float* Bs, Epi epi) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i0 = 0; i0 < na; i0 += kBT)
    for (int j0 = 0; j0 < nb; j0 += kBT) {
      float acc[4][4] = {};
      for (int dc = 0; dc < d; dc += kBT) {
        for (int e = tid; e < kBT * kBT; e += kBwdThreads) {
          const int r = e / kBT, c = e % kBT;
          const bool cin = dc + c < d;
          As[c * kBTLd + r] = (cin && i0 + r < na) ? to_f32(A[(i0 + r) * a_sl + dc + c]) : 0.f;
          Bs[c * kBTLd + r] = (cin && j0 + r < nb) ? to_f32(B[(j0 + r) * b_sl + dc + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < kBT; ++c) {
          const float4 a4 = reinterpret_cast<const float4*>(As + c * kBTLd)[ty];
          const float4 b4 = reinterpret_cast<const float4*>(Bs + c * kBTLd)[tx];
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
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = i0 + ty * 4 + r, j = j0 + tx * 4 + cc;
          dst[i * ld + j] = epi(acc[r][cc], i, j);
        }
    }
}

// out[m][c] = round(alpha * sum_k a(k, m) B[k][c]) for m < nm, c < d, k < nk,
// with a(k, m) = S[k][m] (TRANS: the row set read by columns, for dV and dK)
// or S[m][k] (for dQ and ctx), rounded to T first when ROUND (round(P)).
// The loops run to whole tiles: S is zero past its real rows and keys, and
// B's rows past nk are staged as zeros, never read. B streams from device
// memory.
template <typename T, bool TRANS, bool ROUND>
__device__ __forceinline__ void bwd_s_product(T* out, long long o_sl, int nm, const float* S,
                                              int ld, const T* B, long long b_sl, int nk, int d,
                                              float alpha, float* As, float* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < nm; m0 += kBT)
    for (int c0 = 0; c0 < d; c0 += kBT) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < nk; k0 += kBT) {
        for (int e = tid; e < kBT * kBT; e += kBwdThreads) {
          const int r = e / kBT, c = e % kBT;
          Bs[r * kBTLd + c] = (k0 + r < nk && c0 + c < d) ? to_f32(B[(k0 + r) * b_sl + c0 + c]) : 0.f;
          float x = TRANS ? S[(k0 + r) * ld + m0 + c] : S[(m0 + r) * ld + k0 + c];
          if (ROUND) x = to_f32(from_f32<T>(x));
          // As[k][m]: TRANS reads row r = k; otherwise row r = m, column c = k
          if (TRANS)
            As[r * kBTLd + c] = x;
          else
            As[c * kBTLd + r] = x;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kBT; ++kk) {
          const float4 a4 = reinterpret_cast<const float4*>(As + kk * kBTLd)[ty];
          const float4 b4 = reinterpret_cast<const float4*>(Bs + kk * kBTLd)[tx];
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
        const int m = m0 + ty * 4 + r;
        if (m >= nm) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = c0 + tx * 4 + cc;
          if (c < d) out[m * o_sl + c] = from_f32<T>(acc[r][cc] * alpha);
        }
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) sdpa_bwd_kernel(SdpaBwdArgs a) {
  extern __shared__ float4 smem4[];
  const int ld = sdpa_row_stride(a.lk);
  const int lq_pad = sdpa_bwd_rows(a.lq);
  float* P = reinterpret_cast<float*>(smem4);  // [lq_pad][ld] scores, then f32 P
  float* G = P + lq_pad * ld;                  // [lq_pad][ld] dP, then round(dS)
  float* As = G + lq_pad * ld;                 // [kBT][kBTLd] staging
  float* Bs = As + kBT * kBTLd;                // [kBT][kBTLd] staging

  const int h = blockIdx.x, b = blockIdx.y;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* dout = static_cast<const T*>(a.dout) + qo;
  const T* k = static_cast<const T*>(a.k) + ko;
  const T* v = static_cast<const T*>(a.v) + ko;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const float scale = a.scale;
  const int lq = a.lq, lk = a.lk;

  // 1. scores (scaled, masked) and dP = dO V^T; padding rows and keys are 0
  bwd_nt_product(P, ld, q, a.q_sl, lq, k, a.k_sl, lk, a.d, As, Bs,
                 [&](float s, int i, int j) {
                   if (i >= lq || j >= lk) return 0.f;
                   return (mask == nullptr || mask[j] > 0) ? s * scale : kNegInf;
                 });
  bwd_nt_product(G, ld, dout, a.q_sl, lq, v, a.k_sl, lk, a.d, As, Bs,
                 [&](float s, int i, int j) { return (i < lq && j < lk) ? s : 0.f; });
  __syncthreads();

  // 2. per row, one warp: P = softmax (f32), then dS = P (dP - rowsum(dP P))
  //    rounded to T; every lane touches only its own columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lk_tiles = (lk + kBK - 1) / kBK * kBK;
  for (int i = warp; i < lq; i += kBwdThreads / 32) {
    float* prow = P + i * ld;
    float* grow = G + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) m = fmaxf(m, prow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    float r = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float p = prow[j] / l;
      prow[j] = p;
      r += grow[j] * p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
    for (int j = lane; j < lk_tiles; j += 32)
      grow[j] = j < lk ? to_f32(from_f32<T>(prow[j] * (grow[j] - r))) : 0.f;
  }
  __syncthreads();

  // 3. the four products that read the row sets
  T* dq = static_cast<T*>(a.dq) + qo;
  T* dk = static_cast<T*>(a.dk) + ko;
  T* dv = static_cast<T*>(a.dv) + ko;
  bwd_s_product<T, true, true>(dv, a.k_sl, lk, P, ld, dout, a.q_sl, lq, a.d, 1.f, As, Bs);
  bwd_s_product<T, true, false>(dk, a.k_sl, lk, G, ld, q, a.q_sl, lq, a.d, scale, As, Bs);
  bwd_s_product<T, false, false>(dq, a.q_sl, lq, G, ld, k, a.k_sl, lk, a.d, scale, As, Bs);
  if (a.o != nullptr)
    bwd_s_product<T, false, true>(static_cast<T*>(a.o) + qo, a.q_sl, lq, P, ld, v, a.k_sl, lk,
                                  a.d, 1.f, As, Bs);
}

// At most kRowMaxLq query rows: K and V stream from device memory.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) sdpa_bwd_row_kernel(SdpaBwdArgs a) {
  extern __shared__ float4 smem4[];
  const int lq = a.lq, lk = a.lk, d = a.d;
  float* qs = reinterpret_cast<float*>(smem4);  // [lq][d]
  float* dos = qs + lq * d;                     // [lq][d]
  float* P = dos + lq * d;                      // [lq][lk] scores, then f32 P
  float* G = P + lq * lk;                       // [lq][lk] dP, then round(dS)
  const int h = blockIdx.x, b = blockIdx.y;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* dout = static_cast<const T*>(a.dout) + qo;
  const T* k = static_cast<const T*>(a.k) + ko;
  const T* v = static_cast<const T*>(a.v) + ko;
  const int* mask = a.mask ? a.mask + (long long)b * lk : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kRowThreads / 32;

  for (int e = tid; e < lq * d; e += kRowThreads) {
    const int i = e / d, c = e % d;
    qs[e] = to_f32(q[i * a.q_sl + c]);
    dos[e] = to_f32(dout[i * a.q_sl + c]);
  }
  __syncthreads();

  // 1. scores and dP, one warp per key: K and V rows read once, coalesced
  for (int j = warp; j < lk; j += kWarps) {
    const T* kj = k + j * a.k_sl;
    const T* vj = v + j * a.k_sl;
    float s[kRowMaxLq] = {}, dp[kRowMaxLq] = {};
    for (int c = lane; c < d; c += 32) {
      const float kv = to_f32(kj[c]), vv = to_f32(vj[c]);
#pragma unroll
      for (int i = 0; i < kRowMaxLq; ++i)
        if (i < lq) {
          s[i] = fmaf(qs[i * d + c], kv, s[i]);
          dp[i] = fmaf(dos[i * d + c], vv, dp[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        dp[i] += __shfl_xor_sync(0xffffffffu, dp[i], off);
      }
      if (lane == 0 && i < lq) {
        P[i * lk + j] = (mask == nullptr || mask[j] > 0) ? s[i] * a.scale : kNegInf;
        G[i * lk + j] = dp[i];
      }
    }
  }
  __syncthreads();

  // 2. softmax and dS, one warp per query row
  if (warp < lq) {
    float* prow = P + warp * lk;
    float* grow = G + warp * lk;
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) m = fmaxf(m, prow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    float r = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float p = prow[j] / l;
      prow[j] = p;
      r += grow[j] * p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
    for (int j = lane; j < lk; j += 32) grow[j] = to_f32(from_f32<T>(prow[j] * (grow[j] - r)));
  }
  __syncthreads();

  // 3. dQ (and ctx): one thread per column, K (and V) read down the keys
  T* dq = static_cast<T*>(a.dq) + qo;
  T* o = a.o ? static_cast<T*>(a.o) + qo : nullptr;
  for (int c = tid; c < d; c += kRowThreads) {
    float aq[kRowMaxLq] = {}, ao[kRowMaxLq] = {};
    for (int j = 0; j < lk; ++j) {
      const float kv = to_f32(k[j * a.k_sl + c]);
      const float vv = o ? to_f32(v[j * a.k_sl + c]) : 0.f;
#pragma unroll
      for (int i = 0; i < kRowMaxLq; ++i)
        if (i < lq) {
          aq[i] = fmaf(G[i * lk + j], kv, aq[i]);
          ao[i] = fmaf(to_f32(from_f32<T>(P[i * lk + j])), vv, ao[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i)
      if (i < lq) {
        dq[i * a.q_sl + c] = from_f32<T>(aq[i] * a.scale);
        if (o) o[i * a.q_sl + c] = from_f32<T>(ao[i]);
      }
  }

  // 4. dK = (dS^T q) * scale and dV = round(P)^T dO as outer products
  T* dk = static_cast<T*>(a.dk) + ko;
  T* dv = static_cast<T*>(a.dv) + ko;
  for (int c = tid; c < d; c += kRowThreads) {
    float qc[kRowMaxLq], dc[kRowMaxLq];
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i) {
      qc[i] = i < lq ? qs[i * d + c] : 0.f;
      dc[i] = i < lq ? dos[i * d + c] : 0.f;
    }
    for (int j = 0; j < lk; ++j) {
      float sk = 0.f, sv = 0.f;
#pragma unroll
      for (int i = 0; i < kRowMaxLq; ++i)
        if (i < lq) {
          sk = fmaf(G[i * lk + j], qc[i], sk);
          sv = fmaf(to_f32(from_f32<T>(P[i * lk + j])), dc[i], sv);
        }
      dk[j * a.k_sl + c] = from_f32<T>(sk * a.scale);
      dv[j * a.k_sl + c] = from_f32<T>(sv);
    }
  }
}

inline bool sdpa_bwd_fits(int lq, int lk, int d) {
  if (lq <= 0 || lk <= 0 || d <= 0) return false;
  const size_t smem = lq <= kRowMaxLq ? sdpa_bwd_row_smem_bytes(lq, lk, d)
                                      : sdpa_bwd_smem_bytes(lq, lk);
  return smem <= 232448;
}

template <typename T>
cudaError_t launch_sdpa_bwd(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  if (!sdpa_bwd_fits(a.lq, a.lk, a.d)) return cudaErrorInvalidValue;
  const dim3 grid(a.heads, batch);
  if (a.lq <= kRowMaxLq) {
    const size_t smem = sdpa_bwd_row_smem_bytes(a.lq, a.lk, a.d);
    cudaError_t err = cudaFuncSetAttribute(sdpa_bwd_row_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sdpa_bwd_row_kernel<T><<<grid, kRowThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sdpa_bwd_smem_bytes(a.lq, a.lk);
  cudaError_t err = cudaFuncSetAttribute(sdpa_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sdpa_bwd_kernel<T><<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace smtc
