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
// Three kernels, chosen by launch_sdpa_bwd:
//   * the block kernel: one block per (batch, head) holds the whole Lq x Lk
//     problem, the f32 P and dP/dS row sets in shared memory (2 x 66 KB at
//     Lq = Lk = 128), like the Pallas kernel's grid over batch rows, so dK and
//     dV sum over every query row inside the block: no atomics, no second
//     pass. The six products are 64 x 64 output tiles of 4 x 4 f32 FMA
//     micro-tiles per thread; Q, K, V and dO stream from device memory
//     through 64 x 64 staging tiles. It takes any head dim, float32 or
//     bfloat16, and Lq, Lk up to what the two row sets leave room for.
//   * the row kernel, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K or V per batch
//     row, far beyond shared memory): one block per (batch, head) streams K
//     and V from device memory, one warp per key for the scores and dP,
//     reduces dQ with one thread per column, and writes dK and dV directly
//     as the outer products dS^T q and round(P)^T dO.
//   * the query-tiled pair, for every other shape the forward takes (ViLT's
//     joint sequence, L = 402 or 185): the counterpart of the Pallas
//     ops/attention.py::_bwd_kernel_blocked, whose grid walks 128-row query
//     tiles in order and sums dK and dV across them in an f32 output block.
//     Hopper blocks run in no order, so the sum moves into a second pass
//     (FlashAttention-2's shape, no atomics):
//       pass A (sdpa_bwd_rows_kernel), one block of 128 threads per (batch,
//       head, tile of kBQ = 32 query rows): the scores of the tile's rows into
//       one f32 row set in shared memory (the forward's layout and products,
//       so it takes every Lk the forward does), the exact softmax, ctx =
//       round(P) V when asked for, rowsum(dP P) with dP = dO V^T swept once,
//       then dP swept again to overwrite P in place with round(P (dP -
//       rowsum)), and dQ = (dS K) * scale. Per query row it writes three f32
//       numbers, the max, the sum and the rowsum, to `stats`. Two row sets of
//       64 rows would need 231 KB at Lk = 402, over a block's 227 KB: the one
//       row set and the second dP sweep are what make the tile fit.
//       pass B (sdpa_bwd_keys_kernel), one block of 256 threads per (batch,
//       head, tile of kBT = 64 keys): over the query rows in tiles of 64, P
//       recomputed from the stored max and sum, dP, dS from the stored
//       rowsum, and dV += round(P)^T dO, dK += dS^T Q in registers, so dK and
//       dV sum in f32 over every query row and are rounded once.
//     Both passes sum every product over the head dim in the same order, so
//     pass B's P and dS are pass A's bit for bit.
//
// What bounds it on the H100. At the training shapes (text 32x12x128x64 in
// bf16; fusion 32x1x1x768 over 197 keys in f32) the least time is set by the
// bytes of q, k, v, dO and the three gradients (about 6 us and 24 us at
// 3.35 TB/s); the text shape's 2.4 GFLOP would take 2.4 us on the bf16 tensor
// cores. ViLT's 32x12x402x402x64 in bf16 is 25 GFLOP, 25 us on the tensor
// cores against 13 us for its bytes. The kernels keep P and dS on chip, so
// only those bytes cross device memory, but their products run on the CUDA
// cores in f32 FMA: they are bound by FMA issue and shared-memory bandwidth,
// not by device memory. mma.sync/wgmma for the products is the next step.

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
  float* stats;  // (B, H, Lq, kStats) scratch of the query-tiled pair
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
constexpr int kStats = 3;         // per query row: max, sum, rowsum(dP P)

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

// ---- the query-tiled pair ------------------------------------------------------
//
// Pass A's thread layout is the forward FMA kernel's (sdpa_core.cuh): 128
// threads, ty = tid / 16 owns query rows 4 ty .. 4 ty + 3 of the kBQ-row tile,
// tx = tid % 16 owns keys (or head-dim columns) 4 tx .. 4 tx + 3 of a tile.

// acc[r][cc] = sum_c A[q0 + 4 ty + r][c] B[kt + 4 tx + cc][c]: one kBQ x kBK
// tile, the head dim summed in order through the d-major staging tiles Qs and
// Ks (the forward's step 1 and bwd_nt_product sum in the same order); rows at
// or past na and keys at or past nb are 0.
template <typename T>
__device__ __forceinline__ void rows_nt_tile(float (&acc)[4][4], const T* A, long long a_sl,
                                             int q0, int na, const T* B, long long b_sl, int kt,
                                             int nb, int d, float* Qs, float* Ks) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
  for (int dc = 0; dc < d; dc += kDC) {
    for (int e = tid; e < kBQ * kDC; e += kThreads) {
      const int i = e / kDC, c = e % kDC;
      Qs[c * kQLd + i] = (q0 + i < na && dc + c < d) ? to_f32(A[(q0 + i) * a_sl + dc + c]) : 0.f;
    }
    for (int e = tid; e < kBK * kDC; e += kThreads) {
      const int j = e / kDC, c = e % kDC;
      Ks[c * kKLd + j] = (kt + j < nb && dc + c < d) ? to_f32(B[(kt + j) * b_sl + dc + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDC; ++c) {
      const float4 a4 = reinterpret_cast<const float4*>(Qs + c * kQLd)[ty];
      const float4 b4 = reinterpret_cast<const float4*>(Ks + c * kKLd)[tx];
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

// out[q0 + i][c] = round(alpha * sum_j f(R[i][j]) B[j][c]) for the tile's rows
// below na, f rounding to T when ROUND (round(P)); keys summed in order, B
// staged kBK rows at a time into Vs (the forward's step 3). R is 0 past nb.
template <typename T, bool ROUND>
__device__ __forceinline__ void rows_s_product(T* out, long long o_sl, int q0, int na,
                                               const float* R, int ld, const T* B, long long b_sl,
                                               int nb, int d, float alpha, float* Vs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int dc = 0; dc < d; dc += kDC) {
    float acc[4][4] = {};
    for (int kt = 0; kt < nb; kt += kBK) {
      for (int e = tid; e < kBK * kDC; e += kThreads) {
        const int j = e / kDC, c = e % kDC;
        Vs[j * kDC + c] = (kt + j < nb && dc + c < d) ? to_f32(B[(kt + j) * b_sl + dc + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float4 b4 = reinterpret_cast<const float4*>(Vs + j * kDC)[tx];
        const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = R[(ty * 4 + r) * ld + kt + j];
          if (ROUND) p = to_f32(from_f32<T>(p));
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(p, bc[cc], acc[r][cc]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      if (i >= na) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = dc + tx * 4 + cc;
        if (c < d) out[i * o_sl + c] = from_f32<T>(acc[r][cc] * alpha);
      }
    }
  }
}

// Pass A: one block per (tile of kBQ query rows, head, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) sdpa_bwd_rows_kernel(SdpaBwdArgs a) {
  extern __shared__ float4 smem4[];
  const int ld = sdpa_row_stride(a.lk);
  float* R = reinterpret_cast<float*>(smem4);  // [kBQ][ld] scores, P, then round(dS)
  float* Qs = R + kBQ * ld;                    // [kDC][kQLd] staging
  float* Ks = Qs + kDC * kQLd;                 // [kDC][kKLd] staging

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* dout = static_cast<const T*>(a.dout) + qo;
  const T* k = static_cast<const T*>(a.k) + ko;
  const T* v = static_cast<const T*>(a.v) + ko;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  float* stats = a.stats + ((long long)b * a.heads + h) * a.lq * kStats;
  const int lq = a.lq, lk = a.lk;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int lk_tiles = (lk + kBK - 1) / kBK * kBK;

  // 1. scores (scaled, masked), key tile by key tile
  for (int kt = 0; kt < lk; kt += kBK) {
    float acc[4][4];
    rows_nt_tile(acc, q, a.q_sl, q0, lq, k, a.k_sl, kt, lk, a.d, Qs, Ks);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = kt + tx * 4 + cc;
        const bool keep = j < lk && (mask == nullptr || mask[j] > 0);
        R[(ty * 4 + r) * ld + j] = keep ? acc[r][cc] * a.scale : kNegInf;
      }
  }
  __syncthreads();

  // 2. softmax per row, one warp per row: P in f32; the max and sum to stats
  for (int i = warp; i < kBQ; i += kThreads / 32) {
    float* row = R + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < lk_tiles; j += 32) row[j] = j < lk ? row[j] / l : 0.f;
    if (lane == 0 && q0 + i < lq) {
      stats[(q0 + i) * kStats] = m;
      stats[(q0 + i) * kStats + 1] = l;
    }
  }
  __syncthreads();

  // 3. ctx = round(P) V, for the fused block's out-projection gradient
  if (a.o != nullptr)
    rows_s_product<T, true>(static_cast<T*>(a.o) + qo, a.q_sl, q0, lq, R, ld, v, a.k_sl, lk,
                            a.d, 1.f, Ks);

  // 4. rowsum(dP P) over the row, dP = dO V^T in f32; each row's 16 threads
  //    (a half warp) sum their partials, then every one of them holds it
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < lk; kt += kBK) {
    float acc[4][4];
    rows_nt_tile(acc, dout, a.q_sl, q0, lq, v, a.k_sl, kt, lk, a.d, Qs, Ks);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = kt + tx * 4 + cc;
        if (j < lk) rs[r] += acc[r][cc] * R[(ty * 4 + r) * ld + j];
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off);
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (q0 + ty * 4 + r < lq) stats[(q0 + ty * 4 + r) * kStats + 2] = rs[r];

  // 5. dP swept again: dS = P (dP - rowsum) from the f32 P, rounded to T,
  //    over P in place (each element is read and written by its own thread)
  for (int kt = 0; kt < lk; kt += kBK) {
    float acc[4][4];
    rows_nt_tile(acc, dout, a.q_sl, q0, lq, v, a.k_sl, kt, lk, a.d, Qs, Ks);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = kt + tx * 4 + cc;
        float* x = R + (ty * 4 + r) * ld + j;
        *x = j < lk ? to_f32(from_f32<T>(*x * (acc[r][cc] - rs[r]))) : 0.f;
      }
  }
  __syncthreads();

  // 6. dQ = (dS K) * scale
  rows_s_product<T, false>(static_cast<T*>(a.dq) + qo, a.q_sl, q0, lq, R, ld, k, a.k_sl, lk,
                           a.d, a.scale, Ks);
}

__host__ inline size_t sdpa_bwd_keys_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kBT * kBTLd + (size_t)kBT * kStats);
}

// Pass B: one block per (tile of kBT keys, head, batch); dV and dK of the
// tile's keys, kBT head-dim columns at a time, summed over every query row.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) sdpa_bwd_keys_kernel(SdpaBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [kBT][kBTLd] staging, then Q columns
  float* Bs = As + kBT * kBTLd;                 // [kBT][kBTLd] staging, then dO columns
  float* Pt = Bs + kBT * kBTLd;                 // [query][key] P, then round(P)
  float* Dt = Pt + kBT * kBTLd;                 // [query][key] round(dS)
  float* st = Dt + kBT * kBTLd;                 // [kBT][kStats] the query tile's stats

  const int k0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* dout = static_cast<const T*>(a.dout) + qo;
  const T* k = static_cast<const T*>(a.k) + ko + k0 * a.k_sl;
  const T* v = static_cast<const T*>(a.v) + ko + k0 * a.k_sl;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk + k0 : nullptr;
  const float* stats = a.stats + ((long long)b * a.heads + h) * a.lq * kStats;
  const int lq = a.lq, d = a.d, nk = min(kBT, a.lk - k0);
  const float scale = a.scale;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int c0 = 0; c0 < d; c0 += kBT) {
    float accv[4][4] = {}, acck[4][4] = {};
    for (int q0 = 0; q0 < lq; q0 += kBT) {
      const int nq = min(kBT, lq - q0);
      for (int e = tid; e < kBT * kStats; e += kBwdThreads)
        st[e] = e < nq * kStats ? stats[q0 * kStats + e] : 0.f;
      // P = exp(s - max) / sum from pass A's statistics (the product's
      // syncs order the stats above before the epilogue reads them)
      bwd_nt_product(Pt, kBTLd, q + q0 * a.q_sl, a.q_sl, nq, k, a.k_sl, nk, d, As, Bs,
                     [&](float s, int i, int j) {
                       if (i >= nq || j >= nk) return 0.f;
                       const float x = (mask == nullptr || mask[j] > 0) ? s * scale : kNegInf;
                       return expf(x - st[i * kStats]) / st[i * kStats + 1];
                     });
      // dS = P (dP - rowsum) rounded; P rounded in place for dV. Both
      // products give a thread the same (i, j), so it reads its own P.
      bwd_nt_product(Dt, kBTLd, dout + q0 * a.q_sl, a.q_sl, nq, v, a.k_sl, nk, d, As, Bs,
                     [&](float dp, int i, int j) {
                       float* p = Pt + i * kBTLd + j;
                       const float ds = (i < nq && j < nk)
                                            ? to_f32(from_f32<T>(*p * (dp - st[i * kStats + 2])))
                                            : 0.f;
                       *p = to_f32(from_f32<T>(*p));
                       return ds;
                     });
      // Q and dO columns [c0, c0 + kBT) of the tile's query rows
      for (int e = tid; e < kBT * kBT; e += kBwdThreads) {
        const int i = e / kBT, c = e % kBT;
        const bool in = i < nq && c0 + c < d;
        As[i * kBTLd + c] = in ? to_f32(q[(q0 + i) * a.q_sl + c0 + c]) : 0.f;
        Bs[i * kBTLd + c] = in ? to_f32(dout[(q0 + i) * a.q_sl + c0 + c]) : 0.f;
      }
      __syncthreads();
      // dV[j][c] += round(P)[i][j] dO[i][c], dK[j][c] += dS[i][j] Q[i][c],
      // the query rows in order
#pragma unroll 4
      for (int i = 0; i < kBT; ++i) {
        const float4 p4 = reinterpret_cast<const float4*>(Pt + i * kBTLd)[ty];
        const float4 s4 = reinterpret_cast<const float4*>(Dt + i * kBTLd)[ty];
        const float4 o4 = reinterpret_cast<const float4*>(Bs + i * kBTLd)[tx];
        const float4 q4 = reinterpret_cast<const float4*>(As + i * kBTLd)[tx];
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
        const float oc[4] = {o4.x, o4.y, o4.z, o4.w};
        const float qc[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            accv[r][cc] = fmaf(pr[r], oc[cc], accv[r][cc]);
            acck[r][cc] = fmaf(sr[r], qc[cc], acck[r][cc]);
          }
      }
      __syncthreads();
    }
    T* dk = static_cast<T*>(a.dk) + ko + k0 * a.k_sl;
    T* dv = static_cast<T*>(a.dv) + ko + k0 * a.k_sl;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty * 4 + r;
      if (j >= nk) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = c0 + tx * 4 + cc;
        if (c < d) {
          dv[j * a.k_sl + c] = from_f32<T>(accv[r][cc]);
          dk[j * a.k_sl + c] = from_f32<T>(acck[r][cc] * scale);
        }
      }
    }
  }
}

enum SdpaBwdKernel { kBwdAuto = 0, kBwdTiled = 1 };

inline bool sdpa_bwd_row_fits(int lq, int lk, int d) {
  return lq <= kRowMaxLq && sdpa_bwd_row_smem_bytes(lq, lk, d) <= 232448;
}
inline bool sdpa_bwd_block_fits(int lq, int lk) { return sdpa_bwd_smem_bytes(lq, lk) <= 232448; }
// pass A holds the forward FMA kernel's row set, so it takes every Lk that does
inline bool sdpa_bwd_tiled_fits(int lk) { return sdpa_smem_bytes(lk) <= 232448; }

inline bool sdpa_bwd_fits(int lq, int lk, int d) {
  if (lq <= 0 || lk <= 0 || d <= 0) return false;
  return sdpa_bwd_row_fits(lq, lk, d) || sdpa_bwd_block_fits(lq, lk) || sdpa_bwd_tiled_fits(lk);
}

template <typename T>
cudaError_t launch_sdpa_bwd_tiled(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  if (a.stats == nullptr || !sdpa_bwd_tiled_fits(a.lk)) return cudaErrorInvalidValue;
  const size_t smem_a = sdpa_smem_bytes(a.lk);
  cudaError_t err = cudaFuncSetAttribute(sdpa_bwd_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  sdpa_bwd_rows_kernel<T><<<dim3((a.lq + kBQ - 1) / kBQ, a.heads, batch), kThreads, smem_a,
                            stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b = sdpa_bwd_keys_smem_bytes();
  err = cudaFuncSetAttribute(sdpa_bwd_keys_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  sdpa_bwd_keys_kernel<T><<<dim3((a.lk + kBT - 1) / kBT, a.heads, batch), kBwdThreads, smem_b,
                            stream>>>(a);
  return cudaGetLastError();
}

// kernel: kBwdAuto takes the row kernel for a few query rows, else the block
// kernel where its row sets fit, else the query-tiled pair; kBwdTiled asks
// for the pair at any shape it takes.
template <typename T>
cudaError_t launch_sdpa_bwd(const SdpaBwdArgs& a, int batch, cudaStream_t stream,
                            int kernel = kBwdAuto) {
  if (!sdpa_bwd_fits(a.lq, a.lk, a.d)) return cudaErrorInvalidValue;
  if (kernel == kBwdTiled ||
      (!sdpa_bwd_row_fits(a.lq, a.lk, a.d) && !sdpa_bwd_block_fits(a.lq, a.lk)))
    return launch_sdpa_bwd_tiled<T>(a, batch, stream);
  if (kernel != kBwdAuto) return cudaErrorInvalidValue;
  const dim3 grid(a.heads, batch);
  if (sdpa_bwd_row_fits(a.lq, a.lk, a.d)) {
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
