// Scaled-dot-product attention backward, shared by sdpa_bwd.cu and
// attn_block_bwd.cu.
//
// Computes exactly the JAX package's Pallas backward
// (ops/attention.py::_bwd_kernel, ::_bwd_kernel_blocked, and the per-head
// body of ops/attn_block.py::_bwd_kernel2), with its rounding points:
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
// Kernels, chosen by launch_sdpa_bwd from the arguments alone:
//   * the tensor-core pair, for bf16 with a head dim of 32 or 64, 16-byte
//     aligned rows and more than kRowMaxLq query rows: every bf16 attention
//     of the training paths (text L = 128, ViLT 185 and 402, the fused
//     blocks' column slices). It replaces TPU kernel 4
//     (ops/attention.py::_bwd_kernel_blocked, whose grid walks 128-row query
//     tiles in order and sums dK and dV across them in an f32 output block)
//     and TPU kernel 2 (::_bwd_kernel) at those shapes. Hopper blocks run in
//     no order, so the sum over query tiles moves into a second pass
//     (FlashAttention-2's shape, no atomics). Both passes are 4 warps of 16
//     rows, every product mma.sync.m16n8k16 with bf16 operands and f32
//     accumulators, operands through ldmatrix, the streamed tiles through
//     sdpa_core.cuh's cp.async ring (kRing stages of two 64-row tiles, 18 KB
//     at D = 64); nothing score-shaped lives in shared memory.
//       pass A (sdpa_bwd_rows_tc_kernel), one block per (64 query rows,
//       head, batch): Q and dO fragments in registers, K and V streaming.
//       Sweep 1: S = Q K^T for the row max m and sum l, online, as the
//       forward. Sweep 2: S and dP = dO V^T together, 32 keys at a time; the
//       f32 P from the final m and l; rowsum(dP P) from the unrounded P;
//       ctx += round(P) V when asked for. Sweep 3: S and dP again, dS =
//       round(P (dP - rowsum)) packed from C fragments into A fragments,
//       dQ += dS K with K through ldmatrix.trans. It writes dQ * scale,
//       ctx, and per query row the max, the sum and the rowsum to `stats`.
//       pass B (sdpa_bwd_keys_tc_kernel), one block per (64 keys, head,
//       batch): K and V fragments in registers as A operands; Q, dO and the
//       stats of each 64-row query tile streaming. S^T = K Q^T and dP^T =
//       V dO^T in registers, P^T from the stored m and l, dS^T =
//       round(P^T (dP^T - rowsum)); dV += round(P^T) dO and dK += dS^T Q,
//       dO and Q read from the same shared tiles through ldmatrix.trans,
//       summed in f32 registers over every query tile and rounded once.
//       Query rows past Lq add exactly zero: their P and dS are set to 0
//       (pass A writes no stats for them; the JAX kernel pads dO with zeros
//       for the same reason).
//     Pass B forms P and dS with pass A's formulas from pass A's m, l and
//     rowsum; its S^T and dP^T are pass A's products with the mma operands
//     swapped, the same bf16 pairs summed in the same k order. They equal
//     pass A's P and dS bit for bit only where the tensor cores sum a k16
//     step the same way whichever operand is A, which is not documented and
//     was not checked; nothing relies on it: each output is held to its
//     plain version on the card.
//     What changes against the JAX kernels: the order of the f32 sums, the
//     online row sum (about 1e-7 relative) and p = e * (1 / l).
//     Occupancy at D = 64, Lk = 402: pass A 3 blocks per SM (168 registers),
//     pass B 3 (bounded to 168 registers); D = 128 would hold 64 more f32
//     accumulators per thread and is left to the FMA kernels below.
//   * the row kernel, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K or V per batch
//     row, far beyond shared memory): one block per (batch, head) streams K
//     and V from device memory, one warp per key for the scores and dP,
//     reduces dQ with one thread per column, and writes dK and dV directly
//     as the outer products dS^T q and round(P)^T dO.
//   * the block kernel, float32 (and bf16 at other head dims) up to what its
//     two row sets leave room for: one block per (batch, head) holds the
//     whole Lq x Lk problem, the f32 P and dP/dS row sets in shared memory
//     (2 x 66 KB at Lq = Lk = 128), like the Pallas kernel's grid over batch
//     rows, so dK and dV sum over every query row inside the block. The six
//     products are 64 x 64 output tiles of 4 x 4 f32 FMA micro-tiles.
//   * the FMA query-tiled pair for the other float32 shapes (and bf16 at
//     other head dims, including 128, whose tensor-core pair would hold
//     more accumulators than a thread has registers): pass A
//     (sdpa_bwd_rows_kernel) per 32 query rows holds one f32 row set of
//     scores, P and then dS in shared memory, sweeping dP = dO V^T twice;
//     pass B (sdpa_bwd_keys_kernel) per 64 keys recomputes P and dS from the
//     stats with the same products in the same order, so its P and dS are
//     pass A's bit for bit.
//
// What bounds it on the H100. At the training shapes (text 32x12x128x64 in
// bf16; fusion 32x1x1x768 over 197 keys in f32) the least time is set by the
// bytes of q, k, v, dO and the three gradients (about 13 us and 23 us at
// 3.35 TB/s). ViLT's 32x12x402x402x64 in bf16 is 40 GFLOP of the five
// products (41 us at 989 TFLOP/s) against 41 us for its bytes; the
// tensor-core pair does twice the products (S three times in pass A and once
// in pass B, dP twice and once) plus three exponentials per score, so it is
// bound by mma.sync issue and the softmax arithmetic, not by device memory.
// f32 runs on the CUDA cores at 67 TFLOP/s.

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

// ---- the FMA query-tiled pair (float32, other head dims) ---------------------
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

// ---- the tensor-core pair (bf16) -------------------------------------------------

// Pass A's P (f32, from the final row max and sum) and dP = dO V^T of the
// warp's 16 rows against keys hk .. hk + 31 of a (K, V) stage
template <int D>
__device__ __forceinline__ void probs_and_dp(float (&p)[4][4], float (&dp)[4][4],
                                             const uint32_t (&qf)[D / 16][4],
                                             const uint32_t (&dof)[D / 16][4],
                                             const __nv_bfloat16* st, int hk, const float* cm,
                                             float scale, const float (&m)[2],
                                             const float (&rl)[2]) {
  nt_tile<D, 32>(p, qf, st + hk * tc_ld(D));
  nt_tile<D, 32>(dp, dof, st + tc_tile(D) + hk * tc_ld(D));
  scale_mask<32>(p, cm + hk, scale);
  probs<32>(p, m, rl);
}

// Pass A: one block per (kMQ query rows, head, batch). Shared memory as the
// forward's: the ring, then the column map of the key mask.
template <int D>
__global__ void __launch_bounds__(kThreads) sdpa_bwd_rows_tc_kernel(SdpaBwdArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int kTile = tc_tile(D), kLd = tc_ld(D);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);  // kRing x 2 tiles
  float* cm = reinterpret_cast<float*>(ring + kRing * 2 * kTile);  // [tc_cols(lk)]
  const int q0 = blockIdx.x * kMQ, h = blockIdx.y, b = blockIdx.z;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + qo;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout) + qo;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + ko;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + ko;
  float* stats = a.stats + ((long long)b * a.heads + h) * a.lq * kStats;
  const int lq = a.lq, lk = a.lk, nt = (lk + kMK - 1) / kMK, n1 = (nt + 1) / 2;
  const int lane = threadIdx.x % 32, row0 = (threadIdx.x / 32) * 16;
  const int grp = lane >> 2, t4 = lane & 3;

  __nv_bfloat16* last = ring + (kRing - 1) * 2 * kTile;
  tile_async<D>(last, q, a.q_sl, q0, lq);
  tile_async<D>(last + kTile, dout, a.q_sl, q0, lq);
  cp_async_commit();
  fill_cols(cm, a.mask ? a.mask + (long long)b * lk : nullptr, lk);
  // stage s: two K tiles (sweep 1, s < n1), then a (K, V) pair per key tile
  // for sweep 2 and again for sweep 3
  auto issue = [&](int s) {
    __nv_bfloat16* dst = ring + (s % kRing) * 2 * kTile;
    if (s < n1) {
      tile_async<D>(dst, k, a.k_sl, 2 * s * kMK, lk);
      if ((2 * s + 1) * kMK < lk) tile_async<D>(dst + kTile, k, a.k_sl, (2 * s + 1) * kMK, lk);
    } else if (s < n1 + 2 * nt) {
      const int kt = (s - n1) % nt * kMK;
      tile_async<D>(dst, k, a.k_sl, kt, lk);
      tile_async<D>(dst + kTile, v, a.k_sl, kt, lk);
    }
    cp_async_commit();
  };
  ring_start(issue);
  uint32_t qf[D / 16][4], dof[D / 16][4];
  a_frags<D>(qf, last, row0);
  a_frags<D>(dof, last + kTile, row0);
  int s = 0;
  auto next = [&]() {
    return static_cast<const __nv_bfloat16*>(ring + ring_next(s, issue) * 2 * kTile);
  };

  // 1. row max and sum
  float m[2], l[2];
  row_stats<D>(m, l, qf, next, cm, lk, a.scale);
  const float rl[2] = {1.f / l[0], 1.f / l[1]};

  // 2. rowsum(dP P) from the f32 P, and ctx = round(P) V when asked for;
  //    32 keys at a time keep the score fragments few
  float rs[2] = {0.f, 0.f};
  {
    float cacc[D / 8][4] = {};
    for (int t = 0; t < nt; ++t) {
      const __nv_bfloat16* st = next();
#pragma unroll
      for (int hk = 0; hk < kMK; hk += 32) {
        float p[4][4], dp[4][4];
        probs_and_dp<D>(p, dp, qf, dof, st, hk, cm + t * kMK, a.scale, m, rl);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[nb][e] * p[nb][e];
        if (a.o != nullptr) {
          uint32_t pf[2][4];
          pack_a<32>(pf, p);
          nn_tile<D, 32>(cacc, pf, st + kTile + hk * kLd);
        }
      }
    }
    if (a.o != nullptr)
      store_rows<D>(static_cast<__nv_bfloat16*>(a.o) + qo, a.q_sl, q0 + row0, lq, cacc, 1.f);
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
  if (t4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + row0 + grp + 8 * r;
      if (i < lq) {
        stats[i * kStats] = m[r];
        stats[i * kStats + 1] = l[r];
        stats[i * kStats + 2] = rs[r];
      }
    }

  // 3. dS = round(P (dP - rowsum)), dQ += dS K
  float qacc[D / 8][4] = {};
  for (int t = 0; t < nt; ++t) {
    const __nv_bfloat16* st = next();
#pragma unroll
    for (int hk = 0; hk < kMK; hk += 32) {
      float p[4][4], dp[4][4];
      probs_and_dp<D>(p, dp, qf, dof, st, hk, cm + t * kMK, a.scale, m, rl);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nb][e] = p[nb][e] * (dp[nb][e] - rs[e >> 1]);
      uint32_t df[2][4];
      pack_a<32>(df, dp);
      nn_tile<D, 32>(qacc, df, st + hk * kLd);
    }
  }
  cp_async_wait<0>();
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dq) + qo, a.q_sl, q0 + row0, lq, qacc, a.scale);
}

// Pass B stage: a Q tile, a dO tile, then the tile's stats as f32
template <int D>
__host__ __device__ constexpr int keys_tc_stage_bytes() {
  return 2 * tc_tile(D) * (int)sizeof(__nv_bfloat16) + kMQ * kStats * (int)sizeof(float);
}

// Pass B: one block per (kMK keys, head, batch); dV and dK of the block's
// keys summed over every query tile. Bounded to 168 registers so 3 blocks
// share an SM: at D = 64 that spills a few bytes (ptxas: 64 B stored, 104 B
// loaded) and beat the unbounded 186 registers (2 blocks) by 9-13% (PERF.md).
template <int D>
__global__ void __launch_bounds__(kThreads, 3) sdpa_bwd_keys_tc_kernel(SdpaBwdArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int kTile = tc_tile(D), kLd = tc_ld(D), kStage = keys_tc_stage_bytes<D>();
  char* ring = reinterpret_cast<char*>(smem4);  // kRing stages of kStage bytes
  const int k0 = blockIdx.x * kMK, h = blockIdx.y, b = blockIdx.z;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + qo;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout) + qo;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + ko;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + ko;
  const float* stats = a.stats + ((long long)b * a.heads + h) * a.lq * kStats;
  const int lq = a.lq, lk = a.lk, nqt = (lq + kMQ - 1) / kMQ;
  const int lane = threadIdx.x % 32, row0 = (threadIdx.x / 32) * 16;
  const int grp = lane >> 2, t4 = lane & 3;
  const float scale = a.scale;
  auto stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(ring + s % kRing * kStage);
  };

  __nv_bfloat16* last = stage(kRing - 1);
  tile_async<D>(last, k, a.k_sl, k0, lk);
  tile_async<D>(last + kTile, v, a.k_sl, k0, lk);
  cp_async_commit();
  // the key mask of the warp's two rows (rows past lk are never written)
  bool keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + row0 + grp + 8 * r;
    keep[r] = j < lk && (a.mask == nullptr || a.mask[(long long)b * lk + j] > 0);
  }
  // stage s: query tile s's Q, dO and stats (rows past lq zero-filled)
  auto issue = [&](int s) {
    if (s < nqt) {
      __nv_bfloat16* dst = stage(s);
      const int r0 = s * kMQ;
      tile_async<D>(dst, q, a.q_sl, r0, lq);
      tile_async<D>(dst + kTile, dout, a.q_sl, r0, lq);
      float* st = reinterpret_cast<float*>(dst + 2 * kTile);
      for (int e = threadIdx.x; e < kMQ * kStats; e += kThreads) {
        const bool ok = r0 * kStats + e < lq * kStats;
        cp_async4(st + e, ok ? stats + r0 * kStats + e : stats, ok);
      }
    }
    cp_async_commit();
  };
  ring_start(issue);
  uint32_t kf[D / 16][4], vf[D / 16][4];
  a_frags<D>(kf, last, row0);
  a_frags<D>(vf, last + kTile, row0);
  int s = 0;
  auto next = [&]() { return static_cast<const __nv_bfloat16*>(stage(ring_next(s, issue))); };

  float vacc[D / 8][4] = {}, kacc[D / 8][4] = {};
  for (int t = 0; t < nqt; ++t) {
    const __nv_bfloat16* st = next();
    const float* sts = reinterpret_cast<const float*>(st + 2 * kTile);
#pragma unroll
    for (int hq = 0; hq < kMQ; hq += 32) {
      // S^T and dP^T of the warp's 16 keys against 32 query rows
      float p[4][4], dp[4][4];
      nt_tile<D, 32>(p, kf, st + hq * kLd);
      nt_tile<D, 32>(dp, vf, st + kTile + hq * kLd);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = hq + nb * 8 + 2 * t4 + cc;  // query row within the tile
          const bool valid = t * kMQ + i < lq;
          const float mq = sts[i * kStats], rl = 1.f / sts[i * kStats + 1];
          const float rsq = sts[i * kStats + 2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float x = keep[r] ? p[nb][2 * r + cc] * scale : kNegInf;
            const float pv = valid ? expf(x - mq) * rl : 0.f;
            dp[nb][2 * r + cc] = valid ? pv * (dp[nb][2 * r + cc] - rsq) : 0.f;
            p[nb][2 * r + cc] = pv;
          }
        }
      uint32_t pf[2][4], df[2][4];
      pack_a<32>(pf, p);
      pack_a<32>(df, dp);
      nn_tile<D, 32>(vacc, pf, st + kTile + hq * kLd);  // dV += round(P^T) dO
      nn_tile<D, 32>(kacc, df, st + hq * kLd);          // dK += dS^T Q
    }
  }
  cp_async_wait<0>();
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dv) + ko, a.k_sl, k0 + row0, lk, vacc, 1.f);
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dk) + ko, a.k_sl, k0 + row0, lk, kacc, scale);
}

__host__ inline size_t sdpa_bwd_keys_tc_smem_bytes(int d) {
  return (size_t)kRing * (d == 32 ? keys_tc_stage_bytes<32>() : keys_tc_stage_bytes<64>());
}

// Whether the tensor-core pair takes these arguments (bf16 is the caller's
// test): a head dim of 32 or 64, more than kRowMaxLq query rows, rows and
// pointers 16-byte aligned, the column map within a block's shared memory.
inline bool sdpa_bwd_tc_fits(const SdpaBwdArgs& a) {
  return (a.d == 32 || a.d == 64) && a.lq > kRowMaxLq && a.stats != nullptr &&
         sdpa_tc_fits(a.d, {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl},
                      {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv, a.o}) &&
         sdpa_tc_smem_bytes(a.lk, a.d) <= 232448;
}

template <int D>
cudaError_t launch_sdpa_bwd_tc(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem_a = sdpa_tc_smem_bytes(a.lk, D);
  cudaError_t err = cudaFuncSetAttribute(sdpa_bwd_rows_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  sdpa_bwd_rows_tc_kernel<D><<<dim3((a.lq + kMQ - 1) / kMQ, a.heads, batch), kThreads, smem_a,
                               stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b = sdpa_bwd_keys_tc_smem_bytes(D);
  err = cudaFuncSetAttribute(sdpa_bwd_keys_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  sdpa_bwd_keys_tc_kernel<D><<<dim3((a.lk + kMK - 1) / kMK, a.heads, batch), kThreads, smem_b,
                               stream>>>(a);
  return cudaGetLastError();
}

// Resident blocks per SM of pass A (pass 0) or pass B (pass 1) at head dim d
// and Lk keys, or minus the CUDA error.
inline int sdpa_bwd_tc_blocks_per_sm(int pass, int d, int lk) {
  if (d != 32 && d != 64) return -(int)cudaErrorInvalidValue;
  if (pass == 0) {
    const size_t smem = sdpa_tc_smem_bytes(lk, d);
    return d == 32 ? blocks_per_sm(sdpa_bwd_rows_tc_kernel<32>, kThreads, smem)
                   : blocks_per_sm(sdpa_bwd_rows_tc_kernel<64>, kThreads, smem);
  }
  const size_t smem = sdpa_bwd_keys_tc_smem_bytes(d);
  return d == 32 ? blocks_per_sm(sdpa_bwd_keys_tc_kernel<32>, kThreads, smem)
                 : blocks_per_sm(sdpa_bwd_keys_tc_kernel<64>, kThreads, smem);
}

enum SdpaBwdKernel { kBwdAuto = 0, kBwdTiled = 1, kBwdBlock = 2 };

inline bool sdpa_bwd_row_fits(int lq, int lk, int d) {
  return lq <= kRowMaxLq && sdpa_bwd_row_smem_bytes(lq, lk, d) <= 232448;
}
inline bool sdpa_bwd_block_fits(int lq, int lk) { return sdpa_bwd_smem_bytes(lq, lk) <= 232448; }
// the FMA pair's pass A holds the forward FMA kernel's row set, so it takes
// every Lk that does; so does the tensor-core pair
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

template <typename T>
cudaError_t launch_sdpa_bwd_block(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sdpa_bwd_smem_bytes(a.lq, a.lk);
  cudaError_t err = cudaFuncSetAttribute(sdpa_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sdpa_bwd_kernel<T><<<dim3(a.heads, batch), kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// kernel: kBwdAuto takes the tensor-core pair where it fits (bf16), else the
// row kernel for a few query rows, else the block kernel where its row sets
// fit, else the FMA query-tiled pair; kBwdTiled asks for a query-tiled pair
// (the tensor-core one where it fits) and kBwdBlock for the block kernel, at
// any shape they take, to time them against each other.
template <typename T>
cudaError_t launch_sdpa_bwd(const SdpaBwdArgs& a, int batch, cudaStream_t stream,
                            int kernel = kBwdAuto) {
  if (!sdpa_bwd_fits(a.lq, a.lk, a.d)) return cudaErrorInvalidValue;
  if (kernel == kBwdBlock) {
    if (!sdpa_bwd_block_fits(a.lq, a.lk)) return cudaErrorInvalidValue;
    return launch_sdpa_bwd_block<T>(a, batch, stream);
  }
  if (kernel != kBwdAuto && kernel != kBwdTiled) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (sdpa_bwd_tc_fits(a))
      return a.d == 32 ? launch_sdpa_bwd_tc<32>(a, batch, stream)
                       : launch_sdpa_bwd_tc<64>(a, batch, stream);
  }
  if (kernel == kBwdTiled ||
      (!sdpa_bwd_row_fits(a.lq, a.lk, a.d) && !sdpa_bwd_block_fits(a.lq, a.lk)))
    return launch_sdpa_bwd_tiled<T>(a, batch, stream);
  if (sdpa_bwd_row_fits(a.lq, a.lk, a.d)) {
    const size_t smem = sdpa_bwd_row_smem_bytes(a.lq, a.lk, a.d);
    cudaError_t err = cudaFuncSetAttribute(sdpa_bwd_row_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sdpa_bwd_row_kernel<T><<<dim3(a.heads, batch), kRowThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  return launch_sdpa_bwd_block<T>(a, batch, stream);
}

}  // namespace smtc
