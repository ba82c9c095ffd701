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
//     of the training paths (text L = 128, image 197, ViLT 185 and 402, the
//     fused blocks' column slices). It replaces TPU kernel 4
//     (ops/attention.py::_bwd_kernel_blocked, whose grid walks 128-row query
//     tiles in order and sums dK and dV across them in an f32 output block)
//     and TPU kernel 2 (::_bwd_kernel) at those shapes. Hopper blocks run in
//     no order, so the sum over query tiles moves into a second pass
//     (FlashAttention-2's shape, no atomics). Both passes are one warpgroup
//     (64 rows, wgmma's M; three blocks an SM) whose thread 0 keeps a ring of
//     kTcBwdStages stages in flight by TMA (64-row tiles under the 64- or
//     128-byte swizzle, each stage behind an mbarrier that takes the copy's
//     bytes), a stage's next load issued once the products that read it are
//     done; every product is wgmma.mma_async with bf16 operands and f32
//     accumulators, the score tiles A operands straight from registers (the
//     accumulator layout of two 8-column groups is the A layout of a k16
//     step), nothing score-shaped in shared memory; the outputs leave through
//     a staging tile in whole 16-byte rows.
//       the row stats: each query row's max m and sum l, as the forward
//       kernel formed them (sdpa_core.cuh). ops/attention.py's autograd
//       function keeps the forward's (B, H, Lq, 2) and passes them in
//       (fwd_stats). The fused and per-head blocks recompute q, k and v and
//       have none, and they want ctx = round(P) V for the out-projection's
//       weight gradient: for them (and for any caller without stats) the
//       launch runs the forward kernel first, which writes ctx as its output
//       (the forward's, bit for bit) and the stats into the scratch. So pass
//       A never sweeps for stats, and the stats it reads are the forward's
//       own whichever way they came: a backward given the forward's stats and
//       one that forms them agree bit for bit.
//       pass A (sdpa_bwd_rows_wg_kernel), one block per (64 query rows,
//       head, batch): Q and dO tiles, the (K, V) chunks of 64 keys streaming
//       twice. Sweep 1: S = Q K^T and dP = dO V^T (both operands K-major),
//       P = exp(s - m) * (1 / l) in f32, rowsum(dP P) from the unrounded P.
//       Sweep 2: S and dP again, dS = round(P (dP - rowsum)), dQ += dS K with
//       K read MN-major. It writes dQ * scale and per query row (m, l,
//       rowsum, 0) to `stats` (16 bytes a row, one TMA box row for pass B).
//       That is S and dP twice each, two exponentials per score.
//       pass B (sdpa_bwd_keys_wg_kernel), one block per (64 keys, head,
//       batch): K and V tiles as the A operands; Q, dO and the stats of each
//       64-row query chunk streaming. S^T = K Q^T and dP^T = V dO^T, P^T from
//       the stats, dS^T = round(P^T (dP^T - rowsum)); dV += round(P^T) dO
//       and dK += dS^T Q, dO and Q read MN-major from the same tiles; summed
//       in f32 registers over the query chunks in order, rounded once, so two
//       runs agree bit for bit. Query rows past Lq add exactly zero: their P
//       and dS are set to 0 (TMA reads them as zeros; the JAX kernel pads dO
//       with zeros for the same reason).
//     Pass B forms P and dS with pass A's formulas from pass A's m, l and
//     rowsum; its S^T and dP^T are pass A's products with the operands
//     swapped, which need not round alike; nothing relies on it: each output
//     is held to its plain version on the card.
//     What changes against the JAX kernels: the order of the f32 sums (the
//     tensor cores' k16 steps, the row sums per thread then across the quad,
//     the forward's as its note says) and p = e * (1 / l).
//     What bounds it: the CUDA cores' share, as in the forward. A score takes
//     about 25 instructions in pass A (two accurate exponentials) and 16 in
//     pass B, beside 1.6x the products; clock counts (tools/sdpa_clocks.py,
//     PERF.md): a pass A block at 16x12x197 27,800 cycles, 750 of them
//     waiting for its loads, a pass B block 28,710 and 1,370.
//     D = 128 would hold 64 more f32 accumulators per thread in pass B and is
//     left to the FMA kernels below.
//   * the float32 tensor-core pair, the same two passes for float32 at head
//     dims 32 and 64 with the same arguments (the grid's float32 towers, ViLT
//     exact in float32, the per-head blocks' float32 column slices): every
//     product three tf32 passes (sdpa_core.cuh's split), float32's accuracy
//     kept; its note stands above it, below.
//   * the row pair, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K or V per batch
//     row, far beyond shared memory): a score pass with one warp per key
//     writes the scores and dP to an f32 scratch; a column pass, one block
//     per 64 head-dim columns, forms P and dS from them and writes dK and dV
//     as the outer products dS^T q and round(P)^T dO, and dQ (and ctx) as
//     sums over the keys (design note below). One block per (batch, head)
//     would run 32 blocks on 132 SMs at the fusion head's shape; the column
//     pass runs 384.
//   * the block kernel, for the other head dims (such as 128) up to what its
//     two row sets leave room for: one block per (batch, head) holds the
//     whole Lq x Lk problem, the f32 P and dP/dS row sets in shared memory
//     (2 x 66 KB at Lq = Lk = 128), like the Pallas kernel's grid over batch
//     rows, so dK and dV sum over every query row inside the block. The six
//     products are 64 x 64 output tiles of 4 x 4 f32 FMA micro-tiles.
//   * the FMA query-tiled pair for the other head dims past the block
//     kernel's reach (including 128, whose tensor-core pairs would hold more
//     accumulators than a thread has registers): pass A
//     (sdpa_bwd_rows_kernel) per 32 query rows holds one f32 row set of
//     scores, P and then dS in shared memory, sweeping dP = dO V^T twice;
//     pass B (sdpa_bwd_keys_kernel) per 64 keys recomputes P and dS from the
//     stats with the same products in the same order, so its P and dS are
//     pass A's bit for bit.
//
// What bounds it on the H100. At the training shapes (text 32x12x128x64 in
// bf16; fusion 32x1x1x768 over 197 keys in f32) the least time is set by the
// bytes of q, k, v, dO and the three gradients (about 13 us and 23 us at
// 3.35 TB/s); the row pair moves K twice (once per pass, the second mostly
// from L2) and V once more than that bound counts. The image tower's
// 16x12x197x197x64 in bf16 is 3.0 GFLOP of the five products (3.0 us at
// 989 TFLOP/s) against 10 us for its bytes; ViLT's 32x12x402x402x64 is 40
// GFLOP (41 us) against 41 us. The tensor-core pair does 1.6x the products
// (S and dP twice in pass A, once each in pass B) and three exponentials per
// score (two in pass A, one in pass B), so at 402 its products and the
// softmax arithmetic, not device memory, bound it. The float32 pair's
// products are three tf32 passes at 495 TFLOP/s.

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
  float* stats;  // the f32 scratch (sdpa_bwd_scratch_floats)
  int heads, lq, lk, d;
  // element strides of batch, head and position; the head dim has stride 1.
  // q, dout, dq and o share q's; k, v, dk and dv share k's.
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  float scale;
  // (B, H, Lq, 2) f32, the forward kernel's max and sum of each query row, or
  // nullptr; only the tensor-core pair reads them (a launch that cannot,
  // refuses)
  const float* fwd_stats = nullptr;
};

constexpr int kBwdThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBT = 64;           // output tile rows and columns, staging depth
constexpr int kBTLd = kBT + 4;    // staging row stride (floats)
constexpr int kStats = 3;         // per query row: max, sum, rowsum(dP P)
constexpr int kTcStats = 4;       // the tensor-core pair's: the same and a 0 (16 bytes)

__host__ __device__ inline int sdpa_bwd_rows(int lq) { return (lq + kBT - 1) / kBT * kBT; }

__host__ inline size_t sdpa_bwd_smem_bytes(int lq, int lk) {
  return sizeof(float) * (2 * (size_t)sdpa_bwd_rows(lq) * sdpa_row_stride(lk) +
                          2 * (size_t)kBT * kBTLd);
}

// the row pair's column pass holds its row's (s, dP) pairs, and nothing else
__host__ inline size_t sdpa_bwd_row_smem_bytes(int lq, int lk) {
  return sizeof(float2) * (size_t)lq * lk;
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

// ---- the row pair (at most kRowMaxLq query rows) ---------------------------------
//
// The fusion head's backward: one query of width 768 over 197 keys, per batch
// row. Two launches on the caller's stream, through an f32 scratch that lies
// in the same buffer as `stats`, after it (sdpa_bwd_row_scratch):
//   score pass, one block per (kRowKeys keys, head, batch), one warp per key:
//     s_ij = (q_i . k_j) * scale (-1e30 at masked keys) and dP_ij = dO_i . v_j
//     in f32, K and V rows read once with 16-byte loads, into the scratch as
//     (s, dP) pairs, (B, heads, Lq, Lk);
//   column pass, one block per (kRowCols head-dim columns, head, batch): the
//     block copies its row's pairs to shared memory, one warp per query row
//     forms P (f32) and round(dS) from them, then the block's warps walk the
//     keys for its columns: dK and dV written once each, coalesced along the
//     columns, dQ and ctx summed per lane over its keys and then across the
//     warp's lanes. Every block forms P and dS with the same warp and lane
//     partition, so the blocks of one row agree on them bit for bit.
// The rounding points are the file header's; dQ's and ctx's f32 sums run in a
// fixed order (each lane's keys in order, then a butterfly across lanes).

constexpr int kRowKeys = kRowThreads / 32;  // score pass: keys per block, a warp each
constexpr int kRowColLanes = 2;             // column pass: lanes per key row, 4 columns each
constexpr int kRowKeyGroups = 32 / kRowColLanes;  // keys a warp holds at once
constexpr int kRowCols = kRowThreads / 32 * kRowColLanes * 4;  // columns per block: 64

// Floats of the backward's f32 scratch that the query-tiled pairs' stats take
// (kTcStats a query row; the FMA pair uses kStats of them), then the
// forward's max and sum of each query row, which the tensor-core pair forms
// there when its caller gives none; rounded up to 16 bytes. The row pair's
// (s, dP) pairs follow.
__host__ __device__ inline size_t sdpa_bwd_stats_floats(int batch, int heads, int lq) {
  return ((size_t)batch * heads * lq * (kTcStats + 2) + 3) / 4 * 4;
}

// Floats of the whole scratch the caller allocates (exported to
// ops/attention.py's bwd_scratch as smtc_sdpa_bwd_scratch_floats)
__host__ inline size_t sdpa_bwd_scratch_floats(int batch, int heads, int lq, int lk) {
  return sdpa_bwd_stats_floats(batch, heads, lq) +
         (lq <= kRowMaxLq ? 2 * (size_t)batch * heads * lq * lk : 0);
}

__host__ inline float2* sdpa_bwd_row_scratch(const SdpaBwdArgs& a, int batch) {
  return reinterpret_cast<float2*>(a.stats + sdpa_bwd_stats_floats(batch, a.heads, a.lq));
}

template <int Bytes> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };

// x = columns c .. c + N - 1 of row p in f32, zero past d. VEC: d % N == 0 and
// p + c aligned to N elements, so a column group is all in or all out.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_cols(float (&x)[N], const T* p, int c, int d) {
  if (VEC && c < d) {
    using V = typename RawVec<N * sizeof(T)>::type;
    const V raw = *reinterpret_cast<const V*>(p + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = c + i < d ? to_f32(p[c + i]) : 0.f;
  }
}

template <typename T, int N, bool VEC>
__device__ __forceinline__ void store_cols(T* p, int c, int d, const float (&x)[N]) {
  if (VEC && c < d) {
    using V = typename RawVec<N * sizeof(T)>::type;
    V raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(x[i]);
    *reinterpret_cast<V*>(p + c) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c + i < d) p[c + i] = from_f32<T>(x[i]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowThreads) sdpa_bwd_row_scores_kernel(SdpaBwdArgs a,
                                                                          float2* sc) {
  constexpr int N = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * kRowKeys + warp, h = blockIdx.y, b = blockIdx.z;
  if (j >= a.lk) return;  // the whole warp
  const int lq = a.lq, d = a.d;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh + j * a.k_sl;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* dout = static_cast<const T*>(a.dout) + qo;
  const T* kj = static_cast<const T*>(a.k) + ko;
  const T* vj = static_cast<const T*>(a.v) + ko;
  float s[kRowMaxLq] = {}, dp[kRowMaxLq] = {};
  for (int c = lane * N; c < d; c += 32 * N) {
    float kx[N], vx[N];
    load_cols<T, N, VEC>(kx, kj, c, d);
    load_cols<T, N, VEC>(vx, vj, c, d);
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i)
      if (i < lq) {
        float qx[N], ox[N];
        load_cols<T, N, VEC>(qx, q + i * a.q_sl, c, d);
        load_cols<T, N, VEC>(ox, dout + i * a.q_sl, c, d);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s[i] = fmaf(qx[e], kx[e], s[i]);
          dp[i] = fmaf(ox[e], vx[e], dp[i]);
        }
      }
  }
#pragma unroll
  for (int i = 0; i < kRowMaxLq; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      dp[i] += __shfl_xor_sync(0xffffffffu, dp[i], off);
    }
  if (lane == 0) {
    const bool keep = a.mask == nullptr || a.mask[(long long)b * a.lk + j] > 0;
    float2* out = sc + ((long long)b * a.heads + h) * lq * a.lk + j;
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i)
      if (i < lq) out[i * a.lk] = make_float2(keep ? s[i] * a.scale : kNegInf, dp[i]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowThreads) sdpa_bwd_row_cols_kernel(SdpaBwdArgs a,
                                                                        const float2* sc) {
  extern __shared__ float4 smem4[];
  float2* R = reinterpret_cast<float2*>(smem4);  // [lq][lk] (s, dP), then (P, round(dS))
  const int lq = a.lq, lk = a.lk, d = a.d;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float2* src = sc + ((long long)b * a.heads + h) * lq * lk;
  for (int e = tid; e < lq * lk; e += kRowThreads) R[e] = src[e];
  __syncthreads();

  // 1. softmax and dS, one warp per query row, every block alike
  if (warp < lq) {
    float2* row = R + warp * lk;
    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) m = fmaxf(m, row[j].x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(row[j].x - m);
      row[j].x = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    float r = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float p = row[j].x / l;
      row[j].x = p;
      r += row[j].y * p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
    for (int j = lane; j < lk; j += 32)
      row[j].y = to_f32(from_f32<T>(row[j].x * (row[j].y - r)));
  }
  __syncthreads();

  // 2. the block's columns: a lane holds 4 columns of every kRowKeyGroups-th
  //    key; dK = (dS^T q) * scale and dV = round(P)^T dO per key, dQ and ctx
  //    summed over the lane's keys
  const int c = blockIdx.x * kRowCols + warp * kRowColLanes * 4 + (lane % kRowColLanes) * 4;
  const int kg = lane / kRowColLanes;
  const long long qo = b * a.q_sb + h * a.q_sh, ko = b * a.k_sb + h * a.k_sh;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* dout = static_cast<const T*>(a.dout) + qo;
  const T* k = static_cast<const T*>(a.k) + ko;
  const T* v = static_cast<const T*>(a.v) + ko;
  T* dk = static_cast<T*>(a.dk) + ko;
  T* dv = static_cast<T*>(a.dv) + ko;
  const bool want_o = a.o != nullptr;
  float qc[kRowMaxLq][4], oc[kRowMaxLq][4];
  float aq[kRowMaxLq][4] = {}, ao[kRowMaxLq][4] = {};
#pragma unroll
  for (int i = 0; i < kRowMaxLq; ++i) {
    load_cols<T, 4, VEC>(qc[i], q + (i < lq ? i : 0) * a.q_sl, c, i < lq ? d : 0);
    load_cols<T, 4, VEC>(oc[i], dout + (i < lq ? i : 0) * a.q_sl, c, i < lq ? d : 0);
  }
  for (int j = kg; j < lk; j += kRowKeyGroups) {
    float kx[4], vx[4] = {}, sk[4] = {}, sv[4] = {};
    load_cols<T, 4, VEC>(kx, k + j * a.k_sl, c, d);
    if (want_o) load_cols<T, 4, VEC>(vx, v + j * a.k_sl, c, d);
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i)
      if (i < lq) {
        const float2 pd = R[i * lk + j];
        const float pr = to_f32(from_f32<T>(pd.x));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[i][e] = fmaf(pd.y, kx[e], aq[i][e]);
          ao[i][e] = fmaf(pr, vx[e], ao[i][e]);
          sk[e] = fmaf(pd.y, qc[i][e], sk[e]);
          sv[e] = fmaf(pr, oc[i][e], sv[e]);
        }
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) sk[e] *= a.scale;
    store_cols<T, 4, VEC>(dk + j * a.k_sl, c, d, sk);
    store_cols<T, 4, VEC>(dv + j * a.k_sl, c, d, sv);
  }

  // 3. dQ and ctx: the warp's key groups summed by a fixed butterfly
#pragma unroll
  for (int i = 0; i < kRowMaxLq; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int off = kRowColLanes; off < 32; off <<= 1) {
        aq[i][e] += __shfl_xor_sync(0xffffffffu, aq[i][e], off);
        ao[i][e] += __shfl_xor_sync(0xffffffffu, ao[i][e], off);
      }
  if (kg == 0) {
    T* dq = static_cast<T*>(a.dq) + qo;
    T* o = want_o ? static_cast<T*>(a.o) + qo : nullptr;
#pragma unroll
    for (int i = 0; i < kRowMaxLq; ++i)
      if (i < lq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[i][e] *= a.scale;
        store_cols<T, 4, VEC>(dq + i * a.q_sl, c, d, aq[i]);
        if (want_o) store_cols<T, 4, VEC>(o + i * a.q_sl, c, d, ao[i]);
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

// ---- the tensor-core pair (bf16): wgmma fed by TMA ---------------------------

struct SdpaBwdMaps {
  CUtensorMap q, k, v, dout;  // boxes of 64 rows of one head
  CUtensorMap st;             // pass A's (B * H, Lq, 4) f32 stats, boxes of 64 rows
};

constexpr int kTcBwdStages = 3;  // ring stages of both passes
// a pass's block: one warpgroup, whose thread 0 issues the loads (a producer
// warp beside it measured 1.2x slower: three blocks of five warps put four in
// a register partition, which caps a thread at 128 registers, so only two fit)
constexpr int kTcThreads = 128;

// Pass A's shared memory from a 1024-byte aligned base: Q, dO (64 rows), the
// ring's (K, V) chunks of 64 keys, the barriers, then the column map.
template <int D>
struct RowsLayout {
  static constexpr int kT = tc_tile_bytes<D>(64);
  static constexpr int q = 0, dout = kT, ring = 2 * kT, stage = 2 * kT;
  static constexpr int bars = ring + kTcBwdStages * stage, cols = bars + (1 + kTcBwdStages) * 8;
};
template <int D>
__host__ inline size_t rows_smem_bytes(int lk) {
  return 1024 + RowsLayout<D>::cols + sizeof(float) * (size_t)((lk + 63) / 64 * 64);
}

// Pass B's: K, V (64 keys), the ring's (Q, dO, stats) chunks of 64 query
// rows, the barriers.
template <int D>
struct KeysLayout {
  static constexpr int kT = tc_tile_bytes<D>(64);
  static constexpr int k = 0, v = kT, ring = 2 * kT, stage = 2 * kT + 64 * kTcStats * 4;
  static constexpr int bars = ring + kTcBwdStages * stage, end = bars + (1 + kTcBwdStages) * 8;
};
template <int D>
__host__ inline size_t keys_smem_bytes() {
  return 1024 + KeysLayout<D>::end;
}

// the 64 x 64 f32 accumulators of a product over one chunk, rounded to bf16
// as wgmma's A fragments (window_pack's layout)
__device__ __forceinline__ void pack_tile(uint32_t (&f)[16], const float (&x)[32]) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    f[2 * g] = pack_bf16(x[4 * g], x[4 * g + 1]);
    f[2 * g + 1] = pack_bf16(x[4 * g + 2], x[4 * g + 3]);
  }
}

// c = A B^T over the head dim for a 64-row tile a and a 64-row tile b, both
// K-major (issued, not waited on)
template <int D>
__device__ __forceinline__ void nt_chunk(float (&c)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<64>(c, kmajor<D>(a, 64, 0, kk), kmajor<D>(b, 64, 0, kk), kk);
}

// acc += F B over a chunk's 64 rows: F the packed A fragments, B the chunk's
// 64-row tile read MN-major (issued, not waited on)
template <int D>
__device__ __forceinline__ void nn_chunk(float (&acc)[D / 2], const uint32_t (&f)[16], uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<D>(acc, f + 4 * j, mnmajor<D>(b, 64, 16 * j));
}

// Pass A: one block per (64 query rows, head, batch). Thread 0 loads Q and
// dO, then the (K, V) chunks twice over (a sweep each) through the ring, each
// stage's next load as soon as the warpgroup is done with it; the warpgroup
// reads the forward's max and sum of its rows.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 3)
    sdpa_bwd_rows_wg_kernel(const __grid_constant__ SdpaBwdMaps maps, const SdpaBwdArgs a,
                            const float* fs, int head_inner) {
  using L = RowsLayout<D>;
  extern __shared__ __align__(1024) unsigned char tsmem[];
  const uint32_t raw = smem_addr(tsmem), pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t base = raw + pad, bars = base + L::bars;
  float* cm = reinterpret_cast<float*>(tsmem + pad + L::cols);
  const uint32_t full_qd = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, lq = a.lq, lk = a.lk;
  const int nc = (lk + 63) / 64;
  const int* mask = a.mask ? a.mask + (long long)b * lk : nullptr;

  for (int j = threadIdx.x; j < nc * 64; j += kTcThreads) cm[j] = col_map(mask, j, lk);
  // step i of the ring: chunk i % nc's K and V into stage i % kTcBwdStages
  auto issue = [&](int i) {
    if (threadIdx.x != 0 || i >= 2 * nc) return;
    const int s = i % kTcBwdStages;
    const uint32_t st = base + L::ring + s * L::stage;
    mbar_expect_tx(full(s), 2 * L::kT);
    tma_rows<D>(st, &maps.k, full(s), 64, i % nc * 64, h, b, head_inner);
    tma_rows<D>(st + L::kT, &maps.v, full(s), 64, i % nc * 64, h, b, head_inner);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kTcBwdStages; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    mbar_expect_tx(full_qd, 2 * L::kT);
    tma_rows<D>(base + L::q, &maps.q, full_qd, 64, qt * 64, h, b, head_inner);
    tma_rows<D>(base + L::dout, &maps.dout, full_qd, 64, qt * 64, h, b, head_inner);
    for (int i = 0; i < kTcBwdStages; ++i) issue(i);
  }
  __syncthreads();

  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32) + (threadIdx.x & 31) / 4;
  const long long row0 = ((long long)b * a.heads + h) * lq + qt * 64;
  // the forward's max and 1 / sum of the thread's two rows (0 past Lq: P = 0)
  float m[2], l[2], rl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = qt * 64 + r + 8 * e < lq;
    const float2 x = in ? *reinterpret_cast<const float2*>(fs + (row0 + r + 8 * e) * 2)
                        : make_float2(0.f, 0.f);
    m[e] = x.x;
    l[e] = x.y;
    rl[e] = in ? 1.f / x.y : 0.f;
  }
  const uint32_t qs = base + L::q, ds = base + L::dout;
  float sc[32], dp[32], dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float rs[2] = {0.f, 0.f};
  mbar_wait(full_qd, 0);
  for (int i = 0; i < 2 * nc; ++i) {
    const int s = i % kTcBwdStages, c = i % nc;
    const uint32_t kst = base + L::ring + s * L::stage;
    mbar_wait(full(s), (i / kTcBwdStages) & 1);
    // S and dP of the rows against the chunk's 64 keys
    wgmma_fence();
    nt_chunk<D>(sc, qs, kst);
    nt_chunk<D>(dp, ds, kst + L::kT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    if (i < nc) issue(i + kTcBwdStages);  // the stage is free: sweep 1 reads it no more
    // P in f32 from the forward's max and sum
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 cc = *reinterpret_cast<const float2*>(cm + c * 64 + 8 * g + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(sc[4 * g + e], a.scale, e & 1 ? cc.y : cc.x);
        sc[4 * g + e] = expf(x - m[e >> 1]) * rl[e >> 1];
      }
    }
    if (i < nc) {
      // sweep 1: rowsum(dP P) from the unrounded P, in key order
#pragma unroll
      for (int j = 0; j < 32; ++j) rs[(j >> 1) & 1] += dp[j] * sc[j];
      if (i + 1 == nc) {
        rs[0] = quad_sum(rs[0]);
        rs[1] = quad_sum(rs[1]);
        if (t4 == 0)  // pass B's stats: max, sum, rowsum
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (qt * 64 + r + 8 * e < lq)
              *reinterpret_cast<float4*>(a.stats + (row0 + r + 8 * e) * kTcStats) =
                  make_float4(m[e], l[e], rs[e], 0.f);
      }
    } else {
      // sweep 2: dS = round(P (dP - rowsum)), dQ += dS K
      uint32_t df[16];
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] = sc[j] * (dp[j] - rs[(j >> 1) & 1]);
      pack_tile(df, dp);
      wgmma_fence();
      nn_chunk<D>(dq, df, kst);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      fence_regs(df);
      issue(i + kTcBwdStages);
    }
  }
  // dQ * scale, staged in the ring's first stage (every load into it has landed
  // and every product that reads it is done)
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(tsmem + pad + L::ring);
  stage_tile<D>(staged, dq, a.scale);
  __syncthreads();
  copy_tile_out<D>(static_cast<__nv_bfloat16*>(a.dq) + b * a.q_sb + h * a.q_sh, a.q_sl, qt * 64,
                   lq, staged);
}

// Pass B: one block per (64 keys, head, batch); dV and dK of the block's keys
// summed over every query chunk in f32 registers, in chunk order. Thread 0
// loads K and V, then each query chunk's Q, dO and stats through the ring.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 3)
    sdpa_bwd_keys_wg_kernel(const __grid_constant__ SdpaBwdMaps maps, const SdpaBwdArgs a,
                            int head_inner) {
  using L = KeysLayout<D>;
  extern __shared__ __align__(1024) unsigned char tsmem[];
  const uint32_t raw = smem_addr(tsmem), pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t base = raw + pad, bars = base + L::bars;
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, lq = a.lq, lk = a.lk;
  const int nqc = (lq + 63) / 64;
  // step i of the ring: query chunk i's Q, dO and stats into stage i % kTcBwdStages
  auto issue = [&](int i) {
    if (threadIdx.x != 0 || i >= nqc) return;
    const int s = i % kTcBwdStages;
    const uint32_t st = base + L::ring + s * L::stage;
    mbar_expect_tx(full(s), L::stage);
    tma_rows<D>(st, &maps.q, full(s), 64, i * 64, h, b, head_inner);
    tma_rows<D>(st + L::kT, &maps.dout, full(s), 64, i * 64, h, b, head_inner);
    tma_load_3d(st + 2 * L::kT, &maps.st, full(s), 0, i * 64, b * a.heads + h);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kTcBwdStages; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    mbar_expect_tx(full_kv, 2 * L::kT);
    tma_rows<D>(base + L::k, &maps.k, full_kv, 64, kt * 64, h, b, head_inner);
    tma_rows<D>(base + L::v, &maps.v, full_kv, 64, kt * 64, h, b, head_inner);
    for (int i = 0; i < kTcBwdStages; ++i) issue(i);
  }
  __syncthreads();

  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32) + (threadIdx.x & 31) / 4;
  // the column map of the thread's two key rows (rows past Lk are never written)
  float cmap[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    cmap[e] = col_map(a.mask ? a.mask + (long long)b * lk : nullptr, kt * 64 + r + 8 * e, lk);
  const uint32_t ks = base + L::k, vs = base + L::v;
  float sc[32], dp[32], dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(full_kv, 0);
  for (int i = 0; i < nqc; ++i) {
    const int s = i % kTcBwdStages;
    const uint32_t qst = base + L::ring + s * L::stage, dst = qst + L::kT;
    const float4* st = reinterpret_cast<const float4*>(tsmem + pad + L::ring + s * L::stage +
                                                       2 * L::kT);
    mbar_wait(full(s), (i / kTcBwdStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T of the block's keys against the chunk
    wgmma_fence();
    nt_chunk<D>(sc, ks, qst);
    nt_chunk<D>(dp, vs, dst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    // P^T and dS^T = P^T (dP^T - rowsum) from pass A's stats; query rows past
    // Lq give 0
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int qi = 8 * g + 2 * t4 + cc;
        const float4 x = st[qi];
        const bool valid = i * 64 + qi < lq;
        const float rlq = valid ? 1.f / x.y : 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * g + 2 * e + cc;
          const float pv = valid ? expf(fmaf(sc[j], a.scale, cmap[e]) - x.x) * rlq : 0.f;
          dp[j] = valid ? pv * (dp[j] - x.z) : 0.f;
          sc[j] = pv;
        }
      }
    uint32_t pf[16], df[16];
    pack_tile(pf, sc);
    pack_tile(df, dp);
    wgmma_fence();
    nn_chunk<D>(dv, pf, dst);  // dV += round(P^T) dO
    nn_chunk<D>(dk, df, qst);  // dK += round(dS^T) Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    fence_regs(pf);
    fence_regs(df);
    issue(i + kTcBwdStages);
  }
  // dV and dK * scale, staged in the ring's first two stages (every load has
  // landed and every product that reads them is done)
  const long long ko = b * a.k_sb + h * a.k_sh;
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(tsmem + pad + L::ring);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(tsmem + pad + L::ring + L::stage);
  stage_tile<D>(sv, dv, 1.f);
  stage_tile<D>(sk, dk, a.scale);
  __syncthreads();
  copy_tile_out<D>(static_cast<__nv_bfloat16*>(a.dv) + ko, a.k_sl, kt * 64, lk, sv);
  copy_tile_out<D>(static_cast<__nv_bfloat16*>(a.dk) + ko, a.k_sl, kt * 64, lk, sk);
}

// Whether a tensor-core pair takes these arguments (bf16, elem 2, or
// float32, elem 4, is the caller's test): a head dim of 32 or 64, more than
// kRowMaxLq query rows, rows and pointers 16-byte aligned.
inline bool sdpa_bwd_tc_fits(const SdpaBwdArgs& a, int elem) {
  return (a.d == 32 || a.d == 64) && a.lq > kRowMaxLq && a.stats != nullptr &&
         sdpa_tc_fits(a.d, {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl},
                      {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv, a.o}, elem);
}

// The f32 map of pass A's (B * H, Lq, kTcStats) stats: boxes of 64 rows.
inline bool encode_stats_map(EncodeTiledFn enc, CUtensorMap* map, const float* ptr, int bh, int lq) {
  const cuuint64_t dims[3] = {(cuuint64_t)kTcStats, (cuuint64_t)lq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {kTcStats * sizeof(float), (cuuint64_t)lq * kTcStats * sizeof(float)};
  const cuuint32_t box[3] = {kTcStats, 64, 1}, step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The forward's arguments for the same q, k and v (o: ctx, or nullptr), its
// row stats into the scratch after the pairs' own
inline SdpaArgs sdpa_fwd_args(const SdpaBwdArgs& a, int batch) {
  SdpaArgs f;
  f.q = a.q;
  f.k = a.k;
  f.v = a.v;
  f.mask = a.mask;
  f.o = a.o;
  f.heads = a.heads;
  f.lq = a.lq;
  f.lk = a.lk;
  f.d = a.d;
  f.q_sb = f.o_sb = a.q_sb;
  f.q_sh = f.o_sh = a.q_sh;
  f.q_sl = f.o_sl = a.q_sl;
  f.k_sb = f.v_sb = a.k_sb;
  f.k_sh = f.v_sh = a.k_sh;
  f.k_sl = f.v_sl = a.k_sl;
  f.scale = a.scale;
  f.stats = a.stats + (size_t)batch * a.heads * a.lq * kTcStats;
  return f;
}

// The pair's launches: the forward kernel first where the caller gives no
// row stats or asks for ctx (it writes ctx as the forward's output and the
// stats into the scratch after pass A's), then pass A, then pass B.
template <int D>
cudaError_t launch_sdpa_bwd_tc(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int hi = a.q_sh < a.q_sl;
  if ((a.k_sh < a.k_sl) != hi) return cudaErrorInvalidValue;
  const float* fs = a.fwd_stats;
  cudaError_t err;
  if (fs == nullptr || a.o != nullptr) {
    const SdpaArgs f = sdpa_fwd_args(a, batch);
    err = launch_sdpa_tc_d<D>(f, batch, stream);
    if (err != cudaSuccess) return err;
    fs = f.stats;
  }
  SdpaBwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode_sdpa_map(enc, &maps.q, a.q, batch, a.heads, a.lq, D, a.q_sb, a.q_sh, a.q_sl, 64) ||
      !encode_sdpa_map(enc, &maps.dout, a.dout, batch, a.heads, a.lq, D, a.q_sb, a.q_sh, a.q_sl, 64) ||
      !encode_sdpa_map(enc, &maps.k, a.k, batch, a.heads, a.lk, D, a.k_sb, a.k_sh, a.k_sl, 64) ||
      !encode_sdpa_map(enc, &maps.v, a.v, batch, a.heads, a.lk, D, a.k_sb, a.k_sh, a.k_sl, 64) ||
      !encode_stats_map(enc, &maps.st, a.stats, batch * a.heads, a.lq))
    return cudaErrorInvalidValue;
  const size_t smem_a = rows_smem_bytes<D>(a.lk);
  err = smem_opt_in(sdpa_bwd_rows_wg_kernel<D>, smem_a);
  if (err != cudaSuccess) return err;
  sdpa_bwd_rows_wg_kernel<D><<<dim3((a.lq + 63) / 64, a.heads, batch), kTcThreads, smem_a,
                               stream>>>(maps, a, fs, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b = keys_smem_bytes<D>();
  err = smem_opt_in(sdpa_bwd_keys_wg_kernel<D>, smem_b);
  if (err != cudaSuccess) return err;
  sdpa_bwd_keys_wg_kernel<D><<<dim3((a.lk + 63) / 64, a.heads, batch), kTcThreads, smem_b,
                               stream>>>(maps, a, hi);
  return cudaGetLastError();
}

// ---- the tensor-core pair (float32): three tf32 passes a product, wgmma fed by TMA ----
//
// The bf16 pair's two passes with float32 operands, each product split as
// the float32 forward's are (sdpa_core.cuh: x = big + small, a b ~ a_s b_b +
// a_b b_s + a_b b_b), float32's accuracy kept. A staged operand that a
// product contracts along its rows is also staged transposed (.tf32 wgmma
// reads shared memory K-major only): K for dQ = dS K in pass A, Q and dO for
// dK = dS^T Q and dV = P^T dO in pass B, each transposed from its split pair
// once S and dP have read it, in the order of the registers' A fragments
// (kcol_of). One block an SM (each pass holds 193-225 KB at D = 64), of two
// warpgroups that split every chunk between them (pass A its keys, pass B its
// query rows: 32 each, wgmma's N = 32), their two sums added in a fixed order
// at the end; the 256 threads split each operand once as it arrives, the
// products issued and waited on in turn; TMA refills a stage as soon as the
// products that read it are done, so the next chunk's loads overlap this
// one's work.
//   pass A (sdpa_bwd_rows_f32_wg_kernel), one block per (64 query rows, head,
//   batch): the Q and dO pairs, then the (K, V) chunks twice through a ring of
//   two: sweep 1 S and dP for rowsum(dP P) (the warpgroups' halves added in
//   order); sweep 2 S and dP again, dS and dQ += dS K (K transposed). It
//   writes dQ * scale and (m, l, rowsum, 0) a row.
//   pass B (sdpa_bwd_keys_f32_wg_kernel), one block per (64 keys, head,
//   batch): the K and V pairs, then each query chunk's Q, dO and stats (one
//   stage): S^T = K Q^T, dP^T = V dO^T, P^T and dS^T from the stats, dV +=
//   P^T dO and dK += dS^T Q in f32 registers over the chunks in order, so two
//   runs agree bit for bit.
// What bounds it: at 16x12x128x128x64 the nine products (S and dP twice in
// pass A, dQ; S^T, dP^T, dV, dK in pass B: 9 x 0.40 GFLOP, x 3 passes, 22 us
// at 495 TF32 TFLOP/s) against 44 MB of q, k, v, dO and the gradients (13 us),
// and beside them the CUDA cores' splits and transposes, which a block does
// not overlap with its products (PERF.md: the tensor cores busy about a
// quarter of the time at 197).

// A pass's block: two warpgroups over one stream of tiles, each taking half
// of every chunk (pass A: 32 of its keys; pass B: 32 of its query rows), the
// two halves' sums added in a fixed order at the end.
constexpr int kF32BwdWgs = 2;
constexpr int kF32BwdThreads = 128 * kF32BwdWgs;

template <int D>
struct RowsF32Layout {  // pass A: Q, dO; the ring's (K, V) pairs; K transposed
  static constexpr int T = F32Tile<D>::kBytes;
  static constexpr int q = 0, dout = 2 * T, ring = 4 * T, stage = 4 * T, kt = 12 * T;
  static constexpr int bars = 14 * T, ex = bars + 64, end = ex + 2 * 64 * 4;
};
template <int D>
__host__ inline size_t rows_f32_smem_bytes() {
  return 1024 + RowsF32Layout<D>::end;
}

template <int D>
struct KeysF32Layout {  // pass B: K, V; the stage's Q, dO and stats; Q, dO transposed
  static constexpr int T = F32Tile<D>::kBytes;
  static constexpr int k = 0, v = 2 * T, q = 4 * T, dout = 6 * T, st = 8 * T;
  static constexpr int qt = 8 * T + 1024, dot = 10 * T + 1024, bars = 12 * T + 1024;
  static constexpr int end = bars + 2 * 8;
};
template <int D>
__host__ inline size_t keys_f32_smem_bytes() {
  return 1024 + KeysF32Layout<D>::end;
}

// acc += X B over 8 n8 positions (X in registers, split here; B the
// transposed pair bt): summed apart, issued and waited on, then added in f32
template <int D>
__device__ __forceinline__ void nn_chunk_f32(float (&acc)[D / 2], const float (&x)[32], uint32_t bt,
                                             int n8) {
  uint32_t xb[32], sm[32];
  split_pieces(x, xb, sm, n8);
  float c[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) c[i] = 0.f;
  wgmma_fence();
  nn_pieces_f32<D>(c, xb, sm, bt, n8);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(c);
  fence_regs(xb);
  fence_regs(sm);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += c[i];
}

// The two warpgroups' 64 x D f32 sums added, warpgroup 0's first, through
// `ex` (64 D floats; after a barrier that ends every read of it): warpgroup
// 1 stages its own, warpgroup 0 adds and returns true.
template <int D>
__device__ __forceinline__ bool add_halves(float (&acc)[D / 2], float* ex) {
  const int tid = threadIdx.x & 127;
  if (threadIdx.x >= 128)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) ex[i * 128 + tid] = acc[i];
  __syncthreads();
  if (threadIdx.x >= 128) return false;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += ex[i * 128 + tid];
  return true;
}

// rows r + 8 e (e = 0, 1) of a 64 x D f32 accumulator, below n, to out (row
// stride sl) times alpha: a float2 a thread per 8-column group
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, long long sl, int row0, int n,
                                               const float (&acc)[D / 2], float alpha) {
  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32 % 4) + (threadIdx.x & 31) / 4;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = row0 + r + 8 * e;
    if (i < n)
#pragma unroll
      for (int g = 0; g < D / 8; ++g)
        *reinterpret_cast<float2*>(out + i * sl + 8 * g + 2 * t4) =
            make_float2(acc[4 * g + 2 * e] * alpha, acc[4 * g + 2 * e + 1] * alpha);
  }
}

// Pass A: one block per (64 query rows, head, batch); warpgroup w takes keys
// 32 w .. 32 w + 31 of every chunk.
template <int D>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
    sdpa_bwd_rows_f32_wg_kernel(const __grid_constant__ SdpaBwdMaps maps, const SdpaBwdArgs a,
                                const float* fs, int head_inner) {
  using L = RowsF32Layout<D>;
  constexpr int T = L::T, NT = kF32BwdThreads;
  extern __shared__ __align__(1024) unsigned char tsmem[];
  const uint32_t raw = smem_addr(tsmem), pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* sm = tsmem + pad;
  const uint32_t base = raw + pad, bars = base + L::bars;
  auto full = [&](int i) { return bars + 8 * (1 + (i & 1)); };
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, lq = a.lq, lk = a.lk;
  const int wg = threadIdx.x / 128, nc = (lk + 63) / 64;
  const int* mask = a.mask ? a.mask + (long long)b * lk : nullptr;
  // step i of the ring: chunk i % nc's K and V into stage i % 2
  auto issue = [&](int i) {
    if (threadIdx.x != 0 || i >= 2 * nc) return;
    const uint32_t st = base + L::ring + (i & 1) * L::stage;
    mbar_expect_tx(full(i), 2 * T);
    tma_rows_f32<D>(st, &maps.k, full(i), i % nc * 64, h, b, head_inner);
    tma_rows_f32<D>(st + 2 * T, &maps.v, full(i), i % nc * 64, h, b, head_inner);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, 2 * T);
    tma_rows_f32<D>(base + L::q, &maps.q, bars, qt * 64, h, b, head_inner);
    tma_rows_f32<D>(base + L::dout, &maps.dout, bars, qt * 64, h, b, head_inner);
    issue(0);
    issue(1);
  }
  __syncthreads();

  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32 % 4) + (threadIdx.x & 31) / 4;
  const long long row0 = ((long long)b * a.heads + h) * lq + qt * 64;
  // the forward's max and 1 / sum of the thread's two rows (0 past Lq: P = 0)
  float m[2], l[2], rl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = qt * 64 + r + 8 * e < lq;
    const float2 x = in ? *reinterpret_cast<const float2*>(fs + (row0 + r + 8 * e) * 2)
                        : make_float2(0.f, 0.f);
    m[e] = x.x;
    l[e] = x.y;
    rl[e] = in ? 1.f / x.y : 0.f;
  }
  float sc[32], dp[32], dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float rs[2] = {0.f, 0.f};
  mbar_wait(bars, 0);
  split_tile<D, NT>(sm + L::q, 64);
  split_tile<D, NT>(sm + L::dout, 64);
  for (int i = 0; i < 2 * nc; ++i) {
    const int c = i % nc, off = L::ring + (i & 1) * L::stage;
    mbar_wait(full(i), (i >> 1) & 1);
    split_tile<D, NT>(sm + off, 64);
    split_tile<D, NT>(sm + off + 2 * T, 64);
    __syncthreads();
    // S and dP of the rows against the warpgroup's 32 keys of the chunk
    wgmma_fence();
    nt_pieces_f32<D>(sc, base + L::q, base + off + 32 * 128 * wg, 4);
    nt_pieces_f32<D>(dp, base + L::dout, base + off + 2 * T + 32 * 128 * wg, 4);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    if (i >= nc) transpose_tile<D, false, NT>(sm + L::kt, sm + off, 64);  // K for dQ
    __syncthreads();  // the stage is read
    issue(i + 2);
    // P in f32 from the forward's max and sum
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = c * 64 + 32 * wg + 8 * g + 2 * t4;
      const float cc[2] = {col_map(mask, j, lk), col_map(mask, j + 1, lk)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(sc[4 * g + e], a.scale, cc[e & 1]);
        sc[4 * g + e] = expf(x - m[e >> 1]) * rl[e >> 1];
      }
    }
    if (i < nc) {
      // sweep 1: rowsum(dP P) from P, in key order
#pragma unroll
      for (int j = 0; j < 16; ++j) rs[(j >> 1) & 1] += dp[j] * sc[j];
      if (i + 1 == nc) {
        rs[0] = quad_sum(rs[0]);
        rs[1] = quad_sum(rs[1]);
        // the warpgroups' halves of each row, added in order
        float* ex = reinterpret_cast<float*>(sm + L::ex);
        if (t4 == 0)
#pragma unroll
          for (int e = 0; e < 2; ++e) ex[64 * wg + r + 8 * e] = rs[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < 2; ++e) rs[e] = ex[r + 8 * e] + ex[64 + r + 8 * e];
        if (t4 == 0 && wg == 0)  // pass B's stats: max, sum, rowsum
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (qt * 64 + r + 8 * e < lq)
              *reinterpret_cast<float4*>(a.stats + (row0 + r + 8 * e) * kTcStats) =
                  make_float4(m[e], l[e], rs[e], 0.f);
      }
    } else {
      // sweep 2: dS = P (dP - rowsum), dQ += dS K over the warpgroup's keys
#pragma unroll
      for (int j = 0; j < 16; ++j) dp[j] = sc[j] * (dp[j] - rs[(j >> 1) & 1]);
      nn_chunk_f32<D>(dq, dp, base + L::kt + wg * D * 128, 4);
    }
  }
  __syncthreads();  // every read of the ring is done
  if (add_halves<D>(dq, reinterpret_cast<float*>(sm + L::ring)))
    store_rows_f32<D>(static_cast<float*>(a.dq) + b * a.q_sb + h * a.q_sh, a.q_sl, qt * 64, lq,
                      dq, a.scale);
}

// Pass B: one block per (64 keys, head, batch); dV and dK of the block's keys
// summed over every query chunk in f32 registers, in chunk order; warpgroup w
// takes query rows 32 w .. 32 w + 31 of every chunk.
template <int D>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
    sdpa_bwd_keys_f32_wg_kernel(const __grid_constant__ SdpaBwdMaps maps, const SdpaBwdArgs a,
                                int head_inner) {
  using L = KeysF32Layout<D>;
  constexpr int T = L::T, NT = kF32BwdThreads;
  extern __shared__ __align__(1024) unsigned char tsmem[];
  const uint32_t raw = smem_addr(tsmem), pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* sm = tsmem + pad;
  const uint32_t base = raw + pad, bars = base + L::bars, full = bars + 8;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, lq = a.lq, lk = a.lk;
  const int wg = threadIdx.x / 128, nqc = (lq + 63) / 64;
  // query chunk i's Q, dO and stats into the stage
  auto issue = [&](int i) {
    if (threadIdx.x != 0 || i >= nqc) return;
    mbar_expect_tx(full, 2 * T + 64 * kTcStats * 4);
    tma_rows_f32<D>(base + L::q, &maps.q, full, i * 64, h, b, head_inner);
    tma_rows_f32<D>(base + L::dout, &maps.dout, full, i * 64, h, b, head_inner);
    tma_load_3d(base + L::st, &maps.st, full, 0, i * 64, b * a.heads + h);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, 2 * T);
    tma_rows_f32<D>(base + L::k, &maps.k, bars, kt * 64, h, b, head_inner);
    tma_rows_f32<D>(base + L::v, &maps.v, bars, kt * 64, h, b, head_inner);
    issue(0);
  }
  __syncthreads();

  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32 % 4) + (threadIdx.x & 31) / 4;
  // the column map of the thread's two key rows (rows past Lk are never written)
  float cmap[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    cmap[e] = col_map(a.mask ? a.mask + (long long)b * lk : nullptr, kt * 64 + r + 8 * e, lk);
  const float4* st = reinterpret_cast<const float4*>(sm + L::st);
  float sc[32], dp[32], dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(bars, 0);
  split_tile<D, NT>(sm + L::k, 64);
  split_tile<D, NT>(sm + L::v, 64);
  for (int i = 0; i < nqc; ++i) {
    mbar_wait(full, i & 1);
    split_tile<D, NT>(sm + L::q, 64);
    split_tile<D, NT>(sm + L::dout, 64);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T of the block's keys against the
    // warpgroup's 32 query rows of the chunk
    wgmma_fence();
    nt_pieces_f32<D>(sc, base + L::k, base + L::q + 32 * 128 * wg, 4);
    nt_pieces_f32<D>(dp, base + L::v, base + L::dout + 32 * 128 * wg, 4);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    transpose_tile<D, false, NT>(sm + L::qt, sm + L::q, 64);
    transpose_tile<D, false, NT>(sm + L::dot, sm + L::dout, 64);
    // P^T and dS^T = P^T (dP^T - rowsum) from pass A's stats; query rows past
    // Lq give 0
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int qi = 32 * wg + 8 * g + 2 * t4 + cc;
        const float4 x = st[qi];
        const bool valid = i * 64 + qi < lq;
        const float rlq = valid ? 1.f / x.y : 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * g + 2 * e + cc;
          const float pv = valid ? expf(fmaf(sc[j], a.scale, cmap[e]) - x.x) * rlq : 0.f;
          dp[j] = valid ? pv * (dp[j] - x.z) : 0.f;
          sc[j] = pv;
        }
      }
    __syncthreads();  // the stage is read, the transposed pairs written
    issue(i + 1);
    nn_chunk_f32<D>(dv, sc, base + L::dot + wg * D * 128, 4);  // dV += P^T dO
    nn_chunk_f32<D>(dk, dp, base + L::qt + wg * D * 128, 4);   // dK += dS^T Q
  }
  __syncthreads();  // every read of the stage is done
  const long long ko = b * a.k_sb + h * a.k_sh;
  if (add_halves<D>(dv, reinterpret_cast<float*>(sm + L::q)))
    store_rows_f32<D>(static_cast<float*>(a.dv) + ko, a.k_sl, kt * 64, lk, dv, 1.f);
  if (add_halves<D>(dk, reinterpret_cast<float*>(sm + L::q + 2 * T)))
    store_rows_f32<D>(static_cast<float*>(a.dk) + ko, a.k_sl, kt * 64, lk, dk, a.scale);
}

// The float32 pair's launches: the float32 forward first where the caller
// gives no row stats or asks for ctx, then pass A, then pass B.
template <int D>
cudaError_t launch_sdpa_bwd_f32_tc(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int hi = a.q_sh < a.q_sl;
  if ((a.k_sh < a.k_sl) != hi) return cudaErrorInvalidValue;
  const float* fs = a.fwd_stats;
  cudaError_t err;
  if (fs == nullptr || a.o != nullptr) {
    const SdpaArgs f = sdpa_fwd_args(a, batch);
    err = launch_sdpa_f32_wg<D>(f, batch, stream);
    if (err != cudaSuccess) return err;
    fs = f.stats;
  }
  SdpaBwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode_sdpa_map(enc, &maps.q, a.q, batch, a.heads, a.lq, D, a.q_sb, a.q_sh, a.q_sl, 64, 4) ||
      !encode_sdpa_map(enc, &maps.dout, a.dout, batch, a.heads, a.lq, D, a.q_sb, a.q_sh, a.q_sl, 64,
                       4) ||
      !encode_sdpa_map(enc, &maps.k, a.k, batch, a.heads, a.lk, D, a.k_sb, a.k_sh, a.k_sl, 64, 4) ||
      !encode_sdpa_map(enc, &maps.v, a.v, batch, a.heads, a.lk, D, a.k_sb, a.k_sh, a.k_sl, 64, 4) ||
      !encode_stats_map(enc, &maps.st, a.stats, batch * a.heads, a.lq))
    return cudaErrorInvalidValue;
  const size_t smem_a = rows_f32_smem_bytes<D>();
  err = smem_opt_in(sdpa_bwd_rows_f32_wg_kernel<D>, smem_a);
  if (err != cudaSuccess) return err;
  sdpa_bwd_rows_f32_wg_kernel<D><<<dim3((a.lq + 63) / 64, a.heads, batch), kF32BwdThreads,
                                   smem_a, stream>>>(maps, a, fs, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b = keys_f32_smem_bytes<D>();
  err = smem_opt_in(sdpa_bwd_keys_f32_wg_kernel<D>, smem_b);
  if (err != cudaSuccess) return err;
  sdpa_bwd_keys_f32_wg_kernel<D><<<dim3((a.lk + 63) / 64, a.heads, batch), kF32BwdThreads,
                                   smem_b, stream>>>(maps, a, hi);
  return cudaGetLastError();
}

// Resident blocks per SM of the bf16 tensor-core pair's pass A (pass 0) or
// pass B (pass 1) at head dim d and Lk keys, of the float32 row pair's score
// pass (pass 2) or column pass (pass 3, one query row of Lk keys), or of the
// float32 tensor-core pair's pass A (4) or pass B (5), or minus the CUDA
// error.
inline int sdpa_bwd_tc_blocks_per_sm(int pass, int d, int lk) {
  if (pass == 2) return blocks_per_sm(sdpa_bwd_row_scores_kernel<float, true>, kRowThreads, 0);
  if (pass == 3)
    return blocks_per_sm(sdpa_bwd_row_cols_kernel<float, true>, kRowThreads,
                         sdpa_bwd_row_smem_bytes(1, lk));
  if (d != 32 && d != 64) return -(int)cudaErrorInvalidValue;
  if (pass == 4)
    return d == 32 ? blocks_per_sm(sdpa_bwd_rows_f32_wg_kernel<32>, kF32BwdThreads,
                                   rows_f32_smem_bytes<32>())
                   : blocks_per_sm(sdpa_bwd_rows_f32_wg_kernel<64>, kF32BwdThreads,
                                   rows_f32_smem_bytes<64>());
  if (pass == 5)
    return d == 32 ? blocks_per_sm(sdpa_bwd_keys_f32_wg_kernel<32>, kF32BwdThreads,
                                   keys_f32_smem_bytes<32>())
                   : blocks_per_sm(sdpa_bwd_keys_f32_wg_kernel<64>, kF32BwdThreads,
                                   keys_f32_smem_bytes<64>());
  if (pass == 0)
    return d == 32 ? blocks_per_sm(sdpa_bwd_rows_wg_kernel<32>, kTcThreads, rows_smem_bytes<32>(lk))
                   : blocks_per_sm(sdpa_bwd_rows_wg_kernel<64>, kTcThreads, rows_smem_bytes<64>(lk));
  return d == 32 ? blocks_per_sm(sdpa_bwd_keys_wg_kernel<32>, kTcThreads, keys_smem_bytes<32>())
                 : blocks_per_sm(sdpa_bwd_keys_wg_kernel<64>, kTcThreads, keys_smem_bytes<64>());
}

enum SdpaBwdKernel { kBwdAuto = 0, kBwdTiled = 1, kBwdBlock = 2 };

// The row pair takes at most kRowMaxLq query rows at any head dim, and every
// Lk whose (s, dP) pairs fit the column pass's shared memory: 29,056 keys for
// one query row, 7,264 for four.
inline bool sdpa_bwd_row_fits(int lq, int lk, int d) {
  return lq <= kRowMaxLq && d > 0 && sdpa_bwd_row_smem_bytes(lq, lk) <= 232448;
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
  cudaError_t err = smem_opt_in(sdpa_bwd_rows_kernel<T>, smem_a);
  if (err != cudaSuccess) return err;
  sdpa_bwd_rows_kernel<T><<<dim3((a.lq + kBQ - 1) / kBQ, a.heads, batch), kThreads, smem_a,
                            stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b = sdpa_bwd_keys_smem_bytes();
  err = smem_opt_in(sdpa_bwd_keys_kernel<T>, smem_b);
  if (err != cudaSuccess) return err;
  sdpa_bwd_keys_kernel<T><<<dim3((a.lk + kBT - 1) / kBT, a.heads, batch), kBwdThreads, smem_b,
                            stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sdpa_bwd_block(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sdpa_bwd_smem_bytes(a.lq, a.lk);
  cudaError_t err = smem_opt_in(sdpa_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  sdpa_bwd_kernel<T><<<dim3(a.heads, batch), kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Whether the row pair may read and write whole 16-byte groups of columns (4
// elements in the column pass): the head dim and every stride a multiple of
// 16 bytes' worth of elements, every pointer 16-byte aligned.
inline bool sdpa_bwd_row_vec(const SdpaBwdArgs& a, int elem_bytes) {
  const int n = 16 / elem_bytes;
  if (a.d % n) return false;
  for (long long s : {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl})
    if (s % n) return false;
  for (const void* p : std::initializer_list<const void*>{a.q, a.k, a.v, a.dout, a.dq, a.dk,
                                                         a.dv, a.o})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T, bool VEC>
cudaError_t launch_sdpa_bwd_row_pair(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  float2* sc = sdpa_bwd_row_scratch(a, batch);
  sdpa_bwd_row_scores_kernel<T, VEC>
      <<<dim3((a.lk + kRowKeys - 1) / kRowKeys, a.heads, batch), kRowThreads, 0, stream>>>(a, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sdpa_bwd_row_smem_bytes(a.lq, a.lk);
  err = smem_opt_in(sdpa_bwd_row_cols_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  sdpa_bwd_row_cols_kernel<T, VEC>
      <<<dim3((a.d + kRowCols - 1) / kRowCols, a.heads, batch), kRowThreads, smem, stream>>>(a, sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sdpa_bwd_row(const SdpaBwdArgs& a, int batch, cudaStream_t stream) {
  if (a.stats == nullptr) return cudaErrorInvalidValue;  // the scratch lies after the stats
  return sdpa_bwd_row_vec(a, sizeof(T)) ? launch_sdpa_bwd_row_pair<T, true>(a, batch, stream)
                                        : launch_sdpa_bwd_row_pair<T, false>(a, batch, stream);
}

// kernel: kBwdAuto takes the tensor-core pair of the dtype where it fits,
// else the row pair for a few query rows, else the block kernel where its
// row sets fit, else the FMA query-tiled pair; kBwdTiled asks for a
// query-tiled pair (the tensor-core one where it fits) and kBwdBlock for the
// block kernel, at any shape they take, to time them against each other.
template <typename T>
cudaError_t launch_sdpa_bwd(const SdpaBwdArgs& a, int batch, cudaStream_t stream,
                            int kernel = kBwdAuto) {
  if (!sdpa_bwd_fits(a.lq, a.lk, a.d)) return cudaErrorInvalidValue;
  const bool tc = sdpa_bwd_tc_fits(a, (int)sizeof(T));
  if (a.fwd_stats != nullptr && !(kernel != kBwdBlock && tc)) return cudaErrorInvalidValue;
  if (kernel == kBwdBlock) {
    if (!sdpa_bwd_block_fits(a.lq, a.lk)) return cudaErrorInvalidValue;
    return launch_sdpa_bwd_block<T>(a, batch, stream);
  }
  if (kernel != kBwdAuto && kernel != kBwdTiled) return cudaErrorInvalidValue;
  if (tc) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return a.d == 32 ? launch_sdpa_bwd_tc<32>(a, batch, stream)
                       : launch_sdpa_bwd_tc<64>(a, batch, stream);
    else
      return a.d == 32 ? launch_sdpa_bwd_f32_tc<32>(a, batch, stream)
                       : launch_sdpa_bwd_f32_tc<64>(a, batch, stream);
  }
  if (kernel == kBwdTiled ||
      (!sdpa_bwd_row_fits(a.lq, a.lk, a.d) && !sdpa_bwd_block_fits(a.lq, a.lk)))
    return launch_sdpa_bwd_tiled<T>(a, batch, stream);
  if (sdpa_bwd_row_fits(a.lq, a.lk, a.d)) return launch_sdpa_bwd_row<T>(a, batch, stream);
  return launch_sdpa_bwd_block<T>(a, batch, stream);
}

}  // namespace smtc
