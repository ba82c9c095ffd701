// Scaled-dot-product attention forward, shared by sdpa_fwd.cu and
// attn_block_fwd.cu, and the tensor-core tiles that the backward
// (sdpa_bwd_core.cuh) shares with it.
//
// Computes softmax(q k^T * scale, key mask) v with the numerics of the JAX
// package's Pallas kernels (ops/attention.py::_fwd_kernel,
// ::_fwd_kernel_blocked, ops/attn_block.py::_fwd_kernel2):
//   * scores q.k accumulate in f32 (bf16 products are exact in f32);
//   * masked keys (mask == 0) take the score -1e30, not -inf, so a fully
//     masked row is uniform instead of NaN;
//   * row max, exponentials and row sum in f32; the probabilities, formed
//     from the row's final max and sum, are rounded to the input dtype before
//     the P.V product, which accumulates in f32;
//   * the output is rounded once, to the input dtype.
//
// Three kernels, chosen by launch_sdpa from the arguments:
//   * the tensor-core kernel (sdpa_fwd_tc_kernel), for bf16 with a head dim
//     of 32, 64 or 128, 16-byte aligned rows and more than kRowMaxLq query
//     rows: every self-attention of the serving and training paths, text
//     (L = 128), image (197) and ViLT's joint sequence (185, 402 > 256: TPU
//     kernel 3, _fwd_kernel_blocked, whose 128-row query tiles are this
//     kernel's 64-row tiles); its design note stands above it, below;
//   * the row kernel, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K per batch row):
//     one block per query row, so no block computes idle rows;
//   * the FMA kernel for the rest (float32, other head dims): one block per
//     (batch, head, kBQ query rows) keeps its rows of f32 scores in shared
//     memory, exact two-pass softmax, K and V in chunks of kDC head-dim
//     columns, so the head dim is unbounded; f32 FMA on the CUDA cores.
//
// Strides are in elements and the head dim has stride 1, so the same kernel
// reads the (B, H, L, D) layout of ops/attention.py and the packed (B, L, H*D)
// layout of the fused block, where a head is a column slice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace smtc {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kDC = 64;        // head-dim columns per chunk
constexpr int kThreads = 128;  // 4 warps; a 8 x 16 grid of 4 x 4 micro-tiles
// Row strides of the d-major Q and K chunks: +4 floats keeps float4 reads
// aligned and spreads a warp's transposed stores over 8 banks instead of 1.
constexpr int kQLd = kBQ + 4;
constexpr int kKLd = kBK + 4;
// Up to this many query rows the row kernel runs (one block per query row):
// a tile of kBQ rows would leave at least 7/8 of its rows idle.
constexpr int kRowMaxLq = 4;
constexpr int kRowThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

struct SdpaArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // (B, Lk) 1 = keep, or nullptr for no mask
  void* o;
  int heads, lq, lk, d;
  long long q_sb, q_sh, q_sl;  // element strides of batch, head, position
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  float scale;
};

// Padded score-row length: a whole number of key tiles, plus 4 floats so rows
// start on 16-byte boundaries and neighbouring rows fall in other banks.
__host__ __device__ inline int sdpa_row_stride(int lk) {
  return (lk + kBK - 1) / kBK * kBK + 4;
}

__host__ inline size_t sdpa_smem_bytes(int lk) {
  return sizeof(float) * ((size_t)kBQ * sdpa_row_stride(lk) + kDC * kQLd + kDC * kKLd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sdpa_fwd_kernel(SdpaArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = sdpa_row_stride(a.lk);
  const int lk_tiles = (a.lk + kBK - 1) / kBK * kBK;
  float* S = smem;                 // [kBQ][ld] scores, then probabilities
  float* Qs = S + kBQ * ld;        // [kDC][kQLd] query chunk, d-major
  float* Ks = Qs + kDC * kQLd;     // [kDC][kKLd] key chunk, d-major; reused as
                                   // [kBK][kDC] value chunk

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk : nullptr;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 columns each: 64
  const int ty = tid / 16;  // 4 rows each: 32

  // 1. scores S = q k^T * scale, masked
  for (int kt = 0; kt < a.lk; kt += kBK) {
    float acc[4][4] = {};
    for (int dc = 0; dc < a.d; dc += kDC) {
      for (int e = tid; e < kBQ * kDC; e += kThreads) {
        const int i = e / kDC, c = e % kDC;
        float x = 0.f;
        if (q0 + i < a.lq && dc + c < a.d) x = to_f32(q[(q0 + i) * a.q_sl + dc + c]);
        Qs[c * kQLd + i] = x;
      }
      for (int e = tid; e < kBK * kDC; e += kThreads) {
        const int j = e / kDC, c = e % kDC;
        float x = 0.f;
        if (kt + j < a.lk && dc + c < a.d) x = to_f32(k[(kt + j) * a.k_sl + dc + c]);
        Ks[c * kKLd + j] = x;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDC; ++c) {
        const float4 qa = reinterpret_cast<const float4*>(Qs + c * kQLd)[ty];
        const float4 kb = reinterpret_cast<const float4*>(Ks + c * kKLd)[tx];
        const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kc[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(qr[r], kc[cc], acc[r][cc]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = kt + tx * 4 + cc;
        const bool keep = j < a.lk && (mask == nullptr || mask[j] > 0);
        S[(ty * 4 + r) * ld + j] = keep ? acc[r][cc] * a.scale : kNegInf;
      }
  }
  __syncthreads();

  // 2. softmax over the lk real keys of each row; one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < kBQ; i += kThreads / 32) {
    float* row = S + i * ld;
    float m = -INFINITY;
    for (int j = lane; j < a.lk; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < a.lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < lk_tiles; j += 32)
      row[j] = j < a.lk ? to_f32(from_f32<T>(row[j] / l)) : 0.f;
  }
  __syncthreads();

  // 3. o = P v, a chunk of kDC output columns at a time
  float* Vs = Ks;
  for (int dc = 0; dc < a.d; dc += kDC) {
    float acc[4][4] = {};
    for (int kt = 0; kt < a.lk; kt += kBK) {
      for (int e = tid; e < kBK * kDC; e += kThreads) {
        const int j = e / kDC, c = e % kDC;
        float x = 0.f;
        if (kt + j < a.lk && dc + c < a.d) x = to_f32(v[(kt + j) * a.v_sl + dc + c]);
        Vs[j * kDC + c] = x;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float4 vb = reinterpret_cast<const float4*>(Vs + j * kDC)[tx];
        const float vc[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = S[(ty * 4 + r) * ld + kt + j];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(p, vc[cc], acc[r][cc]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      if (i >= a.lq) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = dc + tx * 4 + cc;
        if (c < a.d) o[i * a.o_sl + c] = from_f32<T>(acc[r][cc]);
      }
    }
  }
}

// The same function for a few query rows (the fusion head's single CLS query
// of width 768): one block per (query row, head, batch). Each warp takes
// whole keys, its lanes splitting the head dim, so K is read once, row by
// row, coalesced; the scores of the row stay in shared memory; then each
// thread accumulates its own output columns over the keys, reading V once.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) sdpa_fwd_row_kernel(SdpaArgs a) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [d] the query row
  float* S = qs + a.d;                          // [lk] scores, then probabilities
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + i * a.q_sl;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + i * a.o_sl;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kRowThreads / 32;

  for (int c = tid; c < a.d; c += kRowThreads) qs[c] = to_f32(q[c]);
  __syncthreads();

  // 1. scores, one warp per key
  for (int j = warp; j < a.lk; j += kWarps) {
    const T* kj = k + j * a.k_sl;
    float s = 0.f;
    for (int c = lane; c < a.d; c += 32) s = fmaf(qs[c], to_f32(kj[c]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) S[j] = (mask == nullptr || mask[j] > 0) ? s * a.scale : kNegInf;
  }
  __syncthreads();

  // 2. softmax over the row by warp 0: max, then sum, then p rounded to T
  if (warp == 0) {
    float m = -INFINITY;
    for (int j = lane; j < a.lk; j += 32) m = fmaxf(m, S[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < a.lk; j += 32) {
      const float e = expf(S[j] - m);
      S[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < a.lk; j += 32) S[j] = to_f32(from_f32<T>(S[j] / l));
  }
  __syncthreads();

  // 3. o = p v, each thread its own columns
  for (int c = tid; c < a.d; c += kRowThreads) {
    float acc = 0.f;
    for (int j = 0; j < a.lk; ++j) acc = fmaf(S[j], to_f32(v[j * a.v_sl + c]), acc);
    o[c] = from_f32<T>(acc);
  }
}

// ---- bf16 on the tensor cores ------------------------------------------------
//
// sdpa_fwd_tc_kernel replaces the Pallas ops/attention.py::_fwd_kernel (TPU
// kernel 1) and ::_fwd_kernel_blocked (TPU kernel 3) for bf16.
//
// Design (FlashAttention-2's register layout, with the JAX rounding points).
// One block of 4 warps per (64-query tile, head, batch); each warp owns 16
// query rows, whose Q fragments stay in registers. K and V stream through a
// ring of kRing cp.async stages, two 64-row bf16 tiles each ([64][D + 8]:
// 9 KB at D = 64), loaded while the warps multiply the stage before. Nothing
// score-shaped lives in shared memory: the ring and a column map of the key
// mask (one f32 per key: 1 keep, -1e30 masked, -inf past Lk) are 39 KB at
// D = 64, Lk = 402. Every product is mma.sync.m16n8k16 (bf16 operands, f32
// accumulators), operands through ldmatrix.
//   1. Row statistics: S = Q K^T tile by tile into registers (a stage holds
//      two K tiles in this sweep), scaled in f32, masked at -1e30, keys past
//      Lk excluded (-inf, never -1e30). A running row max m and sum l in f32,
//      each quad's four lanes agreeing on m through __shfl_xor_sync; l is
//      summed across the quad at the end.
//   2. Output: S recomputed per (K, V) stage, P = exp(s - m) * (1 / l) from the
//      final m and l, rounded to bf16 and packed straight from the C
//      fragments into A fragments, O += round(P) V with V through
//      ldmatrix.trans. O is rounded once.
// What this keeps: P is formed from the exact final row max and rounded at
// the JAX point (_probs, then astype, then the dot). What changes: the order
// of the f32 sums, l summed online (its terms rescaled by exp(m_old - m_new),
// about 1e-7 relative), and p = e * (1 / l) instead of e / l (1 ulp of f32).
// A running O is never rescaled: that would round unnormalised partial sums
// instead of P, another rounding point.
//
// What bounds it on the H100. ViLT's 32x12x402x402x64 is 15.9 GFLOP for the
// two products, 16 us at 989 TFLOP/s, against 24 us for its bytes; the
// kernel does 1.5x the products (S twice) and two exponentials per score,
// so mma.sync issue and the softmax arithmetic bound it, not device memory.
// With no score rows in shared memory 4 blocks share an SM at D = 64 (128
// registers, no spills; 3 at D = 128, 165 registers; the occupancy query
// below, logged by chip_smoke.py), so one block's loads and softmax overlap
// another's products. A third ring stage measured slower (PERF.md).

constexpr int kMQ = 64;   // query rows per block: 4 warps x 16
constexpr int kMK = 64;   // rows per ring tile (keys; pass B's query rows)
constexpr int kRing = 2;  // cp.async stages, two tiles each

// bf16 row stride of a ring tile: +8 puts the 8 rows an ldmatrix reads in
// distinct banks
__host__ __device__ constexpr int tc_ld(int d) { return d + 8; }
__host__ __device__ constexpr int tc_tile(int d) { return kMK * tc_ld(d); }  // elements
// the column map covers whole sweep-1 stages (two key tiles)
__host__ __device__ inline int tc_cols(int lk) {
  return (lk + 2 * kMK - 1) / (2 * kMK) * (2 * kMK);
}

// the ring, then the column map
__host__ inline size_t sdpa_tc_smem_bytes(int lk, int d) {
  return sizeof(__nv_bfloat16) * (size_t)kRing * 2 * tc_tile(d) + sizeof(float) * tc_cols(lk);
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// two f32 rounded to bf16 (nearest even, as XLA's convert), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// rows [r0, r0 + kMK) of an (n, D) bf16 matrix with row stride sl into a ring
// tile by cp.async; rows at or past n are zero-filled
template <int D>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long sl, int r0, int n) {
  constexpr int kVec = D / 8;
  for (int e = threadIdx.x; e < kMK * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * tc_ld(D) + c, ok ? src + (r0 + r) * sl + c : src, ok);
  }
}

// the A fragments (16 rows x D, row-major) of rows row0 .. row0 + 15 of a tile
template <int D>
__device__ __forceinline__ void a_frags(uint32_t (&f)[D / 16][4], const __nv_bfloat16* t,
                                        int row0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(f[ks], t + (row0 + (lane & 15)) * tc_ld(D) + ks * 16 + (lane >> 4) * 8);
}

// acc = F T^T over the head dim: the warp's 16 rows (A fragments f) against
// the first N rows of tile t (K, V, Q or dO), in N / 8 blocks of 8 columns.
// C fragment layout: acc[nb][0..1] row grp, acc[nb][2..3] row grp + 8, at
// columns nb * 8 + 2 t4 + {0, 1} (grp = lane / 4, t4 = lane % 4).
template <int D, int N>
__device__ __forceinline__ void nt_tile(float (&acc)[N / 8][4], const uint32_t (&f)[D / 16][4],
                                        const __nv_bfloat16* t) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, t + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * tc_ld(D) + ks * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_16816(acc[2 * np], f[ks], r[0], r[1]);
      mma_16816(acc[2 * np + 1], f[ks], r[2], r[3]);
    }
}

// acc += P T over the first N rows of tile t (V, K, dO or Q, rows as the
// summed dimension, read through ldmatrix.trans), P the warp's 16 x N A
// fragments
template <int D, int N>
__device__ __forceinline__ void nn_tile(float (&acc)[D / 8][4], const uint32_t (&p)[N / 16][4],
                                        const __nv_bfloat16* t) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, t + (ks * 16 + (lane & 15)) * tc_ld(D) + dp * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * dp], p[ks], r[0], r[1]);
      mma_16816(acc[2 * dp + 1], p[ks], r[2], r[3]);
    }
}

// C fragments of 16 x N f32 values, rounded to bf16, as the A fragments of a
// product over those N columns: no trip through shared memory
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&f)[N / 16][4], const float (&x)[N / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    f[ks][0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    f[ks][1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    f[ks][2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    f[ks][3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
  }
}

// the key mask as one f32 per key of whole sweep-1 stages: 1 keep, -1e30
// masked, -inf past lk (excluded from max, sum and products)
__device__ __forceinline__ void fill_cols(float* cm, const int* mask, int lk) {
  for (int j = threadIdx.x; j < tc_cols(lk); j += kThreads)
    cm[j] = j >= lk ? -INFINITY : (mask == nullptr || mask[j] > 0) ? 1.f : kNegInf;
}

// s *= scale where the key is kept; the column map's value where it is not
template <int N>
__device__ __forceinline__ void scale_mask(float (&s)[N / 8][4], const float* cm, float scale) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    const float2 c = *reinterpret_cast<const float2*>(cm + nb * 8 + 2 * t4);
    s[nb][0] = c.x > 0.f ? s[nb][0] * scale : c.x;
    s[nb][1] = c.y > 0.f ? s[nb][1] * scale : c.y;
    s[nb][2] = c.x > 0.f ? s[nb][2] * scale : c.x;
    s[nb][3] = c.y > 0.f ? s[nb][3] * scale : c.y;
  }
}

// the running row max m and the thread's share of the row sum l (relative to
// m) over one key tile of scaled, masked scores; m agrees across the quad
template <int N>
__device__ __forceinline__ void online_stats(float (&m)[2], float (&l)[2],
                                             const float (&s)[N / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
      sum += expf(s[nb][2 * r] - mx) + expf(s[nb][2 * r + 1] - mx);
    l[r] = l[r] * expf(m[r] - mx) + sum;  // m = -inf before the first tile: 0 * 0
    m[r] = mx;
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s = exp(s - m) * rl, the f32 probabilities of the warp's two rows
template <int N>
__device__ __forceinline__ void probs(float (&s)[N / 8][4], const float (&m)[2],
                                      const float (&rl)[2]) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = expf(s[nb][e] - m[e >> 1]) * rl[e >> 1];
}

// rows row0 + grp and row0 + grp + 8 of a 16 x D C-fragment accumulator,
// times alpha, rounded once, for rows below n
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sl, int r0, int n,
                                           const float (&acc)[D / 8][4], float alpha) {
  const int lane = threadIdx.x % 32, grp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + grp + 8 * r;
    if (i >= n) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + i * sl + nb * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nb][2 * r] * alpha, acc[nb][2 * r + 1] * alpha);
  }
}

// The cp.async ring's protocol, shared by the tensor-core kernels. issue(s)
// loads stage s into ring slot s % kRing and commits one group (an empty one
// past the last stage, to keep the count uniform). Before ring_start the
// caller has committed one group of its own, the operands it keeps in
// registers, staged in the last slot, which the prologue leaves free.
template <typename Issue>
__device__ __forceinline__ void ring_start(Issue& issue) {
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  cp_async_wait<kRing - 1>();  // the caller's group has landed
  __syncthreads();
}

// Waits for stage s, frees the slot before it (every warp is past it), loads
// kRing - 1 stages ahead; returns s's slot and moves s on.
template <typename Issue>
__device__ __forceinline__ int ring_next(int& s, Issue& issue) {
  cp_async_wait<kRing - 2>();
  __syncthreads();
  issue(s + kRing - 1);
  return s++ % kRing;
}

// Sweep 1 of the forward and of the backward's pass A: the final row max m
// and sum l of the warp's rows (l summed across the quad), streaming the ring
// stages `next` hands out, two K tiles each.
template <int D, typename Next>
__device__ __forceinline__ void row_stats(float (&m)[2], float (&l)[2],
                                          const uint32_t (&qf)[D / 16][4], Next& next,
                                          const float* cm, int lk, float scale) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int kt = 0; kt < lk; kt += 2 * kMK) {
    const __nv_bfloat16* st = next();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (kt + half * kMK >= lk) break;
      float s[kMK / 8][4];
      nt_tile<D, kMK>(s, qf, st + half * tc_tile(D));
      scale_mask<kMK>(s, cm + kt + half * kMK, scale);
      online_stats<kMK>(m, l, s);
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads) sdpa_fwd_tc_kernel(SdpaArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int kTile = tc_tile(D);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);  // kRing x 2 tiles
  float* cm = reinterpret_cast<float*>(ring + kRing * 2 * kTile);  // [tc_cols(lk)]
  const int q0 = blockIdx.x * kMQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int lk = a.lk, nt = (lk + kMK - 1) / kMK, n1 = (nt + 1) / 2;
  const int row0 = (threadIdx.x / 32) * 16;  // the warp's rows within the tile

  __nv_bfloat16* last = ring + (kRing - 1) * 2 * kTile;
  tile_async<D>(last, q, a.q_sl, q0, a.lq);
  cp_async_commit();
  fill_cols(cm, a.mask ? a.mask + (long long)b * lk : nullptr, lk);
  // stage s: two K tiles (sweep 1, s < n1), then a (K, V) pair per key tile
  auto issue = [&](int s) {
    __nv_bfloat16* dst = ring + (s % kRing) * 2 * kTile;
    if (s < n1) {
      tile_async<D>(dst, k, a.k_sl, 2 * s * kMK, lk);
      if ((2 * s + 1) * kMK < lk) tile_async<D>(dst + kTile, k, a.k_sl, (2 * s + 1) * kMK, lk);
    } else if (s < n1 + nt) {
      tile_async<D>(dst, k, a.k_sl, (s - n1) * kMK, lk);
      tile_async<D>(dst + kTile, v, a.v_sl, (s - n1) * kMK, lk);
    }
    cp_async_commit();
  };
  ring_start(issue);
  uint32_t qf[D / 16][4];
  a_frags<D>(qf, last, row0);
  int s = 0;
  auto next = [&]() {
    return static_cast<const __nv_bfloat16*>(ring + ring_next(s, issue) * 2 * kTile);
  };

  // 1. row max and sum
  float m[2], l[2];
  row_stats<D>(m, l, qf, next, cm, lk, a.scale);
  const float rl[2] = {1.f / l[0], 1.f / l[1]};

  // 2. O = round(P) V, P from the final max and sum
  float oacc[D / 8][4] = {};
  for (int t = 0; t < nt; ++t) {
    const __nv_bfloat16* st = next();
    float p[kMK / 8][4];
    nt_tile<D, kMK>(p, qf, st);
    scale_mask<kMK>(p, cm + t * kMK, a.scale);
    probs<kMK>(p, m, rl);
    uint32_t pf[kMK / 16][4];
    pack_a<kMK>(pf, p);
    nn_tile<D, kMK>(oacc, pf, st + kTile);
  }
  cp_async_wait<0>();
  store_rows<D>(o, a.o_sl, q0 + row0, a.lq, oacc, 1.f);
}

// Whether the tensor-core kernels take these arguments: bf16 is the caller's
// test; a head dim they are built for, rows and pointers 16-byte aligned.
inline bool sdpa_tc_fits(int d, std::initializer_list<long long> strides,
                         std::initializer_list<const void*> ptrs) {
  if (d != 32 && d != 64 && d != 128) return false;
  for (long long s : strides)
    if (s % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int D>
cudaError_t launch_sdpa_tc(const SdpaArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sdpa_tc_smem_bytes(a.lk, D);
  cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kMQ - 1) / kMQ, a.heads, batch);
  sdpa_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Resident blocks per SM of a kernel at its launch's block size and shared
// memory, or minus the CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
cudaError_t launch_sdpa(const SdpaArgs& a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.lq > kRowMaxLq &&
        sdpa_tc_fits(a.d, {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl, a.v_sb, a.v_sh,
                           a.v_sl, a.o_sb, a.o_sh, a.o_sl},
                     {a.q, a.k, a.v, a.o}) &&
        sdpa_tc_smem_bytes(a.lk, a.d) <= 232448) {
      if (a.d == 32) return launch_sdpa_tc<32>(a, batch, stream);
      if (a.d == 64) return launch_sdpa_tc<64>(a, batch, stream);
      return launch_sdpa_tc<128>(a, batch, stream);
    }
  }
  if (a.lq <= kRowMaxLq) {
    const size_t smem = sizeof(float) * ((size_t)a.d + a.lk);
    cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_row_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    sdpa_fwd_row_kernel<T><<<dim3(a.lq, a.heads, batch), kRowThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sdpa_smem_bytes(a.lk);
  cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.heads, batch);
  sdpa_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace smtc
