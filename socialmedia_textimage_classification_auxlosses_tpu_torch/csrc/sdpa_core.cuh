// Scaled-dot-product attention forward, shared by sdpa_fwd.cu and
// attn_block_fwd.cu.
//
// Computes softmax(q k^T * scale, key mask) v with the numerics of the JAX
// package's Pallas kernels (ops/attention.py::_fwd_kernel,
// ops/attn_block.py::_fwd_kernel2):
//   * scores q.k accumulate in f32 (bf16 products are exact in f32);
//   * masked keys (mask == 0) take the score -1e30, not -inf, so a fully
//     masked row is uniform instead of NaN;
//   * row max, exponentials and row sum in f32; probabilities are rounded to
//     the input dtype before the P.V product, which accumulates in f32;
//   * the output is rounded once, to the input dtype.
//
// Design. Every kernel here keeps the whole row of scores of its queries in
// shared memory (f32, 1 KB per query row at Lk = 197), so the softmax is exact
// two-pass (max, then sum) rather than online: that mirrors the reference,
// where the normalised probabilities, not running partial sums, are rounded
// to bf16. K and V stream through shared memory in tiles of 64 keys. Three
// kernels, chosen by launch_sdpa from the arguments:
//   * the row kernel, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K per batch row):
//     one block per query row, so no block computes idle rows;
//   * the tensor-core kernel, for bf16 with a head dim of 32, 64 or 128 and
//     16-byte aligned rows (every self-attention of the serving path):
//     mma.sync.m16n8k16 for both products;
//   * the FMA kernel for the rest (float32, other head dims): one block per
//     (batch, head, kBQ query rows), K and V in chunks of kDC head-dim
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
// The same function for bf16 with a head dim D of 32, 64 or 128 and 16-byte
// aligned rows (every attention of the serving path). One block per
// (batch, head, tile of kMQ = 64 query rows); each of the 4 warps owns 16
// query rows. Both products run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulation):
//   1. S = Q K^T: the warp's Q fragments stay in registers; K streams through
//      shared memory in tiles of kMK keys; scaled, masked scores go to the
//      f32 row buffer S, as in the FMA kernel;
//   2. the exact two-pass softmax per row; each probability is rounded to
//      bf16 and written over the first half of its own row of S;
//   3. O = P V: P is the A operand straight from shared memory; V tiles are
//      read as the B operand with ldmatrix.trans, so V is stored as it comes.
// Products of bf16 values are exact in f32 and the sums stay in f32, so the
// numerics are those of the FMA kernel up to summation order.

constexpr int kMQ = 64;  // query rows per block
constexpr int kMK = 64;  // keys per tile

__host__ __device__ inline int sdpa_mma_ld(int d) { return d + 8; }  // bf16 row stride

__host__ inline size_t sdpa_mma_smem_bytes(int lk, int d) {
  return sizeof(float) * (size_t)kMQ * sdpa_row_stride(lk) +
         sizeof(__nv_bfloat16) * (size_t)(kMQ + kMK) * sdpa_mma_ld(d);
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + rows) of a (.., D) bf16 matrix with row stride sl into a
// [rows][D + 8] shared tile, 8 values per load; rows at or past `valid` are 0
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long sl, int r0, int valid, int rows) {
  constexpr int kVec = D / 8;
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < valid) x = *reinterpret_cast<const uint4*>(src + (r0 + r) * sl + c);
    *reinterpret_cast<uint4*>(dst + r * sdpa_mma_ld(D) + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) sdpa_fwd_mma_kernel(SdpaArgs a) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [kMQ][ld] scores; then bf16 P
  const int ld = sdpa_row_stride(a.lk);
  constexpr int dp = D + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(S + kMQ * ld);  // [kMQ][dp]
  __nv_bfloat16* KVs = Qs + kMQ * dp;                                  // [kMK][dp]
  const int lk_tiles = (a.lk + kMK - 1) / kMK * kMK;

  const int q0 = blockIdx.x * kMQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;  // the warp's rows within the tile

  load_tile<D>(Qs, q, a.q_sl, q0, a.lq, kMQ);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* p = Qs + (row0 + grp) * dp + ks * 16 + 2 * t4;
    qf[ks][0] = ld_pair(p);
    qf[ks][1] = ld_pair(p + 8 * dp);
    qf[ks][2] = ld_pair(p + 8);
    qf[ks][3] = ld_pair(p + 8 * dp + 8);
  }

  // 1. scores
  for (int kt = 0; kt < a.lk; kt += kMK) {
    load_tile<D>(KVs, k, a.k_sl, kt, a.lk, kMK);
    __syncthreads();
    float acc[kMK / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int nb = 0; nb < kMK / 8; ++nb) {
        const __nv_bfloat16* p = KVs + (nb * 8 + grp) * dp + ks * 16 + 2 * t4;
        mma_16816(acc[nb], qf[ks], ld_pair(p), ld_pair(p + 8));
      }
#pragma unroll
    for (int nb = 0; nb < kMK / 8; ++nb)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = kt + nb * 8 + 2 * t4 + cc;
          const bool keep = j < a.lk && (mask == nullptr || mask[j] > 0);
          S[(row0 + grp + 8 * half) * ld + j] = keep ? acc[nb][2 * half + cc] * a.scale : kNegInf;
        }
    __syncthreads();
  }

  // 2. softmax; p rounded to bf16 over the first half of its own row
  for (int i = warp; i < kMQ; i += kThreads / 32) {
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
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
    // chunk by chunk: p[j] lands on float j/2 < base + 16, which this chunk
    // or an earlier one has already read
    for (int base = 0; base < lk_tiles; base += 32) {
      const int j = base + lane;
      const float p = j < a.lk ? row[j] / l : 0.f;
      __syncwarp();
      prow[j] = __float2bfloat16(p);
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. O = P V
  const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(S);
  const int ldp = 2 * ld;
  float oacc[D / 8][4] = {};
  for (int kt = 0; kt < a.lk; kt += kMK) {
    load_tile<D>(KVs, v, a.v_sl, kt, a.lk, kMK);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMK / 16; ++ks) {
      uint32_t pf[4];
      const __nv_bfloat16* p = P + (row0 + grp) * ldp + kt + ks * 16 + 2 * t4;
      pf[0] = ld_pair(p);
      pf[1] = ld_pair(p + 8 * ldp);
      pf[2] = ld_pair(p + 8);
      pf[3] = ld_pair(p + 8 * ldp + 8);
      const __nv_bfloat16* vrow = KVs + (ks * 16 + (lane & 15)) * dp;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + nb * 8);
        mma_16816(oacc[nb], pf, b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + row0 + grp + 8 * half;
    if (i >= a.lq) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(o + i * a.o_sl + nb * 8 + 2 * t4) =
          __floats2bfloat162_rn(oacc[nb][2 * half], oacc[nb][2 * half + 1]);
  }
}

// Whether the tensor-core kernel takes these arguments: a head dim it is
// built for, rows and pointers 16-byte aligned, its row of scores in memory.
inline bool sdpa_mma_fits(const SdpaArgs& a) {
  if (a.d != 32 && a.d != 64 && a.d != 128) return false;
  const long long strides[] = {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl,
                               a.v_sb, a.v_sh, a.v_sl, a.o_sb, a.o_sh, a.o_sl};
  for (long long s : strides)
    if (s % 8) return false;
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return sdpa_mma_smem_bytes(a.lk, a.d) <= 232448;
}

template <int D>
cudaError_t launch_sdpa_mma(const SdpaArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = sdpa_mma_smem_bytes(a.lk, D);
  cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kMQ - 1) / kMQ, a.heads, batch);
  sdpa_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sdpa(const SdpaArgs& a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.lq > kRowMaxLq && sdpa_mma_fits(a)) {
      if (a.d == 32) return launch_sdpa_mma<32>(a, batch, stream);
      if (a.d == 64) return launch_sdpa_mma<64>(a, batch, stream);
      return launch_sdpa_mma<128>(a, batch, stream);
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
