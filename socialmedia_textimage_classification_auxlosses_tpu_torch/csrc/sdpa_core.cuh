// Scaled-dot-product attention forward, shared by sdpa_fwd.cu,
// attn_block_fwd.cu and the per-head block, and the wgmma pieces that the
// backward (sdpa_bwd_core.cuh) shares with it.
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
// Four kernels, chosen by launch_sdpa from the arguments:
//   * the tensor-core kernel (sdpa_fwd_wg_kernel: wgmma fed by TMA), for
//     bf16 with a head dim of 32, 64 or 128, 16-byte aligned rows and more
//     than kRowMaxLq query rows: every self-attention of the serving and
//     training paths, text (L = 128), image (197) and ViLT's joint sequence
//     (185, 402 > 256: TPU kernel 3, _fwd_kernel_blocked, whose 128-row query
//     tiles are this kernel's 64-row tiles); it also writes each query row's
//     max and sum for the backward when asked; its design note stands above
//     it, below;
//   * its float32 counterpart (sdpa_fwd_f32_wg_kernel: three tf32 passes a
//     product on wgmma fed by TMA, float32's accuracy kept), for float32 with
//     a head dim of 32 or 64 and otherwise the same arguments: the grid's
//     float32 towers, ViLT exact in float32, the per-head blocks' float32
//     column slices; it writes the row statistics too; design note below;
//   * the row kernel, for at most kRowMaxLq query rows (the fusion head's one
//     query of width 768 over 197 image keys, 605 KB of f32 K per batch row):
//     one block per query row, so no block computes idle rows;
//   * the FMA kernel for the rest (other head dims, such as 128 in float32):
//     one block per (batch, head, kBQ query rows) keeps its rows of f32 scores
//     in shared memory, exact two-pass softmax, K and V in chunks of kDC
//     head-dim columns, so the head dim is unbounded; f32 FMA on the CUDA
//     cores.
//
// Strides are in elements and the head dim has stride 1, so the same kernel
// reads the (B, H, L, D) layout of ops/attention.py and the packed (B, L, H*D)
// layout of the fused block, where a head is a column slice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <string.h>

#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

#include "hopper_core.cuh"

namespace smtc {

// A kernel's dynamic shared-memory opt-in on the current device, raised only
// when a launch needs more than the largest size already set there. So the
// attribute call is made once per (device, kernel, larger size): a launch adds
// none to the host's enqueue, and a CUDA graph that captures a step after its
// warm-up records launches only.
template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> set;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = (const void*)kernel;  // as cudaFuncSetAttribute's own overload casts
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = set[{device, key}];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(key, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

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
  // (B, H, Lq, 2) f32, each query row's max and sum, or nullptr; only the
  // tensor-core kernels write them (a launch that cannot, refuses)
  float* stats = nullptr;
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

// ---- mma.sync helpers of the per-head block's product (perhead_core.cuh) ----

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

// ---- bf16 on the tensor cores: wgmma fed by TMA -------------------------------
//
// sdpa_fwd_wg_kernel replaces the Pallas ops/attention.py::_fwd_kernel (TPU
// kernel 1) and ::_fwd_kernel_blocked (TPU kernel 3) for bf16, and writes the
// row statistics (each query row's max and sum) that the backward's pass A
// reads (sdpa_bwd_core.cuh).
//
// What bounds it on the H100. The image tower's 16x12x197x197x64 is 1.2 GFLOP
// of products (1.2 us at 989 TFLOP/s) against 5.8 us for the bytes of q, k, v
// and o; ViLT's 32x12x402x402x64 is 15.9 GFLOP (16 us) against 24 us. So the
// least time is the bytes'. What the kernel spends goes to the softmax on the
// CUDA cores: a score takes an FMA (scale and mask), a max, a subtraction, an
// accurate expf (about eight instructions), a sum and the P scaling and
// packing, about 14 instructions, and two warpgroups share an SM (255
// registers a thread). Clock counts of one unit (64 rows x 197 keys, thread
// 0; tools/sdpa_clocks.py, PERF.md): S 1,250-1,460 cycles, the softmax
// 4,030-4,210, P 740-790, P V 1,210-1,250, the staged store 920-1,360 of
// 9,240-10,270.
//
// Design. A block is one warpgroup (64 query rows, wgmma's M), persistent:
// the grid is as many blocks as the SMs hold, each walking the (query tile,
// head, batch) units u = blockIdx.x + i gridDim.x, query tile fastest, so
// neighbouring blocks share a head's K and V in L2 and no wave runs part full
// beyond the units' own remainder. Thread 0 keeps the block's buffers in
// flight by TMA: Q (64 rows), K windows of W keys (a ring of two at 128-key
// windows) and a V window, each guarded by an mbarrier that takes the copy's
// bytes; a buffer's next load is issued as soon as the products that read it
// are done, so the next unit's Q and K arrive while this one forms P and O.
// (A producer warp beside the warpgroup would cap a thread at 168 registers:
// the SM's four register partitions would hold three warps each; the 256-key
// row spilled there.) TMA zero-fills rows past Lq and Lk; keys past Lk are
// excluded through the column map (0 keep, -1e30 masked, -inf past Lk: one
// FMA gives the scaled, masked score), filled per unit in shared memory.
// Products:
//   * S = Q K^T: wgmma.mma_async with both operands K-major from the swizzled
//     tiles; a full window is one wgmma (N = W), a shorter one is cut into
//     pieces of W/2, W/4, .. 8 keys by the bits of ceil(keys / 8): 197 keys
//     are 128 + 64 + 8 = 200 columns, not 256;
//   * O += round(P) V: P packed from the f32 accumulators straight into
//     wgmma's register A operand (the accumulator layout of two 8-column groups
//     is the A layout of a k16 step), V an MN-major B operand; O stays in
//     registers over the windows, is rounded once and leaves through a staging
//     tile in whole 16-byte rows.
// For 129 to 256 keys at head dim 64 (every model's image tower, ViLT's 185,
// DeiT's 198, MMBT's 132) the whole key row is one 256-key window, and 128-key
// rows are one 128-key window: S is formed once, the row max is exact, each
// score takes one exponential (e = exp(s - m), summed, then P = e * (1 / l)).
// Longer rows (ViLT's 402) take two sweeps over 128-key windows: the first
// forms S for the max and the sum (the sum rescaled once per window as the
// max grows), the second forms S again for P from the final max and sum. (Two
// 256-key windows measured 0.202 against 0.171 ms at 402; keeping the row's
// f32 scores in shared memory instead would hold 64 x Lk x 4 bytes, 103 KB at
// 402 keys and 410 KB at the longest row the kernels take.)
// What this keeps of the JAX rounding points: scores in f32 times the scale,
// masked keys at -1e30, P from the row's final max and sum rounded once to
// bf16 before P V, O rounded once. What changes: the order of the f32 sums
// (the tensor cores' k16 steps; a row's sum in four partial sums per thread,
// then across the quad; past 256 keys the windows' sums rescaled by
// exp(m_old - m_new)) and p = e * (1 / l) instead of e / l (1 ulp of f32). A
// running O is never rescaled: that would round unnormalised partial sums
// instead of P.

template <int D>
struct TcDims {
  static constexpr int kCols = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int kSwz = 2 * kCols;         // its swizzle span: 64 or 128 bytes
  static constexpr int kBoxes = D / kCols;       // boxes across the head dim
};
template <int D>
__host__ __device__ constexpr int tc_tile_bytes(int rows) {
  return rows * D * 2;
}

constexpr int kTcRows = 64;  // query rows of a unit: a warpgroup's wgmma M

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows r0.. (as many as the map's box holds) of head h, batch b of an
// operand into the tile at dst, which holds `rows` rows: one box per kCols
// columns, each at its block of rows x kSwz bytes
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int r0, int h, int b, int head_inner) {
#pragma unroll
  for (int c = 0; c < TcDims<D>::kBoxes; ++c) {
    const uint32_t at = dst + c * rows * TcDims<D>::kSwz;
    if (head_inner)
      tma_load_4d(at, map, bar, c * TcDims<D>::kCols, h, r0, b);
    else
      tma_load_4d(at, map, bar, c * TcDims<D>::kCols, r0, h, b);
  }
}

// A K-major operand: k16 step kk (head-dim columns 16 kk ..) of the rows from
// r0 (a multiple of 8) of a tile of `rows` rows
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0, int kk) {
  constexpr int cols = TcDims<D>::kCols, swz = TcDims<D>::kSwz;
  return wg_desc(tile + (kk * 16 / cols) * rows * swz + r0 * swz + (kk * 16 % cols) * 2, swz, 16);
}
// An MN-major operand: the k16 step of rows r0 .. r0 + 15 (r0 a multiple of
// 16) of a tile of `rows` rows, all D columns
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int r0) {
  constexpr int swz = TcDims<D>::kSwz;
  return wg_desc(tile + r0 * swz, swz, rows * swz);
}

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    static_for<I + 1, N>(f);
  }
}

// The wgmma pieces of a window of W keys: piece 0 is the whole window (wgmma's
// N = W), used when the window is full; a shorter window of n8 8-key groups
// uses piece i > 0 (W / 2^i keys, groups(i) groups) where bit groups(i) of n8
// is set, so at most 7 columns are padding. Pieces lie in key order, and
// their accumulators in that order in the window's registers (4 f32 a thread
// per 8-key group); piece 0 spans them all, as it is used alone.
template <int W>
struct Pieces {
  static constexpr int n = W == 256 ? 6 : W == 128 ? 5 : 4;
  __host__ __device__ static constexpr int groups(int i) { return (W / 8) >> i; }
  __host__ __device__ static constexpr int reg(int i) {
    int r = 0;
    for (int j = 1; j < i; ++j) r += 4 * groups(j);
    return r;
  }
};

template <int W, int I>
__device__ __forceinline__ bool piece_used(int n8) {
  if (I == 0) return n8 == W / 8;
  return n8 != W / 8 && (n8 & Pieces<W>::groups(I)) != 0;
}
// the piece's first key within the window
template <int W, int I>
__device__ __forceinline__ int piece_key(int n8) {
  return I == 0 ? 0 : 8 * (n8 & ~(2 * Pieces<W>::groups(I) - 1));
}

// f(piece, its first key) for each piece a window of n8 groups uses, in key order
template <int W, typename F>
__device__ __forceinline__ void for_pieces(int n8, F&& f) {
  static_for<0, Pieces<W>::n>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    if (piece_used<W, I>(n8)) f(ic, piece_key<W, I>(n8));
  });
}

// S = Q K^T over the window's 8 n8 keys: Q the 64-row tile q, the window the
// tile k of W rows, both K-major; s holds the result when this returns
template <int D, int W>
__device__ __forceinline__ void window_scores(float (&s)[W / 2], uint32_t q, uint32_t k, int n8) {
  wgmma_fence();
  for_pieces<W>(n8, [&](auto ic, int key) {
    constexpr int I = decltype(ic)::value;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<8 * Pieces<W>::groups(I)>(s + Pieces<W>::reg(I), kmajor<D>(q, kTcRows, 0, kk),
                                         kmajor<D>(k, W, key, kk), kk);
  });
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
}

// the accumulator layout: register 4 g + e of a thread holds row
// 16 warp + lane / 4 + 8 (e / 2), column 8 g + 2 (lane % 4) + e % 2

// The column map of a row of keys: 0 where the key is kept, -1e30 where it is
// masked, -inf past Lk. s * scale + c is then the scaled score (adding 0 keeps
// its one rounding), -1e30 (|s * scale| is far below half an ulp of 1e30, so
// the sum rounds to it, as the JAX kernels' where gives) or -inf: one FMA.
__device__ __forceinline__ float col_map(const int* mask, int j, int lk) {
  return j >= lk ? -INFINITY : (mask == nullptr || mask[j] > 0) ? 0.f : kNegInf;
}

// s = s * scale + the column map (cm: the window's first key)
template <int W>
__device__ __forceinline__ void window_mask(float (&s)[W / 2], const float* cm, int n8,
                                            float scale) {
  const int t4 = threadIdx.x & 3;
  for_pieces<W>(n8, [&](auto ic, int key) {
    constexpr int I = decltype(ic)::value, R = Pieces<W>::reg(I);
#pragma unroll
    for (int g = 0; g < Pieces<W>::groups(I); ++g) {
      const float2 c = *reinterpret_cast<const float2*>(cm + key + 8 * g + 2 * t4);
      float* x = s + R + 4 * g;
      x[0] = fmaf(x[0], scale, c.x);
      x[1] = fmaf(x[1], scale, c.y);
      x[2] = fmaf(x[2], scale, c.x);
      x[3] = fmaf(x[3], scale, c.y);
    }
  });
}

// mx = max(mx, the window's row max), agreed across the quad that holds a row;
// four partial maxima a row shorten the chain of dependent steps (a max is
// exact in any order)
template <int W>
__device__ __forceinline__ void window_max(float (&mx)[2], const float (&s)[W / 2], int n8) {
  float part[2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) part[0][k] = mx[0], part[1][k] = mx[1];
  for_pieces<W>(n8, [&](auto ic, int) {
    constexpr int I = decltype(ic)::value, R = Pieces<W>::reg(I);
#pragma unroll
    for (int g = 0; g < Pieces<W>::groups(I); ++g) {
      const int k = (R / 4 + g) & 3;
      part[0][k] = fmaxf(part[0][k], fmaxf(s[R + 4 * g], s[R + 4 * g + 1]));
      part[1][k] = fmaxf(part[1][k], fmaxf(s[R + 4 * g + 2], s[R + 4 * g + 3]));
    }
  });
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(fmaxf(part[e][0], part[e][1]), fmaxf(part[e][2], part[e][3]));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
  }
}

// s = exp(s - m) * alpha in place; sum (when given) += the thread's
// exponentials of each row, in four partial sums a row (8-key groups g, g + 4,
// .. in each) added in order
template <int W>
__device__ __forceinline__ void window_exp(float (&s)[W / 2], const float (&m)[2],
                                           const float (&alpha)[2], float* sum, int n8) {
  float part[2][4] = {};
  for_pieces<W>(n8, [&](auto ic, int) {
    constexpr int I = decltype(ic)::value, R = Pieces<W>::reg(I);
#pragma unroll
    for (int g = 0; g < Pieces<W>::groups(I); ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[R + 4 * g + e] - m[e >> 1]);
        part[e >> 1][(R / 4 + g) & 3] += x;
        s[R + 4 * g + e] = x * alpha[e >> 1];
      }
  });
  if (sum)
#pragma unroll
    for (int e = 0; e < 2; ++e) sum[e] += (part[e][0] + part[e][1]) + (part[e][2] + part[e][3]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two f32 rounded to bf16 (nearest even, as XLA's convert), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// The window's f32 probabilities rounded to bf16 as wgmma's A fragments:
// group g's two rows as p[2 g] and p[2 g + 1], so a k16 step over groups
// (g, g + 1) reads p[2 g .. 2 g + 3]. The 8-key piece pairs with zeros.
template <int W>
__device__ __forceinline__ void window_pack(uint32_t (&p)[W / 4], const float (&s)[W / 2],
                                            int n8) {
  for_pieces<W>(n8, [&](auto ic, int) {
    constexpr int I = decltype(ic)::value, R = Pieces<W>::reg(I);
#pragma unroll
    for (int g = 0; g < Pieces<W>::groups(I); ++g) {
      p[R / 2 + 2 * g] = pack_bf16(s[R + 4 * g], s[R + 4 * g + 1]);
      p[R / 2 + 2 * g + 1] = pack_bf16(s[R + 4 * g + 2], s[R + 4 * g + 3]);
    }
  });
  constexpr int RL = Pieces<W>::reg(Pieces<W>::n - 1) / 2;
  if (piece_used<W, Pieces<W>::n - 1>(n8)) p[RL + 2] = p[RL + 3] = 0u;
}

// o += P V over the window: p the packed probabilities, v the window's V tile
// of W rows (MN-major), a k16 step at a time (the 8-key piece's is half zeros)
template <int D, int W>
__device__ __forceinline__ void window_pv(float (&o)[D / 2], uint32_t (&p)[W / 4], uint32_t v,
                                          int n8) {
  wgmma_fence();
  for_pieces<W>(n8, [&](auto ic, int key) {
    constexpr int I = decltype(ic)::value, R = Pieces<W>::reg(I), G = Pieces<W>::groups(I);
#pragma unroll
    for (int j = 0; j < (G + 1) / 2; ++j)
      wgmma_rs<D>(o, p + R / 2 + 4 * j, mnmajor<D>(v, W, key + 16 * j));
  });
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(p);
}

// Writing a 64 x D accumulator out, rounded once: the accumulator layout's own
// stores would each touch eight rows (4 bytes a row; at 16x12x197 they took
// 1,600-2,100 of a unit's 10,000 cycles), so the tile goes through a staging
// tile in shared memory (64 rows of D + 8 bf16: a warp's writes fall in
// distinct banks) and out in 16-byte pieces along whole rows.
template <int D>
__host__ __device__ constexpr int stage_bytes() {
  return kTcRows * (D + 8) * 2;
}

// acc * alpha rounded to bf16 into the staging tile (rows 16 warp + lane / 4
// and + 8, columns 8 g + 2 (lane % 4) and + 1)
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* stage, const float (&acc)[D / 2],
                                           float alpha) {
  const int lane = threadIdx.x % 32, t4 = lane & 3, r = 16 * (threadIdx.x / 32 % 4) + lane / 4;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(stage + (r + 8 * e) * (D + 8) + 8 * g + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * g + 2 * e] * alpha, acc[4 * g + 2 * e + 1] * alpha);
}

// the staged tile's rows to rows row0.. of out (row stride sl) below n, 16
// bytes a thread at a time; after a barrier that follows stage_tile
template <int D>
__device__ __forceinline__ void copy_tile_out(__nv_bfloat16* out, long long sl, int row0, int n,
                                              const __nv_bfloat16* stage) {
  for (int c = threadIdx.x; c < kTcRows * (D / 8); c += 128) {
    const int row = c / (D / 8), col = c % (D / 8) * 8;
    if (row0 + row < n)
      *reinterpret_cast<uint4*>(out + (row0 + row) * sl + col) =
          *reinterpret_cast<const uint4*>(stage + row * (D + 8) + col);
  }
}

// a unit's (query tile, head, batch), query tile fastest
struct TcUnit {
  int t, h, b;
};
__device__ __forceinline__ TcUnit tc_unit(int u, int tiles, int heads) {
  return {u % tiles, u / tiles % heads, u / tiles / heads};
}

struct SdpaFwdMaps {
  CUtensorMap q, k, v;  // boxes of 64 query rows; of a window's keys (sdpa_kv_rows)
};

// The keys a K or V box holds: a whole window, or the row of a single
// window rounded up to 16 (the last k16 step), so a short row's loads are no
// longer than its keys (every row a product reads lies inside the box).
__host__ __device__ inline int sdpa_kv_rows(int lk, int w) {
  return lk > w ? w : (lk + 15) / 16 * 16;
}

// The forward's shared memory from a 1024-byte aligned base: Q (64 rows), a
// ring of kStagesK K windows, a V window (W rows each), O's staging tile, then
// a barrier per tile, then the column map of whole windows. 128-key windows
// at head dims up to 64 take two K stages, so a window's scores start as soon
// as the window before them is done (past 256 keys, and for the next unit's)
// and three blocks still share an SM; the rest take one.
template <int D, int W>
struct FwdLayout {
  static constexpr int kStagesK = W == 128 && D <= 64 ? 2 : 1;
  static constexpr int kWin = tc_tile_bytes<D>(W);
  static constexpr int q = 0, k = tc_tile_bytes<D>(kTcRows), v = k + kStagesK * kWin;
  static constexpr int out = v + kWin, bars = out + stage_bytes<D>();
  static constexpr int cols = bars + (2 + kStagesK) * 8;
};
template <int D, int W>
__host__ inline size_t fwd_smem_bytes(int lk) {
  return 1024 + FwdLayout<D, W>::cols + sizeof(float) * (size_t)((lk + W - 1) / W * W);
}

// TMA fills the three buffers (Q, the K ring, V); the barrier of a stage
// takes thread 0's expect_tx, then TMA's bytes. A buffer's loads and uses run
// in one order, each counted, so the count gives a use its stage and its
// wait's parity.
enum FwdBuffer { kBufQ = 0, kBufK = 1, kBufV = 2 };

constexpr int kFwdThreads = 128;  // one warpgroup (the design note above)

template <int D, int W>
__global__ void __launch_bounds__(kFwdThreads, W == 256 || D == 128 ? 2 : 3)
    sdpa_fwd_wg_kernel(const __grid_constant__ SdpaFwdMaps maps, const SdpaArgs a, int units,
                       int head_inner) {
  using L = FwdLayout<D, W>;
  constexpr int S = L::kStagesK;
  extern __shared__ __align__(1024) unsigned char tsmem[];
  const uint32_t raw = smem_addr(tsmem), pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t base = raw + pad, bars = base + L::bars;
  float* cm = reinterpret_cast<float*>(tsmem + pad + L::cols);
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(tsmem + pad + L::out);
  const int stages[3] = {1, S, 1};
  const uint32_t first[3] = {base + L::q, base + L::k, base + L::v};
  const int tile_rows[3] = {kTcRows, W, W};
  const int kv = tc_tile_bytes<D>(sdpa_kv_rows(a.lk, W));  // a K or V box's bytes
  const int bytes[3] = {tc_tile_bytes<D>(kTcRows), kv, kv};
  // barrier of stage st of a buffer, and its tile
  auto full = [&](int buf, int st) {
    return bars + 8 * (buf == kBufQ ? 0 : buf == kBufK ? 1 + st : 1 + S);
  };
  auto tile = [&](int buf, int st) {
    return first[buf] + st * tc_tile_bytes<D>(tile_rows[buf]);
  };
  const int tiles = (a.lq + kTcRows - 1) / kTcRows, nwin = (a.lk + W - 1) / W;
  const int last8 = (a.lk - (nwin - 1) * W + 7) / 8;  // 8-key groups of the last window
  const bool want_o = a.o != nullptr;
  // one window holds the whole key row (the launch takes W = 256 only then)
  const bool single = W == 256 || nwin == 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + S; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    prefetch_tensormap(&maps.q);
    prefetch_tensormap(&maps.k);
    if (want_o) prefetch_tensormap(&maps.v);
  }
  __syncthreads();

  // Each buffer's loads, in the order the block uses them: Q once a unit; K
  // per window (twice over past one window when O is wanted: a sweep for the
  // statistics, one for P); V per window when O is wanted. Thread 0 issues a
  // stage's next load as soon as the warpgroup is done with it, so the next
  // window's or unit's Q, K and V arrive while this one is formed.
  const int per[3] = {1, single ? 1 : want_o ? 2 * nwin : nwin, want_o ? nwin : 0};
  const CUtensorMap* map[3] = {&maps.q, &maps.k, &maps.v};
  int next_u[3] = {(int)blockIdx.x, (int)blockIdx.x, (int)blockIdx.x};  // the next load's unit
  int next_j[3] = {0, 0, 0};                                           // and its place there
  uint32_t issued[3] = {0, 0, 0}, used[3] = {0, 0, 0};
  auto issue = [&](int buf) {
    if (next_u[buf] >= units || per[buf] == 0) return;
    if (threadIdx.x == 0) {
      const TcUnit n = tc_unit(next_u[buf], tiles, a.heads);
      const int st = issued[buf] % stages[buf];
      const int r0 = buf == kBufQ ? n.t * kTcRows : next_j[buf] % nwin * W;
      mbar_expect_tx(full(buf, st), bytes[buf]);
      tma_rows<D>(tile(buf, st), map[buf], full(buf, st), tile_rows[buf], r0, n.h, n.b,
                  head_inner);
    }
    ++issued[buf];
    if (++next_j[buf] == per[buf]) next_j[buf] = 0, next_u[buf] += gridDim.x;
  };
  // the tile of a buffer's next use, once it has arrived
  auto acquire = [&](int buf) {
    const int st = used[buf] % stages[buf];
    mbar_wait(full(buf, st), (used[buf] / stages[buf]) & 1);
    return tile(buf, st);
  };
  // done with a buffer's stage (every wgmma that reads it has completed): its next load
  auto release = [&](int buf) {
    ++used[buf];
    issue(buf);
  };
  issue(kBufQ);
  for (int i = 0; i < S; ++i) issue(kBufK);
  issue(kBufV);

  // rows 16 warp + lane / 4 and + 8 of the unit's 64
  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32) + (threadIdx.x & 31) / 4;
  float s[W / 2];
  uint32_t p[W / 4];
  float o[D / 2];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const TcUnit n = tc_unit(u, tiles, a.heads);
    const int* mask = a.mask ? a.mask + (long long)n.b * a.lk : nullptr;
    __syncthreads();  // every thread is past the last unit's column map and staged O
    for (int j = threadIdx.x; j < nwin * W; j += kFwdThreads) cm[j] = col_map(mask, j, a.lk);
    __syncthreads();

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const float one[2] = {1.f, 1.f};
    const uint32_t qs = acquire(kBufQ);
    if (single) {
      // the whole row at once: the exact max, one exponential per score
      window_scores<D, W>(s, qs, acquire(kBufK), last8);
      release(kBufK);
      release(kBufQ);
      window_mask<W>(s, cm, last8, a.scale);
      window_max<W>(m, s, last8);
      window_exp<W>(s, m, one, l, last8);
    } else {
      // sweep 1: the max and the sum, the sum rescaled once per window
      for (int w = 0; w < nwin; ++w) {
        const int n8 = w + 1 < nwin ? W / 8 : last8;
        window_scores<D, W>(s, qs, acquire(kBufK), n8);
        release(kBufK);
        if (w + 1 == nwin && !want_o) release(kBufQ);
        window_mask<W>(s, cm + w * W, n8, a.scale);
        float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
        window_max<W>(mx, s, n8);
        window_exp<W>(s, mx, one, sum, n8);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l[e] = l[e] * expf(m[e] - mx[e]) + sum[e];  // m = -inf before the first window: 0 * 0
          m[e] = mx[e];
        }
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const float rl[2] = {1.f / l[0], 1.f / l[1]};
    if (a.stats != nullptr && t4 == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = n.t * kTcRows + r + 8 * e;
        if (i < a.lq)
          *reinterpret_cast<float2*>(a.stats + (((long long)n.b * a.heads + n.h) * a.lq + i) * 2) =
              make_float2(m[e], l[e]);
      }
    if (!want_o) continue;

    if (single) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) s[i] *= rl[i / 2 % 2];  // P = e * (1 / l)
      window_pack<W>(p, s, last8);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      window_pv<D, W>(o, p, acquire(kBufV), last8);
      release(kBufV);
    } else {
      // sweep 2: S again, P from the final max and sum
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      for (int w = 0; w < nwin; ++w) {
        const int n8 = w + 1 < nwin ? W / 8 : last8;
        window_scores<D, W>(s, qs, acquire(kBufK), n8);
        release(kBufK);
        if (w + 1 == nwin) release(kBufQ);
        window_mask<W>(s, cm + w * W, n8, a.scale);
        window_exp<W>(s, m, rl, nullptr, n8);
        window_pack<W>(p, s, n8);
        window_pv<D, W>(o, p, acquire(kBufV), n8);
        release(kBufV);
      }
    }
    stage_tile<D>(staged, o, 1.f);
    __syncthreads();
    copy_tile_out<D>(static_cast<__nv_bfloat16*>(a.o) + n.b * a.o_sb + n.h * a.o_sh, a.o_sl,
                     n.t * kTcRows, a.lq, staged);
  }
}

// Whether the tensor-core kernels take these arguments: the dtype is the
// caller's test (elem: its bytes); a head dim they are built for, rows and
// pointers 16-byte aligned (so TMA can describe every operand).
inline bool sdpa_tc_fits(int d, std::initializer_list<long long> strides,
                         std::initializer_list<const void*> ptrs, int elem = 2) {
  if (d != 32 && d != 64 && (d != 128 || elem != 2)) return false;
  for (long long s : strides)
    if (s * elem % 16) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The 4D tensor map of a bf16 (elem 2) or f32 (elem 4) SDPA operand
// (element strides sb, sh, sl of batch, head and position; the head dim unit
// stride): head dim, then position and head in the order of their strides
// (the packed (B, L, H * D) layout has the head inside the position), then
// batch, so each stride is the one before it times its extent for both
// layouts the callers pass. Boxes of kCols columns (f32: 32) x `rows`
// positions of one head under the 64- or 128-byte swizzle; positions past
// `len` read as zeros.
inline bool encode_sdpa_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int batch,
                            int heads, int len, int d, long long sb, long long sh, long long sl,
                            int rows, int elem = 2) {
  const int cols = elem == 4 ? 32 : d < 64 ? d : 64;
  const bool hi = sh < sl;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(hi ? heads : len),
                              (cuuint64_t)(hi ? len : heads), (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)((hi ? sh : sl) * elem),
                                 (cuuint64_t)((hi ? sl : sh) * elem), (cuuint64_t)(sb * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, hi ? 1u : (cuuint32_t)rows,
                             hi ? (cuuint32_t)rows : 1u, 1u};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Resident blocks per SM of a kernel at its launch's block size and shared
// memory, or minus the CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = smem_opt_in(kernel, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// SMs x resident blocks of a kernel at this block size and shared memory
// (the opt-in set), looked up once per (device, kernel, size) and kept, so a
// launch adds no query to the host's enqueue.
template <typename Kernel>
inline cudaError_t resident_slots(Kernel* kernel, int threads, size_t smem, int* slots) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> seen;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(device, (const void*)kernel, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = seen.find(key);
    if (it != seen.end()) {
      *slots = it->second;
      return cudaSuccess;
    }
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n = blocks_per_sm(kernel, threads, smem);
  if (n <= 0) return n < 0 ? (cudaError_t)-n : cudaErrorInvalidConfiguration;
  std::lock_guard<std::mutex> lock(mu);
  seen[key] = *slots = sms * n;
  return cudaSuccess;
}

// The window: the whole row of 129 to 256 keys at head dim 64 (every model's),
// else 128 keys (at head dim 128 the output accumulator leaves no room for a
// 256-key row; past 256 keys, 128-key windows hold S, P and O in registers at
// three blocks an SM and measured faster than two 256-key windows, PERF.md).
__host__ inline int sdpa_tc_window(int d, int lk) { return d == 64 && lk > 128 && lk <= 256 ? 256 : 128; }

template <int D, int W>
cudaError_t launch_sdpa_wg(const SdpaArgs& a, int batch, cudaStream_t stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int hi = a.q_sh < a.q_sl;
  if ((a.k_sh < a.k_sl) != hi || (a.v_sh < a.v_sl) != hi) return cudaErrorInvalidValue;
  SdpaFwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode_sdpa_map(enc, &maps.q, a.q, batch, a.heads, a.lq, D, a.q_sb, a.q_sh, a.q_sl, kTcRows) ||
      !encode_sdpa_map(enc, &maps.k, a.k, batch, a.heads, a.lk, D, a.k_sb, a.k_sh, a.k_sl,
                       sdpa_kv_rows(a.lk, W)) ||
      !encode_sdpa_map(enc, &maps.v, a.v, batch, a.heads, a.lk, D, a.v_sb, a.v_sh, a.v_sl,
                       sdpa_kv_rows(a.lk, W)))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes<D, W>(a.lk);
  int slots = 0;
  cudaError_t err = resident_slots(sdpa_fwd_wg_kernel<D, W>, kFwdThreads, smem, &slots);
  if (err != cudaSuccess) return err;
  const int units = (a.lq + kTcRows - 1) / kTcRows * a.heads * batch;
  sdpa_fwd_wg_kernel<D, W><<<units < slots ? units : slots, kFwdThreads, smem, stream>>>(
      maps, a, units, hi);
  return cudaGetLastError();
}

// the tensor-core forward at head dim D and the window its arguments take
template <int D>
cudaError_t launch_sdpa_tc_d(const SdpaArgs& a, int batch, cudaStream_t stream) {
  if constexpr (D == 64)
    if (sdpa_tc_window(D, a.lk) == 256) return launch_sdpa_wg<D, 256>(a, batch, stream);
  return launch_sdpa_wg<D, 128>(a, batch, stream);
}

inline cudaError_t launch_sdpa_tc(const SdpaArgs& a, int batch, cudaStream_t stream) {
  if (a.d == 32) return launch_sdpa_tc_d<32>(a, batch, stream);
  if (a.d == 64) return launch_sdpa_tc_d<64>(a, batch, stream);
  if (a.d == 128) return launch_sdpa_tc_d<128>(a, batch, stream);
  return cudaErrorInvalidValue;
}

// ---- float32 on the tensor cores: a three-pass tf32 split, wgmma fed by TMA ----
//
// sdpa_fwd_f32_wg_kernel replaces the Pallas ops/attention.py::_fwd_kernel
// (TPU kernel 1) and ::_fwd_kernel_blocked (TPU kernel 3) for float32 at head
// dims 32 and 64 (the grid's float32 towers, ViLT exact in float32, the
// per-head blocks' float32 column slices), and writes the row statistics the
// float32 backward pair reads (sdpa_bwd_core.cuh).
//
// Float32 accuracy. The port's --dtype float32 promises float32 products (no
// TF32). Each product runs as three tf32 products: x = big + small with big =
// tf32_rna(x) (cvt.rna: wgmma's own read of raw bits truncates, twice the
// error) and small = tf32_rna(x - big); a b ~ a_s b_b + a_b b_s + a_b b_b in
// f32 accumulators, only small x small dropped (about 2^-22 of a b). A CPU
// emulation (tests/test_torch_sdpa_f32.py) and the card (chip_smoke.py's
// float32 accuracy gate) hold its error against float64 to within a small
// factor of the plain float32 version's; single-pass tf32 would be 1,000x off.
//
// What bounds it on the H100. At 16x12x197x197x64 the two products in three
// passes are 5.7 GFLOP (12 us at 495 TF32 TFLOP/s; S's second sweep adds
// half) against 38.7 MB of q, k, v and o (12 us at 3.35 TB/s); each staged
// operand also takes a pass on the CUDA cores to form its halves, and V one
// more to stand transposed, and a block waits on each product. So the CUDA
// cores' passes and the softmax beside the tensor cores bound it (0.105 ms,
// PERF.md).
//
// Design. A block is two warpgroups, 64 query rows each (wgmma's M), of one
// head and batch element, over one stream of K and V chunks (one block an SM:
// 192 KB of shared memory at D = 64; one warpgroup a block measured slower,
// PERF.md). Thread 0 keeps the two Q tiles, a ring of two K chunks (64 keys)
// and a ring of two raw V chunks in flight by TMA (64 rows x 128 bytes a box,
// the 128-byte swizzle; two boxes a row at D = 64), each behind an mbarrier.
// The block's 256 threads split each tile as it arrives, once for both
// warpgroups: Q and K in place (big where TMA wrote it, small one tile on: an
// elementwise pass that keeps the swizzle), V transposed into its own pair
// (.tf32 wgmma reads both shared-memory operands K-major; P V contracts over
// V's rows). Products, each warpgroup its own rows:
//   * S = Q K^T: wgmma_ss_tf32 x 3 per k8 step; a short last chunk in pieces
//     of 32, 16, 8 keys by the bits of its 8-key groups (197 keys are 3 x 64
//     + 8, not 4 x 64);
//   * O += P V: P split in registers (big in place, small beside it) as the A
//     operand, straight from the accumulator layout: its 8-key group holds
//     keys 2t and 2t + 1 where the A fragment wants k columns t and t + 4, so
//     the transposed V stages each group's keys in that order (kcol_of) and
//     the registers go in as they are.
// A thread holds one chunk's scores (32 f32) beside O and the chunk's
// accumulator: the row takes two sweeps, the max and sum chunk by chunk (the
// sum rescaled as the max grows), then S again for P (a row of 64 keys or
// fewer: once). The numerics are the bf16 kernel's (its note above), with no
// rounding of P (float32). (Four chunks' scores in registers, for one
// exponential a score up to 256 keys, spilled at 255 registers and
// serialized the wgmmas: 0.261 ms at 16x12x197.)

// A 64-row f32 tile of head dim D: D / 32 TMA boxes of 64 rows x 128 bytes
// (32 floats) under the 128-byte swizzle. A split pair is the tile (big)
// then its small half one tile on.
template <int D>
struct F32Tile {
  static constexpr int kBoxes = D / 32;
  static constexpr int kBytes = 64 * D * 4;
};

// rows r0 .. r0 + 63 of head h, batch b of an operand into the tile at dst
template <int D>
__device__ __forceinline__ void tma_rows_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int r0, int h, int b, int head_inner) {
#pragma unroll
  for (int c = 0; c < F32Tile<D>::kBoxes; ++c) {
    const uint32_t at = dst + c * 64 * 128;
    if (head_inner)
      tma_load_4d(at, map, bar, c * 32, h, r0, b);
    else
      tma_load_4d(at, map, bar, c * 32, r0, h, b);
  }
}

// The descriptor of k8 step kk of a K-major f32 operand: rows from r0 (a
// multiple of 8) of a tile in blocks of `rows` rows x 128 bytes, kk / 4 the
// block. A 64-row tile has rows = 64 (kk over the head dim); a transposed
// pair rows = D (kk over the 64 positions).
__device__ __forceinline__ uint64_t kmajor_f32(uint32_t tile, int rows, int r0, int kk) {
  return wg_desc(tile + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32, 128, 16);
}

// x = its tf32 rounding, in place; returns the remainder's
__device__ __forceinline__ uint32_t split_tf32(float& x) {
  const uint32_t big = tf32_rna(x);
  const uint32_t small = tf32_rna(x - __uint_as_float(big));
  x = __uint_as_float(big);
  return small;
}

// The first `rows` rows of every box of the 64-row tile at `tile`, split in
// place by the block's NT threads: big over the value, small one tile on.
template <int D, int NT = 128>
__device__ __forceinline__ void split_tile(unsigned char* tile, int rows) {
  constexpr int T = F32Tile<D>::kBytes;
#pragma unroll
  for (int c = 0; c < F32Tile<D>::kBoxes; ++c) {
    float4* big = reinterpret_cast<float4*>(tile + c * 64 * 128);
    uint4* small = reinterpret_cast<uint4*>(tile + T + c * 64 * 128);
    for (int i = threadIdx.x; i < rows * 8; i += NT) {
      float4 x = big[i];
      uint4 s;
      s.x = split_tf32(x.x);
      s.y = split_tf32(x.y);
      s.z = split_tf32(x.z);
      s.w = split_tf32(x.w);
      big[i] = x;
      small[i] = s;
    }
  }
  fence_proxy_async();
}

// Where position j of a 64-position chunk stands along K in a transposed
// pair: a k8 step's A fragment taken from the accumulator layout holds, at k
// columns t and t + 4, the group's positions 2 t and 2 t + 1.
__device__ __forceinline__ int kcol_of(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 6) >> 1);
}

// The transposed pair at dst of positions j < n of the 64-row tile at src:
// D rows (head-dim columns) of the 64 positions in kcol_of order, two blocks
// of 32 positions (D rows x 128 bytes, the 128-byte swizzle), big then small
// one tile on; from a raw tile (SPLIT: split here) or a split pair, by the
// block's NT threads. A warp takes 32 positions of one block: 16-byte reads
// and 4-byte writes, each free of bank conflicts.
template <int D, bool SPLIT, int NT = 128>
__device__ __forceinline__ void transpose_tile(unsigned char* dst, const unsigned char* src, int n) {
  constexpr int T = F32Tile<D>::kBytes;
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32 + 32 * (warp & 1);
  if (j < n) {
    const int p = kcol_of(j), at_p = (p >> 5) * D * 128 + (p & 31) * 4;
#pragma unroll
    for (int qd = warp >> 1; qd < D / 4; qd += NT / 64) {
      const int d0 = 4 * qd;
      const int at = (d0 >> 5) * 64 * 128 + j * 128 + (((d0 & 31) * 4) ^ ((j & 7) << 4));
      float4 x = *reinterpret_cast<const float4*>(src + at);
      uint4 s;
      if (SPLIT) {
        s.x = split_tf32(x.x);
        s.y = split_tf32(x.y);
        s.z = split_tf32(x.z);
        s.w = split_tf32(x.w);
      } else {
        s = *reinterpret_cast<const uint4*>(src + T + at);
      }
      const float xb[4] = {x.x, x.y, x.z, x.w};
      const uint32_t xs[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + e, o = (at_p + d * 128) ^ ((d & 7) << 4);
        *reinterpret_cast<float*>(dst + o) = xb[e];
        *reinterpret_cast<uint32_t*>(dst + T + o) = xs[e];
      }
    }
  }
  fence_proxy_async();
}

// The order of a product's terms. The tensor cores add each wgmma's eight
// products to the accumulator with truncation, an error of up to an ulp of
// the accumulator's magnitude per wgmma. So every product below issues its
// cross terms (a_s b_b, a_b b_s; about 2^-11 of the result) first, while
// the accumulator is still that small, and the big terms (a_b b_b) after:
// three wgmmas per k8 step, and the error of about one. (Measured on the
// H100: issued in step order, the error was 4-7x the plain float32 version's;
// PERF.md.)

// c (64 x 8 n8) = A B^T over the head dim in three tf32 passes, A and B split
// pairs of 64-row tiles (K-major), the 8 n8 rows of B from row 0 in
// window_scores's pieces (W = 64: n8 = 8 is one product); issued, not waited on
template <int D>
__device__ __forceinline__ void nt_pieces_f32(float (&c)[32], uint32_t a, uint32_t b, int n8) {
  constexpr int T = F32Tile<D>::kBytes;
  for_pieces<64>(n8, [&](auto ic, int key) {
    constexpr int I = decltype(ic)::value, N = 8 * Pieces<64>::groups(I), R = Pieces<64>::reg(I);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t ab = kmajor_f32(a, 64, 0, kk), as = kmajor_f32(a + T, 64, 0, kk);
      const uint64_t bb = kmajor_f32(b, 64, key, kk), bs = kmajor_f32(b + T, 64, key, kk);
      wgmma_ss_tf32<N>(c + R, as, bb, kk);
      wgmma_ss_tf32<N>(c + R, ab, bs, 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_ss_tf32<N>(c + R, kmajor_f32(a, 64, 0, kk), kmajor_f32(b, 64, key, kk), 1);
  });
}

// the pieces' f32 values split: big halves in xb, small in sm (as the b32
// registers wgmma reads, formed before its fence: a conversion after it
// would make the compiler serialize the wgmmas)
__device__ __forceinline__ void split_pieces(const float (&x)[32], uint32_t (&xb)[32],
                                             uint32_t (&sm)[32], int n8) {
  for_pieces<64>(n8, [&](auto ic, int) {
    constexpr int I = decltype(ic)::value, R = Pieces<64>::reg(I);
#pragma unroll
    for (int i = 0; i < 4 * Pieces<64>::groups(I); ++i) {
      xb[R + i] = tf32_rna(x[R + i]);
      sm[R + i] = tf32_rna(x[R + i] - __uint_as_float(xb[R + i]));
    }
  });
}

// acc (64 x D) += A B over 8 n8 positions in three tf32 passes, cross terms
// first: A the pieces' values in the accumulator layout, split (split_pieces:
// big in xb, small in sm), B the transposed pair bt; issued, not waited on
// (xb and sm stay put until then). Callers sum a chunk into a zeroed
// accumulator and add it to the running one in f32, so the truncation is the
// chunk's.
template <int D>
__device__ __forceinline__ void nn_pieces_f32(float (&acc)[D / 2], const uint32_t (&xb)[32],
                                              const uint32_t (&sm)[32], uint32_t bt, int n8) {
  constexpr int T = F32Tile<D>::kBytes;
  // group g's A fragment: rows r, r + 8 at k columns t and t + 4 (kcol_of)
  auto frag = [](uint32_t (&f)[4], const uint32_t (&x)[32], int i) {
    f[0] = x[i];
    f[1] = x[i + 2];
    f[2] = x[i + 1];
    f[3] = x[i + 3];
  };
  for_pieces<64>(n8, [&](auto ic, int key) {
    constexpr int I = decltype(ic)::value, R = Pieces<64>::reg(I);
#pragma unroll
    for (int g = 0; g < Pieces<64>::groups(I); ++g) {
      uint32_t big[4], small[4];
      frag(big, xb, R + 4 * g);
      frag(small, sm, R + 4 * g);
      wgmma_rs_tf32<D>(acc, small, kmajor_f32(bt, D, 0, key / 8 + g));
      wgmma_rs_tf32<D>(acc, big, kmajor_f32(bt + T, D, 0, key / 8 + g));
    }
  });
  for_pieces<64>(n8, [&](auto ic, int key) {
    constexpr int I = decltype(ic)::value, R = Pieces<64>::reg(I);
#pragma unroll
    for (int g = 0; g < Pieces<64>::groups(I); ++g) {
      uint32_t big[4];
      frag(big, xb, R + 4 * g);
      wgmma_rs_tf32<D>(acc, big, kmajor_f32(bt, D, 0, key / 8 + g));
    }
  });
}

// The forward's block: two warpgroups, 64 query rows each, over one K and V
// stream (each chunk split and transposed once for 128 rows, by 256 threads).
constexpr int kF32FwdWgs = 2;
constexpr int kF32FwdThreads = 128 * kF32FwdWgs;
constexpr int kF32FwdRows = 64 * kF32FwdWgs;

// The forward's shared memory from a 1024-byte aligned base: the warpgroups'
// Q pairs, the K ring (two pairs), the raw V ring (two tiles), V's transposed
// pair, the five barriers, then the column map of whole chunks.
template <int D>
struct F32FwdLayout {
  static constexpr int T = F32Tile<D>::kBytes;
  static constexpr int q = 0, k = 2 * kF32FwdWgs * T, v = k + 4 * T, vt = v + 2 * T;
  static constexpr int bars = vt + 2 * T, cols = bars + 64;
};
template <int D>
__host__ inline size_t fwd_f32_smem_bytes(int lk) {
  return 1024 + F32FwdLayout<D>::cols + sizeof(float) * (size_t)((lk + 63) / 64 * 64);
}

template <int D>
__global__ void __launch_bounds__(kF32FwdThreads, 1)
    sdpa_fwd_f32_wg_kernel(const __grid_constant__ SdpaFwdMaps maps, const SdpaArgs a,
                           int head_inner) {
  using L = F32FwdLayout<D>;
  constexpr int T = L::T, NT = kF32FwdThreads;
  extern __shared__ __align__(1024) unsigned char tsmem[];
  const uint32_t raw = smem_addr(tsmem), pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* sm = tsmem + pad;
  const uint32_t base = raw + pad, bars = base + L::bars;
  float* cm = reinterpret_cast<float*>(sm + L::cols);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, wg = threadIdx.x / 128;
  const int nc = (a.lk + 63) / 64;
  const int last8 = (a.lk - (nc - 1) * 64 + 7) / 8;  // 8-key groups of the last chunk
  // one chunk holds the whole key row: its scores are formed once
  const bool want_o = a.o != nullptr, single = nc == 1;
  // K is read once a chunk, twice when O is wanted past one chunk; V once
  const int kuses = want_o && !single ? 2 * nc : nc, vuses = want_o ? nc : 0;
  const int* mask = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  // barriers: Q, the K ring's two stages, the V ring's two
  auto bar_k = [&](int i) { return bars + 8 * (1 + (i & 1)); };
  auto bar_v = [&](int i) { return bars + 8 * (3 + (i & 1)); };
  auto issue_k = [&](int i) {  // K use i (chunk i % nc) into stage i % 2
    if (threadIdx.x != 0 || i >= kuses) return;
    mbar_expect_tx(bar_k(i), T);
    tma_rows_f32<D>(base + L::k + (i & 1) * 2 * T, &maps.k, bar_k(i), i % nc * 64, h, b,
                    head_inner);
  };
  auto issue_v = [&](int i) {  // V chunk i into stage i % 2
    if (threadIdx.x != 0 || i >= vuses) return;
    mbar_expect_tx(bar_v(i), T);
    tma_rows_f32<D>(base + L::v + (i & 1) * T, &maps.v, bar_v(i), i * 64, h, b, head_inner);
  };
  // the warpgroups with rows below Lq load their Q tile; one past them (a
  // last tile of 64 rows or fewer) is zeroed instead (no TMA box lies wholly
  // outside the tensor) and computes rows that are never stored
  const int nq = (a.lq - qt * kF32FwdRows + 63) / 64 < kF32FwdWgs
                     ? (a.lq - qt * kF32FwdRows + 63) / 64 : kF32FwdWgs;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    mbar_expect_tx(bars, nq * T);
    for (int w = 0; w < nq; ++w)
      tma_rows_f32<D>(base + L::q + w * 2 * T, &maps.q, bars, qt * kF32FwdRows + 64 * w, h, b,
                      head_inner);
    issue_k(0);
    issue_k(1);
    issue_v(0);
    issue_v(1);
  }
  for (int w = nq; w < kF32FwdWgs; ++w)
    for (int i = threadIdx.x; i < T / 16; i += NT)
      reinterpret_cast<float4*>(sm + L::q + w * 2 * T)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = threadIdx.x; j < nc * 64; j += NT) cm[j] = col_map(mask, j, a.lk);
  __syncthreads();
  mbar_wait(bars, 0);
  for (int w = 0; w < kF32FwdWgs; ++w) split_tile<D, NT>(sm + L::q + w * 2 * T, 64);
  __syncthreads();

  const uint32_t qs = base + L::q + wg * 2 * T;  // this warpgroup's Q pair
  int ku = 0, vu = 0;  // K and V uses so far
  // S of chunk c (n8 groups of keys) from the next K use into s, scaled and masked
  auto scores = [&](float (&s)[32], int c, int n8) {
    const int off = L::k + (ku & 1) * 2 * T;
    mbar_wait(bar_k(ku), (ku >> 1) & 1);
    split_tile<D, NT>(sm + off, 8 * n8);
    __syncthreads();
    wgmma_fence();
    nt_pieces_f32<D>(s, qs, base + off, n8);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    __syncthreads();  // every warp is done with the stage
    issue_k(ku + 2);
    ++ku;
    window_mask<64>(s, cm + 64 * c, n8, a.scale);
  };
  // o += P V over the next V chunk (n8 groups): V transposed and split, P
  // split, the chunk summed apart (oc) and added in f32
  float o[D / 2], oc[D / 2];
  auto pv = [&](float (&p)[32], int n8) {
    mbar_wait(bar_v(vu), (vu >> 1) & 1);
    transpose_tile<D, true, NT>(sm + L::vt, sm + L::v + (vu & 1) * T, 8 * n8);
    __syncthreads();  // V's raw stage is read, its pair written
    issue_v(vu + 2);
    ++vu;
    uint32_t pb[32], psm[32];
    split_pieces(p, pb, psm, n8);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oc[i] = 0.f;
    wgmma_fence();
    nn_pieces_f32<D>(oc, pb, psm, base + L::vt, n8);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(oc);
    fence_regs(pb);
    fence_regs(psm);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += oc[i];
    __syncthreads();  // every warp is done with the pair before the next one
  };
  auto n8_of = [&](int c) { return c + 1 < nc ? 8 : last8; };

  // rows 16 warp + lane / 4 and + 8 of the warpgroup's 64
  const int t4 = threadIdx.x & 3, r = 16 * (threadIdx.x / 32 % 4) + (threadIdx.x & 31) / 4;
  const int row0 = qt * kF32FwdRows + 64 * wg;
  float s[32] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float one[2] = {1.f, 1.f};
  // sweep 1: the max and the sum, chunk by chunk, the sum rescaled as the max
  // grows (a single chunk: its exact max, s left holding exp(s - m))
  for (int c = 0; c < nc; ++c) {
    const int n8 = n8_of(c);
    scores(s, c, n8);
    float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
    window_max<64>(mx, s, n8);
    window_exp<64>(s, mx, one, sum, n8);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] = l[e] * expf(m[e] - mx[e]) + sum[e];  // m = -inf before the first chunk: 0 * 0
      m[e] = mx[e];
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float rl[2] = {1.f / l[0], 1.f / l[1]};
  if (a.stats != nullptr && t4 == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = row0 + r + 8 * e;
      if (i < a.lq)
        *reinterpret_cast<float2*>(a.stats + (((long long)b * a.heads + h) * a.lq + i) * 2) =
            make_float2(m[e], l[e]);
    }
  if (!want_o) return;

  // sweep 2: S again, P from the final max and sum, O += P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int n8 = n8_of(c);
    if (single) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= rl[j / 2 % 2];  // P = e * (1 / l)
    } else {
      scores(s, c, n8);
      window_exp<64>(s, m, rl, nullptr, n8);
    }
    pv(s, n8);
  }
  // O's rows below Lq: a float2 a thread per 8-column group and row
  float* out = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = row0 + r + 8 * e;
    if (i < a.lq)
#pragma unroll
      for (int g = 0; g < D / 8; ++g)
        *reinterpret_cast<float2*>(out + i * a.o_sl + 8 * g + 2 * t4) =
            make_float2(o[4 * g + 2 * e], o[4 * g + 2 * e + 1]);
  }
}

// Whether the float32 tensor-core kernels take these arguments: a head dim
// of 32 or 64, more than kRowMaxLq query rows, rows and pointers 16-byte
// aligned.
inline bool sdpa_f32_tc_fits(const SdpaArgs& a) {
  return (a.d == 32 || a.d == 64) && a.lq > kRowMaxLq &&
         sdpa_tc_fits(a.d, {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl, a.v_sb, a.v_sh,
                            a.v_sl, a.o_sb, a.o_sh, a.o_sl},
                      {a.q, a.k, a.v, a.o}, 4);
}

template <int D>
cudaError_t launch_sdpa_f32_wg(const SdpaArgs& a, int batch, cudaStream_t stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int hi = a.q_sh < a.q_sl;
  if ((a.k_sh < a.k_sl) != hi || (a.v_sh < a.v_sl) != hi) return cudaErrorInvalidValue;
  SdpaFwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode_sdpa_map(enc, &maps.q, a.q, batch, a.heads, a.lq, D, a.q_sb, a.q_sh, a.q_sl, 64, 4) ||
      !encode_sdpa_map(enc, &maps.k, a.k, batch, a.heads, a.lk, D, a.k_sb, a.k_sh, a.k_sl, 64, 4) ||
      !encode_sdpa_map(enc, &maps.v, a.v, batch, a.heads, a.lk, D, a.v_sb, a.v_sh, a.v_sl, 64, 4))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_f32_smem_bytes<D>(a.lk);
  const cudaError_t err = smem_opt_in(sdpa_fwd_f32_wg_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  sdpa_fwd_f32_wg_kernel<D><<<dim3((a.lq + kF32FwdRows - 1) / kF32FwdRows, a.heads, batch),
                              kF32FwdThreads, smem, stream>>>(maps, a, hi);
  return cudaGetLastError();
}

inline cudaError_t launch_sdpa_f32_tc(const SdpaArgs& a, int batch, cudaStream_t stream) {
  if (a.d == 32) return launch_sdpa_f32_wg<32>(a, batch, stream);
  if (a.d == 64) return launch_sdpa_f32_wg<64>(a, batch, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_sdpa(const SdpaArgs& a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.lq > kRowMaxLq &&
        sdpa_tc_fits(a.d, {a.q_sb, a.q_sh, a.q_sl, a.k_sb, a.k_sh, a.k_sl, a.v_sb, a.v_sh,
                           a.v_sl, a.o_sb, a.o_sh, a.o_sl},
                     {a.q, a.k, a.v, a.o}))
      return launch_sdpa_tc(a, batch, stream);
  } else {
    if (sdpa_f32_tc_fits(a)) return launch_sdpa_f32_tc(a, batch, stream);
  }
  if (a.stats != nullptr) return cudaErrorInvalidValue;  // only the tensor-core kernels write them
  if (a.lq <= kRowMaxLq) {
    const size_t smem = sizeof(float) * ((size_t)a.d + a.lk);
    cudaError_t err = smem_opt_in(sdpa_fwd_row_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    sdpa_fwd_row_kernel<T><<<dim3(a.lq, a.heads, batch), kRowThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sdpa_smem_bytes(a.lk);
  cudaError_t err = smem_opt_in(sdpa_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.heads, batch);
  sdpa_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace smtc
