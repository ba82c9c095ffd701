// Tiled GEMMs of the fused attention blocks and of their weight gradients,
// shared by attn_block_fwd.cu, attn_block_bwd.cu and the per-head variant
// (attn_block_perhead_*.cu).
//
// Three orientations, all with f32 accumulation and one rounding of the
// result to the activation dtype:
//   * "NT" with a bias epilogue: C_z = A (M, K) . W_z^T + b_z, W_z stored
//     (N, K) row-major -- the nn.Linear (out, in) layout. This is x . W for a
//     flax (in, out) kernel W: the QKV and out projections of the forward,
//     and the q/k/v recompute of the backward. The bias may be absent, and C
//     may be written head-banked, (B, heads, L, N / heads), instead of (M, N)
//     row-major.
//   * "NN" summed over pairs: C = sum_z A_z (M, K) . W_z (K, N), W_z stored
//     (K, N) row-major. With W_z a Linear's (out, in) weight this is
//     g . W^T for the flax kernel: dctx = dO . Wo^T and
//     dx = dq . Wq^T + dk . Wk^T + dv . Wv^T of the backward, the three
//     products of dx accumulated in the same registers.
//   * "TN", the weight gradients: C_z = G_z^T . X_z, G_z stored (K, M) and
//     X_z (K, N) row-major, K the B * L token rows. With (X_z, G_z) = (x, dq)
//     C_z is dWq in the Linear (out, in) layout, and likewise (x, dk),
//     (x, dv) and (ctx, dO): the wgrad products of the JAX package's
//     ops/attn_block.py::_attn_block2_bwd, up to four in one launch.
//
// bf16 runs all three on one persistent kernel, gemm_bf16_tma<mode>: Hopper's
// warpgroup tensor-core instruction, wgmma, fed by TMA loads into a swizzled
// shared-memory ring (design note below). float32 is plain FMA on the CUDA
// cores and only serves --dtype float32 (NT and NN; its weight gradients
// stay plain float32 products).

#pragma once

#include <atomic>
#include <stdint.h>
#include <string.h>

#include "sdpa_core.cuh"

namespace {

// the Hopper building blocks (hopper_core.cuh)
using smtc::EncodeTiledFn;
using smtc::encode_tiled;
using smtc::fence_acc;
using smtc::mbar_arrive;
using smtc::mbar_expect_tx;
using smtc::mbar_init;
using smtc::mbar_wait;
using smtc::named_sync;
using smtc::tma_load_2d;
using smtc::wgmma_commit;
using smtc::wgmma_fence;
using smtc::wgmma_wait;

enum GemmMode : int { kNT = 0, kNN = 1, kTN = 2 };

struct GemmArgs {
  const void* a[4];     // wgmma's A side: NT a[0] (M, K); NN A_z (M, K); TN G_z (K, M)
  const void* w[4];     // its B side: NT W_z (N, K); NN W_z (K, N); TN X_z (K, N)
  const void* bias[3];  // NT: (N,), or nullptr for none
  void* c[4];           // (M, N) row-major (NN: c[0] only); NT: head-banked when heads > 0
  float* partial;       // TN: the sliced tiles' f32 partial sums, 128 x 128 a slice
  int m, n, k;
  int len, heads;       // heads > 0: row m = b * len + l, column n = h * d + c of
                        // C land at ((b * heads + h) * len + l) * d + c, d = N / heads
  int splits;           // TN: slices of the K rows of a sliced tile (1: none)
  int whole;            // TN: the tiles before the sliced ones (both set by the launch)
};

// Offset of C's element (row, col) in the layout GemmArgs names.
__device__ __forceinline__ size_t gemm_c_offset(const GemmArgs& g, int row, int col) {
  if (g.heads == 0) return (size_t)row * g.n + col;
  const int d = g.n / g.heads;
  return (((size_t)(row / g.len) * g.heads + col / d) * g.len + row % g.len) * d + col % d;
}

// ---- bf16: wgmma fed by TMA ---------------------------------------------------
//
// A persistent kernel, one block per SM, walking work units: an output tile
// of 128 x 128 and its 64-deep k-steps (NT: z, then M, then N fastest; NN:
// the k-steps of all pairs in one sequence, pair z then z + 1; TN: z, then
// M, then N, and the last tiles in K slices, below). Three warpgroups:
//   * the producer (one thread of warpgroup 2) keeps a ring of kWStages
//     stages in flight: per stage the A side's tile (128 rows of M x 64 k)
//     and the B side's (128 of N x 64 k), 16 KB each, written by the copy
//     engine with the 128-byte swizzle and reported on the stage's `full`
//     mbarrier. A K-major operand (K contiguous: A and W of NT, A of NN) is
//     one TMA box of 128 rows x 64 k; an MN-major one (M or N contiguous: W
//     of NN, G and X of TN) two boxes of 64 k-rows x 64 columns, 8 KB each,
//     one per 64-wide half. Rows or columns past M, N or K are zero-filled
//     by TMA, so no tile needs a bounds check;
//   * two consumer warpgroups take the block's units in turn ("ping-pong"):
//     each waits on `full`, issues eight wgmma.mma_async.m64n128k16 per
//     k-step (bf16 in, the tile's two 64-row halves in f32 registers) straight
//     from the swizzled tiles through shared-memory descriptors, keeps one
//     k-step in flight and releases the stage before it on its `empty`
//     mbarrier, which the producer waits on before refilling it. An MN-major
//     operand sets wgmma's transpose bit and its descriptor's two strides:
//     8 KB between the 64-wide halves (leading) and 1 KB between groups of
//     8 k-rows (stride); a k16 step advances 32 bytes in a K-major tile and
//     2 KB in an MN-major one.
// The ring runs on across units, so while one warpgroup runs its epilogue
// the other's products keep the tensor cores busy. The bf16 epilogue adds
// the bias in f32 (NT), rounds once to bf16 into the warpgroup's staging rows
// in shared memory (from the accumulator layout: warp w of a warpgroup holds
// rows 16 w + l / 4 and + 8 of a half, lane l columns 2 (l % 4) + 8 j and + 1
// of the 8-column group j), then writes them to C row-major or head-banked
// (gemm_c_offset) in 16-byte chunks along the rows; written straight from
// the accumulator layout, each store touched eight rows and the epilogue
// took longer than the products (PERF.md). setmaxnreg moves registers from
// the producer (40) to the consumers (232), which hold 128 accumulators.
//
// TN's K is long (4,096 or 12,864 token rows) and its M x N short (768 x 768:
// 36 tiles a product, 144 for four, on 132 SMs): whole tiles alone would take
// two rounds, the second for 12 tiles. So the tiles that do not fill a last
// round (all of them when there are fewer than SMs) are cut along K into
// `splits` slices each (gemm_tn_splits: as many as fill the SMs once more,
// each at least 4 k-steps): the first `whole` units are whole tiles, the rest
// slices. A slice writes its f32 sum to its own 128 x 128 block of `partial`
// straight from the accumulators (each warp store 8 rows x 32 bytes, whole
// sectors), and gemm_split_sum adds a tile's slices in slice order and
// rounds once. The order is fixed, so two runs agree bit for bit: no float
// atomics. (Cutting every tile alike cost about 8 us of partial-sum traffic
// a slice at 4 x 768 x 768 and gained at most 7%; PERF.md.)
//
// TMA needs every row stride and base address 16-byte aligned: K a multiple
// of 8 for a K-major operand, M or N for an MN-major one, every operand
// 16-byte aligned. gemm_tma_fits refuses the rest from the arguments, before
// any launch. The tensor maps are encoded on the host per call, through the
// runtime's driver entry point (no -lcuda), and passed as __grid_constant__
// parameters.

constexpr int kWM = 128, kWN = 128, kWK = 64, kWStages = 4;
constexpr int kWConsumers = 2;                      // warpgroups, a whole tile each
constexpr int kWThreads = 128 * (kWConsumers + 1);  // + the producer warpgroup
// registers per thread after setmaxnreg: each quarter of the register file
// (16,384) holds one warp of each warpgroup, 40 + 2 x 232 of 512 per lane
constexpr int kWProducerRegs = 40, kWConsumerRegs = 232;
constexpr int kWTileBytes = kWM * kWK * 2;  // one operand tile: 16 KB (kWN == kWM)
constexpr int kWStageBytes = 2 * kWTileBytes;
// each consumer warpgroup's 128 output rows in bf16, rows padded by 16 bytes
// so that the accumulator layout's writes fall in distinct banks
constexpr int kWOutLd = kWN + 8;
constexpr int kWOutBytes = kWConsumers * kWM * kWOutLd * 2;
// the ring, the output staging, 1 KB of slack to align the ring to the
// swizzle's 1024-byte period, and the full and empty barriers: 197 KB
constexpr int kWSmemBytes = kWStages * kWStageBytes + kWOutBytes + 1024 + 2 * kWStages * 8;
constexpr int kMaxSplits = 16;

// which operands are MN-major (their M or N contiguous in memory)
template <int kMode>
struct GemmMajor {
  static constexpr bool a = kMode == kTN;  // G_z (K, M)
  static constexpr bool w = kMode != kNT;  // W_z (K, N) of NN, X_z (K, N) of TN
};

struct GemmMaps {
  CUtensorMap a[4];  // K-major: boxes of kWM rows x kWK; MN-major: kWK rows x 64
  CUtensorMap w[4];
};

// One stage's operand tile: rows r0.. r0 + 127 of M or N at k-steps from kc.
// K-major: one box of 128 rows x 64 k; MN-major: two boxes of 64 k-rows x 64
// columns, the halves r0 and r0 + 64, 8 KB apart.
template <bool kMN>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int kc, int r0) {
  if (kMN) {
    tma_load_2d(dst, map, bar, r0, kc);
    tma_load_2d(dst + kWTileBytes / 2, map, bar, r0 + 64, kc);
  } else {
    tma_load_2d(dst, map, bar, kc, r0);
  }
}

// wgmma descriptors under the 128-byte swizzle, from a 1024-byte aligned
// address. K-major: 128-byte rows of k, 1024 bytes between 8-row groups, the
// leading offset unused (a k16 step stays inside a row); a k16 step adds 2
// to the encoded address (32 bytes). MN-major: rows of 64 M or N per k, 1024
// bytes between groups of 8 k-rows (stride), 8 KB between the 64-wide halves
// (leading); a k16 step adds 128 (2 KB).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((kWTileBytes / 2) >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
template <bool kMN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return kMN ? sw128_mn_desc(addr) : sw128_desc(addr);
}
template <bool kMN>
constexpr uint64_t kK16Step = kMN ? 2048 >> 4 : 32 >> 4;

// the hand-over between the two consumer warpgroups (ids 3 and 4): one
// arrives, the other waits, 256 threads in all
__device__ __forceinline__ void handover_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void handover_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128), or = when accumulate is
// 0; kTA / kTB: A / B MN-major (wgmma's transpose bits)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p_acc;\n"
      "setp.ne.b32 p_acc, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p_acc, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
}

// A work unit: output tile (m0, n0) of product z and its k-steps
// [k0, k0 + steps) (NN: of the sequence over all pairs); `slice` is the K
// slice of a sliced TN tile (its block of `partial`), -1 for a whole tile.
struct GemmUnit {
  int z, slice, m0, n0, k0, steps;
};

template <int kMode>
__device__ __forceinline__ GemmUnit gemm_unit(const GemmArgs& g, int count, int t, int tiles_m,
                                              int tiles_n, int nk) {
  const int per = tiles_m * tiles_n, r = t % per, q = t / per;
  GemmUnit u;
  u.m0 = r / tiles_n * kWM;
  u.n0 = r % tiles_n * kWN;
  if (kMode == kNT) {
    u.z = q, u.slice = 0, u.k0 = 0, u.steps = nk;
  } else if (kMode == kNN) {
    u.z = 0, u.slice = 0, u.k0 = 0, u.steps = count * nk;
  } else if (t < g.whole) {
    u.z = q, u.slice = -1, u.k0 = 0, u.steps = nk;
  } else {
    const int j = t - g.whole, tile = g.whole + j / g.splits;
    u.z = tile / per;
    u.m0 = tile % per / tiles_n * kWM;
    u.n0 = tile % per % tiles_n * kWN;
    u.slice = j;
    u.k0 = j % g.splits * nk / g.splits;
    u.steps = (j % g.splits + 1) * nk / g.splits - u.k0;
  }
  return u;
}

template <int kMode>
__host__ __device__ __forceinline__ int gemm_units(const GemmArgs& g, int count, int tiles_m, int tiles_n) {
  const int per = tiles_m * tiles_n;
  return kMode == kNT ? per * count : kMode == kNN ? per
                                     : g.whole + (per * count - g.whole) * g.splits;
}

template <int kMode>
__global__ void __launch_bounds__(kWThreads, 1)
    gemm_bf16_tma(const __grid_constant__ GemmMaps maps, const GemmArgs g, int count) {
  constexpr bool kAmn = GemmMajor<kMode>::a, kWmn = GemmMajor<kMode>::w;
  extern __shared__ __align__(1024) unsigned char wsmem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(wsmem));
  const uint32_t pad = ((base + 1023) & ~1023u) - base;
  const uint32_t ring = base + pad;
  // the output staging, [kWConsumers][kWM][kWOutLd] bf16, after the ring
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(wsmem + pad + kWStages * kWStageBytes);
  const uint32_t bars = ring + kWStages * kWStageBytes + kWOutBytes;  // full[s], empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWStages + s); };
  const int tiles_m = (g.m + kWM - 1) / kWM, tiles_n = (g.n + kWN - 1) / kWN;
  const int units = gemm_units<kMode>(g, count, tiles_m, tiles_n), nk = (g.k + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 1);  // the consumer warpgroup of the stage's unit
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's units t = blockIdx.x + i gridDim.x go to warpgroup i % 2, and
  // their k-steps to consecutive ring steps.
  if (threadIdx.x >= 128 * kWConsumers) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProducerRegs));
    if (threadIdx.x != 128 * kWConsumers) return;
    for (int z = 0; z < count; ++z) {
      if (z == 0 || kMode != kNT)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.a[z]))
                     : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.w[z]))
                   : "memory");
    }
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < units; t += gridDim.x) {
      const GemmUnit u = gemm_unit<kMode>(g, count, t, tiles_m, tiles_n, nk);
      for (int j = 0; j < u.steps; ++j) {
        // NN walks the pairs in turn: pair j / nk at its k-step j % nk
        const int z = kMode == kNN ? j / nk : u.z;
        const int kc = (kMode == kNN ? j % nk : u.k0 + j) * kWK;
        mbar_wait(empty(s), phase ^ 1);  // the first pass over the ring finds it free
        mbar_expect_tx(full(s), kWStageBytes);
        const uint32_t st = ring + s * kWStageBytes;
        tma_tile<kAmn>(st, &maps.a[kMode == kNT ? 0 : z], full(s), kc, u.m0);
        tma_tile<kWmn>(st + kWTileBytes, &maps.w[z], full(s), kc, u.n0);
        if (++s == kWStages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup cw: the tile's rows 0-63 in lo, 64-127 in hi; while
  // one warpgroup runs its epilogue, the other's products keep the tensor
  // cores busy
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsumerRegs));
  const int cw = threadIdx.x / 128, wi = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  // 8 columns from a multiple of 8 lie in one 16-byte aligned row of C, in
  // either layout, when N and the head dim are multiples of 8
  bool chunks = g.n % 8 == 0 && (g.heads == 0 || (g.n / g.heads) % 8 == 0);
  for (int z = 0; z < (kMode == kNN ? 1 : count); ++z)
    chunks = chunks && reinterpret_cast<uintptr_t>(g.c[z]) % 16 == 0;
  __nv_bfloat16* out = staged + cw * kWM * kWOutLd;
  const int n_units = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // the block's
  // the ring step of unit i's first k-step: the k-steps of the block's units
  // before it, the other warpgroup's included
  int first = cw == 0 ? 0 : gemm_unit<kMode>(g, count, blockIdx.x, tiles_m, tiles_n, nk).steps;
  for (int i = cw, t = blockIdx.x + cw * gridDim.x; t < units; i += 2, t += 2 * gridDim.x) {
    const GemmUnit u = gemm_unit<kMode>(g, count, t, tiles_m, tiles_n, nk);
    // Unit i's products start when unit i - 1's are done: the warpgroups
    // take turns on the tensor cores, and every ring step before unit i's
    // has been waited on, so the parity of each `full` wait names one phase.
    if (i > 0) handover_wait(3 + i % 2);
    float lo[64], hi[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) lo[e] = hi[e] = 0.f;
    int prev = 0;
    for (int j = 0; j < u.steps; ++j) {
      const int step = first + j, s = step % kWStages;
      mbar_wait(full(s), (step / kWStages) & 1);
      const uint32_t st = ring + s * kWStageBytes;
      const uint64_t da = tile_desc<kAmn>(st), db = tile_desc<kWmn>(st + kWTileBytes);
      fence_acc(lo);
      fence_acc(hi);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        // the tile's second 64 rows lie 8 KB on in either majorness
        wgmma_m64n128k16<kAmn, kWmn>(lo, da + kK16Step<kAmn> * kk, db + kK16Step<kWmn> * kk,
                                     j > 0 || kk > 0);
        wgmma_m64n128k16<kAmn, kWmn>(hi, da + ((kWTileBytes / 2) >> 4) + kK16Step<kAmn> * kk,
                                     db + kK16Step<kWmn> * kk, j > 0 || kk > 0);
      }
      wgmma_commit();
      fence_acc(lo);
      fence_acc(hi);
      if (j > 0) {  // the previous k-step's products are done: free its stage
        wgmma_wait<1>();
        fence_acc(lo);
        fence_acc(hi);
        if (leader) mbar_arrive(empty(prev));
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(lo);
    fence_acc(hi);
    if (leader && u.steps > 0) mbar_arrive(empty(prev));
    if (i + 1 < n_units) handover_arrive(3 + (i + 1) % 2);
    first += u.steps;
    if (t + gridDim.x < units)
      first += gemm_unit<kMode>(g, count, t + gridDim.x, tiles_m, tiles_n, nk).steps;

    const int r0 = wi * 16 + lane / 4;
    if (kMode == kTN && u.slice >= 0) {
      // the slice's f32 sum into its block of partial, straight from the
      // accumulators (the whole 128 x 128: gemm_split_sum drops the edge)
      float* P = g.partial + (size_t)u.slice * kWM * kWN;
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const int c = j * 8 + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = r0 + 8 * half;
          *reinterpret_cast<float2*>(P + rr * kWN + c) =
              make_float2(lo[4 * j + 2 * half], lo[4 * j + 2 * half + 1]);
          *reinterpret_cast<float2*>(P + (rr + 64) * kWN + c) =
              make_float2(hi[4 * j + 2 * half], hi[4 * j + 2 * half + 1]);
        }
      }
      continue;
    }

    // epilogue: (f32 sum + bias) rounded once to bf16 into the warpgroup's
    // staging rows, then out to C in 16-byte chunks along the rows
    const __nv_bfloat16* bias =
        kMode == kNT ? static_cast<const __nv_bfloat16*>(g.bias[u.z]) : nullptr;
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(g.c[u.z]);
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int c = j * 8 + 2 * (lane % 4), col = u.n0 + c;
      const float b0 = bias && col < g.n ? __bfloat162float(bias[col]) : 0.f;
      const float b1 = bias && col + 1 < g.n ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r0 + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(out + rr * kWOutLd + c) =
            __floats2bfloat162_rn(lo[4 * j + 2 * half] + b0, lo[4 * j + 2 * half + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(out + (rr + 64) * kWOutLd + c) =
            __floats2bfloat162_rn(hi[4 * j + 2 * half] + b0, hi[4 * j + 2 * half + 1] + b1);
      }
    }
    named_sync(1 + cw);
    for (int e = threadIdx.x % 128; e < kWM * (kWN / 8); e += 128) {
      const int rr = e / (kWN / 8), c = e % (kWN / 8) * 8;
      const int row = u.m0 + rr, col = u.n0 + c;
      if (row >= g.m || col >= g.n) continue;
      const __nv_bfloat16* src = out + rr * kWOutLd + c;
      if (chunks) {
        *reinterpret_cast<uint4*>(C + gemm_c_offset(g, row, col)) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int q = 0; q < 8 && col + q < g.n; ++q) C[gemm_c_offset(g, row, col + q)] = src[q];
      }
    }
    named_sync(1 + cw);  // the rows are read before the next tile writes them
  }
}

// TN's sliced tiles: C_z's tile = its slices' f32 sums added in slice
// order, then rounded once to bf16. Four columns a thread (N % 8 == 0).
__global__ void __launch_bounds__(256) gemm_split_sum(const GemmArgs g, int tiles_n, int per,
                                                      int sliced) {
  constexpr int kQuads = kWM * kWN / 4;  // float4s of one 128 x 128 block
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < (size_t)sliced * kQuads;
       e += (size_t)gridDim.x * blockDim.x) {
    const int lt = (int)(e / kQuads), q = (int)(e % kQuads);
    const int rr = q / (kWN / 4), c = q % (kWN / 4) * 4;
    const int tile = g.whole + lt, z = tile / per;
    const int row = tile % per / tiles_n * kWM + rr, col = tile % per % tiles_n * kWN + c;
    if (row >= g.m || col >= g.n) continue;
    const float* P = g.partial + (size_t)lt * g.splits * kWM * kWN + rr * kWN + c;
    float4 acc = *reinterpret_cast<const float4*>(P);
    for (int s = 1; s < g.splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(P + (size_t)s * kWM * kWN);
      acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
    }
    __nv_bfloat162* C = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(g.c[z]) +
                                                           (size_t)row * g.n + col);
    C[0] = __floats2bfloat162_rn(acc.x, acc.y);
    C[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// The tensor map of a (rows, cols) row-major bf16 matrix under the 128-byte
// swizzle: K-major (cols = K) in boxes of 128 rows x 64; MN-major (rows = K)
// in boxes of 64 rows x 64.
inline bool encode_tile_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int rows,
                            int cols, bool mn_major) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kWK, mn_major ? (cuuint32_t)kWK : (cuuint32_t)kWM};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// What TMA and the epilogues can take: every operand 16-byte aligned, each
// operand's row stride a multiple of 16 bytes (K for a K-major operand, M or
// N for an MN-major one); NT: a banked C's heads dividing N.
template <int kMode>
inline bool gemm_tma_fits(const GemmArgs& g, int count) {
  if (count < 1 || count > (kMode == kTN ? 4 : 3) || g.m <= 0 || g.n <= 0 || g.k <= 0)
    return false;
  if ((kMode == kNT && g.k % 8) || (kMode == kNN && (g.k % 8 || g.n % 8)) ||
      (kMode == kTN && (g.m % 8 || g.n % 8)))
    return false;
  if (g.heads < 0 || (g.heads > 0 && (kMode != kNT || g.n % g.heads || g.len <= 0))) return false;
  for (int z = 0; z < count; ++z) {
    if (!aligned(g.a[kMode == kNT ? 0 : z], 16) || !aligned(g.w[z], 16)) return false;
    if (kMode != kNN && !aligned(g.c[z], kMode == kTN ? 8 : 2)) return false;
    if (kMode == kNT && reinterpret_cast<uintptr_t>(g.bias[z]) % 2) return false;
  }
  if (kMode == kNN && !aligned(g.c[0], 2)) return false;
  return true;
}

// The current device's SM count, with the kernel's shared-memory opt-in set
// there: both looked up once per device and kept, so that a launch adds no
// attribute calls to the host's enqueue.
template <int kMode>
inline cudaError_t gemm_tma_device_setup(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sm_count[kMaxDevices];  // 0 until the device is set up
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = sm_count[device].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_bf16_tma<kMode>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
    if (err != cudaSuccess) return err;
    sm_count[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

// TN on `sms` SMs: the whole tiles before the sliced ones, with `splits`
// slices a sliced tile. The tiles past the last full round (all of them when
// there are fewer than SMs) are sliced, unless splits is 1.
inline int gemm_tn_whole(int tiles, int sms, int splits) {
  return splits == 1 ? tiles : tiles < sms ? 0 : tiles - tiles % sms;
}

// The K slices the TN GEMM takes: as many as fill the SMs once with the
// sliced tiles' slices, each at least 4 k-steps, at most kMaxSplits (1 at
// short K, where nothing is sliced).
inline int gemm_tn_splits(int m, int n, int k, int count, int sms) {
  const int nk = (k + kWK - 1) / kWK;
  const int tiles = (m + kWM - 1) / kWM * ((n + kWN - 1) / kWN) * count;
  const int sliced = tiles - gemm_tn_whole(tiles, sms, 2);
  int s = sliced > 0 ? sms / sliced : 1;
  if (s > nk / 4) s = nk / 4;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : s;
}

// The f32 elements of TN's partial sums at this shape.
inline long long gemm_tn_partial_floats(int m, int n, int k, int count, int sms) {
  const int tiles = (m + kWM - 1) / kWM * ((n + kWN - 1) / kWN) * count;
  const int splits = gemm_tn_splits(m, n, k, count, sms);
  return (long long)(tiles - gemm_tn_whole(tiles, sms, splits)) * splits * kWM * kWN;
}

template <int kMode>
inline cudaError_t launch_gemm_bf16(GemmArgs g, int count, cudaStream_t stream) {
  constexpr bool kAmn = GemmMajor<kMode>::a, kWmn = GemmMajor<kMode>::w;
  if (!gemm_tma_fits<kMode>(g, count)) return cudaErrorInvalidValue;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  GemmMaps maps;
  memset(&maps, 0, sizeof(maps));
  for (int z = 0; z < count; ++z) {
    const bool a_ok = (kMode == kNT && z > 0) ||
                      encode_tile_map(enc, &maps.a[z], g.a[z], kAmn ? g.k : g.m,
                                      kAmn ? g.m : g.k, kAmn);
    if (!a_ok || !encode_tile_map(enc, &maps.w[z], g.w[z], kWmn ? g.k : g.n, kWmn ? g.n : g.k,
                                  kWmn))
      return cudaErrorInvalidValue;
  }
  int sms = 0;
  cudaError_t err = gemm_tma_device_setup<kMode>(&sms);
  if (err != cudaSuccess) return err;
  const int tiles_m = (g.m + kWM - 1) / kWM, tiles_n = (g.n + kWN - 1) / kWN;
  int sliced = 0;
  if (kMode == kTN) {
    g.splits = gemm_tn_splits(g.m, g.n, g.k, count, sms);
    g.whole = gemm_tn_whole(tiles_m * tiles_n * count, sms, g.splits);
    sliced = tiles_m * tiles_n * count - g.whole;
    if (sliced > 0 && !aligned(g.partial, 16)) return cudaErrorInvalidValue;
  }
  const int units = gemm_units<kMode>(g, count, tiles_m, tiles_n);
  gemm_bf16_tma<kMode><<<units < sms ? units : sms, kWThreads, kWSmemBytes, stream>>>(maps, g,
                                                                                      count);
  if (sliced > 0) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int blocks = (sliced * (kWM * kWN / 4) + 255) / 256;
    gemm_split_sum<<<blocks < 4 * sms ? blocks : 4 * sms, 256, 0, stream>>>(
        g, tiles_n, tiles_m * tiles_n, sliced);
  }
  return cudaGetLastError();
}

// Resident blocks per SM of the bf16 GEMM, or minus the CUDA error.
template <int kMode>
inline int gemm_tma_blocks_per_sm() {
  return smtc::blocks_per_sm(gemm_bf16_tma<kMode>, kWThreads, kWSmemBytes);
}

// ---- float32: FMA on the CUDA cores -----------------------------------------

constexpr int kBM = 64, kBN = 64, kBKf = 16;

__global__ void __launch_bounds__(256) gemm_bias_f32(GemmArgs g) {
  __shared__ __align__(16) float As[kBKf][kBM];  // k-major
  __shared__ __align__(16) float Bs[kBKf][kBN];
  const int z = blockIdx.z;
  const float* A = static_cast<const float*>(g.a[0]);
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
  if (dtype == 1) return launch_gemm_bf16<kNT>(g, count, stream);
  gemm_bias_f32<<<dim3((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM, count), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

// ---- NN in float32, summed over up to three (A_z, W_z) pairs ----------------

__global__ void __launch_bounds__(256) gemm_nn_f32(GemmArgs g, int count) {
  __shared__ __align__(16) float As[kBKf][kBM];  // k-major
  __shared__ __align__(16) float Bs[kBKf][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int z = 0; z < count; ++z) {
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
  float* C = static_cast<float*>(g.c[0]);
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

}  // namespace
