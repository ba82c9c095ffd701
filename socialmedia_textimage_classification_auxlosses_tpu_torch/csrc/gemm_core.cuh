// Tiled GEMMs of the fused attention blocks, shared by attn_block_fwd.cu,
// attn_block_bwd.cu and the per-head variant (attn_block_perhead_*.cu).
//
// Two orientations, both with f32 accumulation and one rounding of the
// result to the activation dtype:
//   * "NT" with a bias epilogue: C_z = A (M, K) . W_z^T + b_z, W_z stored
//     (N, K) row-major -- the nn.Linear (out, in) layout. This is x . W for a
//     flax (in, out) kernel W: the QKV and out projections of the forward,
//     and the q/k/v recompute of the backward. blockIdx.z picks z. The bias
//     may be absent, and C may be written head-banked, (B, heads, L, N /
//     heads), instead of (M, N) row-major.
//   * "NN" summed over pairs: C = sum_z A_z (M, K) . W_z (K, N), W_z stored
//     (K, N) row-major. With W_z a Linear's (out, in) weight this is
//     g . W^T for the flax kernel: dctx = dO . Wo^T and
//     dx = dq . Wq^T + dk . Wk^T + dv . Wv^T of the backward, the three
//     products of dx accumulated in the same registers.
//
// bf16 NT runs on Hopper's warpgroup tensor-core instruction, wgmma, fed by
// TMA loads into a swizzled shared-memory ring (gemm_bias_bf16_tma, design
// note below; both operands K-major, wgmma's native bf16 case). bf16 NN runs
// on mma.sync.m16n8k16 (128 x 64 x 32 block tiles, a 3-stage cp.async
// pipeline, its K-major B tile through ldmatrix.trans). float32 is plain FMA
// on the CUDA cores and only serves --dtype float32.

#pragma once

#include <atomic>
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <stdint.h>
#include <string.h>

#include "sdpa_core.cuh"

namespace {

struct GemmArgs {
  const void* a;        // (M, K) row-major
  const void* w[3];     // (N, K) row-major
  const void* bias[3];  // (N,), or nullptr for none
  void* c[3];           // (M, N) row-major; head-banked when heads > 0
  int m, n, k;
  int len, heads;       // heads > 0: row m = b * len + l, column n = h * d + c of
                        // C land at ((b * heads + h) * len + l) * d + c, d = N / heads
};

// Offset of C's element (row, col) in the layout GemmArgs names.
__device__ __forceinline__ size_t gemm_c_offset(const GemmArgs& g, int row, int col) {
  if (g.heads == 0) return (size_t)row * g.n + col;
  const int d = g.n / g.heads;
  return (((size_t)(row / g.len) * g.heads + col / d) * g.len + row % g.len) * d + col % d;
}

// ---- bf16 NT: wgmma fed by TMA ------------------------------------------------
//
// A persistent kernel, one block per SM, walking output tiles of 128 x 128
// (z, then M, then N fastest) with 64-deep k-steps. Three warpgroups:
//   * the producer (one thread of warpgroup 2) keeps a ring of kWStages
//     stages in flight: per stage one TMA load (cp.async.bulk.tensor.2d) of
//     the A tile (128 rows x 64 k) and one of the W tile (128 rows x 64 k),
//     16 KB each, written by the copy engine with the 128-byte swizzle and
//     reported on the stage's `full` mbarrier; rows past M or N and k past K
//     are zero-filled by TMA, so no tile needs a bounds check;
//   * two consumer warpgroups take the block's tiles in turn ("ping-pong"):
//     each waits on `full`, issues eight wgmma.mma_async.m64n128k16 per
//     k-step (bf16 in, the tile's two 64-row halves in f32 registers) straight
//     from the swizzled tiles through shared-memory descriptors, keeps one
//     k-step in flight and releases the stage before it on its `empty`
//     mbarrier, which the producer waits on before refilling it.
// The ring runs on across tiles, so while one warpgroup runs its epilogue
// the other's products keep the tensor cores busy. The epilogue adds the
// bias in f32, rounds once to bf16 into the warpgroup's staging rows in
// shared memory (from the accumulator layout: warp w of a warpgroup holds
// rows 16 w + l / 4 and + 8 of a half, lane l columns 2 (l % 4) + 8 j and + 1
// of the 8-column group j), then writes them to C row-major or head-banked
// (gemm_c_offset) in 16-byte chunks along the rows; written straight from
// the accumulator layout, each store touched eight rows and the epilogue
// took longer than the products (PERF.md). setmaxnreg moves registers from
// the producer (40) to the consumers (232), which hold 128 accumulators.
// TMA needs every row stride and base address 16-byte aligned, so K must be a
// multiple of 8 and A and W 16-byte aligned: gemm_tma_fits refuses the rest
// from the arguments, before any launch. The tensor maps are encoded on the
// host per call, through the runtime's driver entry point (no -lcuda), and
// passed as __grid_constant__ parameters.

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

struct GemmMaps {
  CUtensorMap a;     // A: (M, K), boxes of kWM rows x kWK
  CUtensorMap w[3];  // W_z: (N, K), boxes of kWN rows x kWK
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box at (c0 along K, c1 along rows) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle, starting at a 1024-byte aligned address: stride 1024 bytes between
// 8-row groups, the leading offset unused (a k16 step stays inside a row).
// Advancing along K by 16 bf16 (32 bytes) adds 2 to the encoded address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the accumulators against the asynchronous wgmma: no read or write of
// them moves across this point.
// barrier among the 128 threads of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// the hand-over between the two consumer warpgroups (ids 3 and 4): one
// arrives, the other waits, 256 threads in all
__device__ __forceinline__ void handover_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void handover_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major) . B (16 x 128, K-major), or = when
// accumulate is 0
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
      "%64, %65, p_acc, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kWThreads, 1)
    gemm_bias_bf16_tma(const __grid_constant__ GemmMaps maps, const GemmArgs g, int count) {
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
  const int tiles = tiles_m * tiles_n * count, nk = (g.k + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 1);  // the consumer warpgroup of the stage's tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's tiles t = blockIdx.x + i gridDim.x go to warpgroup i % 2, and
  // k-step kt of the block's i-th tile to ring step i nk + kt.
  if (threadIdx.x >= 128 * kWConsumers) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProducerRegs));
    if (threadIdx.x != 128 * kWConsumers) return;
    for (const CUtensorMap* map : {&maps.a, &maps.w[0], &maps.w[1], &maps.w[2]})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int z = t / (tiles_m * tiles_n), r = t % (tiles_m * tiles_n);
      const int m0 = r / tiles_n * kWM, n0 = r % tiles_n * kWN;
      const CUtensorMap* wmap = z == 0 ? &maps.w[0] : z == 1 ? &maps.w[1] : &maps.w[2];
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty(s), phase ^ 1);  // the first pass over the ring finds it free
        mbar_expect_tx(full(s), kWStageBytes);
        const uint32_t st = ring + s * kWStageBytes;
        tma_load_2d(st, &maps.a, full(s), kt * kWK, m0);
        tma_load_2d(st + kWTileBytes, wmap, full(s), kt * kWK, n0);
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
  const bool chunks = g.n % 8 == 0 && (g.heads == 0 || (g.n / g.heads) % 8 == 0) &&
                      reinterpret_cast<uintptr_t>(g.c[0]) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g.c[count > 1 ? 1 : 0]) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g.c[count > 2 ? 2 : 0]) % 16 == 0;
  __nv_bfloat16* out = staged + cw * kWM * kWOutLd;
  const int n_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // the block's
  for (int i = cw, t = blockIdx.x + cw * gridDim.x; t < tiles; i += 2, t += 2 * gridDim.x) {
    const int z = t / (tiles_m * tiles_n), r = t % (tiles_m * tiles_n);
    const int m0 = r / tiles_n * kWM, n0 = r % tiles_n * kWN;
    // Tile i's products start when tile i - 1's are done: the warpgroups
    // take turns on the tensor cores, and every ring step before tile i's
    // has been waited on, so the parity of each `full` wait names one phase.
    if (i > 0) handover_wait(3 + i % 2);
    float lo[64], hi[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) lo[e] = hi[e] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int step = i * nk + kt, s = step % kWStages;
      mbar_wait(full(s), (step / kWStages) & 1);
      const uint32_t st = ring + s * kWStageBytes;
      const uint64_t da = sw128_desc(st), db = sw128_desc(st + kWTileBytes);
      fence_acc(lo);
      fence_acc(hi);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        wgmma_m64n128k16(lo, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        wgmma_m64n128k16(hi, da + (64 * 128 >> 4) + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      }
      wgmma_commit();
      fence_acc(lo);
      fence_acc(hi);
      if (kt > 0) {  // the previous k-step's products are done: free its stage
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
    if (leader) mbar_arrive(empty(prev));
    if (i + 1 < n_tiles) handover_arrive(3 + (i + 1) % 2);

    // epilogue: (f32 sum + bias) rounded once to bf16 into the warpgroup's
    // staging rows, then out to C in 16-byte chunks along the rows
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(g.bias[z]);
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(g.c[z]);
    const int r0 = wi * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int c = j * 8 + 2 * (lane % 4), col = n0 + c;
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
      const int row = m0 + rr, col = n0 + c;
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

// cuTensorMapEncodeTiled, looked up once through the runtime, so the library
// needs no link to the driver library
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the tensor map of a (rows, k) row-major bf16 matrix in boxes of 128 rows x 64
inline bool encode_rows(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int rows, int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kWK, kWM};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA can describe: A and every W_z 16-byte aligned, K a multiple of 8
// (16-byte row strides); a banked C's heads dividing N.
inline bool gemm_tma_fits(const GemmArgs& g, int count) {
  if (count < 1 || count > 3 || g.m <= 0 || g.n <= 0 || g.k <= 0 || g.k % 8) return false;
  if (g.heads < 0 || (g.heads > 0 && (g.n % g.heads || g.len <= 0))) return false;
  if (reinterpret_cast<uintptr_t>(g.a) % 16) return false;
  for (int z = 0; z < count; ++z)
    if (reinterpret_cast<uintptr_t>(g.w[z]) % 16 || reinterpret_cast<uintptr_t>(g.c[z]) % 2 ||
        reinterpret_cast<uintptr_t>(g.bias[z]) % 2)
      return false;
  return true;
}

// The current device's SM count, with the kernel's shared-memory opt-in set
// there: both looked up once per device and kept, so that a launch adds no
// attribute calls to the host's enqueue.
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
      err = cudaFuncSetAttribute(gemm_bias_bf16_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kWSmemBytes);
    if (err != cudaSuccess) return err;
    sm_count[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

inline cudaError_t launch_gemm_tma(const GemmArgs& g, int count, cudaStream_t stream) {
  if (!gemm_tma_fits(g, count)) return cudaErrorInvalidValue;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  GemmMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode_rows(enc, &maps.a, g.a, g.m, g.k)) return cudaErrorInvalidValue;
  for (int z = 0; z < count; ++z)
    if (!encode_rows(enc, &maps.w[z], g.w[z], g.n, g.k)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = gemm_tma_device_setup(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (g.m + kWM - 1) / kWM * ((g.n + kWN - 1) / kWN) * count;
  gemm_bias_bf16_tma<<<tiles < sms ? tiles : sms, kWThreads, kWSmemBytes, stream>>>(maps, g, count);
  return cudaGetLastError();
}

// Resident blocks per SM of the TMA GEMM, or minus the CUDA error.
inline int gemm_tma_blocks_per_sm() {
  return smtc::blocks_per_sm(gemm_bias_bf16_tma, kWThreads, kWSmemBytes);
}

// ---- bf16 NN: tensor cores through mma.sync, a 3-stage cp.async pipeline -----
//
// Block tile 128 x 64 (4 warps, 64 x 32 each), 32-deep k-steps; while the
// warps multiply one stage, cp.async fills the next two. Operand fragments
// come from shared memory through ldmatrix; rows are padded to 40 bf16 (80 B)
// so the eight 16-byte rows of each 8x8 matrix fall in distinct banks.

constexpr int kGM = 128, kGN = 64, kGK = 32, kStages = 3, kGLd = kGK + 8;
constexpr int kGThreads = 128;

// the copy and fragment loads of the SDPA tensor-core kernels (sdpa_core.cuh)
using smtc::cp_async16;
using smtc::ldmatrix_x4;
using smtc::ldmatrix_x4_trans;

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
      if (col < g.n) C[gemm_c_offset(g, row, col)] = acc[r][cc] + (bias ? bias[col] : 0.f);
    }
  }
}

cudaError_t launch_gemm(const GemmArgs& g, int count, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_gemm_tma(g, count, stream);
  gemm_bias_f32<<<dim3((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM, count), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

// ---- NN, summed over up to three (A_z, W_z) pairs ---------------------------

struct GemmNNArgs {
  const void* a[3];  // (M, K) row-major
  const void* w[3];  // (K, N) row-major
  void* c;           // (M, N) row-major
  int m, n, k, count;
};

// The k-steps of all pairs form one sequence (pair z, then z + 1), so the
// cp.async pipeline runs across the pair boundaries and the three products
// of dx share one f32 accumulator, rounded once.
__global__ void __launch_bounds__(kGThreads) gemm_nn_bf16(GemmNNArgs g) {
  constexpr int kBLd = kGN + 8;  // 144 B rows: ldmatrix rows in distinct banks
  __shared__ __align__(128) __nv_bfloat16 As[kStages][kGM][kGLd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][kGK][kBLd];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int grp = lane >> 2, t4 = lane & 3;
  const int nk = (g.k + kGK - 1) / kGK;
  const int steps = nk * g.count;

  // A: 128 rows x 4 chunks; B: 32 k-rows x 8 chunks of 8 columns
  auto load_stage = [&](int stage, int t) {
    const int z = t / nk, k0 = (t % nk) * kGK;
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a[z]);
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(g.w[z]);
    for (int e = tid; e < kGM * (kGK / 8) + kGK * (kGN / 8); e += kGThreads) {
      if (e < kGM * (kGK / 8)) {
        const int r = e / (kGK / 8), c = (e % (kGK / 8)) * 8;
        const bool ok = k0 + c < g.k && m0 + r < g.m;
        cp_async16(&As[stage][r][c], ok ? A + (size_t)(m0 + r) * g.k + k0 + c : A, ok);
      } else {
        const int f = e - kGM * (kGK / 8);
        const int r = f / (kGN / 8), c = (f % (kGN / 8)) * 8;
        const bool ok = k0 + r < g.k && n0 + c < g.n;
        cp_async16(&Bs[stage][r][c], ok ? W + (size_t)(k0 + r) * g.n + n0 + c : W, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n");
  }

  float acc[4][4][4] = {};
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
      // B stored k-major: the transposing load gives the .col fragments;
      // lanes 0-15 address k rows of the first n8 tile, 16-31 of the next
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], &Bs[st][kk + (lane & 15)][wn * 32 + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          smtc::mma_16816(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],
                          bfr[ni / 2][(ni % 2) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(g.c);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (col >= g.n) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + grp + half * 8;
        if (row >= g.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * g.n + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
  }
}

__global__ void __launch_bounds__(256) gemm_nn_f32(GemmNNArgs g) {
  __shared__ __align__(16) float As[kBKf][kBM];  // k-major
  __shared__ __align__(16) float Bs[kBKf][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int z = 0; z < g.count; ++z) {
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
  float* C = static_cast<float*>(g.c);
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

cudaError_t launch_gemm_nn(const GemmNNArgs& g, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    gemm_nn_bf16<<<dim3((g.n + kGN - 1) / kGN, (g.m + kGM - 1) / kGM), kGThreads, 0, stream>>>(g);
  else
    gemm_nn_f32<<<dim3((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace
