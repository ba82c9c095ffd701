// TPU kernel 7 of PERF.md's table: fused self-attention block forward on Hopper (sm_90a).
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
// 989 TFLOP/s). The bf16 GEMM therefore runs on wgmma (f32 accumulation),
// fed by TMA through a 4-stage ring of 128x64 tiles, one persistent block per
// SM (gemm_core.cuh). The float32 GEMM is plain FMA: it only serves
// --dtype float32.
//
// Weights arrive as (out, in) row-major, the nn.Linear layout; ops/attn_block.py
// takes them in the flax (in, out) layout and passes the transpose. The GEMMs
// live in gemm_core.cuh, shared with the backward (attn_block_bwd.cu).

#include "gemm_core.cuh"

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

// The bf16 NT GEMM of steps 1 and 3 alone: C_z = A . W_z^T + b_z for z < count
// (1 to 3). a: (M, K); w*: (N, K); b*: (N,) or nullptr; c*: (M, N) row-major,
// or head-banked (M / len, heads, len, N / heads) when heads > 0. A shape TMA
// cannot describe (K not a multiple of 8, A or W not 16-byte aligned) returns
// cudaErrorInvalidValue before any launch.
int smtc_gemm_nt_bf16(const void* a, const void* w0, const void* w1, const void* w2,
                      const void* b0, const void* b1, const void* b2, void* c0, void* c1, void* c2,
                      int m, int n, int k, int count, int len, int heads, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g = {};
  g.a = a;
  g.w[0] = w0, g.w[1] = w1, g.w[2] = w2;
  g.bias[0] = b0, g.bias[1] = b1, g.bias[2] = b2;
  g.c[0] = c0, g.c[1] = c1, g.c[2] = c2;
  g.m = m;
  g.n = n;
  g.k = k;
  g.len = len;
  g.heads = heads;
  return (int)launch_gemm(g, count, 1, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the bf16 GEMM, or minus the CUDA error (the
// occupancy lines of chip_smoke.py).
int smtc_gemm_blocks_per_sm() { return gemm_tma_blocks_per_sm(); }

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
