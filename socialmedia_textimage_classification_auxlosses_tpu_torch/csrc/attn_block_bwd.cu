// TPU kernel 8 of PERF.md's table: fused self-attention block backward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attn_block.py
// ::_bwd_kernel2 (the Pallas TPU kernel reached from _run_bwd2, the backward
// of the custom VJP _attn_block2, used by `--attn_impl fused`). It computes,
// with the same casts:
//   q|k|v  = (x Wq|Wk|Wv  accumulated in f32  + b) rounded to x's dtype
//   dctx   = (dO Wo^T  in f32) rounded
//   per head, on column slices of the packed (B, L, H) q, k, v, dctx, the
//   SDPA backward of sdpa_bwd_core.cuh, writing packed ctx, dq, dk, dv, each
//   rounded
//   dx     = (dq Wq^T + dk Wk^T + dv Wv^T, one f32 sum) rounded once
// ctx, dq, dk and dv go back to the caller, which forms the weight and bias
// gradients as large plain products outside the kernel, as the JAX package
// does (attn_block.py::_attn_block2_bwd).
//
// Design. The TPU kernel did all of this in one grid step per batch element,
// the four 768x768 weights resident in VMEM. A Hopper block cannot hold them
// (4.5 MB in bf16 against 227 KB of shared memory), so this port is a chain
// of four launches of the port's own kernels on one stream, behind one C
// entry point and one launch count, as the forward (attn_block_fwd.cu):
//   1. the forward's NT GEMM with bias (gemm_core.cuh) recomputes q, k, v;
//   2. the NN GEMM computes dctx = dO . Wo_lin (Wo^T of the flax kernel);
//   3. the SDPA backward per (batch, head), heads as column slices, also
//      writing ctx: in bf16 the tensor-core query-tiled pair at every length
//      (sdpa_bwd_core.cuh); in f32 the block kernel where its row sets fit
//      (L <= 128 at head dim 64), else the FMA query-tiled pair;
//   4. the NN GEMM sums dq . Wq_lin + dk . Wk_lin + dv . Wv_lin into dx in one
//      f32 accumulator.
// q, k, v, dctx, ctx, dq, dk and dv make one round trip through device
// memory each (buffers the wrapper allocates).
//
// What bounds it on the H100. At the training shape (x of 32x128x768 in
// bf16, 12 heads) the work is the eight 768-wide products (4 + 4 of
// 2 x 4096 x 768 x 768 = 38.7 GFLOP) plus the per-head SDPA backward
// (2.4 GFLOP), about 41 us on the bf16 tensor cores at 989 TFLOP/s; the
// bytes (x, dO, the weights, dx, dq, dk, dv, ctx) take under 10 us. In bf16
// everything runs on the tensor cores: the NT GEMM on wgmma fed by TMA, the
// NN GEMM and the SDPA backward on mma.sync.
//
// Weights arrive as (out, in) row-major, the nn.Linear layout.

#include "gemm_core.cuh"
#include "sdpa_bwd_core.cuh"

extern "C" {

// x, dout, dx: (B, L, H); mask: (B, L) int32 or nullptr; w*: (H, H) as
// (out, in); b*: (H,); q, k, v, dctx: (B, L, H) scratch; ctx, dq, dk, dv:
// (B, L, H) outputs; stats: the SDPA backward's float32 scratch
// (sdpa_bwd_scratch_floats(B, heads, L, L) floats, sdpa_bwd_core.cuh). One
// dtype for all (0 = float32, 1 = bfloat16).
int smtc_attn_block_bwd(const void* x, const int* mask, const void* wq, const void* bq,
                        const void* wk, const void* bk, const void* wv, const void* bv,
                        const void* wo, const void* dout, void* q, void* k, void* v, void* dctx,
                        void* ctx, void* dq, void* dk, void* dv, void* dx, float* stats,
                        int batch, int len,
                        int hidden, int heads, float scale, int dtype, int device,
                        void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = batch * len;

  // 1. q, k, v recomputed as in the forward
  GemmArgs g = {};
  g.a = x;
  g.w[0] = wq, g.w[1] = wk, g.w[2] = wv;
  g.bias[0] = bq, g.bias[1] = bk, g.bias[2] = bv;
  g.c[0] = q, g.c[1] = k, g.c[2] = v;
  g.m = m;
  g.n = hidden;
  g.k = hidden;
  err = launch_gemm(g, 3, dtype, s);
  if (err != cudaSuccess) return (int)err;

  // 2. dctx = dO . Wo_lin
  GemmNNArgs gc = {};
  gc.a[0] = dout;
  gc.w[0] = wo;
  gc.c = dctx;
  gc.m = m;
  gc.n = hidden;
  gc.k = hidden;
  gc.count = 1;
  err = launch_gemm_nn(gc, dtype, s);
  if (err != cudaSuccess) return (int)err;

  // 3. per-head SDPA backward on column slices
  smtc::SdpaBwdArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dctx;
  a.mask = mask;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.o = ctx;
  a.stats = stats;
  a.heads = heads;
  a.lq = len;
  a.lk = len;
  a.d = hidden / heads;
  a.q_sb = a.k_sb = (long long)len * hidden;
  a.q_sh = a.k_sh = a.d;
  a.q_sl = a.k_sl = hidden;
  a.scale = scale;
  err = dtype == 1 ? smtc::launch_sdpa_bwd<__nv_bfloat16>(a, batch, s)
                   : smtc::launch_sdpa_bwd<float>(a, batch, s);
  if (err != cudaSuccess) return (int)err;

  // 4. dx = dq . Wq_lin + dk . Wk_lin + dv . Wv_lin
  GemmNNArgs gx = {};
  gx.a[0] = dq, gx.a[1] = dk, gx.a[2] = dv;
  gx.w[0] = wq, gx.w[1] = wk, gx.w[2] = wv;
  gx.c = dx;
  gx.m = m;
  gx.n = hidden;
  gx.k = hidden;
  gx.count = 3;
  return (int)launch_gemm_nn(gx, dtype, s);
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
