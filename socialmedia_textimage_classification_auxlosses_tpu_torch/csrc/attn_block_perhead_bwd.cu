// TPU kernel 6 of PERF.md's table: the per-head fused self-attention block
// backward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attn_block.py
// ::_bwd_kernel (the Pallas TPU kernel reached from _run_bwd, the backward of
// the custom VJP _attn_block, attn_block(impl="fused_perhead")). It computes,
// with the same casts:
//   per head h:
//     q|k|v_h = (x Wq|Wk|Wv_h  in f32  + b_h) rounded to x's dtype
//     dctx_h  = (dO Wo_h^T  in f32) rounded
//     the SDPA backward of sdpa_bwd_core.cuh on the head's blocks: ctx_h =
//     round(P) V, dv, dS = P (dP - rowsum(dP P)), dq, dk, each rounded
//   dx = (sum over heads h in order, within a head over q, k, v in order, of
//        the f32 products dq_h Wq_h^T, dk_h Wk_h^T, dv_h Wv_h^T) rounded once.
// dq, dk, dv and ctx go back to the caller head-banked, (B, heads, L, d), as
// the Pallas kernel's _hd_spec outputs; the caller merges them to (B, L, H)
// and forms the weight and bias gradients as large plain products, as the
// JAX wrapper _attn_block_bwd does.
//
// Design. Four launches (five at lengths the block kernel cannot hold) on one
// stream behind one C entry point and one launch count:
//   1. gemm_core.cuh's NT GEMM recomputes q, k, v per head, banked;
//   2. the same GEMM, one pair, no bias, gives dctx = dO Wo^T banked: Wo_h is
//      a contiguous (d, H) row block of the (in, out) out-projection, which
//      is the (N, K) operand the NT GEMM reads;
//   3. the SDPA backward per (batch, head) on the banked blocks, writing ctx:
//      in bf16 the tensor-core query-tiled pair of sdpa_bwd_core.cuh at every
//      length; in f32 the block kernel where the head's whole (L, L) problem
//      fits in shared memory (L <= 128 at head dim 64), else the FMA
//      query-tiled pair (ViLT's L = 402: one head's 402 x 402 f32 P alone is
//      646 KB, over a block's 227 KB). Both pairs' pass B sums dK and dV over
//      the query tiles in f32 with no atomics;
//   4. perhead_core.cuh's head-ordered product: every block owns a 128 x 64
//      tile of dx and walks (head, then q, k, v) in order, each product into a
//      fresh f32 partial added to the tile's accumulator, rounded once: the
//      order of the TPU kernel's `dx +=` loop, kept without atomics.
//
// What bounds it on the H100. The work is that of TPU kernel 8
// (attn_block_bwd.cu): the eight 768-wide products and the per-head SDPA
// backward, bound by the bf16 tensor-core rate at the training shapes (x of
// 32x128x768 and 32x402x768: 0.0391 and 0.1556 ms). chip_smoke.py times it
// beside kernel 8 at each shape (PERF.md): the head-ordered dx product makes
// it 30-60% slower than kernel 8; in bf16 step 3 is the tensor-core pair.

#include "perhead_core.cuh"
#include "sdpa_bwd_core.cuh"

extern "C" {

// x, dout, dx: (B, L, H); mask: (B, L) int32 or nullptr; wq, wk, wv: (H, H)
// as (out, in); wo: (H, H) as (in, out); b*: (H,); q, k, v, dctx: banked
// (B, heads, L, H / heads) scratch; ctx, dq, dk, dv: banked outputs; stats:
// the SDPA backward's float32 scratch (sdpa_bwd_scratch_floats(B, heads, L, L)
// floats, sdpa_bwd_core.cuh). One dtype for all (0 = float32, 1 = bfloat16).
int smtc_attn_block_perhead_bwd(const void* x, const int* mask, const void* wq, const void* bq,
                                const void* wk, const void* bk, const void* wv, const void* bv,
                                const void* wo, const void* dout, void* q, void* k, void* v,
                                void* dctx, void* ctx, void* dq, void* dk, void* dv, void* dx,
                                float* stats, int batch, int len, int hidden, int heads,
                                float scale, int dtype, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = batch * len, d = hidden / heads;

  // 1. q, k, v per head, banked, as in the forward
  GemmArgs g = {};
  g.a[0] = x;
  g.w[0] = wq, g.w[1] = wk, g.w[2] = wv;
  g.bias[0] = bq, g.bias[1] = bk, g.bias[2] = bv;
  g.c[0] = q, g.c[1] = k, g.c[2] = v;
  g.m = m;
  g.n = hidden;
  g.k = hidden;
  g.len = len;
  g.heads = heads;
  err = launch_gemm(g, 3, dtype, s);
  if (err != cudaSuccess) return (int)err;

  // 2. dctx_h = dO Wo_h^T, banked
  GemmArgs gc = {};
  gc.a[0] = dout;
  gc.w[0] = wo;
  gc.c[0] = dctx;
  gc.m = m;
  gc.n = hidden;
  gc.k = hidden;
  gc.len = len;
  gc.heads = heads;
  err = launch_gemm(gc, 1, dtype, s);
  if (err != cudaSuccess) return (int)err;

  // 3. the SDPA backward per (batch, head), writing ctx
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
  a.d = d;
  a.q_sb = a.k_sb = (long long)heads * len * d;
  a.q_sh = a.k_sh = (long long)len * d;
  a.q_sl = a.k_sl = d;
  a.scale = scale;
  err = dtype == 1 ? smtc::launch_sdpa_bwd<__nv_bfloat16>(a, batch, s)
                   : smtc::launch_sdpa_bwd<float>(a, batch, s);
  if (err != cudaSuccess) return (int)err;

  // 4. dx = sum over heads, then q, k, v, of dz_h Wz_h^T (Wz_h: rows h d ..
  //    of the (out, in) Linear weight)
  HeadSumArgs gx = {};
  gx.a[0] = dq, gx.a[1] = dk, gx.a[2] = dv;
  gx.w[0] = wq, gx.w[1] = wk, gx.w[2] = wv;
  gx.c = dx;
  gx.m = m;
  gx.n = hidden;
  gx.len = len;
  gx.heads = heads;
  gx.d = d;
  gx.count = 3;
  return (int)launch_headsum(gx, dtype, s);
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
