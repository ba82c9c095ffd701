// TPU kernel 5 of PERF.md's table: the per-head fused self-attention block
// forward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attn_block.py
// ::_fwd_kernel (the Pallas TPU kernel reached from _run_fwd, used by
// attn_block(impl="fused_perhead"), the ablation of the packed-lane variant).
// It computes, with the same casts and the same order of the float32 sums:
//   per head h, in order:
//     q|k|v_h = (x Wq|Wk|Wv_h  accumulated in f32  + b_h) rounded to x's dtype
//     ctx_h   = SDPA(q_h, k_h, v_h) (sdpa_core.cuh), rounded
//     acc    += ctx_h Wo_h   (a fresh f32 product per head, added in head order)
//   out = (acc + bo) rounded once.
//
// Design. The TPU kernel ran one grid step per batch element and split the
// weights per head outside it, because Mosaic cannot split the lane dimension
// of an (L, H) activation. On Hopper nothing is pre-split: Wq_h, Wk_h and Wv_h
// are contiguous (d, H) row blocks of the (out, in) Linear weights, Wo_h a
// contiguous (d, H) row block of the (in, out) out-projection. Three launches
// on one stream behind one C entry point and one launch count:
//   1. gemm_core.cuh's NT GEMM (wgmma, TMA): z picks q, k or v, and its
//      epilogue writes each 128-wide column tile of the 768-wide product, two
//      heads' (L x 768).(768 x 64) products at d = 64, head-banked,
//      (B, heads, L, d), the layout of the Pallas kernels' per-head blocks;
//   2. sdpa_core.cuh's SDPA on the banked heads, ctx banked;
//   3. perhead_core.cuh's head-ordered product: one block per 128 x 64 output
//      tile walks the heads in order, each head's ctx_h Wo_h into a fresh f32
//      partial added to the tile's f32 accumulator, then + bo, rounded once.
//      Hopper blocks run in no order, so the cross-head sum cannot be carried
//      across blocks as the TPU grid carries it; keeping every head of a tile
//      in one block keeps the order with no atomics and no scratch.
// q, k, v and ctx make one round trip through device memory each (scratch the
// wrapper allocates).
//
// What bounds it on the H100. The work is that of TPU kernel 7
// (attn_block_fwd.cu): at x of 16x128x768 and 16x197x768 and ViLT's
// 32x402x768 in bf16, the four projections and the per-head SDPA, bound by
// the bf16 tensor-core rate (0.0106, 0.0170 and 0.0774 ms). chip_smoke.py
// times it beside kernel 7 at each shape (PERF.md): the head-ordered
// out-projection makes it 20-40% slower than kernel 7; the SDPA forward, on
// the tensor cores, is a quarter of the call at 402.

#include "perhead_core.cuh"

extern "C" {

// x: (B, L, H); mask: (B, L) int32 or nullptr; wq, wk, wv: (H, H) as (out, in);
// wo: (H, H) as (in, out); b*: (H,); q, k, v, ctx: (B, heads, L, H / heads)
// scratch; out: (B, L, H). One dtype for all (0 = float32, 1 = bfloat16).
int smtc_attn_block_perhead_fwd(const void* x, const int* mask, const void* wq, const void* bq,
                                const void* wk, const void* bk, const void* wv, const void* bv,
                                const void* wo, const void* bo, void* q, void* k, void* v,
                                void* ctx, void* out, int batch, int len, int hidden, int heads,
                                float scale, int dtype, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = hidden / heads;

  // 1. q, k, v per head, banked
  GemmArgs g = {};
  g.a[0] = x;
  g.w[0] = wq, g.w[1] = wk, g.w[2] = wv;
  g.bias[0] = bq, g.bias[1] = bk, g.bias[2] = bv;
  g.c[0] = q, g.c[1] = k, g.c[2] = v;
  g.m = batch * len;
  g.n = hidden;
  g.k = hidden;
  g.len = len;
  g.heads = heads;
  err = launch_gemm(g, 3, dtype, s);
  if (err != cudaSuccess) return (int)err;

  // 2. SDPA per (batch, head) on the banked blocks
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
  a.q_sb = (long long)heads * len * d;
  a.q_sh = (long long)len * d;
  a.q_sl = d;
  a.k_sb = a.v_sb = a.o_sb = a.q_sb;
  a.k_sh = a.v_sh = a.o_sh = a.q_sh;
  a.k_sl = a.v_sl = a.o_sl = a.q_sl;
  a.scale = scale;
  err = dtype == 1 ? smtc::launch_sdpa<__nv_bfloat16>(a, batch, s)
                   : smtc::launch_sdpa<float>(a, batch, s);
  if (err != cudaSuccess) return (int)err;

  // 3. out = sum over heads, in order, of ctx_h Wo_h, + bo
  HeadSumArgs o = {};
  o.a[0] = ctx;
  o.w[0] = wo;
  o.bias = bo;
  o.c = out;
  o.m = batch * len;
  o.n = hidden;
  o.len = len;
  o.heads = heads;
  o.d = d;
  o.count = 1;
  return (int)launch_headsum(o, dtype, s);
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
