// TPU kernels 2 and 4 of PERF.md's table: SDPA backward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attention.py
// ::_bwd_kernel (the Pallas TPU kernel reached from _pallas_bwd for Lq <= 256)
// and ::_bwd_kernel_blocked (Lq > 256, 128-row query tiles), the backward of
// the custom VJP _sdpa_pallas. The TPU kernels held one batch element's
// Q/K/V/dO for all heads in VMEM and recomputed P there. Here bf16 at head
// dims 32 and 64 (every training path) runs the tensor-core query-tiled pair:
// pass A writes dQ and per-row statistics from the forward's row max and sum,
// pass B sums dK and dV per key tile over every query row, without atomics,
// every product on wgmma fed by TMA; float32 at those head dims runs the
// same pair with every product three tf32 passes (float32's accuracy kept).
// The fusion head's single query runs in the row pair (a score pass per key,
// then a gradient pass per 64 head-dim columns), and other head dims in the
// block kernel where the whole (Lq, Lk) problem fits a block's shared memory,
// else in the FMA query-tiled pair. The kernels and what bounds them are
// described in sdpa_bwd_core.cuh.
//
// Plain-C interface for ctypes: pointers from tensor.data_ptr(), PyTorch's
// current stream, and cudaGetLastError() as the return value.

#include "sdpa_bwd_core.cuh"

extern "C" {

// q, dout, dq: (B, H, Lq, D); k, v, dk, dv: (B, H, Lk, D); all contiguous in
// one dtype (0 = float32, 1 = bfloat16); mask: (B, Lk) int32 or nullptr;
// stats: float32 scratch of sdpa_bwd_stats_floats(B, H, Lq) floats (the
// query-tiled pair's per-row stats), followed, for Lq <= 4, by the row pair's
// (B, H, Lq, Lk, 2) scores and dP; fwd_stats: nullptr, or the forward's
// (B, H, Lq, 2) float32 row max and sum (smtc_sdpa_fwd's stats), which only
// the tensor-core pairs read (cudaErrorInvalidValue where another kernel
// would run); kernel: 0 = chosen by shape, 1 = a query-tiled pair (the
// tensor-core one where it fits), 2 = the block kernel.
int smtc_sdpa_bwd(const void* q, const void* k, const void* v, const int* mask,
                  const void* dout, void* dq, void* dk, void* dv, float* stats,
                  const float* fwd_stats, int batch, int heads, int lq, int lk, int d,
                  float scale, int dtype, int kernel, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  smtc::SdpaBwdArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.mask = mask;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.o = nullptr;
  a.stats = stats;
  a.fwd_stats = fwd_stats;
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.d = d;
  a.q_sl = d;
  a.q_sh = (long long)lq * d;
  a.q_sb = a.q_sh * heads;
  a.k_sl = d;
  a.k_sh = (long long)lk * d;
  a.k_sb = a.k_sh * heads;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)smtc::launch_sdpa_bwd<float>(a, batch, s, kernel);
  if (dtype == 1) return (int)smtc::launch_sdpa_bwd<__nv_bfloat16>(a, batch, s, kernel);
  return (int)cudaErrorInvalidValue;
}

// 1 if the kernels take this (Lq, Lk, D): the row pair's rows, the block
// kernel's two f32 row sets or pass A's row set of the query-tiled pair fit
// one block's shared memory (pass A's takes every Lk the forward takes).
int smtc_sdpa_bwd_fits(int lq, int lk, int d) { return smtc::sdpa_bwd_fits(lq, lk, d) ? 1 : 0; }

// Floats of the f32 scratch that `stats` points to (ops/attention.py's
// bwd_scratch allocates this many).
long long smtc_sdpa_bwd_scratch_floats(int batch, int heads, int lq, int lk) {
  return (long long)smtc::sdpa_bwd_scratch_floats(batch, heads, lq, lk);
}

// Resident blocks per SM of the bf16 tensor-core pair's pass A (pass 0) or
// pass B (pass 1) at head dim d and Lk keys, of the float32 row pair's score
// pass (pass 2) or column pass (pass 3), or of the float32 tensor-core pair's
// pass A (4) or pass B (5), or minus the CUDA error (the occupancy lines of
// chip_smoke.py).
int smtc_sdpa_bwd_blocks_per_sm(int pass, int d, int lk) {
  return smtc::sdpa_bwd_tc_blocks_per_sm(pass, d, lk);
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
