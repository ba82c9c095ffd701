// Kernel 1: SDPA forward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attention.py
// ::_fwd_kernel (the Pallas TPU kernel reached from _pallas_fwd for Lq <= 256).
// The TPU kernel held one batch element's Q/K/V for all heads in VMEM and ran
// head-batched MXU contractions; here a block takes one (batch, head, tile of
// 32 query rows), since Hopper runs blocks in parallel on 132 SMs and has
// 227 KB of shared memory per block, not megabytes of VMEM.
//
// What bounds it on the H100. On the serving shapes (text 16x12x128x64 and
// image 16x12x197x64 in bf16; the fusion head 16x1x1x768 over 197 keys in
// f32) the least time is set by the bytes of q, k, v and o at 3.35 TB/s
// (about 3.8 us, 5.8 us and 5.8 us); the operations would take less on the
// tensor cores. The kernels keep scores and probabilities in shared memory so
// that only q, k, v and o cross device memory, which is what the bound counts.
// The fusion head's single query runs in the row kernel (sdpa_core.cuh), one
// block per query row, reading K and V once. The encoder attentions run in
// the tensor-core kernel, 16-byte loads and mma.sync. Both still run 6-20x
// above the bound (PERF.md): the scores make a round trip through shared
// memory in f32, the loads are not pipelined (no cp.async/TMA), and a block
// of 4 warps leaves the tensor cores idle while it softmaxes; wgmma with a
// register-resident online softmax is the next step, with care for where the
// probabilities are rounded.
//
// Plain-C interface for ctypes: pointers from tensor.data_ptr(), PyTorch's
// current stream, and cudaGetLastError() as the return value.

#include "sdpa_core.cuh"

extern "C" {

// q: (B, H, Lq, D), k/v: (B, H, Lk, D), o: (B, H, Lq, D), all contiguous in
// one dtype (0 = float32, 1 = bfloat16); mask: (B, Lk) int32 or nullptr.
int smtc_sdpa_fwd(const void* q, const void* k, const void* v, const int* mask, void* o,
                  int batch, int heads, int lq, int lk, int d, float scale, int dtype,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  smtc::SdpaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o = o;
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
  a.v_sl = a.k_sl;
  a.v_sh = a.k_sh;
  a.v_sb = a.k_sb;
  a.o_sl = a.q_sl;
  a.o_sh = a.q_sh;
  a.o_sb = a.q_sb;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)smtc::launch_sdpa<float>(a, batch, s);
  if (dtype == 1) return (int)smtc::launch_sdpa<__nv_bfloat16>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// Largest Lk whose row of scores fits the shared memory of one block.
int smtc_sdpa_max_lk(void) {
  int lk = smtc::kBK;
  while (smtc::sdpa_smem_bytes(lk + smtc::kBK) <= 232448) lk += smtc::kBK;
  return lk;
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
