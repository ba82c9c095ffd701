// TPU kernels 1 and 3 of PERF.md's table: SDPA forward on Hopper (sm_90a).
//
// Replaces socialmedia_textimage_classification_auxlosses_tpu/ops/attention.py
// ::_fwd_kernel (the Pallas TPU kernel reached from _pallas_fwd for Lq <= 256)
// and ::_fwd_kernel_blocked (Lq > 256: Q in 128-row tiles, the whole K and V,
// the padded tail sliced off). The TPU kernels held one batch element's Q/K/V
// for all heads in VMEM and ran head-batched MXU contractions; here a block
// takes (batch, head, tile of 32 or 64 query rows) units, since Hopper runs
// blocks in parallel on 132 SMs and has 227 KB of shared memory per block,
// not megabytes of VMEM. Query tiles make the blocked variant the same
// kernel: ViLT's joint sequence (Lq = Lk = 402, a ragged last tile of 18
// rows) runs in the tensor-core kernels, bf16 and float32 alike.
//
// What bounds it on the H100. On the serving shapes (text 16x12x128x64 and
// image 16x12x197x64 in bf16; the fusion head 16x1x1x768 over 197 keys in
// f32) the least time is set by the bytes of q, k, v and o at 3.35 TB/s
// (about 3.8 us, 5.8 us and 5.8 us); at ViLT's 32x12x402x402x64 the bf16
// products (16 us at 989 TFLOP/s) and the bytes (24 us) are close. The bf16
// attentions run in sdpa_core.cuh's tensor-core kernel: wgmma for both
// products, Q, K and V by TMA into mbarrier-guarded buffers that one thread
// keeps in flight, scores, probabilities and the output accumulator in
// registers, the whole key row in one pass up to 256 keys, so only q, k, v
// and o cross device memory. Float32 at head dims 32 and 64 runs the same
// design with every product three tf32 passes (float32's accuracy kept;
// sdpa_core.cuh's note). The fusion head's single query runs in the row
// kernel, one block per query row, reading K and V once. PERF.md has the
// times against these bounds.
//
// Plain-C interface for ctypes: pointers from tensor.data_ptr(), PyTorch's
// current stream, and cudaGetLastError() as the return value.

#include "sdpa_core.cuh"

extern "C" {

// q: (B, H, Lq, D), k/v: (B, H, Lk, D), o: (B, H, Lq, D), all contiguous in
// one dtype (0 = float32, 1 = bfloat16); mask: (B, Lk) int32 or nullptr;
// stats: nullptr, or (B, H, Lq, 2) float32 for each query row's max and sum,
// which only the tensor-core kernels form (cudaErrorInvalidValue where
// another kernel would run).
int smtc_sdpa_fwd(const void* q, const void* k, const void* v, const int* mask, void* o,
                  float* stats, int batch, int heads, int lq, int lk, int d, float scale,
                  int dtype, int device, void* stream) {
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
  a.stats = stats;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)smtc::launch_sdpa<float>(a, batch, s);
  if (dtype == 1) return (int)smtc::launch_sdpa<__nv_bfloat16>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// Largest Lk the forward takes: the FMA kernel's (other head dims) rows of
// scores fit one block's shared memory.
int smtc_sdpa_max_lk(void) {
  int lk = smtc::kBK;
  while (smtc::sdpa_smem_bytes(lk + smtc::kBK) <= 232448) lk += smtc::kBK;
  return lk;
}

// Resident blocks per SM of the tensor-core kernel at head dim d and Lk keys,
// or minus the CUDA error (the occupancy line of chip_smoke.py).
int smtc_sdpa_fwd_blocks_per_sm(int d, int lk) {
  using namespace smtc;
  if (d == 32)
    return blocks_per_sm(sdpa_fwd_wg_kernel<32, 128>, kFwdThreads, fwd_smem_bytes<32, 128>(lk));
  if (d == 64)
    return sdpa_tc_window(d, lk) == 256
               ? blocks_per_sm(sdpa_fwd_wg_kernel<64, 256>, kFwdThreads, fwd_smem_bytes<64, 256>(lk))
               : blocks_per_sm(sdpa_fwd_wg_kernel<64, 128>, kFwdThreads, fwd_smem_bytes<64, 128>(lk));
  if (d == 128)
    return blocks_per_sm(sdpa_fwd_wg_kernel<128, 128>, kFwdThreads, fwd_smem_bytes<128, 128>(lk));
  return -(int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the float32 tensor-core kernel at head dim d and
// Lk keys, or minus the CUDA error.
int smtc_sdpa_fwd_f32_blocks_per_sm(int d, int lk) {
  using namespace smtc;
  if (d == 32)
    return blocks_per_sm(sdpa_fwd_f32_wg_kernel<32>, kF32FwdThreads, fwd_f32_smem_bytes<32>(lk));
  if (d == 64)
    return blocks_per_sm(sdpa_fwd_f32_wg_kernel<64>, kF32FwdThreads, fwd_f32_smem_bytes<64>(lk));
  return -(int)cudaErrorInvalidValue;
}

const char* smtc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
