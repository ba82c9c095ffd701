"""Clock counts inside the port's bf16 SDPA kernels on the card.

    python3 tools/sdpa_clocks.py

Copies the port into ``build/inst/`` with ``clock64()`` reads added (the
source text is patched where the kernels' phases begin and end; the script
fails if that text has moved) and builds it there, then runs, at the main
path's shapes, the forward (thread 0 of blocks 0-31, first units: the cycles
of each phase of a unit: the column map, the waits for Q, K and V, S, the
softmax, P, P V and the staged store) and the backward's two passes (thread 0
of blocks 0-255: the block's cycles and those spent waiting for its loads),
and prints the medians. The counts are the SM's cycles; the instrumented
kernels run slightly slower than the port's. Needs a CUDA device.
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_copy():
    os.chdir(ROOT)
    src = "socialmedia_textimage_classification_auxlosses_tpu_torch"
    dst = "build/inst"
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(src, os.path.join(dst, src), ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy("chip_smoke.py", dst)
    p = os.path.join(dst, src, "csrc", "sdpa_core.cuh")
    s = open(p).read()
    s = s.replace("template <int D, int W>\n__global__ void __launch_bounds__(kFwdThreads",
                  "__device__ long long smtc_dbg[32 * 8 * 10];\n#define DBG(i) if (threadIdx.x == 0 && blockIdx.x < 32 && ui < 8) smtc_dbg[(blockIdx.x * 8 + ui) * 10 + (i)] = clock64();\n"
                  "template <int D, int W>\n__global__ void __launch_bounds__(kFwdThreads", 1)
    reps = [
        ("  for (int u = blockIdx.x; u < units; u += gridDim.x) {\n    const TcUnit n = tc_unit(u, tiles, a.heads);\n    const int* mask = a.mask ? a.mask + (long long)n.b * a.lk : nullptr;\n    __syncthreads();",
         "  int ui = -1;\n  for (int u = blockIdx.x; u < units; u += gridDim.x) {\n    ++ui;\n    DBG(0)\n    const TcUnit n = tc_unit(u, tiles, a.heads);\n    const int* mask = a.mask ? a.mask + (long long)n.b * a.lk : nullptr;\n    __syncthreads();"),
        ("    const uint32_t qs = acquire(kBufQ);\n    if (single) {\n      // the whole row at once: the exact max, one exponential per score\n      window_scores<D, W>(s, qs, acquire(kBufK), last8);",
         "    DBG(1)\n    const uint32_t qs = acquire(kBufQ);\n    DBG(2)\n    if (single) {\n      // the whole row at once: the exact max, one exponential per score\n      const uint32_t kk_ = acquire(kBufK);\n      DBG(3)\n      window_scores<D, W>(s, qs, kk_, last8);\n      DBG(4)"),
        ("      window_exp<W>(s, m, one, l, last8);\n    } else {",
         "      window_exp<W>(s, m, one, l, last8);\n      DBG(5)\n    } else {"),
        ("      window_pack<W>(p, s, last8);\n#pragma unroll\n      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;\n      window_pv<D, W>(o, p, acquire(kBufV), last8);\n      release(kBufV);",
         "      window_pack<W>(p, s, last8);\n#pragma unroll\n      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;\n      DBG(6)\n      const uint32_t vv_ = acquire(kBufV);\n      DBG(7)\n      window_pv<D, W>(o, p, vv_, last8);\n      DBG(8)\n      release(kBufV);"),
        ("                     n.t * kTcRows, a.lq, staged);\n  }\n}",
         "                     n.t * kTcRows, a.lq, staged);\n    DBG(9)\n  }\n}"),
    ]
    for a, b in reps:
        assert a in s, a[:80]
        s = s.replace(a, b)
    open(p, "w").write(s)
    p = os.path.join(dst, src, "csrc", "sdpa_fwd.cu")
    s = open(p).read()
    s = s.replace('const char* smtc_error_string(int err)', 'int smtc_dbg_copy(void* dst) { return (int)cudaMemcpyFromSymbol(dst, smtc::smtc_dbg, sizeof(smtc::smtc_dbg)); }\n\nint smtc_dbg_clear(void) { static long long z[sizeof(smtc::smtc_dbg) / 8]; return (int)cudaMemcpyToSymbol(smtc::smtc_dbg, z, sizeof(z)); }\n\nconst char* smtc_error_string(int err)')
    open(p, "w").write(s)

    # backward passes: thread 0's cycles in the block, and those spent waiting on
    # the ring's barriers (blocks 0-255)
    p = os.path.join(dst, src, "csrc", "sdpa_bwd_core.cuh")
    s = open(p).read()
    s = s.replace("// ---- the tensor-core pair (bf16): wgmma fed by TMA", "__device__ long long smtc_dbgb[2 * 256 * 4];\n// ---- the tensor-core pair (bf16): wgmma fed by TMA", 1)
    for kern, idx in (("sdpa_bwd_rows_wg_kernel", 0), ("sdpa_bwd_keys_wg_kernel", 1)):
        i = s.index(kern + "(const __grid_constant__")
        j = s.index("{", i) + 1
        s = s[:j] + "\n  const long long dbg_t0 = clock64(); long long dbg_w = 0;\n  const int dbg_blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n" + s[j:]
        # end of kernel: before the staged copy
        k = s.index("  __syncthreads();\n  copy_tile_out<D>", j)
        s = s[:k] + ("  if (threadIdx.x == 0 && dbg_blk < 256) { smtc_dbgb[(%d * 256 + dbg_blk) * 4] = clock64() - dbg_t0; smtc_dbgb[(%d * 256 + dbg_blk) * 4 + 1] = dbg_w; }\n" % (idx, idx)) + s[k:]
    s = s.replace("    mbar_wait(full(s), (i / kTcBwdStages) & 1);", "    { const long long w0 = clock64(); mbar_wait(full(s), (i / kTcBwdStages) & 1); dbg_w += clock64() - w0; }")
    s = s.replace("  mbar_wait(full_qd, 0);", "  { const long long w0 = clock64(); mbar_wait(full_qd, 0); dbg_w += clock64() - w0; }")
    s = s.replace("  mbar_wait(full_kv, 0);", "  { const long long w0 = clock64(); mbar_wait(full_kv, 0); dbg_w += clock64() - w0; }")
    open(p, "w").write(s)
    p = os.path.join(dst, src, "csrc", "sdpa_bwd.cu")
    s = open(p).read()
    s = s.replace('const char* smtc_error_string(int err)', 'int smtc_dbgb_copy(void* dst) { return (int)cudaMemcpyFromSymbol(dst, smtc::smtc_dbgb, sizeof(smtc::smtc_dbgb)); }\n\nconst char* smtc_error_string(int err)')
    open(p, "w").write(s)


def measure():
    os.chdir(ROOT)
    sys.path.insert(0, os.path.join(ROOT, "build", "inst"))
    import numpy as np
    import torch

    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A

    lib = A._lib()
    names = ["start", "cm", "accQ", "accK", "S", "softmax", "pack", "accV", "PV", "store"]
    for (b, h, lq, lk, masked) in ((16, 12, 197, 197, False), (16, 12, 128, 128, True)):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device="cuda").bfloat16() for n in (lq, lk, lk))
        mask = (torch.arange(lk, device="cuda")[None] < torch.full((b, 1), lk - 20, device="cuda")).int() if masked else None
        lib.smtc_dbg_clear()
        for _ in range(5):
            A.sdpa_fwd_cuda(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        buf = np.zeros(32 * 8 * 10, np.int64)
        rc = lib.smtc_dbg_copy(ctypes.c_void_p(buf.ctypes.data))
        t = buf.reshape(32, 8, 10).astype(np.float64)
        print(f"== {b}x{h}x{lq}x{lk} rc {rc}")
        for ui in range(4):
            d = t[:, ui, 1:] - t[:, ui, :-1]
            ok = (t[:, ui, 0] > 0)
            print("unit", ui, " ".join(f"{names[i+1]} {np.median(d[ok, i]):.0f}" for i in range(9)),
                  "| total", np.median(t[ok, ui, 9] - t[ok, ui, 0]))
        print("gap between units", np.median(t[:, 1, 0] - t[:, 0, 9]), np.median(t[:, 2, 0] - t[:, 1, 9]))

    blib = A._bwd_lib()
    for (b, h, lq, lk, masked) in ((16, 12, 197, 197, False), (32, 12, 128, 128, True), (32, 12, 402, 402, True)):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(b, h, n, 64, generator=g, device="cuda").bfloat16() for n in (lq, lk, lk, lq))
        _, st = A.sdpa_fwd_cuda(q, k, v, None, 0.125, with_stats=True)
        for _ in range(3):
            A.sdpa_bwd_cuda(q, k, v, None, do, 0.125, stats=st)
        torch.cuda.synchronize()
        buf = np.zeros(2 * 256 * 4, np.int64)
        blib.smtc_dbgb_copy(ctypes.c_void_p(buf.ctypes.data))
        t = buf.reshape(2, 256, 4)
        for pi, name in enumerate(("pass A", "pass B")):
            ok = t[pi, :, 0] > 0
            print(f"{b}x{h}x{lq}x{lk} {name}: block cycles median {np.median(t[pi, ok, 0]):.0f}, waiting {np.median(t[pi, ok, 1]):.0f}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--measure"]:
        measure()
    else:
        make_copy()
        sys.exit(subprocess.run([sys.executable, os.path.abspath(__file__), "--measure"]).returncode)
