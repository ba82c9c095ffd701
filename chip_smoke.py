#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a host with a CUDA card, ``nvcc``
and the CUDA toolkit. It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per source,
   all at once) and prints the build seconds;
3. calls each kernel's wrapper at every shape the serving path and ViLT's
   joint encoder give it (every bf16 SDPA in the tensor-core kernel of
   ``sdpa_core.cuh``, P in registers; ViLT: 32x12x402x402x64 bf16 with
   ViLT's mask of text padding and canvas area past each image's extent,
   and the fused block at 32x402x768; also checked, though no path runs
   them, 402 in float32 and the fixed square's 185) and holds the result
   against the plain PyTorch version on the same inputs (float32: 1e-4 of the output's scale; bfloat16: 2e-2 of it, because the
   plain version rounds its score product to bfloat16 where the kernel keeps
   float32), and times the kernel, the plain version and, as a yardstick the
   port never calls, one PyTorch library call computing the same function
   (the fused block's forward also as the encoder calls it, with Linear weight
   views that the wrapper reads without copying);
4. serves the full-width late-fusion model (Bernice-base + ViT-B/16, 12+12
   layers, hidden 768, vocab 250,002, 224 px, ``max_batch`` 16, random
   weights from a seed) through ``build_service`` + ``MicroBatcher`` + HTTP,
   once with ``--attn_impl auto`` (the SDPA kernel everywhere) and once with
   ``--attn_impl fused`` (the block kernel for self-attention), with the
   launch counts set to 0 before and read after each run;
5. checks that no request failed, that each answer's probabilities sum to 1,
   that every kernel of the path launched the expected number of times per
   window, and that the probabilities match a plain-path service built from
   the same state dict (within 2e-2: bfloat16 activations through 24 layers,
   rounded at other places than in the plain version);
6. holds the backward kernels against their plain versions at the training
   shapes (the SDPA backward at text 32x12x128x64 bf16 masked, at the
   fusion head's 32x1x1x768 over 197 keys in float32, where the row pair of
   ``sdpa_bwd_core.cuh`` runs, and at ViLT's shapes above; in bf16 the
   tensor-core query-tiled pair runs at all of them, and at the text shape
   the block kernel, asked for, is checked and timed beside it; the fused block's backward at
   32x128x768 and 32x402x768 bf16, 12 heads, masked, its five outputs and,
   through autograd, all ten gradients), with the tolerances above against each
   output's scale (for the weight and bias gradients, sums over 4,096 rows
   that cancel, the size of their terms), and times them like the forward
   kernels (the library yardstick: the backward alone of
   ``scaled_dot_product_attention`` / ``nn.MultiheadAttention`` over a graph
   built once); the fused block's backward twice: the kernel alone (to x,
   against ``nn.MultiheadAttention``'s backward to x) and whole, through
   autograd with its weight gradients on the TN GEMM (against
   ``nn.MultiheadAttention``'s backward to x, its weights and biases);
7. trains the full-width model with ITC + TIM through the port's
   ``cli/run_mm_late.main`` on a small generated task-3 dataset (64 posts,
   a uint8 pixel cache, neither pandas nor PIL), one epoch at batch 16 in
   bfloat16, once with ``--attn_impl auto`` and once with ``fused``, and
   checks the artifacts, that every loss is finite, that every trainable
   parameter got a finite gradient and the vision tower none, and the exact
   launch counts per train step and per eval step (under ``fused`` one TN
   weight-gradient launch per block backward); it prints ms per train
   step, posts/s, the device idle share of one profiled step, its largest
   kernels, copies and float32 sgemm launches (``fused`` may launch no more
   of these than ``auto``) and the peak device memory;
8. trains full-width ViLT-B/32 (12 pre-LN layers, hidden 768, vocab 30,522,
   40 text positions, patch 32) with ITC + TIM through ``cli/run_mm_early.main``
   under ``--vilt_exact_resize`` on the same posts, one epoch at batch 16 in
   bfloat16 under ``auto`` and ``fused``: each image a generated frame at the
   extent of a random photo size on the 608-px canvas (no photo is decoded,
   so no PIL is needed), and it checks that every batch carries its images'
   extents,
   the exact launch counts (12 SDPA forward and 12 backward per train step,
   12 forward per eval step, all at L = 402; under ``fused`` the block
   kernels and 12 TN launches instead), finite losses and gradients of every parameter but the
   unread pooler, and the artifacts, with the same numbers as step 7;
9. holds the first train step of ``auto`` and of ``fused`` against the plain
   path (``--attn_impl jnp``), for late fusion and for ViLT: same state
   dict, same batch, dropout 0, the ITM swap pinned, every text-tower (ViLT:
   joint-encoder) attention weight and, in late fusion, fusion-head tensor
   (but the key bias, whose exact gradient is zero). In float32 the loss
   within 1e-5 and each gradient within 1e-3 relative (Frobenius). In
   bfloat16 the plain path rounds its scores to bfloat16 before the softmax
   where the kernels keep float32, so both are held against the float32
   plain gradients: the kernel path's median and worst relative error no
   more than 1.5 times the bfloat16 plain path's, the loss within 2e-2;
10. drives ``attn_block(impl="fused_perhead")`` (TPU kernels 5 and 6) at
   full width, 768 hidden and 12 heads, masked where the path masks: the
   forward at text 16x128 and image 16x197, forward and backward (through
   ``torch.autograd.grad``) at text 32x128 and ViLT 32x402 in bfloat16 and
   at 32x402 in float32, with the counts at 0 before and read after; holds
   the outputs, the backward kernel's five outputs and the ten gradients
   against the plain per-head versions (step 3's and step 6's tolerances),
   and times each kernel beside its plain version, ``nn.MultiheadAttention``,
   its bound and the packed kernels 7 and 8 at the same shape;
11. starts the late-fusion towers from checkpoints written from a seed under
   Hugging Face's names at full width (Bernice-base ``pytorch_model.bin``
   with a hand-encoded ``sentencepiece.bpe.model``, ViT-B/16
   ``model.safetensors`` written by hand): one epoch of
   ``cli/run_mm_late.main``, every imported tensor on the device checked
   against the file's, the tokenizer's ids against the file's vocabulary,
   the vision tower frozen as the file's, finite losses; then
   ``--import_reference_ckpt`` with a reference-format ``MM_Model`` state
   dict, its classification logits equal to those of a model loaded from
   the converted state dict; no transformers, safetensors, msgpack or flax
   imported;
12. logs the ptxas registers and spills of every kernel, the resident
   blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) of the
   tensor-core SDPA kernels at ViLT's 402 keys, of the fusion head's row
   pair and of the bf16 GEMM in each orientation, and the count of HGMMA
   (wgmma), UTMALDG (TMA load) and HMMA (mma.sync) instructions in each
   kernel function's SASS (``cuobjdump --dump-sass``), failing if a bf16
   GEMM function (NT, NN or TN) has none of the first two; then holds the
   bf16 GEMM alone against its plain version and times it beside one cuBLAS
   call over the same operands (a yardstick the port never calls), with the
   TFLOP/s of each: NT at row 7's shapes (M = 2048, 3152, 12864; three
   weights and one, against ``F.linear``), NN at row 8's (dctx and dx at
   M = 4096 and 12864, against ``torch.matmul``) and TN, the four weight
   gradients of a block at the same rows (against ``torch.bmm``); and the
   host's time to enqueue
   one fused block, forward and
   forward plus backward, at a shape whose device time is smaller
   (``python3 chip_smoke.py --enqueue ROOT`` runs that reading alone for
   the port of another checkout, such as an older commit's, so two versions
   can be compared in one run);
13. prints one JSON line of per-kernel numbers (``launches``: the count over
   the serving and training runs and the per-head phase's main path; 0 for
   the check-only shapes), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. Without CUDA, or
without the repository beside it, it exits non-zero at once.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

PKG = "socialmedia_textimage_classification_auxlosses_tpu_torch"
JAX_PKG = "socialmedia_textimage_classification_auxlosses_tpu"

# NVIDIA H100 SXM data sheet (dense): bytes/s of HBM3, operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

BATCH = 16
N_REQUESTS = 48
N_CLIENTS = 16
PROB_TOL = 2e-2
TRAIN_POSTS = (48, 8, 8)  # train / val / test rows of the generated dataset
DEVICE = "cuda"
VILT_TEXT, VILT_SIDE = 40, 19  # ViLT's text positions; the 608-px canvas at patch 32
VILT_LEN = VILT_TEXT + 1 + VILT_SIDE ** 2  # 402, --vilt_exact_resize
VILT_FIXED_LEN = VILT_TEXT + 1 + 12 ** 2  # 185, the fixed 384-px square
# photo sizes (height, width) of 4:3, 3:4, 16:9 and 1:1 for the generated ViLT frames
VILT_PHOTOS = ((480, 640), (640, 480), (720, 1280), (500, 500), (960, 1280), (1080, 1920))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters=30, warmup=3):
    """Device milliseconds per call of ``fn``. A long sleep kernel is queued
    first so the host enqueues every call before the card reaches the start
    event: the events then time the device, not the host's launch loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for sleep in (200_000_000, 2_000_000_000):
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_bound = start.query()  # the card got past the sleep before the host was done
        torch.cuda.synchronize()
        if not host_bound:
            return start.elapsed_time(end) / iters
    # still host-bound: the events' span includes the card waiting for the
    # host, an upper bound on the device time
    log(f"timing: {getattr(fn, '__name__', 'call')} stayed host-bound; its time is "
        "the events' span, an upper bound")
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def vilt_mask(torch, g, b, length):
    """ViLT's joint key mask (B, L) int32: 40 text positions padded past a
    random length, the image CLS, then the image patches: at L = 402 the
    19 x 19 canvas kept inside a random extent of 12 to 19 patches a side
    (canvas area past the image is masked), at L = 185 the 12 x 12 square
    kept whole."""
    lens = torch.randint(2, VILT_TEXT + 1, (b,), generator=g, device="cuda")
    text = torch.arange(VILT_TEXT, device="cuda")[None, :] < lens[:, None]
    side = round((length - VILT_TEXT - 1) ** 0.5)
    if length == VILT_LEN:
        gh, gw = (torch.randint(12, side + 1, (b,), generator=g, device="cuda") for _ in range(2))
    else:
        gh = gw = torch.full((b,), side, device="cuda")
    iy = torch.arange(side, device="cuda")
    grid = (iy[None, :, None] < gh[:, None, None]) & (iy[None, None, :] < gw[:, None, None])
    return torch.cat([text, torch.ones(b, 1, dtype=torch.bool, device="cuda"),
                      grid.reshape(b, -1)], dim=1).to(torch.int32)


def log_ptxas(source, text):
    """One line per kernel of ``source``'s nvcc log (``-Xptxas -v``): its
    (mangled) name, registers and spill bytes."""
    import re

    name = None
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            log(f"ptxas {source}: {name}: {regs.group(1) if regs else ln.strip()} registers; "
                f"{spill}")
            name = None


def log_occupancy(A, AB):
    """Resident blocks per SM, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with shared memory and registers as launched: the tensor-core SDPA
    kernels at ViLT's 402 keys, head dim 64 (128 threads a block), the row
    pair of the fusion head's backward at 197 keys in float32 (256 threads)
    and the bf16 GEMM in its three orientations (384 threads, its 4-stage
    ring and output staging)."""
    import ctypes

    fwd, bwd, gemm = A._lib(), A._bwd_lib(), AB._bwd_lib()
    fwd.smtc_sdpa_fwd_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    bwd.smtc_sdpa_bwd_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    for kernel, n, what in (
            ("sdpa_fwd_tc_kernel<64>", fwd.smtc_sdpa_fwd_blocks_per_sm(64, VILT_LEN),
             f"128 threads at Lk = {VILT_LEN}"),
            ("sdpa_bwd_rows_tc_kernel<64> (pass A)",
             bwd.smtc_sdpa_bwd_blocks_per_sm(0, 64, VILT_LEN), f"128 threads at Lk = {VILT_LEN}"),
            ("sdpa_bwd_keys_tc_kernel<64> (pass B)",
             bwd.smtc_sdpa_bwd_blocks_per_sm(1, 64, VILT_LEN), f"128 threads at Lk = {VILT_LEN}"),
            ("sdpa_bwd_row_scores_kernel<float> (row pair, score pass)",
             bwd.smtc_sdpa_bwd_blocks_per_sm(2, 768, 197), "256 threads"),
            ("sdpa_bwd_row_cols_kernel<float> (row pair, column pass)",
             bwd.smtc_sdpa_bwd_blocks_per_sm(3, 768, 197), "256 threads at Lk = 197"),
            ("gemm_bf16_tma<NT>", gemm.smtc_gemm_blocks_per_sm(0), "384 threads"),
            ("gemm_bf16_tma<NN>", gemm.smtc_gemm_blocks_per_sm(1), "384 threads"),
            ("gemm_bf16_tma<TN>", gemm.smtc_gemm_blocks_per_sm(2), "384 threads")):
        if n < 0:
            raise AssertionError(f"occupancy query of {kernel}: CUDA error {-n}")
        log(f"occupancy {kernel}: {n} blocks of {what} per SM")


# the bf16 GEMM's orientations (gemm_core.cuh::GemmMode) each library must hold
GEMM_MODES = {"attn_block_fwd": {0}, "attn_block_bwd": {0, 1, 2},
              "attn_block_perhead_fwd": {0}, "attn_block_perhead_bwd": {0}}


def log_sass(_cuda):
    """Counts of the Hopper instructions in each kernel function's SASS
    (``cuobjdump --dump-sass`` of every built library): HGMMA (wgmma),
    UTMALDG (TMA loads) and HMMA (mma.sync). Fails if a library lacks a
    bf16 GEMM orientation it should hold (``GEMM_MODES``: NT, and in the
    block backward's library NN and TN too), or if one of those functions
    issues no wgmma or no TMA load."""
    import re
    import shutil

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    names = {0: "NT", 1: "NN", 2: "TN"}
    for lib in _cuda.SOURCES:
        sass = subprocess.run([tool, "--dump-sass", _cuda.library_path(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        parts = re.split(r"Function : (\S+)", sass)
        seen = set()
        for fn, body in zip(parts[1::2], parts[2::2]):
            n = {op: len(re.findall(rf"\b{op}\.", body)) for op in ("HGMMA", "UTMALDG", "HMMA")}
            mode = re.search(r"gemm_bf16_tmaILi(\d)E", fn)
            tag = f"gemm_bf16_tma<{names[int(mode.group(1))]}>" if mode else fn[:90]
            log(f"sass {lib}: {tag}: HGMMA {n['HGMMA']}, UTMALDG {n['UTMALDG']}, HMMA {n['HMMA']}")
            if mode:
                seen.add(int(mode.group(1)))
                if not (n["HGMMA"] and n["UTMALDG"]):
                    raise AssertionError(f"{lib}: {tag} issues no wgmma or no TMA load")
        if not GEMM_MODES.get(lib, set()) <= seen:
            raise AssertionError(f"{lib}: bf16 GEMM orientations {sorted(seen)}, expected "
                                 f"{sorted(GEMM_MODES[lib])}")


def time_gemm(torch, AB):
    """The bf16 GEMM of kernels 5-8 alone, in its three orientations, each
    held against its plain version (2e-2 of the output's scale) and timed
    beside one cuBLAS call over the same operands, a yardstick the port
    never calls; the achieved TFLOP/s of each:
      * NT at row 7's shapes (the QKV projections, three weights, and the
        out-projection, one) against ``F.linear`` over the weights
        concatenated;
      * NN at row 8's (dctx = dO . Wo, one pair, and dx, three pairs summed)
        against ``torch.matmul`` (over the pairs concatenated along K);
      * TN, the four weight gradients of one block backward (x with dq, dk
        and dv, ctx with dO) at the same rows, against one ``torch.bmm``.
    Returns the lines by orientation and the TN kernel rows (the rows of
    the main path's shapes, for the kernels line)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    hid, out = 768, {"gemm_nt": [], "gemm_nn": [], "gemm_tn": []}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    def held(what, got, want):
        err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
        if not err <= 2e-2 * max(1.0, max(y.float().abs().max().item() for y in want)):
            raise AssertionError(f"{what}: disagrees with its plain version ({err})")
        return err

    def line(kind, what, m, err, ms, lib_name, lib_ms, flop, **extra):
        row = dict(shape=what, m=m, max_abs_err=err, ms=ms, tflops=flop / ms / 1e9,
                   library_ms=lib_ms, library_tflops=flop / lib_ms / 1e9, **extra)
        log(f"{kind}/{what}: M {m}, kernel {ms:.5f} ms ({row['tflops']:.1f} TFLOP/s), "
            f"{lib_name} {lib_ms:.5f} ms ({row['library_tflops']:.1f} TFLOP/s), "
            f"max_abs_err {err:.3e}" + "".join(f", {k} {v}" for k, v in extra.items()))
        out[kind].append(row)
        return row

    for tag, m in (("text", BATCH * 128), ("image", BATCH * 197), ("vilt_exact", 2 * BATCH * VILT_LEN)):
        a = randn(m, hid)
        for count in (3, 1):
            ws = [randn(hid, hid, scale=hid ** -0.5) for _ in range(count)]
            bs = [randn(hid) for _ in range(count)]
            err = held(f"gemm_nt {tag} x{count}", AB.gemm_nt(a, ws, bs), AB.gemm_nt_reference(a, ws, bs))
            w_cat, b_cat = torch.cat(ws), torch.cat(bs)
            line("gemm_nt", f"{tag} x{count}", m, err, device_ms(torch, lambda: AB.gemm_nt(a, ws, bs)),
                 "F.linear", device_ms(torch, lambda: F.linear(a, w_cat, b_cat)),
                 2.0 * m * hid * hid * count)

    tn_rows = []
    for tag, m in (("text", 2 * BATCH * 128), ("vilt_exact", 2 * BATCH * VILT_LEN)):
        # NN: dctx (one pair) and dx (three), W the Linear (out, in) weight as (K, N)
        for count in (1, 3):
            as_ = [randn(m, hid) for _ in range(count)]
            ws = [randn(hid, hid, scale=(count * hid) ** -0.5) for _ in range(count)]
            err = held(f"gemm_nn {tag} x{count}", [AB.gemm_nn(as_, ws)],
                       [AB.gemm_nn_reference(as_, ws)])
            a_cat, w_cat = torch.cat(as_, dim=1), torch.cat(ws)
            line("gemm_nn", f"{tag} x{count}", m, err, device_ms(torch, lambda: AB.gemm_nn(as_, ws)),
                 "torch.matmul", device_ms(torch, lambda: torch.matmul(a_cat, w_cat)),
                 2.0 * m * hid * hid * count)
        # TN: the block's four weight gradients over m token rows
        x, ctx = randn(m, hid), randn(m, hid)
        xs, gs = [x, x, x, ctx], [randn(m, hid, scale=m ** -0.5) for _ in range(4)]
        want = AB.gemm_tn_reference(xs, gs)
        err = held(f"gemm_tn {tag}", AB.gemm_tn(xs, gs), want)
        x_st, g_st = torch.stack(xs), torch.stack(gs)
        flop = 2.0 * m * hid * hid * 4
        lib_ms = device_ms(torch, lambda: torch.bmm(g_st.transpose(1, 2), x_st))
        ms = device_ms(torch, lambda: AB.gemm_tn(xs, gs))
        line("gemm_tn", f"{tag} x4", m, err, ms, "torch.bmm", lib_ms, flop)
        # the kernels line: six (m, 768) inputs read once, four (768, 768) written
        bound_ms, bound_by = bound(nbytes(x, ctx, *gs, *want), flop, "bfloat16")
        tn_rows.append(dict(name=f"gemm_tn/{tag}", kernel="gemm_tn_bf16", key=(m, hid, hid, 4),
                            max_abs_err=err, ms=ms,
                            plain_ms=device_ms(torch, lambda: AB.gemm_tn_reference(xs, gs)),
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
        log(f"time gemm_tn/{tag}: kernel {ms:.4f} ms, plain {tn_rows[-1]['plain_ms']:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del x, ctx, xs, gs, want, x_st, g_st
        torch.cuda.empty_cache()
    return out, tn_rows


ENQUEUE_CALLS = 300


def time_enqueue(torch, AB):
    """Host microseconds to enqueue the fused block (kernels 7 and 8) once,
    at 2x16x768 bf16, 12 heads, masked, with Linear weight views as the
    encoder passes them: its forward under ``no_grad``, and forward plus
    backward through autograd. Each is the wall time of ``ENQUEUE_CALLS``
    calls without a sync, per call, the median of five such loops; the
    device time per call (``device_ms``) stands beside it, and where it is
    the smaller, the loop measured the host's enqueue, not the card."""
    g = torch.Generator(device="cuda").manual_seed(5)
    b, l, hid, heads = 2, 16, 768, 12
    x = torch.randn(b, l, hid, generator=g, device="cuda").bfloat16()
    lin = [(torch.randn(hid, hid, generator=g, device="cuda") * hid ** -0.5).bfloat16()
           .requires_grad_() for _ in range(4)]  # (out, in), as nn.Linear keeps them
    bias = [(0.1 * torch.randn(hid, generator=g, device="cuda")).bfloat16().requires_grad_()
            for _ in range(4)]
    mask = torch.ones(b, l, dtype=torch.int32, device="cuda")
    mask[1, l // 2:] = 0
    do = torch.randn(b, l, hid, generator=g, device="cuda").bfloat16()

    def block():
        return AB.attn_block(x, mask, lin[0].t(), bias[0], lin[1].t(), bias[1], lin[2].t(),
                             bias[2], lin[3].t(), bias[3], heads=heads)

    def fwd():
        with torch.no_grad():
            block()

    def fwd_bwd():
        block().backward(do)

    out = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(ENQUEUE_CALLS):
                fn()
            loops.append((time.perf_counter() - t0) / ENQUEUE_CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = {"host_us": sorted(loops)[2], "host_us_loops": loops,
                     "device_us": device_ms(torch, fn) * 1e3}
        log(f"enqueue attn_block {name} 2x16x768: host {out[name]['host_us']:.2f} us per call "
            f"(median of 5 loops of {ENQUEUE_CALLS}; loops {[round(t, 2) for t in loops]}), "
            f"device {out[name]['device_us']:.2f} us")
    return out


def enqueue_only(root):
    """``python3 chip_smoke.py --enqueue ROOT``: ``time_enqueue`` alone, for the
    port of the checkout at ROOT (for example an unpacked older commit, to
    compare two versions in one run), after building its kernels there."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    _cuda.build()
    log(f"enqueue: the port at {os.path.dirname(os.path.dirname(os.path.abspath(AB.__file__)))}; "
        f"card: {card_line()}")
    log(json.dumps({"enqueue": time_enqueue(torch, AB)}))
    return 0


def check_kernels(torch):
    """Each kernel against its plain version at the serving shapes."""
    import torch.nn.functional as F

    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def lengths_mask(b, length):
        lens = torch.randint(2, length + 1, (b,), generator=g, device="cuda")
        mask = (torch.arange(length, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        mask[0] = 0  # a fully masked row: uniform weights, not NaN
        return mask

    def record(name, kernel, key, out, ref, run, plain, library, nb, ops, dtype):
        out, ref = out.float(), ref.float()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        tol = (2e-2 if dtype == "bfloat16" else 1e-4) * scale
        log(f"check {name}: max_abs_err {err:.3e} rel {err / scale:.3e} "
            f"tol {tol:.1e} ({dtype})")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err} > {tol})")
        bound_ms, bound_by = bound(nb, ops, dtype)
        with torch.no_grad():
            row = dict(name=name, kernel=kernel, key=key, max_abs_err=err,
                       ms=device_ms(torch, run), plain_ms=device_ms(torch, plain),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=device_ms(torch, library))
        log(f"time {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append(row)

    # TPU kernels 1 and 3: every SDPA of the serving path and of ViLT (the
    # joint sequence with TIM batched, 2B rows; 402 > 256 is kernel 3's
    # range; float32 and the fixed square's 185 are checked, not on the paths)
    for tag, (b, h, lq, lk, d, dtype, masked) in {
            "text": (BATCH, 12, 128, 128, 64, "bfloat16", True),
            "image": (BATCH, 12, 197, 197, 64, "bfloat16", False),
            "fusion": (BATCH, 1, 1, 197, 768, "float32", False),
            "vilt_exact": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "bfloat16", "vilt"),
            "vilt_exact_f32": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "float32", "vilt"),
            "vilt_fixed": (2 * BATCH, 12, VILT_FIXED_LEN, VILT_FIXED_LEN, 64, "bfloat16",
                           "vilt")}.items():
        dt = getattr(torch, dtype)
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        mask = (vilt_mask(torch, g, b, lk) if masked == "vilt"
                else lengths_mask(b, lk) if masked else None)
        masked = mask is not None
        scale = d ** -0.5
        attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
        out = A.sdpa(q, k, v, mask, scale)
        ref = A.sdpa_reference(q, k, v, mask, scale)
        record(f"sdpa_fwd/{tag}", "sdpa_fwd", (dtype, b, h, lq, lk, d, masked), out, ref,
               lambda: A.sdpa(q, k, v, mask, scale),
               lambda: A.sdpa_reference(q, k, v, mask, scale),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale),
               nbytes(q, k, v, mask, out), 4.0 * b * h * lq * lk * d, dtype)

    # TPU kernel 7: every self-attention block with --attn_impl fused
    hid, heads = 768, 12
    for tag, (b, l, masked) in {"text": (BATCH, 128, True),
                                "image": (BATCH, 197, False),
                                "vilt_exact": (2 * BATCH, VILT_LEN, "vilt")}.items():
        dt = torch.bfloat16
        x = randn(b, l, hid, dtype=dt)
        w = [(randn(hid, hid, dtype=torch.float32) * hid ** -0.5).to(dt) for _ in range(4)]
        bias = [randn(hid, dtype=torch.float32).mul(0.1).to(dt) for _ in range(4)]
        mask = (vilt_mask(torch, g, b, l) if masked == "vilt"
                else lengths_mask(b, l) if masked else None)
        masked = mask is not None
        args = [x, mask, w[0], bias[0], w[1], bias[1], w[2], bias[2], w[3], bias[3]]
        mha = torch.nn.MultiheadAttention(hid, heads, batch_first=True, device="cuda", dtype=dt)
        with torch.no_grad():
            mha.in_proj_weight.copy_(torch.cat([wi.t() for wi in w[:3]]))
            mha.in_proj_bias.copy_(torch.cat(bias[:3]))
            mha.out_proj.weight.copy_(w[3].t())
            mha.out_proj.bias.copy_(bias[3])
        pad = None if mask is None else mask == 0
        out = AB.attn_block(*args, heads=heads)
        ref = AB.attn_block(*args, heads=heads, impl="jnp")
        ops = 2.0 * b * l * hid * hid * 4 + 4.0 * b * l * l * hid
        record(f"attn_block_fwd/{tag}", "attn_block_fwd", ("bfloat16", b, l, hid, heads, masked),
               out, ref, lambda: AB.attn_block(*args, heads=heads),
               lambda: AB.attn_block(*args, heads=heads, impl="jnp"),
               lambda: mha(x, x, x, key_padding_mask=pad, need_weights=False),
               nbytes(x, mask, *w, *bias, out), ops, "bfloat16")
        # the call as the encoder makes it, with Linear weights: the wrapper reads
        # their (out, in) storage through .t() views, where the row above copies
        # the four contiguous (in, out) weights into that layout on every call
        lin = [wi.t().contiguous().t() for wi in w]
        largs = [x, mask, lin[0], bias[0], lin[1], bias[1], lin[2], bias[2], lin[3], bias[3]]
        with torch.no_grad():
            if not torch.equal(AB.attn_block(*largs, heads=heads), out):
                raise AssertionError(f"attn_block_fwd/{tag}: Linear weight views change the output")
            views_ms = device_ms(torch, lambda: AB.attn_block(*largs, heads=heads))
        log(f"time attn_block_fwd/{tag} with Linear weight views (no copies): kernel "
            f"{views_ms:.5f} ms")
    return rows


def check_bwd_kernels(torch):
    """Each backward kernel against its plain version at the training shapes."""
    import torch.nn.functional as F

    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def close(name, outs, refs, scales, dtype):
        """Max abs error over the outputs; each held to its own scale."""
        worst = 0.0
        for i, (o, r, sc) in enumerate(zip(outs, refs, scales)):
            o, r = o.float(), r.float()
            if not torch.isfinite(o).all():
                raise AssertionError(f"{name}: output {i} is not finite")
            err = (o - r).abs().max().item()
            tol = (2e-2 if dtype == "bfloat16" else 1e-4) * max(1.0, sc)
            if not err <= tol:
                raise AssertionError(f"{name}: output {i} disagrees with the plain "
                                     f"version ({err} > {tol})")
            worst = max(worst, err)
        log(f"check {name}: max_abs_err {worst:.3e} over {len(outs)} outputs ({dtype})")
        return worst

    def timed(name, kernel, key, err, run, plain, library, nb, ops, dtype):
        bound_ms, bound_by = bound(nb, ops, dtype)
        row = dict(name=name, kernel=kernel, key=key, max_abs_err=err,
                   ms=device_ms(torch, run), plain_ms=device_ms(torch, plain),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=device_ms(torch, library))
        log(f"time {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append(row)

    # TPU kernels 2 and 4: the SDPA backward of the text tower, of the fusion
    # head and of ViLT's joint sequence (the query-tiled pair at 402 and 185;
    # float32 and 185 are checked, not on the paths)
    for tag, (b, h, lq, lk, d, dtype, masked) in {
            "text": (2 * BATCH, 12, 128, 128, 64, "bfloat16", True),
            "fusion": (2 * BATCH, 1, 1, 197, 768, "float32", False),
            "vilt_exact": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "bfloat16", "vilt"),
            "vilt_exact_f32": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "float32", "vilt"),
            "vilt_fixed": (2 * BATCH, 12, VILT_FIXED_LEN, VILT_FIXED_LEN, 64, "bfloat16",
                           "vilt")}.items():
        dt = getattr(torch, dtype)
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        do = randn(b, h, lq, d, dtype=dt)
        mask = None
        if masked == "vilt":
            mask = vilt_mask(torch, g, b, lk)
        elif masked:
            lens = torch.randint(2, lk + 1, (b,), generator=g, device="cuda")
            mask = (torch.arange(lk, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        masked = mask is not None
        scale = d ** -0.5
        outs = A.sdpa_bwd_cuda(q, k, v, mask, do, scale)
        refs = A.sdpa_bwd_reference(q, k, v, mask, do, scale)
        err = close(f"sdpa_bwd/{tag}", outs, refs, [r.float().abs().max().item() for r in refs],
                    dtype)
        if tag == "text":
            # the block kernel, asked for, where the tensor-core pair runs:
            # which is faster
            block = A.sdpa_bwd_cuda(q, k, v, mask, do, scale, kernel="block")
            close("sdpa_bwd/text block kernel", block, refs,
                  [r.float().abs().max().item() for r in refs], dtype)
            block_ms = device_ms(torch, lambda: A.sdpa_bwd_cuda(q, k, v, mask, do, scale,
                                                                kernel="block"))
            pair_ms = device_ms(torch, lambda: A.sdpa_bwd_cuda(q, k, v, mask, do, scale))
            log(f"time sdpa_bwd/text: block kernel {block_ms:.4f} ms, query-tiled pair "
                f"{pair_ms:.4f} ms")
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask, scale=scale)
        timed(f"sdpa_bwd/{tag}", "sdpa_bwd", (dtype, b, h, lq, lk, d, masked), err,
              lambda: A.sdpa_bwd_cuda(q, k, v, mask, do, scale),
              lambda: A.sdpa_bwd_reference(q, k, v, mask, do, scale),
              lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True),
              nbytes(q, k, v, do, mask, *outs), 10.0 * b * h * lq * lk * d, dtype)

    # TPU kernel 8: the fused block's backward in the text tower and in
    # ViLT's joint encoder, --attn_impl fused
    hid, heads = 768, 12
    for tag, l in (("text", 128), ("vilt_exact", VILT_LEN)):
        b, dt = 2 * BATCH, torch.bfloat16
        x = randn(b, l, hid, dtype=dt)
        w = [(randn(hid, hid, dtype=torch.float32) * hid ** -0.5).to(dt) for _ in range(4)]
        bias = [randn(hid, dtype=torch.float32).mul(0.1).to(dt) for _ in range(4)]
        if tag == "text":
            lens = torch.randint(2, l + 1, (b,), generator=g, device="cuda")
            mask = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        else:
            mask = vilt_mask(torch, g, b, l)
        do = randn(b, l, hid, dtype=dt)
        scale = (hid // heads) ** -0.5
        kargs = (x, mask, w[0], bias[0], w[1], bias[1], w[2], bias[2], w[3], do, heads)
        outs = AB.attn_block_bwd_cuda(*kargs, scale)
        refs = AB.attn_block_bwd_packed_reference(*kargs, scale)
        err = close(f"attn_block_bwd/{tag}", outs, refs,
                    [r.float().abs().max().item() for r in refs], "bfloat16")
        # through autograd: the ten gradients of attn_block against the plain backward
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, w[0], bias[0], w[1], bias[1], w[2], bias[2], w[3], bias[3])]
        before = AB.bwd_launches.count
        out = AB.attn_block(leaves[0], mask, *leaves[1:], heads=heads)
        out.backward(do, retain_graph=True)
        if AB.bwd_launches.count != before + 1:
            raise AssertionError("attn_block's gradient did not launch its backward kernel")
        want = AB.attn_block_bwd_reference(x, mask, *w[:1], bias[0], w[1], bias[1], w[2],
                                           bias[2], w[3], bias[3], do, heads)
        _, dq, dk, dv, _ = refs
        want = (want[0],) + tuple(want[2:])

        def wscale(i):
            # a weight gradient is held as the TN GEMM alone is (time_gemm),
            # to 2e-2 of its largest element
            return want[i].float().abs().max().item()

        def bscale(gr):
            return gr.float().abs().sum(dim=(0, 1)).max().item()

        scales = [outs[0].float().abs().max().item(), wscale(1), bscale(dq), wscale(3),
                  bscale(dk), wscale(5), bscale(dv), wscale(7), bscale(do)]
        # the kernel's row reports its own outputs; the whole backward's row
        # below, these ten
        err_whole = close(f"attn_block_bwd/{tag} ten gradients", [t.grad for t in leaves],
                          want, scales, "bfloat16")
        grads = [t.grad for t in leaves]
        del want
        mha = torch.nn.MultiheadAttention(hid, heads, batch_first=True, device="cuda", dtype=dt)
        with torch.no_grad():
            mha.in_proj_weight.copy_(torch.cat([wi.t() for wi in w[:3]]))
            mha.in_proj_bias.copy_(torch.cat(bias[:3]))
            mha.out_proj.weight.copy_(w[3].t())
            mha.out_proj.bias.copy_(bias[3])
        x_leaf = x.detach().clone().requires_grad_(True)
        lib_out = mha(x_leaf, x_leaf, x_leaf, key_padding_mask=mask == 0, need_weights=False)[0]
        m = b * l
        ops = 2.0 * m * hid * hid * 7 + 12.0 * b * l * l * hid
        timed(f"attn_block_bwd/{tag}", "attn_block_bwd", ("bfloat16", b, l, hid, heads, True),
              err, lambda: AB.attn_block_bwd_cuda(*kargs, scale),
              lambda: AB.attn_block_bwd_packed_reference(*kargs, scale),
              lambda: torch.autograd.grad(lib_out, (x_leaf,), do, retain_graph=True),
              nbytes(x, mask, do, *w, *bias[:3], *outs), ops, "bfloat16")
        # the whole backward through autograd: the kernel, the TN GEMM's four
        # weight gradients and the bias sums, against nn.MultiheadAttention's
        # backward to x, its weights and its biases
        mha_params = [mha.in_proj_weight, mha.in_proj_bias, mha.out_proj.weight,
                      mha.out_proj.bias]
        timed(f"attn_block_bwd_whole/{tag}", "attn_block_bwd_whole",
              ("bfloat16", b, l, hid, heads, True), err_whole,
              lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
              lambda: AB.attn_block_bwd_reference(x, mask, w[0], bias[0], w[1], bias[1], w[2],
                                                  bias[2], w[3], bias[3], do, heads),
              lambda: torch.autograd.grad(lib_out, [x_leaf] + mha_params, do, retain_graph=True),
              nbytes(x, mask, do, *w, *bias, *grads), ops + 2.0 * m * hid * hid * 4, "bfloat16")
        del lib_out, x_leaf, mha, mha_params, outs, refs, leaves, out, grads
        torch.cuda.empty_cache()
    return rows


def check_perhead_kernels(torch):
    """TPU kernels 5 and 6, ``attn_block(impl="fused_perhead")``, at full
    width (768 hidden, 12 heads): the forward at the serving shapes (text
    16x128 masked, image 16x197) and the forward and backward at the training
    shapes (text 32x128 masked, ViLT 32x402 bf16 and float32 with ViLT's
    mask). The main path is driven first, with the counts at 0 before it and
    read after it: each forward through ``attn_block`` and each backward
    through ``torch.autograd.grad``. Then its outputs, the backward kernel's
    five outputs and the ten gradients are held against the plain versions
    (rows 7/8's tolerances), and each kernel is timed beside its plain
    version, ``nn.MultiheadAttention`` (forward, or its backward over a graph
    built once), its bound and the packed kernels 7/8 at the same shape.
    Returns the rows, the launches by (kernel, key) and the comparison."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    g = torch.Generator(device="cuda").manual_seed(2)
    hid, heads = 768, 12
    scale = (hid // heads) ** -0.5

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def lengths_mask(b, length):
        lens = torch.randint(2, length + 1, (b,), generator=g, device="cuda")
        return (torch.arange(length, device="cuda")[None, :] < lens[:, None]).to(torch.int32)

    shapes = {  # tag: (batch, length, dtype, mask, backward)
        "text": (BATCH, 128, "bfloat16", "lengths", False),
        "image": (BATCH, 197, "bfloat16", None, False),
        "text_train": (2 * BATCH, 128, "bfloat16", "lengths", True),
        "vilt_exact": (2 * BATCH, VILT_LEN, "bfloat16", "vilt", True),
        "vilt_exact_f32": (2 * BATCH, VILT_LEN, "float32", "vilt", True)}
    cases = {}
    for tag, (b, l, dtype, masked, bwd) in shapes.items():
        dt = getattr(torch, dtype)
        x = randn(b, l, hid, dtype=dt)
        w = [(randn(hid, hid, dtype=torch.float32) * hid ** -0.5).to(dt) for _ in range(4)]
        bias = [randn(hid, dtype=torch.float32).mul(0.1).to(dt) for _ in range(4)]
        mask = (vilt_mask(torch, g, b, l) if masked == "vilt"
                else lengths_mask(b, l) if masked else None)
        do = randn(b, l, hid, dtype=dt) if bwd else None
        params = [w[0], bias[0], w[1], bias[1], w[2], bias[2], w[3], bias[3]]
        cases[tag] = dict(b=b, l=l, dtype=dtype, x=x, mask=mask, params=params, do=do,
                          key=(dtype, b, l, hid, heads, mask is not None))

    # the main path: attn_block(impl="fused_perhead"), forward and autograd
    AB.perhead_launches.reset()
    AB.perhead_bwd_launches.reset()
    for tag, c in cases.items():
        if c["do"] is None:
            with torch.no_grad():
                c["out"] = AB.attn_block(c["x"], c["mask"], *c["params"], heads=heads,
                                         impl="fused_perhead")
        else:
            leaves = [t.detach().clone().requires_grad_(True) for t in [c["x"]] + c["params"]]
            out = AB.attn_block(leaves[0], c["mask"], *leaves[1:], heads=heads,
                                impl="fused_perhead")
            c["grads"] = torch.autograd.grad(out, leaves, c["do"])
            c["out"] = out.detach()
            del leaves, out
    torch.cuda.synchronize()
    launches = {("attn_block_perhead_fwd", k): n
                for k, n in AB.perhead_launches.by_key.items()}
    launches.update({("attn_block_perhead_bwd", k): n
                     for k, n in AB.perhead_bwd_launches.by_key.items()})
    want_bwd = sum(c["do"] is not None for c in cases.values())
    if (AB.perhead_launches.count, AB.perhead_bwd_launches.count) != (len(cases), want_bwd):
        raise AssertionError(f"perhead: {AB.perhead_launches.count} forward and "
                             f"{AB.perhead_bwd_launches.count} backward launches, expected "
                             f"{len(cases)} and {want_bwd}")
    log(f"perhead: main path launched attn_block_perhead_fwd {AB.perhead_launches.count} and "
        f"attn_block_perhead_bwd {AB.perhead_bwd_launches.count} times")

    def close(name, outs, refs, scales, dtype):
        worst = 0.0
        for i, (o, r, sc) in enumerate(zip(outs, refs, scales)):
            o, r = o.float(), r.float()
            if not torch.isfinite(o).all():
                raise AssertionError(f"{name}: output {i} is not finite")
            err = (o - r).abs().max().item()
            tol = (2e-2 if dtype == "bfloat16" else 1e-4) * max(1.0, sc)
            if not err <= tol:
                raise AssertionError(f"{name}: output {i} disagrees with the plain version "
                                     f"({err} > {tol})")
            worst = max(worst, err)
        log(f"check {name}: max_abs_err {worst:.3e} over {len(outs)} outputs ({dtype})")
        return worst

    def mha_of(c):
        dt = getattr(torch, c["dtype"])
        wq, bq, wk, bk, wv, bv, wo, bo = c["params"]
        mha = torch.nn.MultiheadAttention(hid, heads, batch_first=True, device="cuda", dtype=dt)
        with torch.no_grad():
            mha.in_proj_weight.copy_(torch.cat([wq.t(), wk.t(), wv.t()]))
            mha.in_proj_bias.copy_(torch.cat([bq, bk, bv]))
            mha.out_proj.weight.copy_(wo.t())
            mha.out_proj.bias.copy_(bo)
        return mha

    rows, versus = [], []
    for tag, c in cases.items():
        b, l, dtype, x, mask, params = c["b"], c["l"], c["dtype"], c["x"], c["mask"], c["params"]
        pad = None if mask is None else mask == 0
        mha = mha_of(c)
        ref = AB.attn_block_perhead_reference(x, mask, *params, heads, scale)
        err = close(f"attn_block_perhead_fwd/{tag}", [c["out"]], [ref],
                    [ref.float().abs().max().item()], dtype)
        nb = nbytes(x, mask, *params, c["out"])
        ops = 2.0 * b * l * hid * hid * 4 + 4.0 * b * l * l * hid
        bound_ms, bound_by = bound(nb, ops, dtype)
        with torch.no_grad():
            row = dict(name=f"attn_block_perhead_fwd/{tag}", kernel="attn_block_perhead_fwd",
                       key=c["key"], max_abs_err=err,
                       ms=device_ms(torch, lambda: AB.attn_block_perhead_cuda(
                           x, mask, *params, heads, scale)),
                       plain_ms=device_ms(torch, lambda: AB.attn_block_perhead_reference(
                           x, mask, *params, heads, scale)),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=device_ms(torch, lambda: mha(x, x, x, key_padding_mask=pad,
                                                                 need_weights=False)))
            packed_ms = device_ms(torch, lambda: AB.attn_block_cuda(x, mask, *params, heads,
                                                                      scale))
        rows.append(row)
        versus.append(dict(name=row["name"], perhead_ms=row["ms"], packed_ms=packed_ms))
        log(f"time {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"packed kernel 7 {packed_ms:.4f} ms")
        if c["do"] is None:
            continue
        do, kargs = c["do"], (x, mask, *params[:7], c["do"], heads, scale)
        outs = AB.attn_block_perhead_bwd_cuda(*kargs)
        refs = AB.attn_block_perhead_bwd_banked_reference(*kargs)
        err = close(f"attn_block_perhead_bwd/{tag}", outs, refs,
                    [r.float().abs().max().item() for r in refs], dtype)
        want = AB.attn_block_perhead_bwd_reference(x, mask, *params, do, heads, scale)
        dq, dk, dv, ctx = (AB._merge_heads(t) for t in refs[1:])

        def wscale(a, gr):
            return (a.reshape(-1, hid).float().abs().t()
                    @ gr.reshape(-1, hid).float().abs()).max().item()

        def bscale(gr):
            return gr.float().abs().sum(dim=(0, 1)).max().item()

        scales = [refs[0].float().abs().max().item(), wscale(x, dq), bscale(dq), wscale(x, dk),
                  bscale(dk), wscale(x, dv), bscale(dv), wscale(ctx, do), bscale(do)]
        close(f"attn_block_perhead_bwd/{tag} ten gradients", c["grads"],
              (want[0],) + tuple(want[2:]), scales, dtype)
        del want, dq, dk, dv, ctx
        x_leaf = x.detach().clone().requires_grad_(True)
        lib_out = mha(x_leaf, x_leaf, x_leaf, key_padding_mask=pad, need_weights=False)[0]
        m = b * l
        ops = 2.0 * m * hid * hid * 7 + 12.0 * b * l * l * hid
        bound_ms, bound_by = bound(nbytes(x, mask, do, *params[:7], *outs), ops, dtype)
        row = dict(name=f"attn_block_perhead_bwd/{tag}", kernel="attn_block_perhead_bwd",
                   key=c["key"], max_abs_err=err,
                   ms=device_ms(torch, lambda: AB.attn_block_perhead_bwd_cuda(*kargs)),
                   plain_ms=device_ms(torch, lambda: AB.attn_block_perhead_bwd_banked_reference(
                       *kargs)),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=device_ms(torch, lambda: torch.autograd.grad(
                       lib_out, (x_leaf,), do, retain_graph=True)))
        packed_ms = device_ms(torch, lambda: AB.attn_block_bwd_cuda(*kargs))
        rows.append(row)
        versus.append(dict(name=row["name"], perhead_ms=row["ms"], packed_ms=packed_ms))
        log(f"time {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"packed kernel 8 {packed_ms:.4f} ms")
        del lib_out, x_leaf, outs, refs
        torch.cuda.empty_cache()
    del cases
    torch.cuda.empty_cache()
    return rows, launches, versus


def make_dataset(root):
    """A task-3 data key (``data_key_mvsa.csv``) and a 224-px uint8 pixel
    cache in the on-disk format of ``data/cache.py``, made with the csv
    module and numpy from a seed; returns the data directory."""
    import csv

    import numpy as np

    rng = np.random.RandomState(7)
    data = os.path.join(root, "data") + os.sep
    os.makedirs(data, exist_ok=True)
    words = "rain sun happy sad team win lose love hate coffee city tonight best worst".split()
    splits = (["train"] * TRAIN_POSTS[0] + ["val"] * TRAIN_POSTS[1]
              + ["test"] * TRAIN_POSTS[2])
    ids = [1000 + i for i in range(len(splits))]
    with open(data + "data_key_mvsa.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tweet_id", "text", "label", "split"])
        for i, split in zip(ids, splits):
            text = " ".join(rng.choice(words, size=rng.randint(3, 60)))
            w.writerow([i, text, rng.randint(0, 3), split])
    cache = os.path.join(data, "cache", "mvsa_u8_224")
    os.makedirs(cache)
    np.save(os.path.join(cache, "pixels.npy"),
            rng.randint(0, 256, (len(ids), 224, 224, 3), dtype=np.uint8))
    with open(os.path.join(cache, "meta.json"), "w") as f:
        json.dump({"index": {str(i): r for r, i in enumerate(ids)}, "size": 224,
                   "valid": [True] * len(ids)}, f)
    return data


def train_args(attn_impl, extra=()):
    return ["--txt_model_name", "bernice", "--img_model_name", "vit",
            "--fusion_name", "attention", "--task", "3", "--epochs", "1",
            "--seed", "30", "--arch", "base", "--dtype", "bfloat16",
            "--use_clip_loss", "--use_tim_loss", "--use_saved_features",
            "--save_model", "--log_every", "1", "--attn_impl", attn_impl, *extra]


def vilt_args(attn_impl, extra=()):
    return ["--model", "vilt", "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--vilt_exact_resize",
            "--use_clip_loss", "--use_tim_loss", "--save_model", "--log_every", "1",
            "--attn_impl", attn_impl, *extra]


def fill_vilt_frames(build_early, ids):
    """No photos are decoded (the port needs no PIL on the card): every split's
    ``ExactViltImageSource`` gets its memo filled with generated frames, each
    at the ``vilt_exact_geometry`` extent of a random photo size of
    ``VILT_PHOTOS`` (so a batch mixes extents), pasted onto the 608-px
    canvas. Returns the memo and the list of (ids, grid_hw) every gather
    returned, to check the batches against."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.images import (
        vilt_canvas, vilt_exact_geometry)

    rng = np.random.RandomState(11)
    canvas = vilt_canvas()
    memo, seen = {}, []
    for data_id in ids:
        nh, nw = vilt_exact_geometry(*VILT_PHOTOS[rng.randint(len(VILT_PHOTOS))])
        frame = np.zeros((canvas, canvas, 3), np.uint8)
        frame[:nh, :nw] = rng.randint(0, 256, (nh, nw, 3), dtype=np.uint8)
        memo[str(data_id)] = (frame, (nh, nw))
    base = build_early.ExactViltImageSource

    class FilledSource(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.memo.update(memo)

        def gather(self, batch_ids):
            frames, grid = super().gather(batch_ids)
            seen.append(([str(i) for i in batch_ids], grid.copy()))
            return frames, grid

    build_early.ExactViltImageSource = FilledSource
    return memo, seen


def check_vilt_extents(memo, seen, tag):
    """Every gathered batch carries its images' own extents, and mixes them."""
    if not seen:
        raise AssertionError(f"{tag}: no image batch was gathered")
    for ids, grid in seen:
        want = [list(memo[i][1]) for i in ids]
        if grid.tolist() != want:
            raise AssertionError(f"{tag}: batch extents {grid.tolist()} are not the "
                                 f"images' {want}")
        if len({tuple(g) for g in want}) < 2:
            raise AssertionError(f"{tag}: a batch of one extent {want[0]}")
    log(f"{tag}: {len(seen)} image batches, each with its images' extents "
        f"({len({tuple(g) for _, gr in seen for g in gr.tolist()})} distinct)")


def train_run(torch, main, argv, tag, counters, results_dir, stem, expect, check_grads):
    """One epoch through a trainer's ``main(argv)``; checks the launch counts
    per train and eval step, the gradients (``check_grads(setup, grads)``)
    and the artifacts ``stem`` + ...; returns its numbers and the launch
    counts by (kernel, key)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for c in counters.values():
        c.reset()
    steps = []
    state = {"t": None, "prev": {k: 0 for k in counters}}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = {k: c.count - state["prev"][k] for k, c in counters.items()}
        state["prev"] = {k: c.count for k, c in counters.items()}
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(map(lambda v: v == v and abs(v) != float("inf"), vals.values())):
            raise AssertionError(f"{tag}: step {step} metrics not finite: {vals}")
        steps.append(dict(seconds=None if state["t"] is None else now - state["t"],
                          counts=counts, loss=vals["loss"]))
        state["t"] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state["t"] = None
    trainer, setup = main(argv, on_step=on_step, keep_grads=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    totals = {k: c.count for k, c in counters.items()}
    by_key = {k: dict(c.by_key) for k, c in counters.items()}

    n_train = len(steps)
    n_eval = setup.pipes["val"].num_batches + setup.pipes["test"].num_batches
    for i, st in enumerate(steps):
        for kernel, n in expect["train"].items():
            if st["counts"][kernel] != n:
                raise AssertionError(f"{tag}: step {i + 1} launched {kernel} "
                                     f"{st['counts'][kernel]} times, expected {n}")
    for kernel, n in expect["eval"].items():
        seen = totals[kernel] - sum(st["counts"][kernel] for st in steps)
        if seen != n * n_eval:
            raise AssertionError(f"{tag}: {n_eval} eval steps launched "
                                 f"{kernel} {seen} times, expected {n} each")
    log(f"{tag}: launches per train step {expect['train']}, per eval step "
        f"{expect['eval']} over {n_train} train and {n_eval} eval steps: exact")

    check_grads(setup, setup.train_step.last_grads)

    for suffix in ("metrics_val.csv", "metrics_test.csv", "net.pth"):
        path = os.path.join(results_dir, stem + suffix)
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"{tag}: artifact {path} missing")
    with open(os.path.join(results_dir, stem + "metrics_test.csv")) as f:
        table = f.read().splitlines()
    if table[0] != "metric,epoch-1" or len(table) != 8:
        raise AssertionError(f"{tag}: metrics table {table}")

    # one more step under the profiler: the device's idle share
    batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
    setup.train_step(batch, trainer.gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        setup.train_step(batch, trainer.gen)
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t1) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    idle = (1 - busy / step_wall) if busy else None
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # cuBLAS's float32 SIMT GEMMs (the block's weight gradients before they
    # moved onto the TN GEMM): their launches and time
    sgemm = [e for e in events if "sgemm" in e.key]
    sgemm_calls = sum(e.count for e in sgemm)
    sgemm_ms = sum(e.self_device_time_total for e in sgemm) / 1e3
    # copies and casts (PyTorch's copy kernels), e.g. float32 copies made for
    # products, or a transpose copy of a gradient
    copies = [e for e in events if "copy_kernel" in e.key]
    log(f"profile {tag}: f32 sgemm {sgemm_ms:.3f} ms x{sgemm_calls}; copies "
        f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms "
        f"x{sum(e.count for e in copies)}")
    # the eight largest, then every other kernel of the port's own
    # (csrc/: the smtc:: SDPA kernels and the block kernels' GEMMs)
    for i, e in enumerate(ranked):
        if i < 8 or "smtc::" in e.key or "namespace)::gemm_" in e.key:
            log(f"profile {tag}:   {e.self_device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<4d} {e.key[:90]}")
    timed_steps = [st["seconds"] for st in steps if st["seconds"] is not None]
    ms = 1e3 * sum(timed_steps) / len(timed_steps)
    # the profiler's own host work lengthens the profiled step: the share
    # against the unprofiled mean step is the second reading
    result = dict(run=tag, train_steps=n_train, eval_steps=n_eval,
                  ms_per_train_step=ms, posts_per_s=BATCH / (ms / 1e3),
                  profiled_step_ms=step_wall, device_busy_ms=busy,
                  idle_share=idle, sgemm_calls=sgemm_calls, sgemm_ms=sgemm_ms,
                  idle_share_of_mean_step=(1 - busy / ms) if busy else None,
                  max_memory_allocated=peak, run_seconds=wall,
                  losses=[st["loss"] for st in steps])
    log(f"{tag}: {json.dumps(result)}")
    if idle is None:
        log(f"{tag}: device idle share not measured (the profiler saw no "
            "device events)")
    del trainer, setup, batch
    torch.cuda.empty_cache()
    return result, by_key


def no_added_sgemm(fused, auto, tag):
    """The fused path's profiled step launches no more float32 sgemm than
    the auto path's: the block's weight gradients run on the TN GEMM."""
    if fused["sgemm_calls"] > auto["sgemm_calls"]:
        raise AssertionError(f"{tag}[fused]: {fused['sgemm_calls']} f32 sgemm launches in a "
                             f"step, {auto['sgemm_calls']} under auto")
    log(f"{tag}: f32 sgemm a step, fused {fused['sgemm_calls']} ({fused['sgemm_ms']:.3f} ms), "
        f"auto {auto['sgemm_calls']} ({auto['sgemm_ms']:.3f} ms)")


def late_grads_check(torch, tag):
    """Late fusion: every trainable parameter but ``linear_iadds`` (unused by
    the loss) has a finite gradient, the vision tower is frozen without
    gradients, and AdamW holds every trainable parameter."""
    def check(setup, grads):
        names = set(setup.optimizer.names)
        unused = sorted(n for n, gr in grads.items() if gr is None)
        if unused != ["linear_iadds.bias", "linear_iadds.weight"]:
            raise AssertionError(f"{tag}: parameters without a gradient: {unused}")
        bad = [n for n, gr in grads.items() if gr is not None and not torch.isfinite(gr).all()]
        if bad:
            raise AssertionError(f"{tag}: non-finite gradients in {bad[:5]}")
        vision = [n for n, p in setup.model.named_parameters() if n.startswith("dual.vision.")]
        if (not vision or any(n in names for n in vision)
                or any(p.requires_grad or p.grad is not None
                       for n, p in setup.model.named_parameters() if n in vision)):
            raise AssertionError(f"{tag}: the vision tower is not frozen")
        trainable = [n for n, p in setup.model.named_parameters() if n not in vision]
        if sorted(trainable) != sorted(names):
            raise AssertionError(f"{tag}: AdamW does not hold every trainable parameter")
        log(f"{tag}: {len(names) - len(unused)} trainable tensors with finite "
            f"gradients, {len(unused)} unused by the loss (linear_iadds, decayed as under optax), "
            f"{len(vision)} vision tensors frozen without gradients")

    return check


def vilt_grads_check(torch, tag):
    """Early fusion trains everything: every parameter but the pooler (whose
    output no head reads) has a finite gradient, and AdamW holds them all."""

    def check(setup, grads):
        unused = sorted(n for n, gr in grads.items() if gr is None)
        if unused != ["backbone.pooler.dense.bias", "backbone.pooler.dense.weight"]:
            raise AssertionError(f"{tag}: parameters without a gradient: {unused}")
        bad = [n for n, gr in grads.items() if gr is not None and not torch.isfinite(gr).all()]
        if bad:
            raise AssertionError(f"{tag}: non-finite gradients in {bad[:5]}")
        every = sorted(n for n, _ in setup.model.named_parameters())
        if sorted(setup.optimizer.names) != every or sorted(grads) != every:
            raise AssertionError(f"{tag}: AdamW does not hold every parameter")
        log(f"{tag}: {len(every) - len(unused)} tensors with finite gradients, "
            f"{len(unused)} unused by the loss (the pooler), nothing frozen")

    return check


def first_step_check(torch, tag, make_setup, keep):
    """The first train step of auto and fused against the plain path: the
    setups from ``make_setup(attn_impl, dtype)`` (the same state dict from
    the same seed), the same first batch, the TIM swap pinned, the gradients
    of the parameters named by ``keep``.

    float32: the loss within 1e-5 relative and every gradient within 1e-3
    relative (Frobenius) of the plain path's. bfloat16: the plain path
    rounds its scores q.k to bfloat16 before the softmax (as the JAX
    package's plain version does) where the kernels keep float32, so both
    are held against the float32 plain gradients: the loss within 2e-2 of
    the bfloat16 plain path's, and the kernel path's median and worst
    relative gradient error no more than 1.5 times the bfloat16 plain
    path's. Every check is made before any fails."""
    import numpy as np

    perm = np.random.RandomState(3).permutation(BATCH)
    results, failed = {}, []

    def rel_errors(keep, ref):
        return {n: (torch.linalg.vector_norm(g - ref[n])
                    / torch.linalg.vector_norm(ref[n])).item() for n, g in keep.items()}

    ref32 = plain16 = None
    for dtype in ("float32", "bfloat16"):
        plain_loss = None
        for impl in ("jnp", "auto", "fused"):
            setup = make_setup(impl, dtype)
            batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
            batch["tim_src"] = torch.as_tensor(perm, device=DEVICE)
            batch["tim_labels"] = torch.as_tensor(
                (perm == np.arange(BATCH)).astype(np.int32), device=DEVICE)
            grads, parts, _ = setup.train_step.gradients(batch, torch.Generator(DEVICE))
            kept = {n: gr.float() for n, gr in grads.items() if gr is not None and keep(n)}
            loss = float(parts["loss"].detach())
            del setup, grads, batch
            torch.cuda.empty_cache()
            if impl == "jnp":
                plain_loss = loss
                if dtype == "float32":
                    ref32 = kept
                else:
                    plain16 = rel_errors(kept, ref32)
                    log(f"first step[{tag} jnp, bfloat16 vs float32]: gradient rel error median "
                        f"{np.median(list(plain16.values())):.2e}, worst "
                        f"{max(plain16.values()):.2e}")
                continue
            rel_loss = abs(loss - plain_loss) / abs(plain_loss)
            rel = rel_errors(kept, ref32)
            worst = max(rel, key=rel.get)
            med = float(np.median(list(rel.values())))
            if dtype == "float32":
                tol_loss, tol_med, tol_worst = 1e-5, 1e-3, 1e-3
            else:
                tol_loss = 2e-2
                tol_med = 1.5 * float(np.median(list(plain16.values())))
                tol_worst = 1.5 * max(plain16.values())
            log(f"first step[{tag} {impl}, {dtype}]: loss {loss:.6f} vs plain {plain_loss:.6f} "
                f"(rel {rel_loss:.2e}, tol {tol_loss}); gradient rel error vs the float32 "
                f"plain path over {len(rel)} tensors: median {med:.2e} (tol {tol_med:.2e}), "
                f"worst {rel[worst]:.2e} (tol {tol_worst:.2e}, {worst})")
            results[f"{impl}/{dtype}"] = dict(rel_loss=rel_loss, median_rel=med,
                                               worst_rel=rel[worst], worst_grad=worst)
            if not (rel_loss <= tol_loss and med <= tol_med and rel[worst] <= tol_worst):
                failed.append(f"{impl}/{dtype}")
    if failed:
        raise AssertionError(f"first step[{tag}] disagrees with the plain path: {failed}")
    return results


def late_first_step(torch, C, run_mm_late, build, hub):
    """``first_step_check`` of late fusion: the text tower's attention
    weights and the fusion head's tensors, but ``fc_k.bias`` (a key bias
    shifts every score of a row alike, so its exact gradient is zero and its
    relative error is noise)."""
    for name in ("bernice", "vit"):
        d = os.path.join(hub, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"hidden_dropout_prob": 0.0}, f)
        C.MODEL_DIR_DICT[name] = d + os.sep

    def make_setup(impl, dtype):
        args = run_mm_late.parse_args(train_args(impl, ["--dropout", "0", "--dtype", dtype]))
        return build.build_mm_late_train_setup(args, C.Config(args), torch.device(DEVICE),
                                               torch.Generator().manual_seed(30))

    def keep(n):
        return ((n.startswith("dual.text.encoder.") and ".attention." in n
                 and n.endswith("weight"))
                or (n.startswith("fusion.") and n != "fusion.fc_k.bias"))

    return first_step_check(torch, "late", make_setup, keep)


def vilt_first_step(torch, C, run_mm_early, build_early, hub):
    """``first_step_check`` of ViLT under ``--vilt_exact_resize``: every
    attention weight of the joint encoder (12 layers x q, k, v, out)."""
    d = os.path.join(hub, "vilt")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"hidden_dropout_prob": 0.0}, f)
    C.MODEL_DIR_DICT["vilt"] = d + os.sep

    def make_setup(impl, dtype):
        args = run_mm_early.parse_args(vilt_args(impl, ["--dropout", "0", "--dtype", dtype]))
        return build_early.build_mm_early_train_setup(
            args, C.Config(args, model_name="vilt"), torch.device(DEVICE),
            torch.Generator().manual_seed(30))

    def keep(n):
        return n.startswith("backbone.encoder.") and ".attention." in n and n.endswith("weight")

    return first_step_check(torch, "vilt", make_setup, keep)


def spm_model_bytes(pieces):
    """A sentencepiece ModelProto in protobuf wire format, written by hand:
    repeated field 1, each a SentencePiece of piece (1, string), score (2,
    float) and type (3, enum)."""
    import struct

    def varint(n):
        out = bytearray()
        while True:
            out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
            n >>= 7
            if not n:
                return bytes(out)

    buf = bytearray()
    for piece, score, typ in pieces:
        raw = piece.encode("utf-8")
        msg = (b"\x0a" + varint(len(raw)) + raw + b"\x15" + struct.pack("<f", score)
               + b"\x18" + varint(typ))
        buf += b"\x0a" + varint(len(msg)) + msg
    return bytes(buf)


def write_safetensors(path, tensors):
    """``tensors`` as a ``.safetensors`` file, written by hand: the header's
    length (little-endian uint64), the JSON header, the raw float32 bytes."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.float().contiguous().numpy().tobytes())


BERNICE_CONFIG = {"vocab_size": 250002, "hidden_size": 768, "num_hidden_layers": 12,
                  "num_attention_heads": 12, "intermediate_size": 3072,
                  "max_position_embeddings": 514, "type_vocab_size": 1, "pad_token_id": 1,
                  "layer_norm_eps": 1e-5, "hidden_dropout_prob": 0.1}
VIT_CONFIG = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
              "intermediate_size": 3072, "image_size": 224, "patch_size": 16,
              "layer_norm_eps": 1e-12, "hidden_dropout_prob": 0.0}


def hf_tower_state(torch, g, kind):
    """A full-width Hugging Face-named state dict from ``g``: Bernice-base
    (XLM-R naming, 250,002 x 768 word embeddings) or ViT-B/16. Linear weights
    (out, in), LayerNorm scales near 1, on the CPU in float32."""
    cfg = BERNICE_CONFIG if kind == "text" else VIT_CONFIG
    h, m = cfg["hidden_size"], cfg["intermediate_size"]
    state = {}

    def arr(key, *shape, scale=0.02, offset=0.0):
        state[key] = (offset + scale * torch.randn(*shape, generator=g, device="cuda")).cpu()

    def dense(key, out, inp):
        arr(f"{key}.weight", out, inp, scale=inp ** -0.5)
        arr(f"{key}.bias", out)

    def ln(key):
        arr(f"{key}.weight", h, scale=0.05, offset=1.0)
        arr(f"{key}.bias", h)

    if kind == "text":
        arr("embeddings.word_embeddings.weight", cfg["vocab_size"], h, scale=0.5)
        arr("embeddings.position_embeddings.weight", cfg["max_position_embeddings"], h, scale=0.5)
        arr("embeddings.token_type_embeddings.weight", 1, h, scale=0.5)
        ln("embeddings.LayerNorm")
        state["embeddings.position_ids"] = torch.arange(514)[None]
    else:
        arr("embeddings.cls_token", 1, 1, h, scale=0.5)
        arr("embeddings.position_embeddings", 1, 197, h, scale=0.5)
        arr("embeddings.patch_embeddings.projection.weight", h, 3, 16, 16, scale=768 ** -0.5)
        arr("embeddings.patch_embeddings.projection.bias", h)
        ln("layernorm")
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}"
        att = f"{p}.attention.self" if kind == "text" else f"{p}.attention.attention"
        for name in ("query", "key", "value"):
            dense(f"{att}.{name}", h, h)
        dense(f"{p}.attention.output.dense", h, h)
        dense(f"{p}.intermediate.dense", m, h)
        dense(f"{p}.output.dense", h, m)
        if kind == "text":
            ln(f"{p}.attention.output.LayerNorm")
            ln(f"{p}.output.LayerNorm")
        else:
            ln(f"{p}.layernorm_before")
            ln(f"{p}.layernorm_after")
    dense("pooler.dense", h, h)
    return state


def pretrained_start(torch, C, run_mm_late, counters):
    """The towers start from checkpoints: a full-width Bernice-base
    ``pytorch_model.bin`` (``torch.save``) with its ``config.json`` and a
    small ``sentencepiece.bpe.model`` (protobuf written by hand), a ViT-B/16
    ``model.safetensors`` (written by hand) with its ``config.json``, and a
    reference-format ``MM_Model`` state dict, all from a seed into temporary
    directories. One epoch of ``run_mm_late.main`` with ``MODEL_DIR_DICT``
    there (the path that used to train on a random vision tower): every
    imported tensor on the device equals the file's (a Linear's (out, in)
    weight is the file's as it is: the import transposes to the flax layout
    and back), the tokenizer is the file's SentencePiece-BPE, the vision tower
    gets no gradient and stays the file's, the losses are finite. Then
    ``--import_reference_ckpt``: the model's classification logits on a batch
    equal (exactly) those of a model loaded from the converted state dict.
    No transformers, safetensors, msgpack or flax is imported."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
        build_tokenizer)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as H
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models.fusion import (
        MMLateModel)

    g = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.monotonic()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        text_dir, vit_dir = os.path.join(tmp, "bernice"), os.path.join(tmp, "vit")
        os.makedirs(text_dir)
        os.makedirs(vit_dir)
        text_state = hf_tower_state(torch, g, "text")
        vit_state = hf_tower_state(torch, g, "vision")
        torch.save(text_state, os.path.join(text_dir, "pytorch_model.bin"))
        write_safetensors(os.path.join(vit_dir, "model.safetensors"), vit_state)
        words = "rain sun happy sad team win lose love hate coffee city tonight best worst"
        pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
        pieces += [(c, -10.0, 1) for c in sorted(set(words.replace(" ", ""))) + ["\u2581"]]
        marked = sorted({"\u2581" + w[:n] for w in words.split() for n in range(1, len(w) + 1)})
        pieces += [(p, float(len(p)), 1) for p in marked]
        with open(os.path.join(text_dir, "sentencepiece.bpe.model"), "wb") as f:
            f.write(spm_model_bytes(pieces))
        for d, cfg in ((text_dir, BERNICE_CONFIG), (vit_dir, VIT_CONFIG)):
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(cfg, f)
        C.MODEL_DIR_DICT["bernice"] = text_dir + os.sep
        C.MODEL_DIR_DICT["vit"] = vit_dir + os.sep
        log(f"pretrained: checkpoints written in {time.monotonic() - t0:.1f} s "
            f"({os.path.getsize(os.path.join(text_dir, 'pytorch_model.bin')) / 2 ** 20:.0f} MiB "
            f"Bernice, {os.path.getsize(os.path.join(vit_dir, 'model.safetensors')) / 2 ** 20:.0f}"
            " MiB ViT)")

        # the file's tensors in the port's names: the import's own map, and a
        # few names checked by hand
        expect = {"dual.text." + k: v for k, v in H.torch_state_from_jax(
            H.import_bert_tower({k: v.numpy() for k, v in text_state.items()}, 12)).items()}
        expect.update({"dual.vision." + k: v for k, v in H.torch_state_from_jax(
            H.import_vit_tower({k: v.numpy() for k, v in vit_state.items()}, 12)).items()})
        by_hand = {"dual.text.embeddings.word.weight": text_state["embeddings.word_embeddings.weight"],
                   "dual.text.encoder.layers.7.attention.value.weight":
                       text_state["encoder.layer.7.attention.self.value.weight"],
                   "dual.vision.embeddings.proj.weight":
                       vit_state["embeddings.patch_embeddings.projection.weight"],
                   "dual.vision.encoder.layers.11.mlp.mlp_out.weight":
                       vit_state["encoder.layer.11.output.dense.weight"],
                   "dual.vision.embeddings.prefix_tokens": vit_state["embeddings.cls_token"]}

        def check_imported(setup):
            own = setup.model.state_dict()
            for key, want in list(expect.items()) + list(by_hand.items()):
                got = own[key]
                if got.device.type != "cuda" or not torch.equal(
                        got, torch.as_tensor(np.asarray(want)).to(got)):
                    raise AssertionError(f"pretrained: {key} is not the file's tensor")
            tok = build_tokenizer("bernice", text_dir, 128, 250002).backend
            ids = tok.encode_batch(["rain sun"])[0][0][:4].tolist()
            want_ids = [0] + [1 + [p for p, _, _ in pieces].index("\u2581" + w)
                              for w in ("rain", "sun")] + [2]
            if type(tok).__name__ != "SentencePieceBPE" or ids != want_ids:
                raise AssertionError(f"pretrained: tokenizer {type(tok).__name__} gives {ids}, "
                                     f"expected {want_ids}")
            # the pipelines' ids come from the file's vocabulary (hashed ids
            # would spread over all 250,002)
            top = max(int(pipe.ids.max()) for pipe in setup.pipes.values())
            if top > len(pieces):
                raise AssertionError(f"pretrained: token id {top} is outside the vocabulary")
            log(f"pretrained: {len(expect)} imported tensors on the device equal the files' "
                f"({len(by_hand)} also by name by hand); tokenizer {type(tok).__name__} "
                f"{ids}, every pipeline id <= {top}")

        real_build = run_mm_late.build_mm_late_train_setup

        def build_and_check(*a, **k):
            setup = real_build(*a, **k)
            check_imported(setup)
            return setup

        for c in counters.values():
            c.reset()
        losses = []
        run_mm_late.build_mm_late_train_setup = build_and_check
        try:
            t1 = time.monotonic()
            _, setup = run_mm_late.main(
                train_args("auto"), keep_grads=True,
                on_step=lambda step, m: losses.append(float(m["loss"])))
        finally:
            run_mm_late.build_mm_late_train_setup = real_build
        counts = {k: c.count for k, c in counters.items()}
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"pretrained: losses {losses}")
        grads = setup.train_step.last_grads
        own = setup.model.state_dict()
        vision = [n for n in own if n.startswith("dual.vision.")]
        if any(grads.get(n) is not None for n in vision) or any(
                p.grad is not None for n, p in setup.model.named_parameters() if n in vision):
            raise AssertionError("pretrained: the vision tower got a gradient")
        for n in vision:
            if not torch.equal(own[n], torch.as_tensor(np.asarray(expect[n])).to(own[n])):
                raise AssertionError(f"pretrained: vision tensor {n} moved in training")
        if not counts["sdpa_fwd"] or not counts["sdpa_bwd"]:
            raise AssertionError(f"pretrained: kernel launches {counts}")
        log(f"pretrained: one epoch from the checkpoints in {time.monotonic() - t1:.1f} s, "
            f"{len(losses)} steps, losses finite (first {losses[0]:.4f}, last {losses[-1]:.4f}); "
            f"{len(vision)} vision tensors frozen, still the file's; launches {counts}")
        result["losses"] = list(losses)
        del setup, grads, own
        torch.cuda.empty_cache()

        # --import_reference_ckpt: a reference MM_Model over the same towers
        ref = {f"dual_encoder.text_model.{k}": v for k, v in text_state.items()}
        ref.update({f"dual_encoder.vision_model.{k}": v for k, v in vit_state.items()})
        heads = {"dual_encoder.text_projection.weight": (512, 768),
                 "dual_encoder.visual_projection.weight": (512, 768),
                 "fc_Q.weight": (768, 768), "fc_K.weight": (768, 768),
                 "fc_V.weight": (768, 768), "linear_fusion.weight": (768, 1536),
                 "linear_cls.weight": (3, 768), "linear_tim.weight": (2, 768),
                 "linear_iadds.weight": (2, 768)}
        for key, shape in heads.items():
            ref[key] = (torch.randn(*shape, generator=g, device="cuda") * shape[1] ** -0.5).cpu()
            if not key.startswith("dual_encoder."):
                ref[key[:-len("weight")] + "bias"] = 0.1 * torch.randn(
                    shape[0], generator=g, device="cuda").cpu()
        ref["dual_encoder.logit_scale"] = torch.tensor(2.3)
        ref_path = os.path.join(tmp, "mm_model.pth")
        torch.save(ref, ref_path)
        del ref, text_state, vit_state

        real_import = run_mm_late.import_reference_checkpoint
        checked = {}

        def import_and_check(model, args):
            real_import(model, args)
            with torch.device("meta"):
                twin = MMLateModel(model.text_cfg, model.vision_cfg, 3, fusion_name="attention",
                                   dropout=0.0, patch=16, image_size=224)
            twin = twin.to_empty(device="cuda").eval()
            tree = H.import_reference_mm_late(H.load_torch_file(ref_path), 12, 12, "attention")
            twin.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                                  for k, v in H.torch_state_from_jax(tree).items()})
            gen = torch.Generator().manual_seed(5)
            ids = torch.randint(4, 250002, (4, 128), generator=gen).cuda()
            mask = torch.ones(4, 128, dtype=torch.int32, device="cuda")
            mask[1:, 60:] = 0
            px = torch.randn(4, 224, 224, 3, generator=gen).cuda().to(model.text_cfg.torch_dtype)
            was = model.training
            model.eval()
            with torch.no_grad():
                got = model(ids, mask, px)["out_cls"].float()
                want = twin(ids, mask, px)["out_cls"].float()
            model.train(was)
            checked["max_abs_diff"] = (got - want).abs().max().item()
            checked["finite"] = bool(torch.isfinite(got).all())
            del twin

        run_mm_late.import_reference_checkpoint = import_and_check
        losses.clear()
        try:
            t1 = time.monotonic()
            run_mm_late.main(train_args("auto", ["--import_reference_ckpt", ref_path]),
                             on_step=lambda step, m: losses.append(float(m["loss"])))
        finally:
            run_mm_late.import_reference_checkpoint = real_import
        if not checked or not checked["finite"] or checked["max_abs_diff"] != 0.0:
            raise AssertionError(f"pretrained: --import_reference_ckpt logits {checked}")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"pretrained: --import_reference_ckpt losses {losses}")
        log(f"pretrained: --import_reference_ckpt in {time.monotonic() - t1:.1f} s: classification "
            f"logits equal the converted state dict's (max |diff| {checked['max_abs_diff']}), "
            f"{len(losses)} finite losses")
        result["reference_ckpt"] = dict(checked, losses=list(losses))
    for name in ("transformers", "safetensors", "msgpack", "flax", "jax"):
        if name in sys.modules:
            raise AssertionError(f"pretrained: the import pulled in {name}")
    result["seconds"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    return result


def make_requests():
    import numpy as np

    rng = np.random.RandomState(30)
    words = ("rain sun happy sad team win lose #news @user https://t.co/x "
             "love hate coffee city \U0001F60D \U0001F389 tonight again never "
             "best worst").split()
    reqs = []
    for i in range(N_REQUESTS):
        text = " ".join(rng.choice(words, size=rng.randint(1, 40)))
        image = rng.randint(0, 256, (224, 224, 3), np.uint8) if i % 2 else None
        reqs.append((text, image))
    return reqs


def service_args(serve, model_path, attn_impl):
    return serve.parse_args([
        "--task", "3", "--txt_model_name", "bernice", "--img_model_name", "vit",
        "--fusion_name", "attention", "--arch", "base", "--dtype", "bfloat16",
        "--max_batch", str(BATCH), "--batch_window_ms", "20", "--seed", "30",
        "--attn_impl", attn_impl, "--model_path", model_path, "--port", "0"])


def profile_window(torch, predict, window, tag):
    """Where one full window's time goes: wall clock, the host ranges of
    ``predict_batch`` (serve.make_batch / serve.forward / serve.answer) and
    the device time by kernel, from torch.profiler. Informational: it checks
    nothing, and says so when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict(window)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(window)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a named range also shows on the device as its span: keep it apart
    spans = {e.key: e.self_device_time_total / 1e3 for e in events
             if e.device_type == DeviceType.CUDA and e.key.startswith("serve.")}
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and not e.key.startswith("serve.")]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    ranges = {e.key: e.cpu_time_total / 1e3 for e in events
              if e.device_type == DeviceType.CPU and e.key.startswith("serve.")}
    log(f"profile[{tag}]: window wall {wall:.2f} ms; host ranges "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(ranges.items()))
        + "; device spans " + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(spans.items()))
        + (f"; kernels busy {busy:.2f} ms ({100 * (1 - busy / wall):.0f}% of the "
           "window idle)" if busy
           else "; device time not measured (the profiler saw no device events)"))
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"profile[{tag}]:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")


def run_service(torch, serve, A, AB, args, reqs, http_text):
    """Serve ``reqs`` from several client threads plus one HTTP request;
    returns (answers, batcher stats, launch counts, seconds)."""
    predict, meta = serve.build_service(args)
    serve.warm_service(args, predict)
    torch.cuda.synchronize()
    A.launches.reset()
    AB.launches.reset()
    batcher = serve.MicroBatcher(predict, args.max_batch, args.batch_window_ms)
    server = serve.make_server(args, batcher, meta)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * len(reqs)
    try:
        def client(c):
            for i in range(c, len(reqs), N_CLIENTS):
                answers[i] = batcher.submit(*reqs[i])

        t0 = time.monotonic()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
            if c.is_alive():
                raise AssertionError("a client thread did not finish")
        seconds = time.monotonic() - t0
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/classify",
            data=json.dumps({"text": http_text}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            http_answer = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    counts = {"sdpa_fwd": dict(A.launches.by_key), "attn_block_fwd": dict(AB.launches.by_key)}
    profile_window(torch, predict, reqs[:BATCH], args.attn_impl)
    del predict
    torch.cuda.empty_cache()
    return answers + [http_answer], health, counts, seconds


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
        build_mm_late_setup)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        seed_everything)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
        save_params)

    if any(m == JAX_PKG or m.startswith(JAX_PKG + ".") or m.split(".")[0] in ("jax", "flax")
           for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.monotonic()
    secs = _cuda.build()
    log(f"build: {time.monotonic() - t0:.1f} s wall; per source {secs}")
    for name in _cuda.SOURCES:
        log_ptxas(name, _cuda.build_log(name))
    log_occupancy(A, AB)
    log_sass(_cuda)
    gemm_rows, tn_rows = time_gemm(torch, AB)
    enqueue = time_enqueue(torch, AB)

    rows = check_kernels(torch) + check_bwd_kernels(torch) + tn_rows
    perhead_rows, perhead_launches, perhead_vs_packed = check_perhead_kernels(torch)
    rows += perhead_rows

    reqs = make_requests()
    http_text = "an http request about the #weather @user"
    with tempfile.TemporaryDirectory() as tmp:
        model_path = os.path.join(tmp, "random_weights.pth")
        args = service_args(serve, model_path, "auto")
        t0 = time.monotonic()
        setup = build_mm_late_setup(args, C.serving_config(args),
                                    generator=seed_everything(args.seed))
        save_params(model_path, setup.model)
        n_params = sum(p.numel() for p in setup.model.parameters())
        del setup
        log(f"weights: {n_params} random parameters (seed {args.seed}) in "
            f"{time.monotonic() - t0:.1f} s")

        # the plain path: every attention through the plain PyTorch version
        plain_args = service_args(serve, model_path, "jnp")
        plain_predict, _ = serve.build_service(plain_args)
        A.launches.reset()
        AB.launches.reset()
        every = reqs + [(http_text, None)]
        plain = []
        for i in range(0, len(every), BATCH):
            plain += plain_predict(every[i:i + BATCH])
        if A.launches.count or AB.launches.count:
            raise AssertionError("the plain path launched a kernel")
        del plain_predict
        torch.cuda.empty_cache()
        plain_probs = np.array([p["probs"] for p in plain])

        per_window = {"auto": {"sdpa_fwd": 25, "attn_block_fwd": 0},
                      "fused": {"sdpa_fwd": 1, "attn_block_fwd": 24}}
        launches = {}
        for impl, expect in per_window.items():
            answers, health, counts, seconds = run_service(
                torch, serve, A, AB, service_args(serve, model_path, impl), reqs, http_text)
            windows = health["windows"]
            log(f"serve[{impl}]: {health['requests']} requests in {windows} windows, "
                f"{len(reqs) / seconds:.1f} requests/s from {N_CLIENTS} clients, "
                f"mean window {health['mean_dispatch_ms']} ms, errors {health['errors']}")
            if health["errors"] or health["requests"] != len(reqs) + 1:
                raise AssertionError(f"serve[{impl}]: {health}")
            probs = np.array([a["probs"] for a in answers])
            if probs.shape != plain_probs.shape or not np.isfinite(probs).all():
                raise AssertionError(f"serve[{impl}]: bad probabilities {probs.shape}")
            if np.abs(probs.sum(-1) - 1).max() > 1e-4:
                raise AssertionError(f"serve[{impl}]: probabilities do not sum to 1")
            err = np.abs(probs - plain_probs).max()
            log(f"serve[{impl}]: max |p - p_plain| {err:.3e} (tol {PROB_TOL})")
            if not err <= PROB_TOL:
                raise AssertionError(f"serve[{impl}]: disagrees with the plain path")
            for kernel, n in expect.items():
                total = sum(counts[kernel].values())
                log(f"serve[{impl}]: {kernel} launches {total} = {windows} windows x "
                    f"{total / windows:g} {counts[kernel]}")
                if total != n * windows:
                    raise AssertionError(f"serve[{impl}]: {kernel} launched {total} "
                                         f"times, expected {n} x {windows}")
            for kernel, by_key in counts.items():
                for key, n in by_key.items():
                    launches[(kernel, key)] = launches.get((kernel, key), 0) + n

    # the training paths: one-epoch runs of run_mm_late and of run_mm_early
    # (ViLT) under auto and fused, and their first-step checks
    import csv

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as build
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        _build_early as build_early)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        run_mm_early, run_mm_late)

    counters = {"sdpa_fwd": A.launches, "sdpa_bwd": A.bwd_launches,
                "attn_block_fwd": AB.launches, "attn_block_bwd": AB.bwd_launches,
                "gemm_tn_bf16": AB.wgrad_launches}
    none = {k: 0 for k in counters}
    per_step = {
        # text tower (2B rows, one call) 12 + vision 12 + fusion head 1;
        # backward: text 12 + fusion 1 (the vision tower is frozen); under
        # fused each block backward's weight gradients are one TN launch
        "auto": {"train": {**none, "sdpa_fwd": 25, "sdpa_bwd": 13},
                 "eval": {**none, "sdpa_fwd": 25}},
        "fused": {"train": {**none, "attn_block_fwd": 24, "sdpa_fwd": 1,
                            "attn_block_bwd": 12, "sdpa_bwd": 1, "gemm_tn_bf16": 12},
                  "eval": {**none, "attn_block_fwd": 24, "sdpa_fwd": 1}}}
    training = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_dataset(tmp)
        C.DATA_PATH = data
        C.PATH[3] = data + "data_key_mvsa.csv"
        C.IMG_FMT[3] = data + "MVSA-Single/data/{}.jpg"  # never read: the cache holds every id
        C.results_dir_mm_late = os.path.join(tmp, "results", "mm_late") + os.sep
        for impl, expect in per_step.items():
            tag = f"train[{impl}]"
            training[impl], by_key = train_run(
                torch, run_mm_late.main, train_args(impl), tag, counters,
                C.results_dir_mm_late, "bernice-vit-attention_task3_seed30_itc0.1itm0.1_",
                expect, late_grads_check(torch, tag))
            for kernel, keys in by_key.items():
                for key, n in keys.items():
                    launches[(kernel, key)] = launches.get((kernel, key), 0) + n
        no_added_sgemm(training["fused"], training["auto"], "train")
        training["first_step"] = late_first_step(torch, C, run_mm_late, build,
                                                 os.path.join(tmp, "hub"))

        # ViLT early fusion under --vilt_exact_resize: every attention is the
        # joint sequence, L = 402, 2B rows with TIM batched
        with open(C.PATH[3], newline="") as f:
            ids = [row["tweet_id"] for row in csv.DictReader(f)]
        memo, seen = fill_vilt_frames(build_early, ids)
        C.results_dir_mm_early = os.path.join(tmp, "results", "mm_early") + os.sep
        vilt_step = {
            "auto": {"train": {**none, "sdpa_fwd": 12, "sdpa_bwd": 12},
                     "eval": {**none, "sdpa_fwd": 12}},
            "fused": {"train": {**none, "attn_block_fwd": 12, "attn_block_bwd": 12,
                                "gemm_tn_bf16": 12},
                      "eval": {**none, "attn_block_fwd": 12}}}
        for impl, expect in vilt_step.items():
            tag = f"vilt[{impl}]"
            seen.clear()
            training[f"vilt/{impl}"], by_key = train_run(
                torch, run_mm_early.main, vilt_args(impl), tag, counters,
                C.results_dir_mm_early, "vilt_task3_seed30_itc0.1itm0.1_", expect,
                vilt_grads_check(torch, tag))
            check_vilt_extents(memo, seen, tag)
            lengths = {key[3] if kernel.startswith("sdpa") else key[2]
                       for kernel, keys in by_key.items() for key in keys
                       if kernel != "gemm_tn_bf16"}
            # the weight gradients' K: the 2B x 402 token rows
            lengths |= {key[0] // (2 * BATCH) for key in by_key["gemm_tn_bf16"]}
            if lengths != {VILT_LEN}:
                raise AssertionError(f"{tag}: attention at lengths {sorted(lengths)}, "
                                     f"expected only {VILT_LEN}")
            for kernel, keys in by_key.items():
                for key, n in keys.items():
                    launches[(kernel, key)] = launches.get((kernel, key), 0) + n
        no_added_sgemm(training["vilt/fused"], training["vilt/auto"], "vilt")
        training["vilt/first_step"] = vilt_first_step(torch, C, run_mm_early, build_early,
                                                      os.path.join(tmp, "hub"))
        # the late-fusion towers from checkpoints, and --import_reference_ckpt
        training["pretrained"] = pretrained_start(torch, C, run_mm_late, counters)
    log(json.dumps({"training": training}))
    log(json.dumps({"perhead_vs_packed": perhead_vs_packed}))
    log(json.dumps(gemm_rows))
    log(json.dumps({"enqueue": enqueue}))
    launches.update(perhead_launches)

    # the TPU kernel each row replaces: the JAX SDPA kernels by query length
    # (above 2 x 128 rows the blocked ones), the fused block's by kernel
    sources = {"sdpa_fwd": (f"{PKG}/csrc/sdpa_fwd.cu", f"{JAX_PKG}/ops/attention.py:81",
                            f"{JAX_PKG}/ops/attention.py:144"),
               "attn_block_fwd": (f"{PKG}/csrc/attn_block_fwd.cu",
                                  f"{JAX_PKG}/ops/attn_block.py:143", None),
               "sdpa_bwd": (f"{PKG}/csrc/sdpa_bwd.cu", f"{JAX_PKG}/ops/attention.py:98",
                            f"{JAX_PKG}/ops/attention.py:154"),
               "attn_block_bwd": (f"{PKG}/csrc/attn_block_bwd.cu",
                                  f"{JAX_PKG}/ops/attn_block.py:175", None),
               # the whole backward of the custom VJP, its weight gradients included
               "attn_block_bwd_whole": (f"{PKG}/csrc/attn_block_bwd.cu",
                                        f"{JAX_PKG}/ops/attn_block.py:371", None),
               "gemm_tn_bf16": (f"{PKG}/csrc/gemm_core.cuh",
                                f"{JAX_PKG}/ops/attn_block.py:378", None),
               "attn_block_perhead_fwd": (f"{PKG}/csrc/attn_block_perhead_fwd.cu",
                                          f"{JAX_PKG}/ops/attn_block.py:70", None),
               "attn_block_perhead_bwd": (f"{PKG}/csrc/attn_block_perhead_bwd.cu",
                                          f"{JAX_PKG}/ops/attn_block.py:89", None)}
    # rows held against their plain versions at shapes no main path runs
    check_only = {"sdpa_fwd/vilt_exact_f32", "sdpa_fwd/vilt_fixed",
                  "sdpa_bwd/vilt_exact_f32", "sdpa_bwd/vilt_fixed"}
    kernels = []
    for row in rows:
        # the whole backward runs once per launch of the backward kernel
        counted = "attn_block_bwd" if row["kernel"] == "attn_block_bwd_whole" else row["kernel"]
        n = launches.get((counted, row["key"]), 0)
        if n == 0 and row["name"] not in check_only:
            raise AssertionError(f"{row['name']} was never launched on the main paths")
        source, replaces, blocked = sources[row["kernel"]]
        if blocked and row["key"][3] > 256:
            replaces = blocked
        kernels.append(dict(name=row["name"], route="cuda", source=source,
                            replaces=replaces, launches=n,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--enqueue"] and len(sys.argv) == 3:
            sys.exit(enqueue_only(sys.argv[2]))
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
