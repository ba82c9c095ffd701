#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training and sweep paths on one NVIDIA GPU.

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
   launch counts set to 0 before and read after each run; then
   ``--model vilt`` (the fixed 384-px square, L = 185) and ``--model mmbt``
   (ResNet-152 at 224 px, L = 132) the same way, each held to 2e-2 of its
   plain-path service; between them, the serving extras over the same
   weights (``serve_extras_phase``): ``/metrics`` of the ``auto`` run
   against its ``/healthz``, ``--quantize w8`` under both modes (within 6e-3
   of the plain path under w8, the launches a window unchanged, the resident
   bytes by dtype, window ms and the device memory (the build's peak, what
   stays after it, the windows' peak) beside the bf16 service's),
   ``--extra_model e:attn_impl=fused`` (each route equal to its single-model
   service, both labels in ``/metrics``), ``--workers 2`` against one worker
   as subprocesses over HTTP (both pids answer, SIGTERM gives 0 and reaps
   them), ``--img_decoder native`` (whether ``imgdec.cpp`` builds; if it
   does, against PIL and served; if not, the PIL fallback and its warning)
   and ``cli/export.py`` for ``cuda`` (the loaded program's probabilities
   within 1e-5 of the live predict, its ``smtc::sdpa_fwd`` nodes launching
   the kernel as often as a live window) (``python3 chip_smoke.py
   --serve_extras`` runs the serving phase and these alone);
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
   built once); also the image-only runner's trained towers, unmasked: the
   tensor-core pair at 16x12x197x197x64 and 16x12x198x198x64, the fused
   block's backward at 16x197 and 16x198 x768 and its TN GEMM over 3,152 and
   3,168 rows; the fused block's backward twice: the kernel alone (to x,
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
   kernels, copies and float32 sgemm launches, the float32 matrix products
   dispatched in a step (``fused`` may dispatch no more of these than
   ``auto``) and the peak device memory; then ``fused`` again
   at ``--steps_per_dispatch 3``, every step a CUDA graph replay: the launch
   counts exact per chunk (a launch counts when a replay runs it; the first
   chunk and the first eval add the eager warm-up step run before each
   capture), one profiled replay (after one unrecorded warm-up replay)
   running the port's kernels by name as often as the eager step does, the
   two moving the counters by two steps' counts, each
   step's loss within 1e-5 relative of the K = 1 run's; every run also times
   two more passes over the train split with one sync at the end (ms per
   step with the host free to run ahead); then the headline run's optimizer
   and workload flags (``lazy_phase``): ``--opt_impl lazy_emb`` under
   ``auto`` (the word table outside AdamW; step 1 from fresh moments against
   exact AdamW on the same batch: the row gradient within 1e-5 of the dense
   table gradient's rows, the touched rows within 1e-5, the untouched rows
   bit-unchanged; one optimizer step's device ms and launches beside the
   exact run's, and the busy ms and peak memory of both), under ``fused`` at
   K = 1 (a checkpoint at step 2) and K = 3 (losses within 1e-5 of K = 1's),
   ``--resume`` from that checkpoint ending bit for bit where K = 1 ended,
   ``--cache_vision`` for two epochs (the frozen tower once per batch of
   epoch 1, train and eval, never in epoch 2, its 12 SDPA launches counted
   to the step or eval that ran it; an epoch-2 step's busy ms) and
   ``--tim_reuse_text`` (the text tower's backward at 16 rows, not 32); the
   text-only runner
   ``cli/run_txt.main`` (Bernice-base, CLS head) the same way under
   ``fused`` at K = 1 and K = 3; then sequence bucketing (``bucket_phase``)
   on 128 generated tweet-like posts whose six train batches take the
   widths 32, 64, 96 and 128: the headline run's flags unbucketed under
   ``fused`` at K = 3, then with ``--bucket_seq`` under ``auto`` and
   ``fused`` at K = 1 (the trained weights' eval logits at the buckets
   within 2e-2 of their full-pad logits) and under ``fused`` at K = 3 with
   ``--bucket_group`` (exactly one train graph per width run and one eval
   graph per eval width; its losses within 1e-5 of the grouped order
   stepped at K = 1; stopped by SIGTERM after its first chunk and resumed,
   bit for bit), per width the ms, busy ms, idle share and peak memory of
   a step beside the full pad's, the text-only runner with ``--bucket_seq``,
   and the first step at its bucket against full pad in float32 (loss 1e-5,
   gradients 1e-3, eval logits 1e-5) and bfloat16 (``first_step_check``'s
   limits against the float32 full pad) (``python3 chip_smoke.py --bucket``
   runs this phase and the BEiT sweep alone); then the image-only runner
   ``cli/run_img.main`` the same way, each tower trained whole: ViT-B/16
   under ``auto`` (K = 1) and ``fused`` (K = 1 and 3: #2's tensor-core pair,
   #8 and its TN GEMM at 16x197 for the first time on a main path), DeiT-B/16
   (L = 198) under both, BEiT-B/16 (no kernel: its attention with the
   relative position bias is PyTorch's) started from a ``model.safetensors``
   written from a seed under Hugging Face's names, ResNet-152 ``--conv_att``
   at K = 1 and 3 (every BatchNorm buffer moved, updated inside the replayed
   graphs; K = 3's losses within 1e-5 of K = 1's, as everywhere: cuDNN's
   convolutions repeated bit for bit on the card) and ResNet-50
   ``--feature_extract`` started from a torchvision ``.npz`` written from a
   seed (only ``fc`` trains; the trunk and its
   BatchNorm buffers stay as imported); ``cli/run_mm_late.main`` with
   ResNet-152 ``concat_cnn`` and ``xatt`` (the text tower's kernels, the
   float32 trunk's buffers moved) and with BEiT (ITC + TIM, the frozen tower
   launching nothing); every imported tensor checked on the device against
   the file's, and the first step of ViT, DeiT, ``concat_cnn`` and BEiT late
   fusion held against the plain path as in step 9;
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
   unread pooler, and the artifacts, with the same numbers as step 7, and
   ``fused`` at K = 3 as in step 7; then ``--ckpt_every 2`` and ``--resume``
   (a 1.3 GB checkpoint at step 2; the resumed run's parameters equal the
   straight run's within 1e-6 of their scale; deleted after) and
   ``--remat`` (the first step's gradients, dropout on, within 1e-6 of those
   without it; the peak memory of both); then LXMERT (9 / 5 / 5 layers,
   hidden 768, 12 heads) over a task-3 ROI cache that the runner imports
   from the reference's per-sample dumps written from a seed (36 regions of
   2,048 float32 features a post, kept bit for bit), and MMBT (BERT-base
   over ``[CLS] img_1..img_3 [SEP] sentence``, L = 132, with a ResNet-152
   trunk at 224 px in bfloat16) the same way under ``auto`` and ``fused``
   at K = 1 and ``fused`` at K = 3 (LXMERT: 34 SDPA launches a step at
   128 x 128, 36 x 36, 128 x 36 and 36 x 128, or 24 blocks and the 10
   cross-attentions on the plain SDPA; MMBT: 12; every MMBT BatchNorm
   buffer moved, inside the replayed graphs at K = 3); and the grid ROI
   fallback (ResNet-50 at 224 px, 49 regions a post) on the same posts,
   timed, its features finite and its cache read back as written; every
   trainer, run with TF32 switched on before it, must leave it off (the
   port's float32 policy, ``cli/_common.py::set_precision_policy``);
9. holds the first train step of ``auto`` and of ``fused`` against the plain
   path (``--attn_impl jnp``), for late fusion, ViLT, LXMERT (every
   attention weight, the shared cross-attention's too) and MMBT: same state
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
   imported; then RoBERTa-base (``roberta_phase``): the tokenizer layouts on
   the host (a tiny BERT ``vocab.txt``, a BERT ``tokenizer.json`` and a
   byte-level ``vocab.json`` + ``merges.txt`` written by the script, their
   ids on ten texts equal to those the JAX package's Rust path gives, pasted
   here), the port's C++ tokenizer library built on this machine (its build
   seconds; hash, SentencePiece-BPE and fastBPE ids equal to the Python
   paths'), then a directory as roberta-base ships it, written from a seed
   (``model.safetensors`` at the published widths, vocabulary 50,265 and 514
   positions; ``vocab.json`` + ``merges.txt`` of 50,000 merges) and
   ``cli/run_txt.main --model_name roberta`` from it, one epoch of 48
   tweet-like posts in bfloat16 under ``auto``: the byte-level BPE with pad
   id 1, every id under 50,265, the imported tensors on the device equal to
   the file's, exact launch counts, the tokenizer's load and encode seconds,
   and the first step against the plain path as in step 9
   (``python3 chip_smoke.py --roberta`` runs the phase alone);
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
13. times one AdamW step over ViLT-B/32's 211 parameter tensors (float32
   and bfloat16 first moments): the kernel launches and copies the profiler
   sees, device ms and ms per step (``python3 chip_smoke.py --optimizer
   ROOT`` runs it alone for the port of another checkout);
14. trains three seeds of the late-fusion model together (``--seeds 30,40,50``)
   through ``cli/run_seed_sweep.main`` at full width, one epoch, under
   ``auto`` at K = 1 (each SDPA launch takes the three seeds' rows as its
   batch: a sweep step launches one seed's count; the S-folded shapes are
   checked in steps 3 and 6) and ``fused`` at K = 3 (the block kernels once
   per seed: three times one seed's count), with the same launch, loss,
   artifact, steady-time, idle-share and memory readings as step 7 beside
   the single seed's at the same K; each seed's per-step bfloat16 losses
   within 2e-2 relative of its separate ``run_mm_late`` run, and the first
   step in float32 (dropout 0, the swap pinned) within 1e-5 (loss) and 1e-3
   (text-tower attention and fusion-head gradients, relative) of each
   seed's separate setup; after the ``fused`` run, one AdamW step over the
   stacked gradients of one batch, every weight gradient in its parameter's
   strides, launching fewer kernels than over the gradients of the stacked
   product's old backward (transposed views, where ``_foreach_*`` falls back
   to one launch per tensor); then BEiT-B/16 late fusion under ``auto``,
   seeds 30 and 40 stacked (the relative-position tables along the seed
   axis), each seed's losses within 2e-2 of its separate run's
   (``python3 chip_smoke.py --sweep_profile ROOT``
   profiles one eager sweep step and one single-seed step under ``auto``
   and ``fused`` for the port of another checkout, each kernel with the
   autograd nodes or lines of the port that launched it);
15. writes the full-width serving model as the JAX package writes its
   artifact (a flax msgpack, by the port's own encoder: neither flax nor
   msgpack is imported), unrolled and in the ``--scan_layers`` layout, reads both back
   through ``load_params`` and serves 4 windows from each: the
   probabilities equal those served from the port's torch file exactly;
16. runs ``cli/run_grid.main`` over mm_late (two layers a tower, full width,
   float32), task 3, two seeds x aux {none, itc+itm}, under
   ``--seed_backend sequential`` and then ``vmap`` (the seeds of each
   setting as one sweep, seen in the vision tower's SDPA over both seeds'
   images): the tables agree within rtol 5e-3 / atol 1e-4, the predictions
   are equal;
16b. runs the Faster R-CNN (``models/frcnn.py``) at its published geometry
   (R101-C4, 6,000 / 1,000 RPN candidates, 1,600 classes, the 800 x 1,333
   canvas) over 16 generated photos of mixed size and orientation, from a
   checkpoint written from a seed in the published key layout and read by
   ``load_frcnn`` (``seeded_frcnn_checkpoint``: frozen batch norms set from
   their inputs, Detectron2's small head inits, one template class a
   photo under which its per-class NMS keeps 1-35 regions): the card
   against the
   port's CPU path stage by stage (1e-3 of each output's scale), the
   device RPN NMS against ``greedy_nms`` on every photo's candidates
   (identical prefixes, 1,000 kept, candidates suppressed), fused against
   staged ``detect_batch`` (classes exact, boxes 1e-5, features 1e-4) with
   36 live, distinct regions and both branches of the final selection on
   every photo; then ``cli/obj_features.main --mode obj --obj_source
   frcnn`` over 48 posts (three batches) in float32 and ``--frcnn_dtype
   bfloat16``, each with ``pil``, ``device``, ``device`` and ``pil`` ingest
   (the set-up, the first batch and the images/s of the batches after it
   apart, peak memory, the device ms of each stage in a batch of the 16
   photos between CUDA events at its ``record_function`` ranges; no post without
   features; ``ensure_roi_cache`` returns the cache untouched), and
   ``serve --model lxmert`` with the early phase's LXMERT artifact and the
   checkpoint under ``auto`` and ``fused`` (34 SDPA launches / 24 blocks a
   window, probabilities within ``PROB_TOL`` of the plain path's;
   ``python3 chip_smoke.py --detector`` runs this phase alone over a random
   LXMERT, without the last line);
16c. trains the headline run with ``--scan_layers`` (``fused``, K = 1, its
   launches counted) and holds its losses and saved state to the unrolled
   ``train[fused]`` run's, bit for bit (where they differ, a second unrolled
   run measures how far two unrolled runs lie apart, and the scanned run is
   held to that); serves its artifact with ``serve --scan_layers`` beside the
   unrolled one (the same probabilities, the launches a window exact); and
   runs ``cli/export.py --model lxmert --export_detector --platforms cuda``
   at ``--detector_batch`` 16 with the detector phase's checkpoint: each
   orientation's program, loaded, gives the live detector's boxes, classes
   and counts on the photos of that orientation (padded to 16) exactly and
   its features and scores within rtol 1e-5, atol 1e-4, holding two
   ``smtc::nms_keep`` nodes; the export, load and call times logged
   (``python3 chip_smoke.py --scan_export`` runs this phase alone after one
   unrolled run, a seeded detector checkpoint and a random LXMERT, without
   the last line);
17. holds every (kernel, shape) that those runs launched and no row of
   steps 3, 6 and 12 holds (the grid's float32 shapes, eval steps' B rows,
   the sweep's folded eval batch, the text-only runner's B rows) against
   its plain version in the same way, a row named by its shape, and fails
   for a launch that no row can hold;
18. prints one JSON line of per-kernel numbers (``launches``: the count over
   the serving (and its extras), training, sweep, artifact and grid runs and
   the per-head phase's main path, each read with the counts set to 0 just before it; 0
   for the check-only shapes), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. Without CUDA, or
without the repository beside it, it exits non-zero at once.
"""

import contextlib
import gc
import json
import math
import os
import shutil
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
# serve --quantize w8 against the plain path under w8: the same int8 weights, so only the
# kernels' rounding is left (2.9e-3 read on the H100); the unquantized service lies 1.58e-2
# from it, so a service that skipped the quantization fails
W8_TOL = 6e-3
TRAIN_POSTS = (48, 8, 8)  # train / val / test rows of the generated dataset
STEADY_PASSES = 2  # passes over the train split timed after each training run
DEVICE = "cuda"
VILT_TEXT, VILT_SIDE = 40, 19  # ViLT's text positions; the 608-px canvas at patch 32
VILT_LEN = VILT_TEXT + 1 + VILT_SIDE ** 2  # 402, --vilt_exact_resize
VILT_FIXED_LEN = VILT_TEXT + 1 + 12 ** 2  # 185, the fixed 384-px square
DEIT_LEN = 2 + 14 ** 2  # 198: DeiT-B/16's CLS and distillation tokens and 196 patches
LXMERT_BOXES = 36  # ROI regions a post
MMBT_LEN = 128 + 4  # [CLS], three image tokens, [SEP] and the 127 sentence tokens
SWEEP_SEEDS = (30, 40, 50)  # the JAX sweep's default --seeds
BEIT_SWEEP_SEEDS = (30, 40)
BUCKET_POSTS = (96, 16, 16)  # train / val / test rows of the bucketing phase's posts
BUCKET_DATA_SEED = 11  # the bucketing phase's posts: all four widths, the first step at 32
SWEEP_ROWS = len(SWEEP_SEEDS) * BATCH  # a sweep step's rows: the seeds folded into the batch
# photo sizes (height, width) of 4:3, 3:4, 16:9 and 1:1 for the generated ViLT frames
VILT_PHOTOS = ((480, 640), (640, 480), (720, 1280), (500, 500), (960, 1280), (1080, 1920))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


# torch.cuda._sleep counts SM clock cycles: at no more than 2e9 a second
# (the H100's top clock is 1.98 GHz) a sleep lasts at least the seconds asked
SLEEP_CYCLES_PER_S = 2e9
SLEEP_CAP_S = 1.0


def device_ms(torch, fn, iters=30, warmup=3):
    """Device milliseconds per call of ``fn``. A sleep kernel is queued
    first so the host enqueues every call before the card reaches the start
    event: the events then time the device, not the host's launch loop. The
    sleep lasts three times what the host took to enqueue the last warm-up
    call, ``iters`` times over (5 ms at least, a second at most); ``iters``
    is cut (3 at least) until such a sleep covers the host's loop. Where
    the host still lags behind the card, the calls are timed again with a
    quarter of them: the host's launches wait once the card's queue of
    pending launches is full, and a call of many kernels fills it in a few
    dozen calls however long the sleep."""
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    iters = max(3, min(iters, int(SLEEP_CAP_S / (4 * host_s))))
    while True:
        sleep_s = min(max(3 * iters * host_s, 0.005), SLEEP_CAP_S)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        loop_s = time.perf_counter() - t0
        host_bound = start.query()  # the card got past the sleep before the host was done
        torch.cuda.synchronize()
        if not host_bound:
            return start.elapsed_time(end) / iters
        if iters == 3:
            break
        iters = max(3, iters // 4)
    # still host-bound: the events' span includes the card waiting for the
    # host, an upper bound on the device time
    log(f"timing: {getattr(fn, '__name__', 'call')} stayed host-bound ({iters} calls enqueued "
        f"in {loop_s * 1e3:.1f} ms after a {sleep_s * 1e3:.0f} ms sleep); its time is the "
        "events' span, an upper bound")
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def key_mask(torch, g, kind, b, length):
    """A (B, L) int32 key mask of ``kind``: None (``False``), ViLT's
    (``"vilt"``), all ones (``"ones"``: LXMERT's vision branch) or text
    padded past a random length of 2 or more (``True``)."""
    if kind == "vilt":
        return vilt_mask(torch, g, b, length)
    if kind == "ones":
        return torch.ones(b, length, dtype=torch.int32, device="cuda")
    if not kind:
        return None
    lens = torch.randint(2, length + 1, (b,), generator=g, device="cuda")
    return (torch.arange(length, device="cuda")[None, :] < lens[:, None]).to(torch.int32)


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
    # one cuobjdump per library, all at once, each into a file of its own
    dumps, procs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for lib in _cuda.SOURCES:
                with open(os.path.join(tmp, lib), "w") as out:
                    procs.append(subprocess.Popen(
                        [tool, "--dump-sass", _cuda.library_path(lib)], stdout=out))
            for proc in procs:
                if proc.wait(timeout=300):
                    raise subprocess.CalledProcessError(proc.returncode, proc.args)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for lib in _cuda.SOURCES:
            with open(os.path.join(tmp, lib)) as f:
                dumps[lib] = f.read()
    for lib, sass in dumps.items():
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

    for tag, m in TN_ROWS.items():
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
    return out, tn_rows(torch, AB, TN_ROWS, line)


def tn_rows(torch, AB, shapes, line=None):
    """The TN GEMM (a block backward's four weight gradients over ``m``
    token rows, ``shapes``: tag -> m) against its plain version and one
    ``torch.bmm``: its kernels-line rows (and ``time_gemm``'s lines)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    hid, rows = 768, []

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    for tag, m in shapes.items():
        x, ctx = randn(m, hid), randn(m, hid)
        xs, gs = [x, x, x, ctx], [randn(m, hid, scale=m ** -0.5) for _ in range(4)]
        want = AB.gemm_tn_reference(xs, gs)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(AB.gemm_tn(xs, gs), want))
        if not err <= 2e-2 * max(1.0, max(y.float().abs().max().item() for y in want)):
            raise AssertionError(f"gemm_tn {tag}: disagrees with its plain version ({err})")
        x_st, g_st = torch.stack(xs), torch.stack(gs)
        flop = 2.0 * m * hid * hid * 4
        lib_ms = device_ms(torch, lambda: torch.bmm(g_st.transpose(1, 2), x_st))
        ms = device_ms(torch, lambda: AB.gemm_tn(xs, gs))
        if line is not None:
            line("gemm_tn", f"{tag} x4", m, err, ms, "torch.bmm", lib_ms, flop)
        # the kernels line: six (m, 768) inputs read once, four (768, 768) written
        bound_ms, bound_by = bound(nbytes(x, ctx, *gs, *want), flop, "bfloat16")
        rows.append(dict(name=f"gemm_tn/{tag}", kernel="gemm_tn_bf16", key=(m, hid, hid, 4),
                         max_abs_err=err, ms=ms,
                         plain_ms=device_ms(torch, lambda: AB.gemm_tn_reference(xs, gs)),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
        log(f"time gemm_tn/{tag}: kernel {ms:.4f} ms, plain {rows[-1]['plain_ms']:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del x, ctx, xs, gs, want, x_st, g_st
        torch.cuda.empty_cache()
    return rows


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


SDPA_FWD_SHAPES = {
    # TPU kernels 1 and 3: every SDPA of the serving path and of ViLT (the
    # joint sequence with TIM batched, 2B rows; 402 > 256 is kernel 3's
    # range; float32 and the fixed square's 185 are checked, not on the paths)
    "text": (BATCH, 12, 128, 128, 64, "bfloat16", True),
    "image": (BATCH, 12, 197, 197, 64, "bfloat16", False),
    "fusion": (BATCH, 1, 1, 197, 768, "float32", False),
    "vilt_exact": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "bfloat16", "vilt"),
    "vilt_exact_f32": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "float32", "vilt"),
    "vilt_fixed": (2 * BATCH, 12, VILT_FIXED_LEN, VILT_FIXED_LEN, 64, "bfloat16", "vilt"),
    # the seed sweep's S = 3 seeds folded into the batch: its train step's
    # text tower and fusion head (2B rows a seed with TIM) and its vision tower
    "text_s3": (2 * SWEEP_ROWS, 12, 128, 128, 64, "bfloat16", True),
    "image_s3": (SWEEP_ROWS, 12, 197, 197, 64, "bfloat16", False),
    "fusion_s3": (2 * SWEEP_ROWS, 1, 1, 197, 768, "float32", False),
    # DeiT's tower, CLS + distillation token: the image-only runner
    "deit": (BATCH, 12, DEIT_LEN, DEIT_LEN, 64, "bfloat16", False),
    # LXMERT (2B rows, TIM batched): the vision branch's self-attention over
    # 36 regions (its mask all ones) and the two cross-attentions, 128 text
    # queries over 36 regions and 36 region queries over the masked text
    "lxmert_vis": (2 * BATCH, 12, LXMERT_BOXES, LXMERT_BOXES, 64, "bfloat16", "ones"),
    "lxmert_x_lang": (2 * BATCH, 12, 128, LXMERT_BOXES, 64, "bfloat16", "ones"),
    "lxmert_x_vis": (2 * BATCH, 12, LXMERT_BOXES, 128, 64, "bfloat16", True),
    # MMBT's joint sequence, and the two early services' windows of BATCH
    "mmbt": (2 * BATCH, 12, MMBT_LEN, MMBT_LEN, 64, "bfloat16", True),
    "vilt_serve": (BATCH, 12, VILT_FIXED_LEN, VILT_FIXED_LEN, 64, "bfloat16", "vilt"),
    "mmbt_serve": (BATCH, 12, MMBT_LEN, MMBT_LEN, 64, "bfloat16", True)}
# TPU kernel 7: every self-attention block with --attn_impl fused (rows, length, mask)
BLOCK_FWD_SHAPES = {"text": (BATCH, 128, True), "image": (BATCH, 197, False),
                    "vilt_exact": (2 * BATCH, VILT_LEN, "vilt"), "deit": (BATCH, DEIT_LEN, False),
                    "lxmert_vis": (2 * BATCH, LXMERT_BOXES, "ones"),
                    "mmbt": (2 * BATCH, MMBT_LEN, True),
                    "vilt_serve": (BATCH, VILT_FIXED_LEN, "vilt"),
                    "mmbt_serve": (BATCH, MMBT_LEN, True)}
# TPU kernels 2 and 4: the SDPA backward of the text tower, of the fusion head
# and of ViLT's joint sequence (the query-tiled pair at 402 and 185; float32
# and 185 are checked, not on the paths)
SDPA_BWD_SHAPES = {
    "text": (2 * BATCH, 12, 128, 128, 64, "bfloat16", True),
    "fusion": (2 * BATCH, 1, 1, 197, 768, "float32", False),
    "vilt_exact": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "bfloat16", "vilt"),
    "vilt_exact_f32": (2 * BATCH, 12, VILT_LEN, VILT_LEN, 64, "float32", "vilt"),
    "vilt_fixed": (2 * BATCH, 12, VILT_FIXED_LEN, VILT_FIXED_LEN, 64, "bfloat16", "vilt"),
    # the seed sweep's train step, S = 3 seeds folded into the batch
    "text_s3": (2 * SWEEP_ROWS, 12, 128, 128, 64, "bfloat16", True),
    "fusion_s3": (2 * SWEEP_ROWS, 1, 1, 197, 768, "float32", False),
    # the image tower trained whole by the image-only runner: ViT and DeiT
    "image": (BATCH, 12, 197, 197, 64, "bfloat16", False),
    "deit": (BATCH, 12, DEIT_LEN, DEIT_LEN, 64, "bfloat16", False),
    # LXMERT's vision self-attention and cross-attentions, MMBT's joint sequence
    "lxmert_vis": (2 * BATCH, 12, LXMERT_BOXES, LXMERT_BOXES, 64, "bfloat16", "ones"),
    "lxmert_x_lang": (2 * BATCH, 12, 128, LXMERT_BOXES, 64, "bfloat16", "ones"),
    "lxmert_x_vis": (2 * BATCH, 12, LXMERT_BOXES, 128, 64, "bfloat16", True),
    "mmbt": (2 * BATCH, 12, MMBT_LEN, MMBT_LEN, 64, "bfloat16", True)}
# TPU kernel 8: the fused block's backward in the text tower, in ViLT's
# joint encoder and in the image-only runner's ViT / DeiT, --attn_impl fused
BLOCK_BWD_SHAPES = {"text": (2 * BATCH, 128, True), "vilt_exact": (2 * BATCH, VILT_LEN, "vilt"),
                    "image": (BATCH, 197, False), "deit": (BATCH, DEIT_LEN, False),
                    "lxmert_vis": (2 * BATCH, LXMERT_BOXES, "ones"),
                    "mmbt": (2 * BATCH, MMBT_LEN, True)}
# the weight gradients' TN GEMM of kernel 8 over its token rows (3,152 and
# 3,168 for the image towers: no multiple of the 128-row tile; LXMERT's
# vision branch 1,152 and MMBT 4,224, whole tiles of sequences that end
# inside one)
TN_ROWS = {"text": 2 * BATCH * 128, "vilt_exact": 2 * BATCH * VILT_LEN,
           "image": BATCH * 197, "deit": BATCH * DEIT_LEN,
           "lxmert_vis": 2 * BATCH * LXMERT_BOXES, "mmbt": 2 * BATCH * MMBT_LEN}


def check_kernels(torch, sdpa_shapes=SDPA_FWD_SHAPES, block_shapes=BLOCK_FWD_SHAPES):
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

    for tag, (b, h, lq, lk, d, dtype, masked) in sdpa_shapes.items():
        dt = getattr(torch, dtype)
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        mask = lengths_mask(b, lk) if masked is True else key_mask(torch, g, masked, b, lk)
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

    hid, heads = 768, 12
    for tag, (b, l, masked) in block_shapes.items():
        dt = torch.bfloat16
        x = randn(b, l, hid, dtype=dt)
        w = [(randn(hid, hid, dtype=torch.float32) * hid ** -0.5).to(dt) for _ in range(4)]
        bias = [randn(hid, dtype=torch.float32).mul(0.1).to(dt) for _ in range(4)]
        mask = lengths_mask(b, l) if masked is True else key_mask(torch, g, masked, b, l)
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


def check_bwd_kernels(torch, sdpa_shapes=SDPA_BWD_SHAPES, block_shapes=BLOCK_BWD_SHAPES):
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

    for tag, (b, h, lq, lk, d, dtype, masked) in sdpa_shapes.items():
        dt = getattr(torch, dtype)
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        do = randn(b, h, lq, d, dtype=dt)
        mask = key_mask(torch, g, masked, b, lk)
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

    hid, heads = 768, 12
    for tag, (b, l, masked) in block_shapes.items():
        dt = torch.bfloat16
        x = randn(b, l, hid, dtype=dt)
        w = [(randn(hid, hid, dtype=torch.float32) * hid ** -0.5).to(dt) for _ in range(4)]
        bias = [randn(hid, dtype=torch.float32).mul(0.1).to(dt) for _ in range(4)]
        mask = key_mask(torch, g, masked, b, l)
        masked = mask is not None
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
        lib_out = mha(x_leaf, x_leaf, x_leaf, key_padding_mask=None if mask is None else mask == 0,
                      need_weights=False)[0]
        m = b * l
        ops = 2.0 * m * hid * hid * 7 + 12.0 * b * l * l * hid
        timed(f"attn_block_bwd/{tag}", "attn_block_bwd", ("bfloat16", b, l, hid, heads, masked),
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
              ("bfloat16", b, l, hid, heads, masked), err_whole,
              lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
              lambda: AB.attn_block_bwd_reference(x, mask, w[0], bias[0], w[1], bias[1], w[2],
                                                  bias[2], w[3], bias[3], do, heads),
              lambda: torch.autograd.grad(lib_out, [x_leaf] + mha_params, do, retain_graph=True),
              nbytes(x, mask, do, *w, *bias, *grads), ops + 2.0 * m * hid * hid * 4, "bfloat16")
        del lib_out, x_leaf, mha, mha_params, outs, refs, leaves, out, grads
        torch.cuda.empty_cache()
    return rows


def held_keys(rows):
    """The (kernel, key) pairs that kernels-line rows hold (the whole block
    backward runs once per launch of its kernel)."""
    return {("attn_block_bwd" if r["kernel"] == "attn_block_bwd_whole" else r["kernel"], r["key"])
            for r in rows}


def rows_for_every_launch(torch, AB, rows, launches):
    """A kernels-line row for each (kernel, key) that the main paths
    launched and no row holds yet (the grid's float32 shapes, eval steps'
    B rows, the sweep's folded eval batch, ...): the kernel against its
    plain version at that shape, named by it. Fails for a launch that no
    row can hold."""
    def kind(masked, length):
        return "vilt" if masked and length in (VILT_LEN, VILT_FIXED_LEN) else masked

    missing = sorted(pair for pair, n in launches.items() if n and pair not in held_keys(rows))
    sdpa_fwd, sdpa_bwd, block_fwd, block_bwd, tn = {}, {}, {}, {}, {}
    for kernel, key in missing:
        if kernel in ("sdpa_fwd", "sdpa_bwd"):
            dtype, b, h, lq, lk, d, masked = key
            tag = (f"{'f32' if dtype == 'float32' else 'bf16'} {b}x{h}x{lq}x{lk}x{d}"
                   + (" masked" if masked else ""))
            (sdpa_fwd if kernel == "sdpa_fwd" else sdpa_bwd)[tag] = (
                b, h, lq, lk, d, dtype, kind(masked, lk))
        elif kernel in ("attn_block_fwd", "attn_block_bwd") and key[0] == "bfloat16" \
                and key[3:5] == (768, 12):
            _, b, l, _, _, masked = key
            tag = f"bf16 {b}x{l}x768" + (" masked" if masked else "")
            (block_fwd if kernel == "attn_block_fwd" else block_bwd)[tag] = (
                b, l, kind(masked, l))
        elif kernel == "gemm_tn_bf16" and key[1:] == (768, 768, 4):
            tn[f"{key[0]}x768 x4"] = key[0]
        else:
            raise AssertionError(f"{kernel} {key}: launched on a main path, and no row can "
                                 "hold it against its plain version")
    log(f"rows for the main paths' other shapes: {len(missing)} (kernel, shape) pairs "
        f"{missing}")
    new = []
    if sdpa_fwd or block_fwd:
        new += check_kernels(torch, sdpa_fwd, block_fwd)
    if sdpa_bwd or block_bwd:
        new += check_bwd_kernels(torch, sdpa_bwd, block_bwd)
    if tn:
        new += tn_rows(torch, AB, tn)
    still = [pair for pair in missing if pair not in held_keys(new)]
    if still:
        raise AssertionError(f"launches that no row holds: {still}")
    return new


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


POST_WORDS = tuple("rain sun happy sad team win lose love hate coffee city tonight best worst"
                   .split())


def make_dataset(root, name="data", posts=TRAIN_POSTS, words_of=lambda rng: rng.randint(3, 60),
                 seed=7, words=POST_WORDS):
    """A task-3 data key (``data_key_mvsa.csv``) of ``posts`` train / val /
    test rows, each post of ``words_of(rng)`` of ``words``, and a 224-px uint8
    pixel cache in the on-disk format of ``data/cache.py``, made with the
    csv module and numpy from ``seed`` under ``root/name``; returns the data
    directory."""
    import csv

    import numpy as np

    rng = np.random.RandomState(seed)
    data = os.path.join(root, name) + os.sep
    os.makedirs(data, exist_ok=True)
    words = list(words)
    splits = ["train"] * posts[0] + ["val"] * posts[1] + ["test"] * posts[2]
    ids = [1000 + i for i in range(len(splits))]
    with open(data + "data_key_mvsa.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tweet_id", "text", "label", "split"])
        for i, split in zip(ids, splits):
            text = " ".join(rng.choice(words, size=words_of(rng)))
            w.writerow([i, text, rng.randint(0, 3), split])
    cache = os.path.join(data, "cache", "mvsa_u8_224")
    os.makedirs(cache)
    np.save(os.path.join(cache, "pixels.npy"),
            rng.randint(0, 256, (len(ids), 224, 224, 3), dtype=np.uint8))
    with open(os.path.join(cache, "meta.json"), "w") as f:
        json.dump({"index": {str(i): r for r, i in enumerate(ids)}, "size": 224,
                   "valid": [True] * len(ids)}, f)
    return data


def tweet_words(rng):
    """A tweet-like post length in words: mostly 3-25 (one token a word, plus
    two: the 32 bucket), some 40-60 (64), a few 70-90 (96) and 100-120 (past
    the buckets: the full pad of 128)."""
    u = rng.rand()
    for below, low, high in ((0.015, 100, 121), (0.04, 70, 91), (0.09, 40, 61)):
        if u < below:
            return rng.randint(low, high)
    return rng.randint(3, 26)


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


def txt_args(attn_impl, extra=()):
    return ["--model_name", "bernice", "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--save_model", "--log_every", "1",
            "--attn_impl", attn_impl, *extra]


def count_launches(launches, by_key):
    for kernel, keys in by_key.items():
        for key, n in keys.items():
            launches[(kernel, key)] = launches.get((kernel, key), 0) + n


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


def is_port_kernel(key: str) -> bool:
    """The port's own kernels in a profile (csrc/: the smtc:: SDPA kernels
    and the block kernels' GEMMs)."""
    return "smtc::" in key or "namespace)::gemm_" in key


# the idle host time on each side of a profiled step (profile_step)
PROFILE_MARGIN_S = 0.05


def profile_step(torch, step, tag, attempts=3):
    """Two calls of ``step`` under the profiler, the first its warm-up (not
    recorded: the tracer's start can miss the first kernels of a CUDA graph
    replayed at once), the second recorded: its wall ms, the device's busy
    ms and idle share, the events on the device and the calls of ``step``
    made. The recorded window opens ``PROFILE_MARGIN_S`` before the step
    and closes as long after it: the tracer drops a kernel whose device
    timestamp, mapped onto the host's clock, falls outside the window, and
    a step begun just as it opened lost its first kernels that way. A
    profile that records no device event (the tracer missed a whole session
    once in a long run) is taken again, up to ``attempts`` times. Only the
    card's activity is traced: the host's op events, thousands a step, took
    the profiler most of a second a step to read, and nothing reads them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, attempts + 1):
        recorded = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_MARGIN_S)
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        # the schedule's own step range is no kernel
        events = [e for e in recorded[0] if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        if busy:
            break
        log(f"{tag}: the profiler saw no device events (attempt {attempt} of {attempts})")
    if not busy:
        log(f"{tag}: device idle share not measured (the profiler saw no device events)")
    return wall, busy, (1 - busy / wall) if busy else None, events, 2 * attempt


# aten's matrix products: a float32 operand makes one a float32 GEMM
GEMM_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "_addmm_activation", "mv",
                      "addmv", "dot"})


def count_f32_gemms(torch, fn):
    """The float32 matrix products that ``fn`` dispatches, forward and
    backward, by aten op: counted where they are dispatched, so neither the
    name of the kernel cuBLAS picks nor an event the profiler drops moves
    the count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in GEMM_OPS and any(isinstance(a, torch.Tensor)
                                        and a.dtype == torch.float32 for a in args):
                counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


INIT_MEMO_BYTES = 24 << 30  # host bytes the random-init memo may hold


def memoize_init(torch):
    """Make every builder's ``init_weights`` (the port's random init on the
    CPU, drawn one number at a time from a CPU generator: about 2.8 s for
    the 368 M parameters of Bernice + ViT) give a module it has seen before
    the tensors it gave it then: the key is the module's class, each
    parameter's and buffer's name, shape, dtype and device, and the
    generator's state before the draw. A first build runs the real init and
    keeps a CPU copy of every tensor and the generator's state after it; a
    later build with the same key copies those in and sets the generator to
    that state, so the module and every later draw are what the real init
    gives. The least recently used entries go past ``INIT_MEMO_BYTES``.
    Returns the hit and miss counts."""
    import importlib
    from collections import OrderedDict

    encoder = importlib.import_module(f"{PKG}.models.encoder")
    real = encoder.init_weights
    memo, stats = OrderedDict(), {"hits": 0, "misses": 0, "bytes": 0}

    def init_weights(module, generator):
        tensors = dict(module.named_parameters())
        tensors.update(module.named_buffers())
        key = (type(module).__qualname__, generator.device.type,
               tuple((n, tuple(t.shape), t.dtype, t.device.type) for n, t in tensors.items()),
               generator.get_state().numpy().tobytes())
        hit = memo.get(key)
        if hit is None:
            stats["misses"] += 1
            real(module, generator)
            saved = {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}
            size = sum(t.numel() * t.element_size() for t in saved.values())
            memo[key] = (saved, generator.get_state(), size)
            stats["bytes"] += size
            while stats["bytes"] > INIT_MEMO_BYTES and len(memo) > 1:
                stats["bytes"] -= memo.popitem(last=False)[1][2]
            return
        stats["hits"] += 1
        memo.move_to_end(key)
        saved, after, _ = hit
        with torch.no_grad():
            for n, t in tensors.items():
                t.copy_(saved[n])
        generator.set_state(after)

    users = [importlib.import_module(f"{PKG}.{name}")
             for name in ("models.encoder", "models.vilt", "models.mmbt", "models.lxmert",
                          "cli._build", "cli.obj_features")]
    for module in users:
        if getattr(module, "init_weights", None) is not real:
            raise AssertionError(f"{module.__name__} has no init_weights of models/encoder.py")
        module.init_weights = init_weights
    return stats


def train_run(torch, main, argv, tag, counters, results_dir, stem, expect, check_grads,
              k=1, eager_kernels=None, epochs=1, fills=None, after=None):
    """``epochs`` epochs (the argv's ``--epochs``) through a trainer's
    ``main(argv)`` at ``--steps_per_dispatch k``; checks the launch counts
    per train and eval step, the gradients (``check_grads(setup, grads)``)
    and the artifacts ``stem`` + ...; returns its numbers and the launch
    counts by (kernel, key). ``fills`` = (launches of one vision-tower run
    by kernel, a function giving the ``--cache_vision`` tower runs so far of
    the train pipe and of the eval pipes): each run adds its launches to the
    step or eval that triggered it. ``after(trainer, setup)`` is called last,
    before the setup is let go.

    Under k > 1 ``on_step`` comes once per chunk, each step a CUDA graph
    replay: a chunk of n steps launches n times a step's kernels, and once
    more for each graph captured in it (the step's gradients, run eagerly
    before the capture: the first chunk's, and under ``--bucket_seq`` the
    first chunk of each width), and the evals once more than their steps
    for each eval graph captured. A replayed step is profiled, after one
    unrecorded warm-up call: it must run the port's kernels by name as often
    as the eager step of the same path does (``eager_kernels``), and the two
    calls move the counters by two steps' counts."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.loop import Trainer

    for c in counters.values():
        c.reset()
    chunks = []
    # the launches of the evals (an epoch's evals run between two steps when
    # there is a next epoch), kept apart from the steps'
    evals_seen = {k: 0 for k in counters}
    state = {"t": None, "prev": {k: 0 for k in counters}, "fills": 0, "captures": 0,
             "captured": 0, "eval_captures": 0}
    per_fill, fill_calls = fills if fills else ({}, lambda: (0, 0))
    real_evaluate, real_capture = Trainer.evaluate, steps.StepGraph._capture

    def capture(self, tensors):
        state["captures"] += 1
        return real_capture(self, tensors)

    def evaluate(self, *a, **kw):
        before = {k: c.count for k, c in counters.items()}
        captured = state["captures"]
        res = real_evaluate(self, *a, **kw)
        for k, c in counters.items():
            evals_seen[k] += c.count - before[k]
            state["prev"][k] += c.count - before[k]
        state["eval_captures"] += state["captures"] - captured
        state["captured"] += state["captures"] - captured
        return res

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = {k: c.count - state["prev"][k] for k, c in counters.items()}
        state["prev"] = {k: c.count for k, c in counters.items()}
        vals = {k: v.reshape(-1).tolist() for k, v in metrics.items()}
        if not all(x == x and abs(x) != float("inf") for v in vals.values() for x in v):
            raise AssertionError(f"{tag}: step {step} metrics not finite: {vals}")
        train_fills = fill_calls()[0]
        chunks.append(dict(seconds=None if state["t"] is None else now - state["t"],
                           counts=counts, losses=vals["loss"],
                           fills=train_fills - state["fills"],
                           captures=state["captures"] - state["captured"]))
        state["t"], state["fills"], state["captured"] = now, train_fills, state["captures"]

    argv = list(argv) + ["--steps_per_dispatch", str(k)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # TF32 on before the run: the runner itself must turn it off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    Trainer.evaluate, steps.StepGraph._capture = evaluate, capture
    try:
        trainer, setup = main(argv, on_step=on_step, keep_grads=True)
    finally:
        Trainer.evaluate, steps.StepGraph._capture = real_evaluate, real_capture
    torch.cuda.synchronize()
    precision_check(torch, tag)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    totals = {k: c.count for k, c in counters.items()}
    by_key = {k: dict(c.by_key) for k, c in counters.items()}

    losses = [x for ch in chunks for x in ch["losses"]]
    n_train = len(losses)
    n_eval = epochs * (setup.pipes["val"].num_batches + setup.pipes["test"].num_batches)
    for i, ch in enumerate(chunks):
        n_steps = len(ch["losses"]) + ch["captures"]
        for kernel, n in expect["train"].items():
            want = n * n_steps + per_fill.get(kernel, 0) * ch["fills"]
            if ch["counts"][kernel] != want:
                raise AssertionError(f"{tag}: chunk {i + 1} launched {kernel} "
                                     f"{ch['counts'][kernel]} times, expected {n} x {n_steps}"
                                     f" + {ch['fills']} tower runs")
    if k > 1 and not chunks[0]["captures"]:
        raise AssertionError(f"{tag}: the first chunk captured no graph")
    evals = n_eval + state["eval_captures"]
    eval_fills = fill_calls()[1]
    if {k: sum(ch["counts"][k] for ch in chunks) + evals_seen[k] for k in counters} != totals:
        raise AssertionError(f"{tag}: launches outside the steps and the evals")
    for kernel, n in expect["eval"].items():
        seen = evals_seen[kernel]
        if seen != n * evals + per_fill.get(kernel, 0) * eval_fills:
            raise AssertionError(f"{tag}: {evals} eval steps launched "
                                 f"{kernel} {seen} times, expected {n} each + "
                                 f"{eval_fills} tower runs")
    log(f"{tag}: launches per train step {expect['train']}, per eval step "
        f"{expect['eval']} over {n_train} train and {n_eval} eval steps in "
        f"{len(chunks)} dispatches of up to {k}"
        + (f", {sum(ch['captures'] for ch in chunks)} train and {state['eval_captures']} "
           "eval graphs captured" if k > 1 else "")
        + (f", and {per_fill} for each of {sum(fill_calls())} vision-tower runs" if fills else "")
        + ": exact")

    check_grads(setup, setup.train_step.last_grads)

    for suffix in ("metrics_val.csv", "metrics_test.csv", "net.pth"):
        path = os.path.join(results_dir, stem + suffix)
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"{tag}: artifact {path} missing")
    with open(os.path.join(results_dir, stem + "metrics_test.csv")) as f:
        table = f.read().splitlines()
    header = "metric," + ",".join(f"epoch-{e + 1}" for e in range(epochs))
    if table[0] != header or len(table) != 8:
        raise AssertionError(f"{tag}: metrics table {table}")

    # the train split STEADY_PASSES times more through the same path, one
    # sync at the end: ms per step with the host free to run ahead of the
    # card (and under k > 1 to stage a chunk while the card runs the last)
    pipe, dev, gen = setup.pipes["train"], setup.device, trainer.gen
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(STEADY_PASSES):
        if k == 1:
            for batch in pipe.device_iter(dev, shuffle=False):
                setup.train_step(batch, gen)
        else:
            for batches, k_real in pipe.device_iter_chunks(dev, k):
                trainer.train_many(batches, k_real, gen)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t1) * 1e3 / (STEADY_PASSES * pipe.num_batches)

    # one more step under the profiler: the device's idle share
    f32_gemms = None
    if k == 1:
        batch = next(pipe.device_iter(dev, shuffle=False))
        f32_gemms = count_f32_gemms(torch, lambda: setup.train_step(batch, gen))

        def step():
            setup.train_step(batch, gen)
    else:
        batches, _ = next(pipe.device_iter_chunks(dev, 1))

        def step():
            trainer.train_many(batches, 1, gen)
    before = {k: c.count for k, c in counters.items()}
    step_wall, busy, idle, events, calls = profile_step(torch, step, tag)
    # the profiler's warm-up call and the recorded one (of each attempt)
    moved = {k: c.count - before[k] for k, c in counters.items()}
    if moved != {k: calls * n for k, n in expect["train"].items()}:
        raise AssertionError(f"{tag}: the profiled steps moved the counters by {moved}, "
                             f"expected {calls} x {expect['train']}")
    kernels = {e.key: e.count for e in events if is_port_kernel(e.key)}
    if eager_kernels is not None:
        if kernels != eager_kernels:
            raise AssertionError(f"{tag}: the replayed step ran the port's kernels "
                                 f"{kernels}, the eager step {eager_kernels}")
        log(f"{tag}: the profiled replay ran the port's kernels as the eager step did "
            f"({sum(kernels.values())} launches of {len(kernels)} kernels) and moved the "
            f"counters by one step's counts")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # cuBLAS's float32 SIMT GEMMs (the block's weight gradients before they
    # moved onto the TN GEMM): their launches and time
    sgemm = [e for e in events if "sgemm" in e.key]
    sgemm_calls = sum(e.count for e in sgemm)
    sgemm_ms = sum(e.self_device_time_total for e in sgemm) / 1e3
    # copies and casts (PyTorch's copy kernels), e.g. float32 copies made for
    # products, or a transpose copy of a gradient
    copies = [e for e in events if "copy_kernel" in e.key]
    if f32_gemms is not None:
        log(f"profile {tag}: f32 GEMMs dispatched in a step {f32_gemms}; f32 sgemm kernels "
            f"{ {e.key[:60]: e.count for e in sgemm} }")
    log(f"profile {tag}: f32 sgemm {sgemm_ms:.3f} ms x{sgemm_calls}; copies "
        f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms "
        f"x{sum(e.count for e in copies)}; {sum(e.count for e in events)} kernel launches")
    # the eight largest, then every other kernel of the port's own
    for i, e in enumerate(ranked):
        if i < 8 or is_port_kernel(e.key):
            log(f"profile {tag}:   {e.self_device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<4d} {e.key[:90]}")
    timed = [ch["seconds"] / len(ch["losses"]) for ch in chunks if ch["seconds"] is not None]
    ms = 1e3 * sum(timed) / len(timed) if timed else None
    # the profiler's own host work lengthens the profiled step: the share
    # against the unprofiled step is the second reading
    result = dict(run=tag, steps_per_dispatch=k, train_steps=n_train, eval_steps=n_eval,
                  ms_per_train_step=ms, posts_per_s=BATCH / (ms / 1e3) if ms else None,
                  steady_ms_per_step=steady_ms, steady_posts_per_s=BATCH / (steady_ms / 1e3),
                  profiled_step_ms=step_wall, device_busy_ms=busy,
                  idle_share=idle, sgemm_calls=sgemm_calls, sgemm_ms=sgemm_ms,
                  f32_gemm_ops=f32_gemms,
                  idle_share_of_mean_step=(1 - busy / ms) if busy and ms else None,
                  idle_share_of_steady_step=(1 - busy / steady_ms) if busy else None,
                  kernel_launches=sum(e.count for e in events),
                  max_memory_allocated=peak, run_seconds=wall, losses=losses)
    if after is not None:
        result.update(after(trainer, setup) or {})
    log(f"{tag}: {json.dumps(result)}")
    del trainer, setup
    torch.cuda.empty_cache()
    return result, by_key, kernels


def precision_check(torch, tag):
    """The port's float32 policy holds: TF32 off for cuBLAS and cuDNN."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if flags != (False, False):
        raise AssertionError(f"{tag}: allow_tf32 (matmul, cudnn) = {flags}, expected the "
                             "port's policy (False, False)")


def same_losses(replayed, eager, tag):
    """Every step's loss of the K = 3 run within 1e-5 relative of the K = 1
    run of the same seed."""
    if len(replayed["losses"]) != len(eager["losses"]):
        raise AssertionError(f"{tag}: {len(replayed['losses'])} steps against "
                             f"{len(eager['losses'])}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(replayed["losses"], eager["losses"]))
    log(f"{tag}: per-step losses against K = 1: worst relative difference {rel:.2e} "
        f"(tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"{tag}: losses {replayed['losses']} against K = 1 "
                             f"{eager['losses']}")
    return rel


def no_added_f32_gemm(fused, auto, tag):
    """The fused path's step dispatches no more float32 matrix products than
    the auto path's: the block's weight gradients run on the TN GEMM. The
    products are counted as aten dispatches them (``count_f32_gemms``); the
    profiler's sgemm kernels are logged beside them, since their names are
    cuBLAS's choice and the tracer can miss one."""
    n_fused, n_auto = sum(fused["f32_gemm_ops"].values()), sum(auto["f32_gemm_ops"].values())
    for name, run in (("fused", fused), ("auto", auto)):
        if run["sgemm_calls"] and not run["f32_gemm_ops"]:
            raise AssertionError(f"{tag}[{name}]: the profile saw {run['sgemm_calls']} f32 "
                                 "sgemm launches, the dispatch count none")
    if n_fused > n_auto:
        raise AssertionError(f"{tag}[fused]: {n_fused} f32 GEMMs in a step "
                             f"{fused['f32_gemm_ops']}, {n_auto} under auto "
                             f"{auto['f32_gemm_ops']}")
    log(f"{tag}: f32 GEMMs a step, fused {n_fused} {fused['f32_gemm_ops']}, auto {n_auto} "
        f"{auto['f32_gemm_ops']}; profiled sgemm kernels fused {fused['sgemm_calls']} "
        f"({fused['sgemm_ms']:.3f} ms), auto {auto['sgemm_calls']} ({auto['sgemm_ms']:.3f} ms)")


def late_grads_check(torch, tag):
    """Late fusion: every trainable parameter but ``linear_iadds`` (unused by
    the loss) has a finite gradient, the vision tower is frozen without
    gradients, and AdamW holds every trainable parameter."""
    def check(setup, grads):
        names = set(setup.optimizer.names)
        lazy = setup.train_step.lazy
        if lazy is not None:  # --opt_impl lazy_emb: the word table's rows
            grads = dict(grads)
            uids, rows = grads.pop(lazy.name)
            vocab, width = lazy.param.shape
            if (lazy.name != "dual.text.embeddings.word.weight" or lazy.name in names
                    or rows.shape != (uids.shape[0], width) or not torch.isfinite(rows).all()):
                raise AssertionError(f"{tag}: the word table's lazy gradient {lazy.name} "
                                     f"{tuple(rows.shape)}")
            log(f"{tag}: the word table outside AdamW, its gradient {int((uids < vocab).sum())} "
                f"batch rows in {uids.shape[0]} slots (of {vocab} rows), finite")
            names.add(lazy.name)
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


def txt_grads_check(torch, tag):
    """Text-only: every parameter but the pooler (the CLS head does not read
    it) has a finite gradient, and AdamW holds them all."""

    def check(setup, grads):
        unused = sorted(n for n, gr in grads.items() if gr is None)
        if unused != ["tower.pooler.dense.bias", "tower.pooler.dense.weight"]:
            raise AssertionError(f"{tag}: parameters without a gradient: {unused}")
        bad = [n for n, gr in grads.items() if gr is not None and not torch.isfinite(gr).all()]
        if bad:
            raise AssertionError(f"{tag}: non-finite gradients in {bad[:5]}")
        if sorted(setup.optimizer.names) != sorted(n for n, _ in setup.model.named_parameters()):
            raise AssertionError(f"{tag}: AdamW does not hold every parameter")
        log(f"{tag}: {len(grads) - len(unused)} tensors with finite gradients, "
            f"{len(unused)} unused by the loss (the pooler)")

    return check


def vilt_resume_check(torch, C, run_mm_early):
    """``--ckpt_every`` and ``--resume`` on ViLT at full width (``fused``,
    dropout on): a run of the epoch's three steps saves a checkpoint at step
    2 (parameters, both moments, the generators); a second run resumes from
    it, skips the two steps taken and trains the third. Its parameters must
    equal the first run's (the same kernels from the same state and
    generator: within 1e-6 of each tensor's scale). The checkpoints are
    deleted after."""
    import shutil

    ckpt_dir = C.results_dir_mm_early + "vilt_task3_seed30_itc0.1itm0.1_ckpt"
    params, steps, size = {}, {}, None
    for run, extra in (("straight", ["--ckpt_every", "2"]),
                       ("resumed", ["--ckpt_every", "2", "--resume"])):
        seen = []
        t0 = time.perf_counter()
        trainer, setup = run_mm_early.main(vilt_args("fused", extra),
                                           on_step=lambda step, m: seen.append(step))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        params[run] = {k: v.float().clone() for k, v in setup.model.state_dict().items()}
        steps[run] = seen
        if run == "straight":
            size = os.path.getsize(os.path.join(ckpt_dir, "step_2.pt"))
        log(f"vilt resume[{run}]: steps {seen} in {seconds:.1f} s; checkpoints "
            f"{sorted(os.listdir(ckpt_dir))}")
        del trainer, setup
        torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir)
    if steps != {"straight": [1, 2, 3], "resumed": [3]}:
        raise AssertionError(f"vilt resume: steps {steps}")
    worst, exact = 0.0, 0
    for name, want in params["straight"].items():
        got = params["resumed"][name]
        exact += bool(torch.equal(got, want))
        worst = max(worst, (got - want).abs().max().item()
                    / max(want.abs().max().item(), 1e-12))
    log(f"vilt resume: checkpoint {size / 1e9:.3f} GB; resumed parameters against the "
        f"straight run: {exact} of {len(params['straight'])} tensors equal, worst "
        f"{worst:.2e} of the tensor's scale (tol 1e-6)")
    if not worst <= 1e-6:
        raise AssertionError("vilt resume: the resumed run ends elsewhere")
    return dict(checkpoint_bytes=size, tensors_equal=exact, tensors=len(params["straight"]),
                worst_rel=worst)


def vilt_remat_check(torch, C, run_mm_early, build_early, hub):
    """``--remat`` on ViLT at full width (``fused``, dropout 0.1): the first
    step's gradients with and without it, from the same state dict, batch and
    generator seed, within 1e-6 of each gradient's scale (the recompute reuses
    the dropout masks the forward drew); the peak memory of each."""
    d = os.path.join(hub, "vilt")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"hidden_dropout_prob": 0.1}, f)
    C.MODEL_DIR_DICT["vilt"] = d + os.sep
    grads, peak = {}, {}
    for remat in (False, True):
        args = run_mm_early.parse_args(vilt_args("fused", ["--remat"] if remat else []))
        setup = build_early.build_mm_early_train_setup(
            args, C.Config(args, model_name="vilt"), torch.device(DEVICE),
            torch.Generator().manual_seed(30))
        batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g, _, _ = setup.train_step.gradients(batch, torch.Generator(DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated()
        grads[remat] = {n: v.float() for n, v in g.items() if v is not None}
        del setup, g, batch
        torch.cuda.empty_cache()
    worst = max((grads[True][n] - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
                for n, w in grads[False].items())
    log(f"vilt remat: first-step gradients against no remat over {len(grads[False])} "
        f"tensors: worst {worst:.2e} of the gradient's scale (tol 1e-6); peak memory "
        f"{peak[True] / 1e9:.2f} GB with remat, {peak[False] / 1e9:.2f} GB without")
    if not worst <= 1e-6 or set(grads[True]) != set(grads[False]):
        raise AssertionError("vilt remat: the gradients differ from those without remat")
    return dict(worst_rel=worst, peak_bytes_remat=peak[True], peak_bytes_plain=peak[False])


def optimizer_launches(torch, optim, vilt, encoder):
    """The device work of one AdamW step over ViLT-B/32's parameters (random
    weights and gradients), with float32 and with bfloat16 first moments:
    the kernel launches and host-to-device copies the profiler sees in one
    step, their device ms, and ms per step (20 steps, one sync at the end)."""
    cfg = encoder.EncoderConfig(vocab_size=30522, hidden=768, layers=12, heads=12,
                                mlp_dim=3072, max_positions=40, type_vocab=2,
                                ln_style="pre", dtype="bfloat16", attn_impl="fused")
    with torch.device("meta"):
        model = vilt.ViltClassifier(cfg, 3, patch=32, image_size=384, canvas_size=608)
    model = model.to_empty(device=DEVICE)
    g = torch.Generator(DEVICE).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    grads = {n: 1e-3 * torch.randn(p.shape, generator=g, device=DEVICE)
             for n, p in model.named_parameters()}
    out = {}
    for moments in ("f32", "bf16"):
        opt = optim.AdamW(model.named_parameters(), 1e-5, 0.00025,
                          mu_dtype=torch.bfloat16 if moments == "bf16" else None)
        for _ in range(3):
            opt.step(grads)
        _, busy, _, events, _ = profile_step(torch, lambda: opt.step(grads), "optimizer")
        copies = sum(e.count for e in events if e.key.startswith("Memcpy"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            opt.step(grads)
        torch.cuda.synchronize()
        out[moments] = dict(tensors=len(opt.params), kernel_launches=sum(
            e.count for e in events) - copies, memcpy=copies, device_ms=busy,
            ms_per_step=(time.perf_counter() - t0) * 1e3 / 20)
        log(f"optimizer[{moments} moments]: {json.dumps(out[moments])}")
        del opt
    return out


def launch_origin(event) -> str:
    """Where a profiled op that launched device kernels came from: the
    autograd node it ran in (``backward X``), else the first line of the
    port on its Python stack, else its chain of ops (innermost first); with
    the op's input shapes."""
    node, stack, chain, e = None, None, [], event
    while e is not None:
        if node is None and e.name.startswith("autograd::engine::evaluate_function: "):
            node = e.name.split(": ", 1)[1]
        if stack is None and e.stack:
            stack = e.stack
        chain.append(e.name)
        e = e.cpu_parent
    shapes = [s for s in (event.input_shapes or []) if s][:2]
    if node is not None:
        return f"backward {node} ({event.name} {shapes})"
    # the port's innermost Python frame (the profiler's own Python events
    # under verbose stacks, or the op's recorded stack)
    port = [f for f in chain + list(stack or ()) if PKG + "/" in f]
    where = port[0].split(PKG + "/")[-1] if port else " < ".join(chain[:4])
    return f"forward {where} ({event.name} {shapes})"


def sweep_profile(root):
    """``python3 chip_smoke.py --sweep_profile ROOT``: for the port of the
    checkout at ROOT (an unpacked older commit, to set two versions side by
    side in one run), one eager train step of the seed sweep at full width
    (``SWEEP_SEEDS``, as the sweep phase runs it) and of one seed's run
    (``run_mm_late``), under ``auto`` and ``fused``, each after one epoch
    and one more step, profiled with the Python stacks of its ops: wall and
    device-busy ms, the largest kernels each with the autograd nodes or
    lines of the port that launched them, and the device ms by origin."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        run_mm_late, run_seed_sweep)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda

    set_precision_policy()
    _cuda.build()
    log(f"sweep_profile: the port at {os.path.dirname(os.path.abspath(C.__file__))}; "
        f"card: {card_line()}")
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_dataset(tmp)
        C.DATA_PATH = data
        C.PATH[3] = data + "data_key_mvsa.csv"
        C.IMG_FMT[3] = data + "MVSA-Single/data/{}.jpg"
        C.results_dir_mm_late = os.path.join(tmp, "results") + os.sep
        for impl in ("auto", "fused"):
            for run, main, argv in (("sweep", run_seed_sweep.main, sweep_args(impl)),
                                    ("one seed", run_mm_late.main, train_args(impl))):
                tag = f"sweep_profile[{run}, {impl}]"
                trainer, setup = main(argv + ["--steps_per_dispatch", "1"])
                if run == "sweep":
                    gens = trainer.gens
                    batch = next(trainer.device_batches(setup.pipes["train"], False, 1))[0]
                else:
                    gens = trainer.gen
                    batch = next(setup.pipes["train"].device_iter(setup.device))
                setup.train_step(batch, gens)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             record_shapes=True, with_stack=True,
                             experimental_config=_ExperimentalConfig(verbose=True)) as prof:
                    t1 = time.perf_counter()
                    setup.train_step(batch, gens)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t1) * 1e3
                kernels, origins = {}, {}
                for e in prof.events():
                    if e.device_type != DeviceType.CPU or not e.kernels:
                        continue
                    where = launch_origin(e)
                    for k in e.kernels:
                        ms, n, by = kernels.get(k.name, (0.0, 0, {}))
                        by[where] = by.get(where, 0.0) + k.duration / 1e3
                        kernels[k.name] = (ms + k.duration / 1e3, n + 1, by)
                        origins[where] = origins.get(where, 0.0) + k.duration / 1e3
                busy = sum(ms for ms, _, _ in kernels.values())
                log(f"{tag}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
                    f"{sum(n for _, n, _ in kernels.values())} kernel launches")
                for name, (ms, n, by) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
                    top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
                    log(f"{tag}:   {ms:8.3f} ms x{n:<4d} {name[:80]}")
                    for where, wms in top:
                        log(f"{tag}:       {wms:8.3f} ms  {where[:220]}")
                for where, ms in sorted(origins.items(), key=lambda kv: -kv[1])[:16]:
                    log(f"{tag}: origin {ms:8.3f} ms  {where[:220]}")
                result[f"{run}/{impl}"] = dict(wall_ms=wall, device_busy_ms=busy,
                                               top_origins=sorted(origins.items(),
                                                                  key=lambda kv: -kv[1])[:12])
                del trainer, setup, batch, prof
                torch.cuda.empty_cache()
    log(json.dumps({"sweep_profile": result}))
    return 0


def optimizer_only(root):
    """``python3 chip_smoke.py --optimizer ROOT``: ``optimizer_launches`` alone,
    for the port of the checkout at ROOT (an unpacked older commit, to set
    two versions of AdamW side by side in one run)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder, vilt
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim

    log(f"optimizer: the port at {os.path.dirname(os.path.dirname(os.path.abspath(optim.__file__)))}"
        f"; card: {card_line()}")
    log(json.dumps({"optimizer": optimizer_launches(torch, optim, vilt, encoder)}))
    return 0


def first_step_check(torch, tag, make_setup, keep, impls=("auto", "fused")):
    """The first train step of ``impls`` against the plain path: the
    setups from ``make_setup(attn_impl, dtype)`` (the same state dict from
    the same seed), the same first batch, the TIM swap pinned, the gradients
    of the parameters named by ``keep``.

    The reference is the plain path in float64 (its dense layers and
    attention in float64): a gradient that is the small remainder of a
    softmax's cancelling terms (deep query and key gradients) differs
    between two float32 orders of summation by far more than 1e-3, so a
    float32 plain path is no reference for it. At each dtype the plain path
    is held against float64 too, and a kernel path's median and worst
    relative gradient error (Frobenius) must be within the larger of 1e-3
    and 1.5 times the plain path's own at that dtype; a worst-tensor limit
    above 1 is not checked (a relative error that large says nothing), and
    the median decides. The loss within 1e-5 relative of the plain path's
    in float32 and 2e-2 in bfloat16 (whose plain path rounds its scores
    q.k to bfloat16 before the softmax, as the JAX package's plain version
    does, where the kernels keep float32). Every check is made before any
    fails."""
    import numpy as np

    perm = np.random.RandomState(3).permutation(BATCH)
    results, failed = {}, []

    def rel_errors(keep, ref):
        return {n: (torch.linalg.vector_norm(g.double() - ref[n])
                    / torch.linalg.vector_norm(ref[n])).item() for n, g in keep.items()}

    ref64 = None
    for dtype in ("float64", "float32", "bfloat16"):
        plain_loss = plain = None
        for impl in ("jnp",) + (tuple(impls) if dtype != "float64" else ()):
            setup = make_setup(impl, dtype)
            batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
            batch["tim_src"] = torch.as_tensor(perm, device=DEVICE)
            batch["tim_labels"] = torch.as_tensor(
                (perm == np.arange(BATCH)).astype(np.int32), device=DEVICE)
            grads, parts, _ = setup.train_step.gradients(batch, torch.Generator(DEVICE))
            kept = {n: gr.double() for n, gr in grads.items() if gr is not None and keep(n)}
            loss = float(parts["loss"].detach())
            del setup, grads, batch
            torch.cuda.empty_cache()
            if dtype == "float64":
                ref64 = kept
                continue
            rel = rel_errors(kept, ref64)
            worst = max(rel, key=rel.get)
            med = float(np.median(list(rel.values())))
            if impl == "jnp":
                plain_loss, plain = loss, rel
                tol_loss = 1e-5 if dtype == "float32" else 2e-2
                tol_med = max(1e-3, 1.5 * med)
                tol_worst = max(1e-3, 1.5 * rel[worst])
                log(f"first step[{tag} jnp, {dtype}]: gradient rel error vs the float64 plain "
                    f"path median {med:.2e}, worst {rel[worst]:.2e} ({worst}: norm "
                    f"{torch.linalg.vector_norm(ref64[worst]).item():.2e})")
                continue
            rel_loss = abs(loss - plain_loss) / abs(plain_loss)
            checked = tol_worst <= 1
            log(f"first step[{tag} {impl}, {dtype}]: loss {loss:.6f} vs plain {plain_loss:.6f} "
                f"(rel {rel_loss:.2e}, tol {tol_loss}); gradient rel error vs the float64 "
                f"plain path over {len(rel)} tensors: median {med:.2e} (tol {tol_med:.2e}), "
                f"worst {rel[worst]:.2e} ({worst}; "
                + (f"tol {tol_worst:.2e})" if checked else
                   f"limit {tol_worst:.2e} above 1: not checked)"))
            results[f"{impl}/{dtype}"] = dict(rel_loss=rel_loss, median_rel=med,
                                               worst_rel=rel[worst], worst_grad=worst,
                                               plain_median_rel=float(np.median(list(
                                                   plain.values()))),
                                               plain_worst_rel=max(plain.values()),
                                               worst_checked=checked)
            if not (rel_loss <= tol_loss and med <= tol_med
                    and (not checked or rel[worst] <= tol_worst)):
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
        args = run_mm_late.parse_args(train_args(impl, ["--dropout", "0"]))
        args.dtype = dtype  # float64 too, which the command line does not offer
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
        args = run_mm_early.parse_args(vilt_args(impl, ["--dropout", "0"]))
        args.dtype = dtype  # float64 too, which the command line does not offer
        return build_early.build_mm_early_train_setup(
            args, C.Config(args, model_name="vilt"), torch.device(DEVICE),
            torch.Generator().manual_seed(30))

    def keep(n):
        return n.startswith("backbone.encoder.") and ".attention." in n and n.endswith("weight")

    return first_step_check(torch, "vilt", make_setup, keep)


def lazy_args(attn_impl, extra=()):
    """The training runs' configuration under ``--opt_impl lazy_emb``."""
    return train_args(attn_impl, ["--opt_impl", "lazy_emb", *extra])


def optimizer_reading(torch, tag):
    """An ``after`` hook for ``train_run``: one optimizer step of the run's
    setup (AdamW, and under ``--opt_impl lazy_emb`` the word table's row
    update) on the gradients of one train batch: its device ms (CUDA
    events over 10 steps) and the kernel launches the profiler sees."""
    def after(trainer, setup):
        step = setup.train_step
        batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
        grads, _, _ = step.gradients(batch, trainer.gen)

        def optimizer_step():
            step.optimizer.step(grads)
            if step.lazy is not None:
                step.lazy.step(grads[step.lazy.name], batch["ids"])

        ms = device_ms(torch, optimizer_step, iters=10)
        _, busy, _, events, _ = profile_step(torch, optimizer_step, f"{tag} optimizer")
        out = dict(optimizer_ms=ms, optimizer_busy_ms=busy,
                   optimizer_launches=sum(e.count for e in events),
                   optimizer_tensors=len(step.optimizer.params))
        log(f"{tag}: one optimizer step {ms:.3f} ms on the device ({out['optimizer_launches']} "
            f"launches, {out['optimizer_tensors']} AdamW tensors"
            + (f" + the lazy word table)" if step.lazy is not None else ")"))
        return out

    return after


def lazy_first_step_check(torch, trainer, setup, tag):
    """The lazy update against exact AdamW on one batch, both from fresh
    moments (step 1): the injected rows' gradient against the exact path's
    dense table gradient (the same forward with the table read by its
    lookup, the generator at the same state), then the table after one
    step of each: the touched rows within 1e-5 (float32 master weights),
    the untouched rows bit-unchanged under the lazy step (the exact step's
    decay of them, lr x wd x p, is below float32's step at these weights:
    whether it moved any is reported)."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.lazy_emb import (
        LazyEmb, LazyEmbConfig)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.optim import AdamW
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.steps import TrainStep

    step, lazy = setup.train_step, setup.train_step.lazy
    cfg = lazy.cfg
    batch = next(setup.pipes["train"].device_iter(setup.device, shuffle=False))
    state = trainer.gen.get_state()
    grads, _, _ = step.gradients(batch, trainer.gen)
    uids, g_rows = grads[lazy.name]
    trainer.gen.set_state(state)
    table = [(lazy.name, lazy.param)]
    only_table = type("TableOnly", (), {"names": [lazy.name], "params": table})()
    dense = TrainStep(setup.model, step.forward_fn, step.loss_cfg, only_table,
                      step.class_weights).gradients(batch, trainer.gen)[0][lazy.name]
    vocab = lazy.param.shape[0]
    real = uids < vocab
    rows = uids[real]
    scale = dense[rows].abs().max().item()
    grad_err = (g_rows[real] - dense[rows]).abs().max().item() / max(scale, 1e-30)
    outside = dense.abs().sum(1) > 0
    outside[rows] = False

    start = lazy.param.detach().clone()
    exact_table = torch.nn.Parameter(start.clone())
    AdamW([("t", exact_table)], cfg.lr, cfg.weight_decay).step({"t": dense})
    lazy_table = torch.nn.Parameter(start.clone())
    LazyEmb(lazy_table, LazyEmbConfig(name="t", lr=cfg.lr, weight_decay=cfg.weight_decay)).step(
        (uids, g_rows), batch["ids"])
    untouched = torch.ones(vocab, dtype=torch.bool, device=start.device)
    untouched[rows] = False
    touched_err = (lazy_table[rows] - exact_table[rows]).abs().max().item()
    kept = torch.equal(lazy_table[untouched], start[untouched])
    decayed = not torch.equal(exact_table[untouched], start[untouched])
    out = dict(rows=int(rows.numel()), slots=int(uids.numel()), row_grad_err=grad_err,
               dense_grad_rows_outside_batch=int(outside.sum()), touched_abs_err=touched_err,
               untouched_kept=kept, untouched_decayed_by_exact=decayed)
    log(f"{tag}: step 1 from fresh moments on {out['rows']} touched rows ({out['slots']} "
        f"slots): row gradient against the dense table gradient {grad_err:.2e} of its scale, "
        f"touched rows against exact AdamW {touched_err:.2e} (tol 1e-5), untouched rows kept "
        f"{kept} (exact AdamW's decay moved them: {decayed})")
    if not (touched_err <= 1e-5 and kept and not out["dense_grad_rows_outside_batch"]
            and grad_err <= 1e-5):
        raise AssertionError(f"{tag}: the lazy step is not exact AdamW on the touched rows: {out}")
    del dense, exact_table, lazy_table, start
    return {"first_step": out}


def cached_fills(run_mm_late, state):
    """Patch ``run_mm_late.enable_vision_cache`` to keep the cached pipes in
    ``state``; returns the function giving the tower runs so far (the train
    pipe's, and the val and test pipes' together) and the patch's undo."""
    real = run_mm_late.enable_vision_cache

    def enable(setup, args):
        real(setup, args)
        state["pipes"] = setup.pipes

    run_mm_late.enable_vision_cache = enable

    def calls():
        pipes = state.get("pipes")
        if pipes is None:
            return 0, 0
        return pipes["train"].compute_calls, pipes["val"].compute_calls + pipes["test"].compute_calls

    return calls, lambda: setattr(run_mm_late, "enable_vision_cache", real)


def lazy_phase(torch, C, run_mm_late, counters, per_step, training, launches, eager_kernels):
    """The headline run's optimizer and workload flags at full width
    (Bernice-base + ViT-B/16, attention fusion, ITC + TIM, bf16, batch 16,
    the 64-post set): ``--opt_impl lazy_emb`` under ``auto`` at K = 1 (its
    step-1 update against exact AdamW, its optimizer step timed beside the
    exact run's) and under ``fused`` at K = 1 (a checkpoint at step 2) and
    K = 3 (every loss within 1e-5 of K = 1's); ``--resume`` from the step-2
    checkpoint, ending with the K = 1 run's parameters bit for bit;
    ``--cache_vision`` (with ``lazy_emb``, ``auto``) for two epochs: the
    frozen tower runs once per batch of epoch 1 (train and eval) and never in
    epoch 2, and the profiled step after it has no tower; ``--tim_reuse_text``
    (with ``lazy_emb``, ``auto``): the text tower's kernels at B rows, not
    2B. Launch counts exact throughout, as ``train_run`` checks them."""
    stem = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
    results = C.results_dir_mm_late
    out = {}
    tag = "lazy[auto]"
    out["auto"], by_key, _ = train_run(
        torch, run_mm_late.main, lazy_args("auto"), tag, counters, results, stem,
        per_step["auto"], late_grads_check(torch, tag),
        after=lambda trainer, setup: {**lazy_first_step_check(torch, trainer, setup, tag),
                                      **optimizer_reading(torch, tag)(trainer, setup)})
    count_launches(launches, by_key)
    exact = training["auto"]
    mine = out["auto"]
    log(f"{tag}: optimizer step {mine['optimizer_ms']:.3f} ms (exact AdamW "
        f"{exact['optimizer_ms']:.3f}), busy {mine['device_busy_ms']:.2f} ms a step (exact "
        f"{exact['device_busy_ms']:.2f}), peak {mine['max_memory_allocated'] / 1e9:.2f} GB "
        f"(exact {exact['max_memory_allocated'] / 1e9:.2f}), steady "
        f"{mine['steady_ms_per_step']:.2f} ms a step (exact {exact['steady_ms_per_step']:.2f})")

    # fused at K = 1 (a checkpoint at step 2) and at K = 3
    for k in (1, 3):
        tag = f"lazy[fused, K={k}]"
        extra = ["--ckpt_every", "2"] if k == 1 else []
        out[f"fused/k{k}"], by_key, kernels = train_run(
            torch, run_mm_late.main, lazy_args("fused", extra), tag, counters, results, stem,
            per_step["fused"], late_grads_check(torch, tag), k=k,
            eager_kernels=eager_kernels["fused"] if k > 1 else None)
        count_launches(launches, by_key)
        if k == 1:
            straight = torch.load(os.path.join(results, stem + "net.pth"), map_location="cpu",
                                  weights_only=True)
    out["fused/k3"]["loss_rel_vs_k1"] = same_losses(out["fused/k3"], out["fused/k1"],
                                                    "lazy[fused, K=3]")

    # --resume from the K = 1 run's step-2 checkpoint: its step 3 again
    import shutil

    ckpt_dir = results + stem + "ckpt"
    size = os.path.getsize(os.path.join(ckpt_dir, "step_2.pt"))
    seen = []
    t0 = time.perf_counter()
    trainer, setup = run_mm_late.main(lazy_args("fused", ["--ckpt_every", "2", "--resume"]),
                                      on_step=lambda step, m: seen.append(step))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    count = int(setup.train_step.lazy.state["count"])
    del trainer, setup
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir)
    resumed = torch.load(os.path.join(results, stem + "net.pth"), map_location="cpu",
                         weights_only=True)
    differ = [n for n, v in straight.items() if not torch.equal(resumed[n], v)]
    equal = len(straight) - len(differ)
    log(f"lazy resume: checkpoint {size / 1e9:.3f} GB (parameters, AdamW's and the lazy "
        f"table's moments and counts); the resumed run took steps {seen} in {seconds:.1f} s, "
        f"lazy count {count}; {equal} of {len(straight)} tensors equal to the straight run's")
    if seen != [3] or count != 3 or differ or set(resumed) != set(straight):
        raise AssertionError(f"lazy resume: the resumed run does not end bit for bit where the "
                             f"straight run ended: {differ}")
    out["resume"] = dict(checkpoint_bytes=size, tensors_equal=equal, steps=seen)
    del straight, resumed

    # --cache_vision for two epochs: the tower's 12 SDPA forwards leave the step
    tag = "lazy[auto, cache_vision]"
    no_tower = {phase: {**counts, "sdpa_fwd": counts["sdpa_fwd"] - 12}
                for phase, counts in per_step["auto"].items()}
    state = {}
    calls, undo = cached_fills(run_mm_late, state)
    try:
        out["cache_vision"], by_key, _ = train_run(
            torch, run_mm_late.main, lazy_args("auto", ["--cache_vision", "--epochs", "2"]),
            tag, counters, results, stem, no_tower, late_grads_check(torch, tag), epochs=2,
            fills=({"sdpa_fwd": 12}, calls))
    finally:
        undo()
    count_launches(launches, by_key)
    pipes = state["pipes"]
    per_pipe = {n: (p.compute_calls, p.num_batches) for n, p in pipes.items()}
    log(f"{tag}: vision-tower runs (runs, batches an epoch) {per_pipe}: one per batch of "
        f"epoch 1, none in epoch 2; busy {out['cache_vision']['device_busy_ms']:.2f} ms an "
        f"epoch-2 step against {mine['device_busy_ms']:.2f} uncached")
    if any(c != n for c, n in per_pipe.values()):
        raise AssertionError(f"{tag}: the tower ran {per_pipe}")
    out["cache_vision"]["tower_runs"] = per_pipe
    del pipes
    state.clear()

    # --tim_reuse_text: the TIM rows gathered from the first text pass
    tag = "lazy[auto, tim_reuse_text]"
    out["tim_reuse"], by_key, _ = train_run(
        torch, run_mm_late.main, lazy_args("auto", ["--tim_reuse_text"]), tag, counters,
        results, stem, per_step["auto"], late_grads_check(torch, tag))
    count_launches(launches, by_key)
    rows = sorted({key[1] for key in by_key["sdpa_bwd"] if key[3] == 128})
    log(f"{tag}: the text tower's backward at {rows} rows (without the flag "
        f"{2 * BATCH}); busy {out['tim_reuse']['device_busy_ms']:.2f} ms a step against "
        f"{mine['device_busy_ms']:.2f}")
    if rows != [BATCH]:
        raise AssertionError(f"{tag}: text backward at {rows} rows, expected {BATCH}")
    out["tim_reuse"]["text_rows"] = rows
    return out


def bucket_args(attn_impl, extra=()):
    """The headline run's flags (``lazy_args``) with ``--bucket_seq`` at its
    default buckets (32, 64, 96; the full pad, 128, above them)."""
    return lazy_args(attn_impl, ["--bucket_seq", *extra])


def full_pad(pipe):
    """``pipe`` without buckets: the same rows padded to ``max_length``, as an
    unbucketed run pads every batch."""
    import copy
    import dataclasses

    full = copy.copy(pipe)
    full.cfg = dataclasses.replace(pipe.cfg, seq_buckets=None, bucket_group=False)
    return full


def epoch_chunks(pipe, k):
    """(width, steps) of each dispatch of the first training epoch (the
    trainer's host generator at its seed, 30): each batch at its bucket at
    k = 1, each chunk under k > 1 (grouped under ``--bucket_group``)."""
    import numpy as np

    rng = np.random.RandomState(30)
    if k == 1:
        return [(b["ids"].shape[1], 1) for b in pipe.batches(shuffle=True, rng=rng)]
    return [(b["ids"].shape[-1], n) for b, n in pipe.device_iter_chunks("cpu", k, shuffle=True,
                                                                          rng=rng)]


def eval_logits(torch, setup, pipe):
    """The classification logits of every batch of ``pipe`` (eval mode, no
    TIM rows), in float32."""
    setup.model.eval()
    with torch.no_grad():
        return torch.cat([setup.train_step.forward_fn(b, None, None, True)["out_cls"].float()
                          for b in pipe.device_iter(setup.device)])


def same_logits(torch, setup, tag, tol):
    """The per-example eval logits of the val and test splits at their
    buckets against the same weights' at full pad: within ``tol`` of their
    scale."""
    worst = 0.0
    for split in ("val", "test"):
        pipe = setup.pipes[split]
        got, want = eval_logits(torch, setup, pipe), eval_logits(torch, setup, full_pad(pipe))
        worst = max(worst, (got - want).abs().max().item() / want.abs().max().item())
    log(f"{tag}: eval logits at the buckets against full pad, the same weights: "
        f"{worst:.2e} of their scale (tol {tol})")
    if not worst <= tol:
        raise AssertionError(f"{tag}: bucketed eval logits left the full-pad ones: {worst}")
    return worst


def train_widths(setup, tag):
    """The first epoch's batch widths: at least three distinct, or the
    phase's posts do not serve."""
    widths = [w for w, _ in epoch_chunks(setup.pipes["train"], 1)]
    log(f"{tag}: train batch widths in visit order {widths}")
    if len(set(widths)) < 3:
        raise AssertionError(f"{tag}: the posts give the batches {sorted(set(widths))} only")
    return widths


def graphs_per_width(trainer, setup, tag):
    """Under k > 1: one train graph for each width the grouped epoch ran and
    one eval graph for each width of the eval chunks, no more."""
    train = sorted({w for w, _ in epoch_chunks(setup.pipes["train"], 3)})
    evals = sorted({b["ids"].shape[-1] for split in ("val", "test")
                    for b, _ in setup.pipes[split].device_iter_chunks("cpu", 3)})
    got = [sorted(next(shape[-1] for name, shape, _ in sig if name == "ids") for sig in g.graphs)
           for many in (trainer.train_many, trainer.eval_many) for g in many.graphs.values()]
    log(f"{tag}: graphs captured by width: train {got[0]} (widths run {train}), eval "
        f"{got[1]} (widths run {evals})")
    if got != [train, evals]:
        raise AssertionError(f"{tag}: graphs {got} for the widths {train} / {evals}")
    return {"train_graph_widths": train, "eval_graph_widths": evals}


def width_readings(torch, trainer, setup, k, tag, steps=5):
    """Per width of the train split (and, under buckets, at the full pad an
    unbucketed run gives every batch): ``steps`` steps with one sync (ms a
    step, the host free to run ahead), the peak memory of one step after a
    warm-up one, and one profiled step's busy ms and idle share. Under k > 1
    each step replays its width's graph (the full pad's captured here:
    after the graphs were counted)."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.pipeline import (
        stage_chunks, to_device)

    pipe = setup.pipes["train"]
    picks = {}
    for b in pipe.batches():
        picks.setdefault(str(b["ids"].shape[1]), b)
    if pipe.cfg.seq_buckets:
        picks["128 full pad"] = next(full_pad(pipe).batches())
    gen, out = trainer.gen, {}
    for width, host in picks.items():
        if k == 1:
            batch = to_device(host, setup.device)

            def step():
                setup.train_step(batch, gen)
        else:
            chunk, _ = next(stage_chunks([host], setup.device, 1))

            def step():
                trainer.train_many(chunk, 1, gen)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        _, busy, idle, _, _ = profile_step(torch, step, f"{tag} width {width}")
        out[width] = dict(steady_ms=ms, busy_ms=busy, idle_share_profiled=idle,
                          idle_share_steady=(1 - busy / ms) if busy else None, peak_bytes=peak)
        log(f"{tag}: width {width}: {ms:.2f} ms a step ({steps} steps, one sync), busy "
            f"{busy:.2f} ms, idle {out[width]['idle_share_steady']} of the step, "
            f"{idle} of the profiled one, peak {peak / 1e9:.2f} GB")
    return out


@contextlib.contextmanager
def grouped_order_at_k1():
    """A shuffled epoch under ``--bucket_group`` visits the grouped order one
    batch at a time, for as long as it lasts (the port, as the JAX package,
    groups chunked epochs only): the K = 1 run a grouped K = 3 run's losses
    are held against."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data import pipeline as P

    real = P.SplitPipeline.device_iter

    def device_iter(pipe, device, shuffle=False, rng=None, skip=0):
        order = pipe._grouped_order(shuffle, rng) if pipe.grouping(shuffle) else None
        for b in pipe.batches(shuffle=shuffle, rng=rng, skip=skip, order=order):
            yield P.to_device(b, device)

    P.SplitPipeline.device_iter = device_iter
    try:
        yield
    finally:
        P.SplitPipeline.device_iter = real


def grouped_resume_check(torch, run_mm_late, results, stem, straight):
    """The grouped K = 3 run stopped by SIGTERM after its first chunk (a
    checkpoint at that chunk's end), then ``--resume``: it ends with the
    straight run's parameters bit for bit."""
    import shutil
    import signal

    argv = bucket_args("fused", ["--bucket_group", "--steps_per_dispatch", "3",
                                 "--ckpt_every", "100"])
    stopped, resumed_steps = [], []

    def stop(step, metrics):
        stopped.append(step)
        if len(stopped) == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    t0 = time.perf_counter()
    trainer, setup = run_mm_late.main(argv, on_step=stop)
    del trainer, setup
    torch.cuda.empty_cache()
    trainer, setup = run_mm_late.main(argv + ["--resume"],
                                      on_step=lambda step, m: resumed_steps.append(step))
    total = trainer.global_step
    del trainer, setup
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    shutil.rmtree(results + stem + "ckpt")
    resumed = torch.load(os.path.join(results, stem + "net.pth"), map_location="cpu",
                         weights_only=True)
    differ = [n for n, v in straight.items() if not torch.equal(resumed[n], v)]
    log(f"bucket resume: stopped after the chunk ending at step {stopped}, resumed at steps "
        f"{resumed_steps} in {seconds:.1f} s (both runs); {len(straight) - len(differ)} of "
        f"{len(straight)} tensors equal to the straight grouped run's")
    if len(stopped) != 1 or not resumed_steps or resumed_steps[0] <= stopped[0] or differ \
            or set(resumed) != set(straight):
        raise AssertionError(f"bucket resume: the resumed grouped run does not end where the "
                             f"straight one ended: {differ}")
    return dict(stopped_at=stopped[0], resumed_steps=resumed_steps, global_step=total,
                tensors_equal=len(straight))


def bucket_first_step(torch, C, run_mm_late, build, hub):
    """The first train step (the first batch of the shuffled epoch) at its
    bucket against the same rows at full pad, under ``auto`` and ``fused``:
    one setup per dtype and path, the same state dict from seed 30, dropout
    0, the TIM swap pinned; the text tower's attention weights and the
    fusion head's tensors but ``fc_k.bias`` (an exact zero). Float32: the
    loss within 1e-5 relative, each gradient within 1e-3 relative
    (Frobenius), the eval logits of the val and test splits within 1e-5 of
    their scale. Bfloat16, held as ``first_step_check`` holds a kernel path:
    the loss within 2e-2; against the float32 full-pad gradients, the
    bucketed step's median and worst relative error within the larger of
    1e-3 and 1.5 times the full-pad step's (a worst limit above 1 is not
    checked); the eval logits within 2e-2."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.pipeline import to_device

    saved = dict(C.MODEL_DIR_DICT)
    for name in ("bernice", "vit"):
        d = os.path.join(hub, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"hidden_dropout_prob": 0.0}, f)
        C.MODEL_DIR_DICT[name] = d + os.sep
    perm = np.random.RandomState(3).permutation(BATCH)

    def pinned(batch):
        batch["tim_src"] = torch.as_tensor(perm, device=DEVICE)
        batch["tim_labels"] = torch.as_tensor((perm == np.arange(BATCH)).astype(np.int32),
                                              device=DEVICE)
        return batch

    def keep(n):
        return ((n.startswith("dual.text.encoder.") and ".attention." in n
                 and n.endswith("weight"))
                or (n.startswith("fusion.") and n != "fusion.fc_k.bias"))

    def rel(got, want):
        return {n: (torch.linalg.vector_norm(g - want[n])
                    / torch.linalg.vector_norm(want[n])).item() for n, g in got.items()}

    results, failed = {}, []
    try:
        for impl in ("auto", "fused"):
            ref = None
            for dtype in ("float32", "bfloat16"):
                args = run_mm_late.parse_args(train_args(impl, ["--bucket_seq", "--dropout",
                                                                "0", "--dtype", dtype]))
                setup = build.build_mm_late_train_setup(args, C.Config(args),
                                                        torch.device(DEVICE),
                                                        torch.Generator().manual_seed(30))
                pipe = setup.pipes["train"]
                order = np.random.RandomState(30)  # the trainer's first epoch
                host = next(pipe.batches(shuffle=True, rng=order))
                full = next(full_pad(pipe).batches(shuffle=True, rng=np.random.RandomState(30)))
                if not np.array_equal(host["data_id"], full["data_id"]):
                    raise AssertionError("bucket first step: the two batches hold other rows")
                out = {}
                for name, b in (("bucket", host), ("full", full)):
                    g, p, _ = setup.train_step.gradients(pinned(to_device(b, setup.device)),
                                                         torch.Generator(DEVICE))
                    out[name] = ({n: v.double() for n, v in g.items()
                                  if v is not None and keep(n)}, float(p["loss"].detach()))
                tol = 1e-5 if dtype == "float32" else 2e-2
                logits = same_logits(torch, setup, f"bucket first step[{impl}, {dtype}]", tol)
                del setup, g, p
                torch.cuda.empty_cache()
                (gb, lb), (gf, lf) = out["bucket"], out["full"]
                rel_loss = abs(lb - lf) / abs(lf)
                width = host["ids"].shape[1]
                key = f"{impl}/{dtype}"
                if dtype == "float32":
                    ref = gf
                    r = rel(gb, gf)
                    worst = max(r, key=r.get)
                    ok = rel_loss <= 1e-5 and r[worst] <= 1e-3
                    results[key] = dict(width=width, rel_loss=rel_loss, worst_rel=r[worst],
                                        worst_grad=worst, median_rel=float(np.median(
                                            list(r.values()))), logits_rel=logits)
                    log(f"bucket first step[{impl}, float32]: width {width} against 128: loss "
                        f"rel {rel_loss:.2e} (tol 1e-5); gradient rel error over {len(r)} "
                        f"tensors median {results[key]['median_rel']:.2e}, worst "
                        f"{r[worst]:.2e} ({worst}; tol 1e-3)")
                else:
                    rb, rf = rel(gb, ref), rel(gf, ref)
                    med_b, med_f = np.median(list(rb.values())), np.median(list(rf.values()))
                    worst = max(rb, key=rb.get)
                    tol_med, tol_worst = max(1e-3, 1.5 * med_f), max(1e-3, 1.5 * max(rf.values()))
                    checked = tol_worst <= 1
                    ok = rel_loss <= 2e-2 and med_b <= tol_med and (
                        not checked or rb[worst] <= tol_worst)
                    results[key] = dict(width=width, rel_loss=rel_loss, median_rel=float(med_b),
                                        full_median_rel=float(med_f), worst_rel=rb[worst],
                                        worst_grad=worst, full_worst_rel=max(rf.values()),
                                        worst_checked=checked, logits_rel=logits)
                    log(f"bucket first step[{impl}, bfloat16]: width {width}: loss against "
                        f"full pad rel {rel_loss:.2e} (tol 2e-2); gradient rel error against "
                        f"the float32 full pad: median {med_b:.2e} (full pad {med_f:.2e}, tol "
                        f"{tol_med:.2e}), worst {rb[worst]:.2e} ({worst}; full pad "
                        f"{max(rf.values()):.2e}, " + (f"tol {tol_worst:.2e})" if checked else
                                                        "a limit above 1: not checked)"))
                if not ok:
                    failed.append(key)
    finally:
        C.MODEL_DIR_DICT.clear()
        C.MODEL_DIR_DICT.update(saved)
    if failed:
        raise AssertionError(f"bucket first step: bucketed against full pad {failed}")
    return results


def bucket_phase(torch, C, run_mm_late, run_txt, build, counters, per_step, txt_step, launches,
                 eager_kernels, tmp):
    """Sequence bucketing at full width on tweet-like posts (``tweet_words``:
    96 train, 16 val, 16 test; each batch sliced to 32, 64, 96 or the full
    128), the headline run's flags (``--opt_impl lazy_emb``): the unbucketed
    run on these posts under ``fused`` at K = 3 (the reference for memory and
    step time); ``--bucket_seq`` under ``auto`` and ``fused`` at K = 1 (at
    least three widths in the epoch; the trained weights' eval logits at the
    buckets against full pad within 2e-2; under ``fused`` per width the ms,
    busy ms, idle share and peak memory of a step); under ``fused`` at K = 3
    with ``--bucket_group`` (one train graph per width the grouped epoch ran,
    one eval graph per eval width, counted; per width the replayed step's
    readings; its losses within 1e-5 of the same grouped order stepped at
    K = 1; stopped after its first chunk and resumed, bit for bit); the
    text-only runner with ``--bucket_seq`` under ``fused``; the first step
    bucketed against full pad (``bucket_first_step``). Launch counts exact
    throughout, as ``train_run`` checks them."""
    t0 = time.monotonic()
    saved = C.DATA_PATH, C.PATH[3]
    data = make_dataset(tmp, "bucket_data", BUCKET_POSTS, tweet_words, seed=BUCKET_DATA_SEED)
    C.DATA_PATH, C.PATH[3] = data, data + "data_key_mvsa.csv"
    results = C.results_dir_mm_late
    stem = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
    out = {}
    try:
        tag = "bucket[unbucketed, fused, K=3]"
        out["unbucketed/fused/k3"], by_key, _ = train_run(
            torch, run_mm_late.main, lazy_args("fused"), tag, counters, results, stem,
            per_step["fused"], late_grads_check(torch, tag), k=3,
            eager_kernels=eager_kernels["fused"],
            after=lambda trainer, setup: {"per_width": width_readings(
                torch, trainer, setup, 3, "bucket[unbucketed, fused, K=3]")})
        count_launches(launches, by_key)
        for impl in ("auto", "fused"):
            tag = f"bucket[{impl}]"

            def after(trainer, setup, tag=tag, impl=impl):
                res = {"widths": train_widths(setup, tag),
                       "eval_logits_rel": same_logits(torch, setup, tag, 2e-2)}
                if impl == "fused":
                    res["per_width"] = width_readings(torch, trainer, setup, 1, tag)
                return res

            out[impl], by_key, kernels = train_run(
                torch, run_mm_late.main, bucket_args(impl), tag, counters, results, stem,
                per_step[impl], late_grads_check(torch, tag), after=after)
            count_launches(launches, by_key)

        tag = "bucket[fused, K=3, grouped]"
        out["grouped/k3"], by_key, _ = train_run(
            torch, run_mm_late.main, bucket_args("fused", ["--bucket_group"]), tag, counters,
            results, stem, per_step["fused"], late_grads_check(torch, tag), k=3,
            eager_kernels=kernels,
            after=lambda trainer, setup: {
                **graphs_per_width(trainer, setup, "bucket[fused, K=3, grouped]"),
                "chunks": epoch_chunks(setup.pipes["train"], 3),
                "per_width": width_readings(torch, trainer, setup, 3,
                                            "bucket[fused, K=3, grouped]")})
        count_launches(launches, by_key)
        straight = torch.load(os.path.join(results, stem + "net.pth"), map_location="cpu",
                              weights_only=True)
        log(f"{tag}: dispatches (width, steps) {out['grouped/k3']['chunks']}; peak "
            f"{out['grouped/k3']['max_memory_allocated'] / 1e9:.2f} GB with every width "
            f"captured, unbucketed "
            f"{out['unbucketed/fused/k3']['max_memory_allocated'] / 1e9:.2f} GB")
        with grouped_order_at_k1():
            out["grouped/k1"], by_key, _ = train_run(
                torch, run_mm_late.main, bucket_args("fused", ["--bucket_group"]),
                "bucket[fused, K=1, grouped order]", counters, results, stem,
                per_step["fused"], late_grads_check(torch, "bucket[fused, K=1, grouped order]"))
        count_launches(launches, by_key)
        out["grouped/k3"]["loss_rel_vs_k1"] = same_losses(out["grouped/k3"], out["grouped/k1"],
                                                          tag)
        out["resume"] = grouped_resume_check(torch, run_mm_late, results, stem, straight)
        del straight

        tag = "bucket txt[fused]"
        out["txt/fused"], by_key, _ = train_run(
            torch, run_txt.main, txt_args("fused", ["--bucket_seq"]), tag, counters,
            C.results_dir_txt, "bernice_task3_seed30_", txt_step, txt_grads_check(torch, tag),
            after=lambda trainer, setup: {"widths": train_widths(setup, "bucket txt[fused]")})
        count_launches(launches, by_key)
        out["first_step"] = bucket_first_step(torch, C, run_mm_late, build,
                                              os.path.join(tmp, "hub_bucket"))
    finally:
        C.DATA_PATH, C.PATH[3] = saved
    out["seconds"] = time.monotonic() - t0
    log(f"bucket phase: {out['seconds']:.1f} s")
    return out


def old_seed_product(torch):
    """The seed-stacked product before ``SeedProduct``: autograd's own
    backward of ``bmm(x, w.transpose(1, 2))``, which leaves each weight
    gradient as a transposed view."""
    def product(x3, w, bias):
        wt = w.transpose(1, 2)
        return torch.bmm(x3, wt) if bias is None else torch.baddbmm(bias[:, None, :], x3, wt)

    return product


def sweep_adamw_check(torch, encoder, tag):
    """An ``after`` hook for ``sweep_run``: one sweep batch's gradients, every
    weight gradient in its parameter's strides, and the launches of one
    AdamW step over them; then the same with the product's old backward
    (transposed weight gradients, where ``_foreach_*`` falls back to one
    launch per tensor): the step must launch fewer kernels now."""
    def after(trainer, setup):
        batch = next(trainer.device_batches(setup.pipes["train"], False, 1))[0]
        params = dict(setup.model.named_parameters())
        reading = {}
        for name, product in (("now", None), ("before", old_seed_product(torch))):
            real = encoder.SeedProduct.apply
            if product is not None:
                encoder.SeedProduct.apply = product
            try:
                grads = setup.train_step.gradients(batch, trainer.gens)[0]
            finally:
                encoder.SeedProduct.apply = real
            odd = [n for n, g in grads.items() if g is not None and g.stride() != params[n].stride()]
            _, busy, _, events, _ = profile_step(torch, lambda: setup.optimizer.step(grads),
                                              f"{tag} optimizer[{name}]")
            reading[name] = dict(launches=sum(e.count for e in events), device_ms=busy,
                                 gradients_in_other_strides=len(odd))
            del grads
        log(f"{tag}: one AdamW step over {len(setup.optimizer.params)} stacked tensors: "
            f"{json.dumps(reading)}")
        if reading["now"]["gradients_in_other_strides"] or not (
                reading["now"]["launches"] < reading["before"]["launches"]):
            raise AssertionError(f"{tag}: the stacked weight gradients still fall back: "
                                 f"{reading}")
        return {"adamw": reading}

    return after


def sweep_args(attn_impl, extra=(), seeds=SWEEP_SEEDS, image="vit"):
    """``run_seed_sweep`` at full width: the training runs' configuration,
    ``seeds`` trained together."""
    return ["--txt_model_name", "bernice", "--img_model_name", image,
            "--fusion_name", "attention", "--task", "3", "--epochs", "1",
            "--seeds", ",".join(map(str, seeds)), "--arch", "base",
            "--dtype", "bfloat16", "--use_clip_loss", "--use_tim_loss",
            "--use_saved_features", "--log_every", "1", "--attn_impl", attn_impl, *extra]


def sweep_run(torch, sweep_main, argv, tag, counters, expect, results_dir, stem_fmt, k=1,
              after=None, seeds=SWEEP_SEEDS):
    """One epoch of ``run_seed_sweep.main(argv)`` at ``--steps_per_dispatch
    k`` with the counts set to 0 before and read after: the launch counts
    per sweep step (under k > 1 per chunk, the first chunk and the evals once
    more, as ``train_run`` counts them) and per eval step, every seed's loss
    finite, each seed's metric tables; then the steady ms per sweep step (the
    split three more times, one sync), one profiled step (the device's idle
    share, the counters moved by one step's counts) and the peak memory.
    ``after(trainer, setup)`` is called last, before the setup is let go.
    Returns its numbers, the per-step losses by seed and the launch counts."""
    import numpy as np

    for c in counters.values():
        c.reset()
    s = len(seeds)
    chunks, state = [], {"t": None, "prev": {n: 0 for n in counters}}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = {n: c.count - state["prev"][n] for n, c in counters.items()}
        state["prev"] = {n: c.count for n, c in counters.items()}
        losses = metrics["loss"].float().reshape(-1, s).cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError(f"{tag}: step {step} losses not finite: {losses}")
        chunks.append(dict(seconds=None if state["t"] is None else now - state["t"],
                           counts=counts, losses=losses.tolist()))
        state["t"] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, setup = sweep_main(list(argv) + ["--steps_per_dispatch", str(k)], on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    totals = {n: c.count for n, c in counters.items()}
    by_key = {n: dict(c.by_key) for n, c in counters.items()}
    pipes = setup.pipes
    n_train = min(p.num_batches for p in pipes["train"])
    n_eval = sum(min(p.num_batches for p in pipes[split]) for split in ("val", "test"))
    for i, ch in enumerate(chunks):
        steps = len(ch["losses"]) + (1 if k > 1 and i == 0 else 0)
        for kernel, n in expect["train"].items():
            if ch["counts"][kernel] != n * steps:
                raise AssertionError(f"{tag}: dispatch {i + 1} launched {kernel} "
                                     f"{ch['counts'][kernel]} times, expected {n} x {steps}")
    evals = n_eval + (1 if k > 1 else 0)
    for kernel, n in expect["eval"].items():
        seen = totals[kernel] - sum(ch["counts"][kernel] for ch in chunks)
        if seen != n * evals:
            raise AssertionError(f"{tag}: {evals} eval steps launched {kernel} {seen} times, "
                                 f"expected {n} each")
    losses = [row for ch in chunks for row in ch["losses"]]  # (steps, S)
    if len(losses) != n_train:
        raise AssertionError(f"{tag}: {len(losses)} sweep steps, expected {n_train}")
    log(f"{tag}: launches per sweep step of {s} seeds {expect['train']}, per eval step "
        f"{expect['eval']} over {n_train} train and {n_eval} eval steps: exact")
    for seed in seeds:
        with open(stem_fmt.format(seed=seed) + "metrics_test.csv") as f:
            table = f.read().splitlines()
        if table[0] != "metric,epoch-1" or len(table) != 8:
            raise AssertionError(f"{tag}: seed {seed} metrics table {table}")

    gens = trainer.gens
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(STEADY_PASSES):
        for batches, k_real in trainer.device_batches(pipes["train"], False, k):
            if k == 1:
                setup.train_step(batches, gens)
            else:
                trainer.train_many(batches, k_real, gens)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t1) * 1e3 / (STEADY_PASSES * n_train)

    if k == 1:
        batch = next(trainer.device_batches(pipes["train"], False, 1))[0]

        def step():
            setup.train_step(batch, gens)
    else:
        from socialmedia_textimage_classification_auxlosses_tpu_torch.data.pipeline import (
            stage_chunks)

        chunk, _ = next(stage_chunks(trainer.host_batches(pipes["train"], False),
                                     trainer.device, 1))

        def step():
            trainer.train_many(chunk, 1, gens)
    step()
    before = {n: c.count for n, c in counters.items()}
    step_wall, busy, idle, events, calls = profile_step(torch, step, tag)
    # the profiler's warm-up call and the recorded one (of each attempt)
    moved = {n: c.count - before[n] for n, c in counters.items()}
    if moved != {n: calls * k for n, k in expect["train"].items()}:
        raise AssertionError(f"{tag}: the profiled steps moved the counters by {moved}, "
                             f"expected {calls} x {expect['train']}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile {tag}:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")
    timed = [ch["seconds"] / len(ch["losses"]) for ch in chunks if ch["seconds"] is not None]
    ms = 1e3 * sum(timed) / len(timed) if timed else None
    result = dict(run=tag, seeds=list(seeds), steps_per_dispatch=k, train_steps=n_train,
                  eval_steps=n_eval, ms_per_sweep_step=ms, steady_ms_per_sweep_step=steady_ms,
                  steady_posts_per_s=s * BATCH / (steady_ms / 1e3),
                  profiled_step_ms=step_wall, device_busy_ms=busy, idle_share=idle,
                  idle_share_of_steady_step=(1 - busy / steady_ms) if busy else None,
                  kernel_launches=sum(e.count for e in events), max_memory_allocated=peak,
                  run_seconds=wall, losses=losses)
    if after is not None:
        result.update(after(trainer, setup) or {})
    log(f"{tag}: {json.dumps(result)}")
    del trainer, setup
    torch.cuda.empty_cache()
    return result, by_key


def separate_losses(torch, run_mm_late, seed, extra=()):
    """The per-step losses of ``run_mm_late`` under ``auto`` at ``seed``: the
    separate run a sweep seed stands for."""
    argv = [a for a in train_args("auto", extra) if a != "--save_model"]
    argv[argv.index("--seed") + 1] = str(seed)
    losses = []
    run_mm_late.main(argv, on_step=lambda step, m: losses.append(float(m["loss"])))
    torch.cuda.empty_cache()
    return losses


def sweep_against_separate(sweep, separate, tag, seeds=SWEEP_SEEDS):
    """Each seed's per-step bfloat16 losses within 2e-2 relative of its
    separate run's."""
    worst = 0.0
    for i, seed in enumerate(seeds):
        mine = [row[i] for row in sweep["losses"]]
        if len(mine) != len(separate[seed]):
            raise AssertionError(f"{tag}: seed {seed}: {len(mine)} steps against "
                                 f"{len(separate[seed])}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(mine, separate[seed]))
        worst = max(worst, rel)
        log(f"{tag}: seed {seed} losses {mine} vs its separate run {separate[seed]}: worst "
            f"relative difference {rel:.2e} (tol 2e-2)")
    if not worst <= 2e-2:
        raise AssertionError(f"{tag}: a seed's losses left its separate run's")
    return worst


def sweep_first_step(torch, C, run_mm_late, build, sweep, hub):
    """The sweep's first step in float32 against each seed's separate
    ``run_mm_late`` setup: the same state dicts from the same seeds, each
    seed's first batch, dropout 0 and the TIM swap pinned. Each seed's loss
    within 1e-5 relative and each of its text-tower attention weights' and
    fusion-head tensors' gradients (but ``fc_k.bias``, whose exact gradient
    is zero) within 1e-3 relative (Frobenius) of its separate step's."""
    import numpy as np

    saved = dict(C.MODEL_DIR_DICT)
    for name in ("bernice", "vit"):
        d = os.path.join(hub, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"hidden_dropout_prob": 0.0}, f)
        C.MODEL_DIR_DICT[name] = d + os.sep
    extra = ["--dropout", "0", "--dtype", "float32"]
    device = torch.device(DEVICE)
    perm = np.random.RandomState(3).permutation(BATCH)

    def pinned(batch, copies):
        batch["tim_src"] = torch.as_tensor(np.tile(perm, copies), device=DEVICE)
        batch["tim_labels"] = torch.as_tensor(
            np.tile((perm == np.arange(BATCH)).astype(np.int32), copies), device=DEVICE)
        return batch

    def keep(n):
        return ((n.startswith("dual.text.encoder.") and ".attention." in n
                 and n.endswith("weight"))
                or (n.startswith("fusion.") and n != "fusion.fc_k.bias"))

    try:
        t0 = time.monotonic()
        args = sweep.parse_args(sweep_args("auto", extra))
        stacked = sweep.build_sweep_setup(args, C.Config(args),
                                          sweep.build_seed_setups(args, SWEEP_SEEDS), device)
        from socialmedia_textimage_classification_auxlosses_tpu_torch.train.ensemble import (
            EnsembleTrainer)

        trainer = EnsembleTrainer(stacked.train_step, stacked.eval_step, stacked.model, device,
                                  SWEEP_SEEDS)
        batch = pinned(next(trainer.device_batches(stacked.pipes["train"], False, 1))[0],
                       len(SWEEP_SEEDS))
        grads, parts, _ = stacked.train_step.gradients(batch, trainer.gens)
        losses = parts["loss"].tolist()
        kept = [{n: g[i].float().cpu() for n, g in grads.items() if g is not None and keep(n)}
                for i in range(len(SWEEP_SEEDS))]
        peak = torch.cuda.max_memory_allocated()
        del stacked, trainer, grads, parts, batch
        torch.cuda.empty_cache()
        result, failed = {}, []
        for i, seed in enumerate(SWEEP_SEEDS):
            argv = train_args("auto", extra)
            argv[argv.index("--seed") + 1] = str(seed)
            a = run_mm_late.parse_args(argv)
            single = build.build_mm_late_train_setup(a, C.Config(a), device,
                                                     torch.Generator().manual_seed(seed))
            b = pinned(next(single.pipes["train"].device_iter(device, shuffle=False)), 1)
            g, p, _ = single.train_step.gradients(b, torch.Generator(DEVICE))
            want = {n: v.float().cpu() for n, v in g.items() if v is not None and keep(n)}
            loss = float(p["loss"].detach())
            del single, g, p, b
            torch.cuda.empty_cache()
            rel_loss = abs(losses[i] - loss) / abs(loss)
            rel = {n: (torch.linalg.vector_norm(kept[i][n] - w)
                       / torch.linalg.vector_norm(w)).item() for n, w in want.items()}
            if set(rel) != set(kept[i]):
                raise AssertionError(f"sweep first step: seed {seed} kept other tensors")
            worst = max(rel, key=rel.get)
            log(f"sweep first step[seed {seed}, float32]: loss {losses[i]:.6f} vs separate "
                f"{loss:.6f} (rel {rel_loss:.2e}, tol 1e-5); gradient rel error over "
                f"{len(rel)} tensors: median {np.median(list(rel.values())):.2e}, worst "
                f"{rel[worst]:.2e} ({worst}; tol 1e-3)")
            result[str(seed)] = dict(rel_loss=rel_loss, worst_rel=rel[worst], worst_grad=worst,
                                     median_rel=float(np.median(list(rel.values()))))
            if not (rel_loss <= 1e-5 and rel[worst] <= 1e-3):
                failed.append(seed)
        if failed:
            raise AssertionError(f"sweep first step: seeds {failed} left their separate runs")
        result["stacked_first_step_peak_bytes"] = peak
        result["seconds"] = time.monotonic() - t0
        return result
    finally:
        C.MODEL_DIR_DICT.clear()
        C.MODEL_DIR_DICT.update(saved)


def sweep_phase(torch, C, run_mm_late, build, sweep, counters, per_step, training, launches,
                hub):
    """The seed sweep at full width, ``SWEEP_SEEDS`` trained together
    (``run_seed_sweep``): under ``auto`` at K = 1 each SDPA launch takes the
    seeds' rows as its batch, so a sweep step launches one seed's count;
    under ``fused`` at K = 3 the block kernels run once per seed, S times one
    seed's count. Each seed's per-step losses against its separate run, the
    float32 first step against the separate setups, and beside the sweep's
    ms per step the single run's at the same K; after the ``fused`` run one
    AdamW step's launches over the stacked gradients, now and with the
    product's old backward (``sweep_adamw_check``). Then BEiT-B/16 late
    fusion under ``auto`` at K = 1, ``BEIT_SWEEP_SEEDS`` stacked (its
    relative-position tables along the seed axis; the tower launches no
    kernel), each seed's losses against its separate run."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder

    s = len(SWEEP_SEEDS)
    per_seed = ("attn_block_fwd", "attn_block_bwd", "gemm_tn_bf16")
    expect = {"auto": per_step["auto"],
              "fused": {phase: {n: c * s if n in per_seed else c for n, c in counts.items()}
                        for phase, counts in per_step["fused"].items()}}
    stem_fmt = C.results_dir_mm_late + "bernice-vit-attention_task3_seed{seed}_itc0.1itm0.1_"
    result = {}
    for impl, k, single in (("auto", 1, "auto"), ("fused", 3, "fused/k3")):
        tag = f"sweep[{impl}, K={k}]"
        result[f"{impl}/k{k}"], by_key = sweep_run(
            torch, sweep.main, sweep_args(impl), tag, counters, expect[impl],
            C.results_dir_mm_late, stem_fmt, k,
            after=sweep_adamw_check(torch, encoder, tag) if impl == "fused" else None)
        count_launches(launches, by_key)
        one = training[single]
        mine = result[f"{impl}/k{k}"]
        log(f"{tag}: steady {mine['steady_ms_per_sweep_step']:.2f} ms a sweep step of {s} "
            f"seeds ({mine['steady_posts_per_s']:.1f} posts/s), idle "
            f"{mine['idle_share']}, peak {mine['max_memory_allocated'] / 1e9:.2f} GB; one seed "
            f"at K = {k}: steady {one['steady_ms_per_step']:.2f} ms a step "
            f"({one['steady_posts_per_s']:.1f} posts/s), peak "
            f"{one['max_memory_allocated'] / 1e9:.2f} GB")
        mine["single_seed_steady_ms_per_step"] = one["steady_ms_per_step"]
    separate = {SWEEP_SEEDS[0]: training["auto"]["losses"]}
    for seed in SWEEP_SEEDS[1:]:
        separate[seed] = separate_losses(torch, run_mm_late, seed)
    for run in ("auto/k1", "fused/k3"):
        result[run]["loss_rel_vs_separate"] = sweep_against_separate(
            result[run], separate, f"sweep[{run}]")
    result["first_step"] = sweep_first_step(torch, C, run_mm_late, build, sweep, hub)
    result["beit/auto/k1"] = beit_sweep(torch, C, run_mm_late, sweep, counters, per_step,
                                        launches)
    return result


def beit_sweep(torch, C, run_mm_late, sweep, counters, per_step, launches):
    """BEiT-B/16 late fusion under ``auto`` at K = 1, ``BEIT_SWEEP_SEEDS``
    stacked (the relative-position tables along the seed axis): the text
    tower's 12 SDPA launches and the fusion head's a sweep step, none in the
    frozen tower; each seed's losses against its separate run."""
    beit = ("--img_model_name", "beit")
    tag = "sweep[beit, auto, K=1]"
    text_only = {phase: {**counts, "sdpa_fwd": counts["sdpa_fwd"] - 12}
                 for phase, counts in per_step["auto"].items()}
    result, by_key = sweep_run(
        torch, sweep.main, sweep_args("auto", seeds=BEIT_SWEEP_SEEDS, image="beit"), tag,
        counters, text_only, C.results_dir_mm_late,
        C.results_dir_mm_late + "bernice-beit-attention_task3_seed{seed}_itc0.1itm0.1_",
        seeds=BEIT_SWEEP_SEEDS)
    count_launches(launches, by_key)
    separate = {seed: separate_losses(torch, run_mm_late, seed, beit)
                for seed in BEIT_SWEEP_SEEDS}
    result["loss_rel_vs_separate"] = sweep_against_separate(result, separate, tag,
                                                            BEIT_SWEEP_SEEDS)
    return result


def jax_artifact_phase(torch, C, serve, counters, per_window, launches, tmp):
    """The full-width serving model written as the JAX package writes its
    artifact, a flax msgpack of the parameter tree (by the port's encoder:
    flax is not imported), once unrolled and once in the ``--scan_layers`` layout,
    beside the port's own torch file; each read back through
    ``load_params`` (bytes and seconds printed), then served for 4 windows
    of ``BATCH`` requests under ``auto``, the counts set to 0 before and
    read after (``per_window``: each kernel's launches a window) and added to
    ``launches``. Both JAX artifacts' probabilities must equal the torch
    artifact's exactly."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
        build_mm_late_setup)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        seed_everything)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
        jax_tree_from_torch)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train import flax_msgpack
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
        load_params, save_params)

    t0 = time.monotonic()
    paths = {name: os.path.join(tmp, f"{name}_net.pth")
             for name in ("torch", "jax_unrolled", "jax_scan_layers")}
    args = service_args(serve, paths["torch"], "auto")
    model = build_mm_late_setup(args, C.serving_config(args),
                                generator=seed_everything(args.seed)).model
    save_params(paths["torch"], model)
    result = {}
    for name, scan in (("jax_unrolled", False), ("jax_scan_layers", True)):
        t1 = time.monotonic()
        nbytes_written = flax_msgpack.write_file(paths[name],
                                                 jax_tree_from_torch(model, scan_layers=scan))
        result[name] = dict(bytes=nbytes_written, write_seconds=time.monotonic() - t1)
    result["torch"] = dict(bytes=os.path.getsize(paths["torch"]))
    del model
    reqs = (make_requests() * 2)[:4 * BATCH]
    probs = {}
    for name, path in paths.items():
        extra = ["--scan_layers"] if name == "jax_scan_layers" else []
        a = service_args(serve, path, "auto", extra)
        empty = build_mm_late_setup(a, C.serving_config(a)).model
        t1 = time.monotonic()
        load_params(path, empty)
        result[name]["read_seconds"] = time.monotonic() - t1
        del empty
        predict, _ = serve.build_service(a)
        for c in counters.values():
            c.reset()
        answers = [r for i in range(0, len(reqs), BATCH) for r in predict(reqs[i:i + BATCH])]
        torch.cuda.synchronize()
        count_launches(launches, {n: dict(c.by_key) for n, c in counters.items()})
        for kernel, n in per_window.items():
            if counters[kernel].count != n * (len(reqs) // BATCH):
                raise AssertionError(f"artifact[{name}]: {counters[kernel].count} {kernel} "
                                     f"launches in 4 windows, expected {n} each")
        probs[name] = np.array([r["probs"] for r in answers])
        if not np.isfinite(probs[name]).all():
            raise AssertionError(f"artifact[{name}]: probabilities not finite")
        del predict
        torch.cuda.empty_cache()
        log(f"artifact[{name}]: {result[name]['bytes']} bytes, read in "
            f"{result[name]['read_seconds']:.2f} s"
            + (f", written in {result[name]['write_seconds']:.2f} s" if "write_seconds"
               in result[name] else "") + f"; served {len(reqs)} requests in 4 windows")
    for name in ("jax_unrolled", "jax_scan_layers"):
        if not np.array_equal(probs[name], probs["torch"]):
            raise AssertionError(f"artifact[{name}]: probabilities differ from the torch "
                                 f"artifact's (max {np.abs(probs[name] - probs['torch']).max()})")
    log("artifact: both JAX-layout artifacts serve the torch artifact's probabilities "
        "exactly")
    for path in paths.values():
        os.remove(path)
    result["seconds"] = time.monotonic() - t0
    return result


GRID_LAYERS = 2  # the grid phase's towers: full width, cut to 2 layers


def grid_phase(torch, C, run_grid, counters, launches, tmp):
    """``run_grid.main`` over mm_late (Bernice + ViT attention fusion, full
    width cut to ``GRID_LAYERS`` layers a tower, float32), task 3, two seeds
    x aux {none, itc+itm}, one epoch: once with ``--seed_backend
    sequential`` and once, the artifacts removed, with ``vmap`` (each aux
    setting's two seeds as one sweep). The two backends' run and metric
    tables agree within the JAX grid test's tolerance (rtol 5e-3, atol
    1e-4), every run's predictions are equal, and the markdown tables exist.
    The counts are set to 0 before each backend and added to ``launches``
    after it."""
    import csv

    import numpy as np

    saved = dict(C.MODEL_DIR_DICT)
    results_dir = C.results_dir_mm_late
    t0 = time.monotonic()
    try:
        for name in ("bernice", "vit"):
            d = os.path.join(tmp, "hub_grid", name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump({"num_hidden_layers": GRID_LAYERS, "hidden_dropout_prob": 0.1}, f)
            C.MODEL_DIR_DICT[name] = d + os.sep
        C.results_dir_mm_late = os.path.join(tmp, "results", "grid_runs") + os.sep
        base = ["--families", "mm_late", "--mm_late", "bernice-vit-attention", "--tasks", "3",
                "--seeds", ",".join(map(str, SWEEP_SEEDS[:2])), "--aux", "none,itc+itm",
                "--epochs", "1"]
        runner = ["--arch", "base", "--dtype", "float32", "--use_saved_features",
                  "--save_preds", "--log_every", "1", "--attn_impl", "auto"]
        plan = run_grid.build_plan(run_grid.parse_args(base + ["--"] + runner))
        tables, preds, seconds = {}, {}, {}
        for backend in ("sequential", "vmap"):
            for run in plan:
                for path in (run.val_csv, run.test_csv):
                    if os.path.exists(path):
                        os.remove(path)
            out = os.path.join(tmp, "grid", backend) + os.sep
            for c in counters.values():
                c.reset()
            t1 = time.monotonic()
            rc = run_grid.main(base + ["--seed_backend", backend, "--out", out, "--"] + runner)
            seconds[backend] = time.monotonic() - t1
            count_launches(launches, {n: dict(c.by_key) for n, c in counters.items()})
            if rc != 0:
                raise AssertionError(f"grid[{backend}]: run_grid exited {rc}")
            # the vision tower's SDPA over two seeds' images at once shows that
            # the sweep ran (the grid falls back to single runs on a failure)
            folded = any(key[1] == 2 * BATCH and key[3] == 197
                         for key in counters["sdpa_fwd"].by_key)
            if folded != (backend == "vmap"):
                raise AssertionError(f"grid[{backend}]: seeds folded into a batch: {folded}")
            tables[backend] = {}
            for name in ("grid_runs.csv", "grid_table_f1_macro.csv",
                         "grid_table_f1_weighted.csv"):
                with open(out + name, newline="") as f:
                    tables[backend][name] = list(csv.reader(f))
            for name in ("grid_table_f1_macro.md", "grid_table_f1_weighted.md"):
                if not os.path.getsize(out + name):
                    raise AssertionError(f"grid[{backend}]: {name} is empty")
            for run in plan:
                with open(run.test_csv.replace("metrics_test.csv", "preds.csv")) as f:
                    preds[(backend, run.seed, run.aux)] = f.read()
            log(f"grid[{backend}]: {len(plan)} runs in {seconds[backend]:.1f} s")
        worst = 0.0
        for name, rows in tables["sequential"].items():
            other = tables["vmap"][name]
            if rows[0] != other[0] or len(rows) != len(other) or len(rows) < 2:
                raise AssertionError(f"grid: {name} differs in shape between the backends")
            for ra, rb in zip(rows[1:], other[1:]):
                for x, y in zip(ra, rb):
                    try:
                        fx, fy = float(x), float(y)
                    except ValueError:
                        if x != y:
                            raise AssertionError(f"grid: {name}: {x!r} against {y!r}")
                        continue
                    if not abs(fy - fx) <= 1e-4 + 5e-3 * abs(fx):
                        raise AssertionError(f"grid: {name}: {x} sequential, {y} vmap")
                    worst = max(worst, abs(fy - fx))
        for run in plan:
            if preds[("sequential", run.seed, run.aux)] != preds[("vmap", run.seed, run.aux)]:
                raise AssertionError(f"grid: {run} predicts otherwise under vmap")
        log(f"grid: the backends' tables agree (max abs difference {worst:.2e}; rtol 5e-3, "
            f"atol 1e-4) and every run's predictions are equal")
        return dict(runs=len(plan), seconds=seconds, max_abs_diff=worst,
                    total_seconds=time.monotonic() - t0)
    finally:
        C.MODEL_DIR_DICT.clear()
        C.MODEL_DIR_DICT.update(saved)
        C.results_dir_mm_late = results_dir


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


def hf_tower_state(torch, g, kind, cfg=None):
    """A full-width Hugging Face-named state dict from ``g``: a text tower
    (XLM-R / RoBERTa naming; ``cfg`` by default Bernice-base, 250,002 x 768
    word embeddings) or ViT-B/16. Linear weights (out, in), LayerNorm scales
    near 1, on the CPU in float32."""
    cfg = cfg or (BERNICE_CONFIG if kind == "text" else VIT_CONFIG)
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


# -- RoBERTa-base from its checkpoint directory, the tokenizer layouts -------------------

ROBERTA_CONFIG = dict(BERNICE_CONFIG, vocab_size=50265)  # roberta-base's published widths
ROBERTA_MERGES = 50000
ROBERTA_POSTS = (32, 8, 8)  # one short epoch: two train steps
# tweet-like words for the RoBERTa phase's posts: hashtags, mentions, links, emoji,
# accents, contractions, numbers, CJK and Greek (the tweet normalizer rewrites some)
ROBERTA_WORDS = ("rain sun happy sad team win lose love hate coffee city tonight best worst "
                 "#NewMusic @user https://t.co/x1 \U0001f602 \U0001f469‍\U0001f4bb café "
                 "don't it's 1,000 3.14 ΑΣ 世界 <s> [CLS]").split()

# The host checks: tiny layouts written by ``write_tiny_layouts`` and the texts below,
# each encoded at max_length 12 without the tweet normalizer; the ids are those of the
# JAX package's Rust path (``tokenizers`` 0.22.2) on the same files.
HOST_TEXTS = ["hello\U0001f600 world", "café news", "a_b", "hello 世界", "check\xadout",
              "", "Hello world's <s> tweet", "İstanbul ΑΣ é ​x\xa0y",
              "[CLS] hello [MASK] world!!", "  hello\tworld  \U0001f469‍\U0001f4bb 42"]
WP_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "the", "tw", "##ee", "##t", "@",
            "user", "#", "news", "!", ".", "love", "this", "check", "out", "cafe", "_", "a", "b",
            "[MASK]", "istanbul", "##s", "'", "s", "e", "x", "y", "42"]
TINY_MERGES = [("Ġ", "w"), ("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
               ("Ġw", "o"), ("r", "l"), ("Ġwo", "rl"), ("Ġworl", "d"), ("'", "s"),
               ("Ġ", "t"), ("Ġt", "w"), ("e", "e"), ("Ġtw", "ee"), ("Ġtwee", "t"),
               ("Ġ", "<"), ("s", ">"), ("Ġ<", "s>"), ("Ġ", "h"), ("Ġh", "e"),
               ("Ġhe", "ll"), ("Ġhell", "o"), ("4", "2"), ("Ġ", "42")]
_WP_IDS = [[2, 1, 5, 3], [2, 20, 13, 3], [2, 22, 21, 23, 3], [2, 4, 1, 1, 3], [2, 1, 3], [2, 3],
           [2, 4, 5, 27, 28, 1, 28, 1, 7, 8, 9, 3], [2, 25, 1, 29, 30, 31, 3],
           [2, 2, 4, 24, 5, 14, 14, 3], [2, 4, 5, 1, 32, 3]]
HOST_IDS = {  # the rows before their padding (0 for BERT, 1 for the byte-level BPE)
    "vocab.txt": _WP_IDS,
    "tokenizer.json": _WP_IDS,
    "vocab.json + merges.txt": [
        [0, 264, 176, 257, 250, 226, 268, 2], [0, 70, 68, 73, 131, 106, 224, 81, 72, 90, 86, 2],
        [0, 68, 66, 69, 2], [0, 264, 224, 164, 120, 248, 167, 247, 238, 2],
        [0, 70, 261, 70, 78, 130, 259, 82, 88, 87, 2], [0, 2],
        [0, 43, 72, 262, 82, 268, 269, 275, 86, 33, 274, 2],
        [0, 132, 112, 86, 87, 68, 81, 69, 88, 79, 224, 2],
        [0, 62, 38, 47, 54, 64, 224, 264, 224, 62, 48, 2],
        [0, 224, 224, 264, 201, 90, 82, 266, 71, 224, 224, 2]],
}


def write_tiny_layouts(root):
    """A BERT ``vocab.txt``, a BERT ``tokenizer.json`` (BertNormalizer,
    BertPreTokenizer, WordPiece, ``[CLS] $A [SEP]``, the specials added
    tokens) over ``WP_VOCAB``, and a byte-level ``vocab.json`` +
    ``merges.txt`` (``<s> <pad> </s> <unk>``, the 256 byte symbols,
    ``TINY_MERGES``), each in its own directory under ``root``."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.hf_layouts import (
        bytes_to_unicode)

    dirs = {name: os.path.join(root, name.replace(" ", "").replace("+", "_"))
            for name in HOST_IDS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(dirs["vocab.txt"], "vocab.txt"), "w") as f:
        f.write("\n".join(WP_VOCAB) + "\n")
    vocab = {t: i for i, t in enumerate(WP_VOCAB)}
    specials = [t for t in WP_VOCAB if t.startswith("[")]
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": False,
                              "special": True} for t in specials],
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": True, "strip_accents": None,
                           "lowercase": True},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}},
                                          {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
                               "pair": [],
                               "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                                                  for t in ("[CLS]", "[SEP]")}},
            "decoder": None,
            "model": {"type": "WordPiece", "unk_token": "[UNK]",
                      "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                      "vocab": vocab}}
    with open(os.path.join(dirs["tokenizer.json"], "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    bpe = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for c in bytes_to_unicode().values():
        bpe[c] = len(bpe)
    for a, b in TINY_MERGES:
        bpe.setdefault(a + b, len(bpe))
    d = dirs["vocab.json + merges.txt"]
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(bpe, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in TINY_MERGES))
    return dirs


def host_layout_checks(root):
    """No device work: the port's ``build_tokenizer`` on ``write_tiny_layouts``
    gives the Rust path's ``HOST_IDS`` for ``HOST_TEXTS``."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
        build_tokenizer)

    backends = {}
    for name, d in write_tiny_layouts(root).items():
        model, pad = ("roberta", 1) if name.startswith("vocab.json") else ("bert", 0)
        tok = build_tokenizer(model, d, 12, ROBERTA_CONFIG["vocab_size"], normalize=False)
        got = tok(HOST_TEXTS)["ids"].tolist()
        want = [row + [pad] * (12 - len(row)) for row in HOST_IDS[name]]
        if got != want:
            raise AssertionError(f"host check[{name}]: {type(tok.backend).__name__} gives "
                                 f"{got}, the Rust path {want}")
        backends[name] = type(tok.backend).__name__
    log(f"roberta: host checks: {len(HOST_TEXTS)} texts through {backends} give the ids of the "
        "JAX package's Rust path (tokenizers 0.22.2)")
    return backends


def native_encoder_checks(root, texts):
    """The port's C++ tokenizer library built on this machine, and its hash,
    SentencePiece-BPE and fastBPE ids and masks equal to the Python paths'
    on ``texts``."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data import bpe_backends as B
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data import native
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
        HashTokenizer)

    if not native.tokenizer_available():
        raise AssertionError(f"native: the tokenizer library did not build: "
                             f"{native.TOKENIZER.error}")
    os.makedirs(root, exist_ok=True)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(c, -10.0, 1) for c in sorted(set("".join(POST_WORDS))) + ["▁"]]
    pieces += [(p, float(len(p)), 1) for p in sorted(
        {"▁" + w[:n] for w in POST_WORDS for n in range(1, len(w) + 1)})]
    spm = os.path.join(root, "sentencepiece.bpe.model")
    with open(spm, "wb") as f:
        f.write(spm_model_bytes(pieces))
    codes, vocab = os.path.join(root, "bpe.codes"), os.path.join(root, "vocab.txt")
    with open(codes, "w") as f:
        f.write("r a 90\nra in</w> 80\nc o 70\nco ff 60\nf f 50\ncoff ee</w> 40\n")
    with open(vocab, "w") as f:
        f.write("rain 9\ncoffee 8\ncoff 7\nra 6\nco 5\nff 4\nin 3\nee 2\n")
    encoders = {"hash": (HashTokenizer(ROBERTA_CONFIG["vocab_size"], 64, False), None),
                "spbpe": (B.SentencePieceBPE(spm, 64),
                          B.SentencePieceBPE(spm, 64, use_native=False)),
                "fastbpe": (B.FastBPE(vocab, codes, 64), B.FastBPE(vocab, codes, 64,
                                                                   use_native=False))}
    real_hash = native.hash_encode_batch
    for name, (built, python) in encoders.items():
        if name != "hash" and built._native is None:
            raise AssertionError(f"native: {name} took the Python path")
        got = built.encode_batch(texts)
        native.hash_encode_batch = lambda *a: None  # the hashing tokenizer's Python path
        try:
            want = (python or built).encode_batch(texts)
        finally:
            native.hash_encode_batch = real_hash
        for a, b, what in ((got[0], want[0], "ids"), (got[1], want[1], "mask")):
            if not np.array_equal(a, b):
                raise AssertionError(f"native: {name} {what} differ from the Python path's")
    out = dict(library=native.TOKENIZER.path(), build_seconds=native.TOKENIZER.build_seconds,
               texts=len(texts))
    log(f"native: the tokenizer library built in "
        + (f"{out['build_seconds']:.2f} s" if out["build_seconds"] is not None else
           "an earlier process")
        + f" ({os.path.basename(out['library'])}); hash, SP-BPE and fastBPE ids and masks equal "
        f"the Python paths' on {len(texts)} texts")
    return out


def roberta_vocabulary(texts, d, seed=16):
    """``vocab.json`` + ``merges.txt`` of a byte-level BPE at roberta-base's
    size in ``d``: ``<s> <pad> </s> <unk>`` as 0-3, the 256 byte symbols, then
    ``ROBERTA_MERGES`` merges: those a BPE trainer learns from ``texts`` (the
    most frequent adjacent pair, while one occurs twice), then pairs of
    entries drawn from ``seed``. Returns the vocabulary's size."""
    from collections import Counter

    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.hf_layouts import (
        ByteLevel, bytes_to_unicode)

    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for c in bytes_to_unicode().values():
        vocab[c] = len(vocab)
    pre = ByteLevel()
    words = Counter(w for text in texts for w in pre(text))
    seqs = {w: list(w) for w in words}
    merges = []
    while len(merges) < ROBERTA_MERGES:
        pairs = Counter()
        for w, n in words.items():
            for pair in zip(seqs[w], seqs[w][1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), n = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        for w, seq in seqs.items():
            i, out = 0, []
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    learned = len(merges)
    rng = np.random.RandomState(seed)
    short = [t for t in list(vocab)[4:] if len(t) <= 6]  # the parts drawn: up to 12 characters
    while len(merges) < ROBERTA_MERGES:
        a, b = short[rng.randint(len(short))], short[rng.randint(len(short))]
        if a + b in vocab:
            continue
        merges.append((a, b))
        vocab[a + b] = len(vocab)
        if len(a + b) <= 6:
            short.append(a + b)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    log(f"roberta: vocabulary of {len(vocab)} entries, {len(merges)} merges ({learned} learned "
        "from the posts)")
    return len(vocab)


def roberta_args(attn_impl, extra=()):
    """``run_txt --model_name roberta`` at full width on the phase's posts."""
    return ["--model_name", "roberta", "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--save_model", "--log_every", "1",
            "--attn_impl", attn_impl, *extra]


def roberta_grads_check(torch, tag):
    """RoBERTa's pooled head reads the pooler: every parameter has a finite
    gradient."""

    def check(setup, grads):
        missing = sorted(n for n, gr in grads.items() if gr is None)
        bad = [n for n, gr in grads.items() if gr is not None and not torch.isfinite(gr).all()]
        if missing or bad:
            raise AssertionError(f"{tag}: no gradient for {missing}, non-finite for {bad[:5]}")
        log(f"{tag}: {len(grads)} tensors with finite gradients")

    return check


def roberta_phase(torch, C, run_txt, build, counters, none, launches, tmp):
    """RoBERTa-base from its checkpoint directory, and the tokenizer layouts.

    First the host checks (``host_layout_checks``) and the native encoders
    (``native_encoder_checks``) on the phase's posts: tweet-like texts of
    ``ROBERTA_WORDS``. Then a directory as roberta-base ships it, written from
    a seed: ``model.safetensors`` at the published widths (12 layers, hidden
    768, 12 heads, vocabulary 50,265, 514 positions; ``roberta.``-scoped
    names), its ``config.json``, and ``vocab.json`` + ``merges.txt``
    (``roberta_vocabulary``). ``run_txt --model_name roberta`` from it on the
    card, bf16, batch 16, ``--attn_impl auto``, one epoch of the posts
    (``train_run``: exact launch counts, every gradient finite): the backend
    is the byte-level BPE with pad id 1, every id under 50,265, padding
    present, the imported tensors on the device equal the file's. The
    tokenizer's load and its encoding of the posts are timed. Last the first
    step against the plain path in float64 (``first_step_check``, ``auto``;
    the same files with dropout 0)."""
    import csv

    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
        build_tokenizer)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as H

    t0 = time.monotonic()
    vocab_size = ROBERTA_CONFIG["vocab_size"]
    result = {"host": host_layout_checks(os.path.join(tmp, "layouts"))}
    saved = (C.DATA_PATH, C.PATH[3], dict(C.MODEL_DIR_DICT))
    data = make_dataset(tmp, "roberta_data", posts=ROBERTA_POSTS, words_of=tweet_words, seed=16,
                        words=ROBERTA_WORDS)
    C.DATA_PATH, C.PATH[3] = data, data + "data_key_mvsa.csv"
    try:
        with open(C.PATH[3], newline="") as f:
            texts = [row["text"] for row in csv.DictReader(f)]
        result["native"] = native_encoder_checks(os.path.join(tmp, "native"), texts + HOST_TEXTS)

        d = os.path.join(tmp, "roberta")
        os.makedirs(d)
        t1 = time.monotonic()
        g = torch.Generator(device="cuda").manual_seed(16)
        state = hf_tower_state(torch, g, "text", ROBERTA_CONFIG)
        del state["embeddings.position_ids"]
        write_safetensors(os.path.join(d, "model.safetensors"),
                          {f"roberta.{k}": v for k, v in state.items()})
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(ROBERTA_CONFIG, f)
        entries = roberta_vocabulary(texts, d)
        result["write_s"] = time.monotonic() - t1
        mib = os.path.getsize(os.path.join(d, "model.safetensors")) / 2 ** 20
        log(f"roberta: checkpoint ({mib:.0f} MiB), config and vocabulary written in "
            f"{result['write_s']:.1f} s")

        t1 = time.monotonic()
        tok = build_tokenizer("roberta", d, 128, vocab_size)
        result["tokenizer_load_s"] = time.monotonic() - t1
        t1 = time.monotonic()
        enc = tok(texts)
        result["tokenize_s"] = time.monotonic() - t1
        ids = enc["ids"]
        if (type(tok.backend).__name__ != "ByteLevelBPE" or tok.pad_token_id != 1
                or int(ids.max()) >= vocab_size or not (ids == 1).any()):
            raise AssertionError(f"roberta: backend {type(tok.backend).__name__}, pad id "
                                 f"{tok.pad_token_id}, ids up to {int(ids.max())}")
        log(f"roberta: tokenizer {type(tok.backend).__name__} loaded in "
            f"{result['tokenizer_load_s']:.2f} s; {len(texts)} posts in "
            f"{result['tokenize_s']:.3f} s, {int(enc['mask'].sum())} tokens, ids up to "
            f"{int(ids.max())}, pad id {tok.pad_token_id}")

        C.MODEL_DIR_DICT["roberta"] = d + os.sep
        last = ROBERTA_CONFIG["num_hidden_layers"] - 1
        expect = {"tower." + k: v for k, v in H.torch_state_from_jax(H.import_bert_tower(
            {k: v.numpy() for k, v in state.items()}, last + 1)).items()}
        by_hand = {"tower.embeddings.word.weight": state["embeddings.word_embeddings.weight"],
                   "tower.embeddings.position.weight":
                       state["embeddings.position_embeddings.weight"],
                   f"tower.encoder.layers.{last}.attention.value.weight":
                       state[f"encoder.layer.{last}.attention.self.value.weight"]}
        del state
        real_build, checked = run_txt.build_text_setup, {}

        def build_and_check(*a, **k):
            setup = real_build(*a, **k)
            own = setup.model.state_dict()
            for key, want in list(expect.items()) + list(by_hand.items()):
                got = own[key]
                if got.device.type != DEVICE or not torch.equal(
                        got, torch.as_tensor(np.asarray(want)).to(got)):
                    raise AssertionError(f"roberta: {key} is not the file's tensor")
            backend = setup.tokenizer.backend
            top = max(int(pipe.ids.max()) for pipe in setup.pipes.values())
            if (type(backend).__name__ != "ByteLevelBPE" or setup.tokenizer.pad_token_id != 1
                    or top >= vocab_size):
                raise AssertionError(f"roberta: the run's backend {type(backend).__name__}, pad "
                                     f"id {setup.tokenizer.pad_token_id}, ids up to {top}")
            checked.update(tensors=len(expect), by_hand=len(by_hand), top_id=top)
            return setup

        expect_step = {"train": {**none, "sdpa_fwd": 12, "sdpa_bwd": 12},
                       "eval": {**none, "sdpa_fwd": 12}}
        run_txt.build_text_setup = build_and_check
        try:
            result["run"], by_key, _ = train_run(
                torch, run_txt.main, roberta_args("auto"), "roberta[auto]", counters,
                C.results_dir_txt, "roberta_task3_seed30_", expect_step,
                roberta_grads_check(torch, "roberta[auto]"))
        finally:
            run_txt.build_text_setup = real_build
        if not checked:
            raise AssertionError("roberta: the run did not build its setup through the check")
        count_launches(launches, by_key)
        log(f"roberta: {checked['tensors']} imported tensors on the device equal the file's "
            f"({checked['by_hand']} also by name by hand); the run's ids up to {checked['top_id']}")
        del expect, by_hand
        result["imported"] = checked

        # the first step against the plain path: the same files, dropout 0
        fs = os.path.join(tmp, "roberta_first_step")
        os.makedirs(fs)
        for name in ("model.safetensors", "vocab.json", "merges.txt"):
            os.symlink(os.path.join(d, name), os.path.join(fs, name))
        with open(os.path.join(fs, "config.json"), "w") as f:
            json.dump(dict(ROBERTA_CONFIG, hidden_dropout_prob=0.0), f)
        C.MODEL_DIR_DICT["roberta"] = fs + os.sep

        def make_setup(impl, dtype):
            args = run_txt.parse_args(roberta_args(impl, ["--dropout", "0"]))
            args.dtype = dtype  # float64 too, which the command line does not offer
            cfg = C.Config(args)
            cfg.use_loss_correction = args.use_loss_correction
            return build.build_text_setup(args, cfg, torch.device(DEVICE),
                                          torch.Generator().manual_seed(30))

        def keep(n):
            return n.startswith("tower.encoder.") and ".attention." in n and n.endswith("weight")

        result["first_step"] = first_step_check(torch, "roberta", make_setup, keep,
                                                impls=("auto",))
    finally:
        C.DATA_PATH, C.PATH[3] = saved[0], saved[1]
        C.MODEL_DIR_DICT.clear()
        C.MODEL_DIR_DICT.update(saved[2])
    result["seconds"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    return result


def roberta_only():
    """``python3 chip_smoke.py --roberta``: the kernels built, then the
    RoBERTa phase alone, every (kernel, shape) it launched held against its
    plain version, without the last line: a quick run of this phase while it
    changes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as build
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_txt
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    set_precision_policy()
    init_memo = memoize_init(torch)
    log(card_line())
    log(f"build: per source {_cuda.build()}")
    counters, none, _, _ = training_counts(A, AB)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        C.results_dir_txt = os.path.join(tmp, "results", "txt") + os.sep
        out = roberta_phase(torch, C, run_txt, build, counters, none, launches, tmp)
    log(json.dumps({"roberta": out}, default=str))
    rows = rows_for_every_launch(torch, AB, [], launches)
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "key"} for r in rows]}))
    log(f"init memo: {init_memo['hits']} builds copied, {init_memo['misses']} drawn, "
        f"{init_memo['bytes'] / 2 ** 30:.2f} GiB held")
    return 0


def img_args(model, attn_impl="auto", extra=()):
    """``run_img`` at full width on the generated task-3 set."""
    return ["--model_name", model, "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--use_saved_features", "--save_model",
            "--log_every", "1", "--attn_impl", attn_impl, *extra]


def cnn_late_args(fusion, attn_impl="auto"):
    """``run_mm_late`` with Bernice-base and the ResNet-152 fusion path (no
    ITC/TIM: the runner refuses them with a ResNet)."""
    return ["--txt_model_name", "bernice", "--img_model_name", "resnet152",
            "--fusion_name", fusion, "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--use_saved_features", "--save_model",
            "--log_every", "1", "--attn_impl", attn_impl]


class InitialState:
    """While active, ``owner.attr`` (a runner's setup function) keeps CPU
    copies of the model's state dict as it was built, in ``state``, and
    hands the setup to ``check(setup)`` first when one is given."""

    def __init__(self, owner, attr, check=None):
        self.owner, self.attr, self.check, self.state = owner, attr, check, None

    def __enter__(self):
        self.real = real = getattr(self.owner, self.attr)

        def build(*a, **k):
            setup = real(*a, **k)
            self.state = {n: v.detach().to("cpu", copy=True)
                          for n, v in setup.model.state_dict().items()}
            if self.check is not None:
                self.check(setup)
            return setup

        setattr(self.owner, self.attr, build)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.real)


def model_grads_check(torch, tag, unused, initial=None, buffers="moved", fixed=None):
    """Every parameter AdamW holds has a finite gradient but ``unused`` (read
    by no loss), AdamW holds every parameter that needs a gradient, and the
    frozen ones have none. With ``initial`` (an ``InitialState``): the
    BatchNorm buffers ``moved`` in training or were ``kept``, and the
    parameters ``fixed(name)`` names equal the built model's."""
    def check(setup, grads):
        got = sorted(n for n, gr in grads.items() if gr is None)
        if got != sorted(unused):
            raise AssertionError(f"{tag}: parameters without a gradient: {got}")
        bad = [n for n, gr in grads.items() if gr is not None and not torch.isfinite(gr).all()]
        if bad:
            raise AssertionError(f"{tag}: non-finite gradients in {bad[:5]}")
        named = dict(setup.model.named_parameters())
        trainable = sorted(n for n, p in named.items() if p.requires_grad)
        if sorted(setup.optimizer.names) != trainable or sorted(grads) != trainable:
            raise AssertionError(f"{tag}: AdamW does not hold exactly the trainable parameters")
        if any(p.grad is not None for p in named.values()):
            raise AssertionError(f"{tag}: a parameter holds a .grad")
        note = ""
        if initial is not None:
            own = setup.model.state_dict()
            stats = [n for n in own if n.endswith(("running_mean", "running_var"))]
            moved = [n for n in stats if not torch.equal(own[n].cpu(), initial.state[n])]
            if not stats or (buffers == "moved") != bool(moved) or (
                    buffers == "moved" and len(moved) != len(stats)):
                raise AssertionError(f"{tag}: {len(moved)} of {len(stats)} BatchNorm buffers "
                                     f"moved in training, expected {buffers}")
            held = [n for n in named if fixed is not None and fixed(n)]
            changed = [n for n in held if not torch.equal(own[n].cpu(), initial.state[n])]
            if changed:
                raise AssertionError(f"{tag}: frozen parameters moved: {changed[:4]}")
            note = (f"; {len(moved)} of {len(stats)} BatchNorm buffers moved"
                    + (f", {len(held)} frozen parameters as built" if held else ""))
        log(f"{tag}: {len(trainable) - len(unused)} trainable tensors with finite gradients, "
            f"{len(unused)} unused by the loss, {len(named) - len(trainable)} frozen{note}")

    return check


BEIT_CONFIG = dict(VIT_CONFIG, layer_norm_eps=1e-12)


def beit_hf_state(torch, g):
    """A full-width BEiT-B/16 ``BeitModel`` state dict under Hugging Face's
    names from ``g`` (relative-position tables of (2 * 14 - 1)^2 + 3 = 732
    rows, layer scales, no key bias, the mean-pool LayerNorm), on the CPU in
    float32."""
    h, m, n_rel = 768, 3072, (2 * 14 - 1) ** 2 + 3
    state = {}

    def arr(key, *shape, scale=0.02, offset=0.0):
        state[key] = (offset + scale * torch.randn(*shape, generator=g, device="cuda")).cpu()

    def dense(key, out, inp, bias=True):
        arr(f"{key}.weight", out, inp, scale=inp ** -0.5)
        if bias:
            arr(f"{key}.bias", out)

    def ln(key):
        arr(f"{key}.weight", h, scale=0.05, offset=1.0)
        arr(f"{key}.bias", h)

    arr("embeddings.cls_token", 1, 1, h, scale=0.5)
    arr("embeddings.patch_embeddings.projection.weight", h, 3, 16, 16, scale=768 ** -0.5)
    arr("embeddings.patch_embeddings.projection.bias", h)
    ln("pooler.layernorm")
    for i in range(12):
        p, att = f"encoder.layer.{i}", f"encoder.layer.{i}.attention.attention"
        arr(f"{p}.lambda_1", h, scale=0.05, offset=0.1)
        arr(f"{p}.lambda_2", h, scale=0.05, offset=0.1)
        dense(f"{att}.query", h, h)
        dense(f"{att}.key", h, h, bias=False)
        dense(f"{att}.value", h, h)
        arr(f"{att}.relative_position_bias.relative_position_bias_table", n_rel, 12, scale=0.5)
        dense(f"{p}.attention.output.dense", h, h)
        dense(f"{p}.intermediate.dense", m, h)
        dense(f"{p}.output.dense", h, m)
        ln(f"{p}.layernorm_before")
        ln(f"{p}.layernorm_after")
    return state


def resnet_tv_state(torch, g, sizes):
    """A torchvision ResNet state dict from ``g`` as numpy (He-normal
    convolutions, BatchNorm scales near 1 and running statistics, the
    1000-way ``fc``, ``num_batches_tracked``), as a ``.npz`` stores it."""
    import numpy as np

    state = {}

    def randn(*shape, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(*shape, generator=g, device="cuda")).cpu().numpy()

    def conv(name, o, i, k):
        state[f"{name}.weight"] = randn(o, i, k, k, scale=(2.0 / (i * k * k)) ** 0.5)

    def bn(name, c):
        state[f"{name}.weight"] = randn(c, scale=0.05, offset=1.0)
        state[f"{name}.bias"] = randn(c, scale=0.05)
        state[f"{name}.running_mean"] = randn(c, scale=0.05)
        state[f"{name}.running_var"] = 1.0 + 0.2 * torch.rand(c, generator=g,
                                                             device="cuda").cpu().numpy()
        state[f"{name}.num_batches_tracked"] = np.array(100, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, blocks in enumerate(sizes):
        f = 64 * 2 ** s
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            conv(f"{p}.conv1", f, cin, 1)
            bn(f"{p}.bn1", f)
            conv(f"{p}.conv2", f, f, 3)
            bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", 4 * f, f, 1)
            bn(f"{p}.bn3", 4 * f)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    state["fc.weight"] = randn(1000, cin, scale=cin ** -0.5)
    state["fc.bias"] = randn(1000, scale=0.0)
    return state


def imported_check(torch, tag, expect):
    """A setup check: every tensor of ``expect`` (port name -> numpy) is the
    model's on the device, as the file holds it."""
    import numpy as np

    def check(setup):
        own = setup.model.state_dict()
        for key, want in expect.items():
            got = own[key]
            if got.device.type != "cuda" or not torch.equal(
                    got, torch.as_tensor(np.asarray(want)).to(got)):
                raise AssertionError(f"{tag}: {key} is not the file's tensor")
        log(f"{tag}: {len(expect)} imported tensors on the device equal the file's")

    return check


def image_first_step(torch, C, run_img, build, model):
    """``first_step_check`` of the image-only runner (ViT or DeiT, the tower
    trained whole): every attention weight of the tower's 12 layers."""
    def make_setup(impl, dtype):
        args = run_img.parse_args(img_args(model, impl, ["--dropout", "0"]))
        args.dtype = dtype  # float64 too, which the command line does not offer
        return build.build_image_setup(args, C.Config(args), torch.device(DEVICE),
                                       torch.Generator().manual_seed(30))

    def keep(n):
        return n.startswith("tower.encoder.") and ".attention." in n and n.endswith("weight")

    return first_step_check(torch, f"img {model}", make_setup, keep)


def late_variant_first_step(torch, C, run_mm_late, build, argv_of, tag):
    """``first_step_check`` of a late-fusion variant (``argv_of(impl)``) under
    ``auto``, the attention mode its runs take here: the text tower's
    attention weights and the fusion layers' tensors (but a key bias, whose
    exact gradient is zero)."""
    def make_setup(impl, dtype):
        args = run_mm_late.parse_args(argv_of(impl) + ["--dropout", "0"])
        args.dtype = dtype  # float64 too, which the command line does not offer
        return build.build_mm_late_train_setup(args, C.Config(args), torch.device(DEVICE),
                                               torch.Generator().manual_seed(30))

    def keep(n):
        return ((".encoder." in n and n.split(".")[0] in ("text", "dual")
                 and ".attention." in n and n.endswith("weight") and ".vision." not in n)
                or (n.split(".")[0] in ("fusion", "linear_fusion", "conv_proj")
                    and n != "fusion.fc_k.bias"))

    return first_step_check(torch, tag, make_setup, keep, impls=("auto",))


def image_phase(torch, C, run_img, run_mm_late, build, counters, none, launches, tmp):
    """The image-only runner and the BEiT and ResNet late-fusion paths at
    full width, bfloat16, batch 16 (3 train and 2 eval steps each), through
    ``train_run``: ViT under ``auto`` (K = 1) and ``fused`` (K = 1, 3), DeiT
    under ``auto`` and ``fused``, BEiT started from a ``model.safetensors`` written from a
    seed, ResNet-152 ``--conv_att`` at K = 1 and 3, ResNet-50
    ``--feature_extract`` started from a torchvision ``.npz`` written from a
    seed (its trunk and BatchNorm buffers as imported after training), then
    ``run_mm_late`` with ResNet-152 ``concat_cnn`` and ``xatt`` and with
    BEiT (ITC + TIM); then the first step of ViT, DeiT, ``concat_cnn`` and
    BEiT late fusion against the plain path."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as H
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models.resnet import (
        STAGE_SIZES)

    t0 = time.monotonic()
    saved_dirs = dict(C.MODEL_DIR_DICT)
    C.results_dir_img = os.path.join(tmp, "results", "img") + os.sep
    late_dir = C.results_dir_mm_late
    results, eager = {}, {}
    blocks = {"train": {**none, "attn_block_fwd": 12, "attn_block_bwd": 12, "gemm_tn_bf16": 12},
              "eval": {**none, "attn_block_fwd": 12}}
    sdpa = {"train": {**none, "sdpa_fwd": 12, "sdpa_bwd": 12}, "eval": {**none, "sdpa_fwd": 12}}
    nothing = {"train": none, "eval": none}

    def run(key, main, argv, tag, results_dir, stem, expect, check, k=1, like=None):
        results[key], by_key, kernels = train_run(
            torch, main, argv, tag, counters, results_dir, stem, expect, check, k=k,
            eager_kernels=eager.get(like))
        eager.setdefault(key, kernels)
        count_launches(launches, by_key)
        if like is not None:
            results[key]["loss_rel_vs_k1"] = same_losses(results[key], results[like], tag)

    vit_unused = ["tower.pooler.dense.bias", "tower.pooler.dense.weight"]
    for impl, k in (("auto", 1), ("fused", 1), ("fused", 3)):
        tag = f"img[vit, {impl}" + (f", K={k}]" if k > 1 else "]")
        run(f"vit/{impl}/k{k}", run_img.main, img_args("vit", impl), tag, C.results_dir_img,
            "vit_task3_seed30_", sdpa if impl == "auto" else blocks,
            model_grads_check(torch, tag, vit_unused), k=k,
            like="vit/fused/k1" if k > 1 else None)
    for impl in ("auto", "fused"):
        tag = f"img[deit, {impl}]"
        run(f"deit/{impl}/k1", run_img.main, img_args("deit", impl), tag, C.results_dir_img,
            "deit_task3_seed30_", sdpa if impl == "auto" else blocks,
            model_grads_check(torch, tag, []))

    # BEiT from a full-width model.safetensors under HF's names
    g = torch.Generator(device="cuda").manual_seed(6)
    beit_dir = os.path.join(tmp, "hub_img", "beit")
    os.makedirs(beit_dir)
    beit_state = beit_hf_state(torch, g)
    write_safetensors(os.path.join(beit_dir, "model.safetensors"), beit_state)
    with open(os.path.join(beit_dir, "config.json"), "w") as f:
        json.dump(BEIT_CONFIG, f)
    C.MODEL_DIR_DICT["beit"] = beit_dir + os.sep
    expect = {"tower." + k: v for k, v in H.torch_state_from_jax(H.import_beit_tower(
        {k: v.numpy() for k, v in beit_state.items()}, 12)).items()}
    del beit_state
    with InitialState(run_img, "build_image_setup", imported_check(torch, "img[beit]", expect)):
        run("beit/k1", run_img.main, img_args("beit"), "img[beit]", C.results_dir_img,
            "beit_task3_seed30_", nothing, model_grads_check(torch, "img[beit]", []))

    conv_unused = ["trunk.fc.bias", "trunk.fc.weight"]
    for k in (1, 3):
        tag = "img[resnet152 conv_att" + (f", K={k}]" if k > 1 else "]")
        with InitialState(run_img, "build_image_setup") as init:
            run(f"resnet152_conv_att/k{k}", run_img.main,
                img_args("resnet152", extra=["--conv_att"]), tag, C.results_dir_img,
                "resnet152_task3_seed30_", nothing,
                model_grads_check(torch, tag, conv_unused, init), k=k,
                like="resnet152_conv_att/k1" if k > 1 else None)

    # ResNet-50 --feature_extract from a torchvision-format .npz
    npz = os.path.join(tmp, "hub_img", "resnet50.npz")
    tv_state = resnet_tv_state(torch, g, STAGE_SIZES["resnet50"])
    np.savez(npz, **tv_state)
    C.MODEL_DIR_DICT["resnet50"] = npz
    expect = H.torch_state_from_jax(H.import_resnet(tv_state, STAGE_SIZES["resnet50"]))
    del tv_state
    tag = "img[resnet50 feature_extract]"
    with InitialState(run_img, "build_image_setup", imported_check(torch, tag, expect)) as init:
        run("resnet50_feature_extract/k1", run_img.main,
            img_args("resnet50", extra=["--feature_extract"]), tag, C.results_dir_img,
            "resnet50_task3_seed30_", nothing,
            model_grads_check(torch, tag, [], init, buffers="kept",
                              fixed=lambda n: n.split(".")[0] != "fc"))

    cnn_unused = ["cnn.fc.bias", "cnn.fc.weight", "text.pooler.dense.bias",
                  "text.pooler.dense.weight"]
    for fusion in ("concat_cnn", "xatt"):
        tag = f"late[resnet152 {fusion}]"
        with InitialState(run_mm_late, "build_mm_late_train_setup") as init:
            run(f"late_resnet152_{fusion}/k1", run_mm_late.main, cnn_late_args(fusion), tag,
                late_dir, f"bernice-resnet152-{fusion}_task3_seed30__", sdpa,
                model_grads_check(torch, tag, cnn_unused, init))
    # BEiT late fusion: the text tower and the fusion row launch kernels, the
    # frozen BEiT tower none
    tag = "late[beit attention]"
    run("late_beit/k1", run_mm_late.main, train_args("auto", ["--img_model_name", "beit"]),
        tag, late_dir, "bernice-beit-attention_task3_seed30_itc0.1itm0.1_",
        {"train": {**none, "sdpa_fwd": 13, "sdpa_bwd": 13}, "eval": {**none, "sdpa_fwd": 13}},
        late_grads_check(torch, tag))
    results["train_seconds"] = time.monotonic() - t0

    # the first steps against the plain path, dropout 0 in every tower
    t1 = time.monotonic()
    hub = os.path.join(tmp, "hub_img_first")
    for name in ("bernice", "vit", "deit", "beit"):
        d = os.path.join(hub, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"hidden_dropout_prob": 0.0}, f)
        C.MODEL_DIR_DICT[name] = d + os.sep
    C.MODEL_DIR_DICT["resnet152"] = os.path.join(hub, "absent.npz")
    first = {}
    for model in ("vit", "deit"):
        first[f"img_{model}"] = image_first_step(torch, C, run_img, build, model)
    first["late_concat_cnn"] = late_variant_first_step(
        torch, C, run_mm_late, build, lambda impl: cnn_late_args("concat_cnn", impl),
        "late concat_cnn")
    first["late_beit"] = late_variant_first_step(
        torch, C, run_mm_late, build,
        lambda impl: train_args(impl, ["--img_model_name", "beit"]), "late beit")
    results["first_step"] = first
    results["first_step_seconds"] = time.monotonic() - t1
    C.MODEL_DIR_DICT.clear()
    C.MODEL_DIR_DICT.update(saved_dirs)
    results["seconds"] = time.monotonic() - t0
    log(f"image phases: {results['train_seconds']:.1f} s of runs, "
        f"{results['first_step_seconds']:.1f} s of first steps")
    torch.cuda.empty_cache()
    return results


def lxmert_args(attn_impl, extra=()):
    """``run_mm_early --model lxmert`` at full width (9 / 5 / 5 layers) over
    the generated posts' ROI features."""
    return ["--model", "lxmert", "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--use_clip_loss", "--use_tim_loss",
            "--save_model", "--log_every", "1", "--attn_impl", attn_impl, *extra]


def mmbt_args(attn_impl, extra=()):
    """``run_mm_early --model mmbt`` at full width (BERT-base, ResNet-152 at
    224 px) over the uint8 pixel cache."""
    return ["--model", "mmbt", "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "base", "--dtype", "bfloat16", "--use_clip_loss", "--use_tim_loss",
            "--use_saved_features", "--save_model", "--log_every", "1",
            "--attn_impl", attn_impl, *extra]


def write_roi_dumps(torch, data, ids):
    """The reference's per-sample ROI dumps of every post (``torch.save`` of
    a (1, 36, 2048) float32 feature tensor and a (1, 36, 4) box tensor under
    ``<data>/mvsa_img_feats/``), from a seed; returns them stacked."""
    g = torch.Generator().manual_seed(12)
    feats = torch.rand(len(ids), LXMERT_BOXES, 2048, generator=g) * 4
    lo = torch.rand(len(ids), LXMERT_BOXES, 2, generator=g) * 0.5
    boxes = torch.cat([lo, lo + torch.rand(len(ids), LXMERT_BOXES, 2, generator=g) * 0.5], -1)
    root = os.path.join(data, "mvsa_img_feats")
    for sub in ("features", "boxes"):
        os.makedirs(os.path.join(root, sub))
    for i, data_id in enumerate(ids):
        torch.save(feats[i:i + 1].clone(), os.path.join(root, "features", f"feat_{data_id}"))
        torch.save(boxes[i:i + 1].clone(), os.path.join(root, "boxes", f"nbox_{data_id}"))
    return feats.numpy(), boxes.numpy()


def grid_roi_check(torch, C, run_mm_early, build_early, counters, data, ids, weight_path):
    """The grid ROI fallback as a user meets it: ``run_mm_early --model
    lxmert`` at full width with neither a ROI cache nor the reference's
    dumps, under ``--use_saved_features`` (the pixels from the uint8 cache
    ``mvsa_u8_224``), so the builder's ``ensure_roi_cache`` runs
    ``cli/obj_features.py::extract_grid_features``: ResNet-50 at 224 px, 7 x 7
    = 49 regions of 2,048 features a post. The model trains on them with
    the plain attention (49 regions are no shape of the kernel rows; the
    runs above hold the kernels), and no kernel is launched. Its seconds,
    and the cache it leaves: finite features that differ between posts (a
    blank image for every post would give one post's features), the grid's
    boxes, float16 on disk read back equal."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import obj_features
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.cache import (
        RoiFeatureCache)

    cache_dir = os.path.join(data, "cache", "mvsa_roi")
    if os.path.exists(cache_dir) or os.path.exists(os.path.join(data, "mvsa_img_feats")):
        raise AssertionError("grid ROI: a ROI cache or the reference dumps are still there")
    ensure, saved = build_early.ensure_roi_cache, C.MODEL_DIR_DICT.get("resnet50")
    timed = {}

    def timed_ensure(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = ensure(*a, **k)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t0
        return cache

    for c in counters.values():
        c.reset()
    build_early.ensure_roi_cache = timed_ensure
    if weight_path is not None:
        C.MODEL_DIR_DICT["resnet50"] = weight_path
    t0 = time.perf_counter()
    try:
        run_mm_early.main(lxmert_args("jnp", ["--use_saved_features"]))
    finally:
        build_early.ensure_roi_cache = ensure
        C.MODEL_DIR_DICT["resnet50"] = saved
    wall = time.perf_counter() - t0
    precision_check(torch, "grid ROI")
    launched = {k: c.count for k, c in counters.items() if c.count}
    if launched:
        raise AssertionError(f"grid ROI: the plain-attention run launched {launched}")
    seconds = timed["seconds"]
    back = RoiFeatureCache(cache_dir)
    feats, boxes = back.gather(ids)
    if feats.shape != (len(ids), 49, 2048) or back.num_boxes != 49 or back.feat_dim != 2048:
        raise AssertionError(f"grid ROI: features {feats.shape}, {back.num_boxes} boxes of "
                             f"{back.feat_dim}")
    if not np.isfinite(feats).all() or not feats.std(axis=0).any():
        raise AssertionError("grid ROI: features not finite, or the same for every post")
    if not np.array_equal(boxes, np.tile(obj_features._grid_boxes(7)[None], (len(ids), 1, 1))):
        raise AssertionError("grid ROI: the boxes are not the 7 x 7 grid's")
    on_disk = np.load(os.path.join(cache_dir, "features.npy"))
    if on_disk.dtype != np.float16 or not np.array_equal(
            feats, on_disk[[back.index[str(i)] for i in ids]].astype(np.float32)):
        raise AssertionError("grid ROI: the cache does not read back what it wrote")
    log(f"grid ROI: run_mm_early --model lxmert built {len(ids)} posts x 49 regions x 2048 "
        f"from the pixel cache in {seconds:.2f} s ({len(ids) / seconds:.1f} posts/s; the "
        f"whole run {wall:.1f} s), float16 on disk, read back equal, posts distinct")
    return dict(posts=len(ids), seconds=seconds, posts_per_s=len(ids) / seconds,
                run_seconds=wall)


def early_first_step(torch, C, run_mm_early, build_early, hub, model, argv_of, keep):
    """``first_step_check`` of LXMERT or MMBT: the backbone's dropout 0
    (a ``config.json`` in the model directory), the attention weights."""
    d = os.path.join(hub, model)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"hidden_dropout_prob": 0.0}, f)
    saved = C.MODEL_DIR_DICT.get(model)
    C.MODEL_DIR_DICT[model] = d + os.sep

    def make_setup(impl, dtype):
        args = run_mm_early.parse_args(argv_of(impl) + ["--dropout", "0"])
        args.dtype = dtype  # float64 too, which the command line does not offer
        return build_early.build_mm_early_train_setup(
            args, C.Config(args, model_name=model), torch.device(DEVICE),
            torch.Generator().manual_seed(30))

    try:
        return first_step_check(torch, model, make_setup, keep)
    finally:
        C.MODEL_DIR_DICT[model] = saved


def early_phase(torch, C, run_mm_early, build_early, counters, none, launches, tmp, data, ids,
                eager):
    """LXMERT and MMBT at full width, bfloat16, batch 16, ITC + TIM (3 train
    and 2 eval steps each) through ``train_run``, under ``auto`` and
    ``fused`` at K = 1 and ``fused`` at K = 3: LXMERT over the posts' ROI
    features written in the reference's dump format (imported into the
    cache by the runner), MMBT over the uint8 pixel cache with its
    BatchNorm buffers moved in every run (inside the replayed graphs at
    K = 3); each first step against the plain path; then, with the ROI
    cache and the dumps taken away, the grid ROI fallback through the
    runner."""
    import shutil

    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.cache import (
        RoiFeatureCache)

    t0 = time.monotonic()
    results = {}
    feats, boxes = write_roi_dumps(torch, data, ids)
    # LXMERT: 9 language + 5 vision self-attentions, 5 cross layers of two
    # cross-attentions and two self-attentions (2B rows with TIM batched);
    # under fused the 24 self-attentions are blocks, the 10 cross-attentions
    # the plain SDPA
    lx_step = {"auto": {"train": {**none, "sdpa_fwd": 34, "sdpa_bwd": 34},
                        "eval": {**none, "sdpa_fwd": 34}},
               "fused": {"train": {**none, "attn_block_fwd": 24, "attn_block_bwd": 24,
                                   "gemm_tn_bf16": 24},
                         "eval": {**none, "attn_block_fwd": 24}}}
    # MMBT: BERT-base's 12 layers over the joint sequence of 132
    mmbt_step = {"auto": {"train": {**none, "sdpa_fwd": 12, "sdpa_bwd": 12},
                          "eval": {**none, "sdpa_fwd": 12}},
                 "fused": {"train": {**none, "attn_block_fwd": 12, "attn_block_bwd": 12,
                                     "gemm_tn_bf16": 12},
                           "eval": {**none, "attn_block_fwd": 12}}}
    os.symlink(os.path.join(data, "cache", "mvsa_u8_224"),
               os.path.join(data, "cache", "mvsa_mmbt_u8_224"))
    C.results_dir_mmbt = os.path.join(tmp, "results", "mmbt") + os.sep

    def lengths_of(by_key):
        """(SDPA (Lq, Lk) pairs, block lengths, TN rows) the run launched."""
        return ({k[3:5] for kernel in ("sdpa_fwd", "sdpa_bwd") for k in by_key[kernel]},
                {k[2] for kernel in ("attn_block_fwd", "attn_block_bwd")
                 for k in by_key[kernel]},
                {k[0] for k in by_key["gemm_tn_bf16"]})

    for model, argv_of, stem, step, unused, want in (
            ("lxmert", lxmert_args, "lxmert_task3_seed30_itc0.1itm0.1_", lx_step, [],
             {"auto": ({(128, 128), (36, 36), (128, 36), (36, 128)}, set(), set()),
              "fused": (set(), {128, 36}, {2 * BATCH * 128, 2 * BATCH * LXMERT_BOXES})}),
            ("mmbt", mmbt_args, "mmbt_task3_seed30_itc0.1itm0.1_", mmbt_step,
             ["backbone.cnn.fc.bias", "backbone.cnn.fc.weight"],
             {"auto": ({(MMBT_LEN, MMBT_LEN)}, set(), set()),
              "fused": (set(), {MMBT_LEN}, {2 * BATCH * MMBT_LEN})})):
        results_dir = C.results_dir_mmbt if model == "mmbt" else C.results_dir_mm_early
        for impl, k in (("auto", 1), ("fused", 1), ("fused", 3)):
            tag = f"{model}[{impl}]" if k == 1 else f"{model}[{impl}, K={k}]"
            run = f"{model}/{impl}" if k == 1 else f"{model}/{impl}/k{k}"
            with InitialState(run_mm_early, "build_mm_early_train_setup") as init:
                results[run], by_key, kernels = train_run(
                    torch, run_mm_early.main, argv_of(impl), tag, counters, results_dir, stem,
                    step[impl], model_grads_check(torch, tag, unused,
                                                  init if model == "mmbt" else None),
                    k=k, eager_kernels=eager[f"{model}/{impl}"] if k > 1 else None)
            if k == 1:
                eager[run] = kernels
            else:
                results[run]["loss_rel_vs_k1"] = same_losses(results[run],
                                                             results[f"{model}/{impl}"], tag)
            if lengths_of(by_key) != want[impl]:
                raise AssertionError(f"{tag}: launched at {lengths_of(by_key)}, expected "
                                     f"{want[impl]}")
            count_launches(launches, by_key)
        if model == "lxmert":
            cache = RoiFeatureCache(os.path.join(data, "cache", "mvsa_roi"))
            got_f, got_b = cache.gather(ids)
            if not (np.array_equal(got_f, feats) and np.array_equal(got_b, boxes)):
                raise AssertionError("lxmert: the ROI cache does not hold the dumps' float32 bits")
            log(f"lxmert: the runner imported the {len(ids)} reference dumps into "
                f"{cache.cache_dir} (float32 kept bit for bit)")
        no_added_f32_gemm(results[f"{model}/fused"], results[f"{model}/auto"], model)
    hub = os.path.join(tmp, "hub_early")

    def lxmert_keep(n):
        return n.startswith("backbone.") and n.endswith("weight") and any(
            s in n for s in (".attention.", ".cross_attention.", ".lang_self.", ".vis_self."))

    def mmbt_keep(n):
        return n.startswith("backbone.encoder.") and ".attention." in n and n.endswith("weight")

    results["first_step"] = {
        "lxmert": early_first_step(torch, C, run_mm_early, build_early, hub, "lxmert",
                                   lxmert_args, lxmert_keep),
        "mmbt": early_first_step(torch, C, run_mm_early, build_early, hub, "mmbt", mmbt_args,
                                 mmbt_keep)}
    # the grid ROI fallback: no cache and no dumps left
    shutil.rmtree(os.path.join(data, "mvsa_img_feats"))
    shutil.rmtree(os.path.join(data, "cache", "mvsa_roi"))
    npz = os.path.join(tmp, "hub_img", "resnet50.npz")
    results["grid_roi"] = grid_roi_check(torch, C, run_mm_early, build_early, counters, data,
                                         ids, npz if os.path.isfile(npz) else None)
    results["seconds"] = time.monotonic() - t0
    log(f"early phases (LXMERT, MMBT, grid ROI): {results['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return results


def early_service_args(serve, model, model_path, attn_impl):
    return serve.parse_args([
        "--task", "3", "--model", model, "--arch", "base", "--dtype", "bfloat16",
        "--max_batch", str(BATCH), "--batch_window_ms", "20", "--seed", "30",
        "--attn_impl", attn_impl, "--model_path", model_path, "--port", "0"])


def early_serve_phase(torch, C, serve, A, AB, launches, tmp):
    """``serve --model vilt`` (the fixed 384-px square, L = 185) and
    ``--model mmbt`` (ResNet-152 at 224 px, L = 132) at full width from
    random weights: ``N_REQUESTS`` requests and one HTTP request under
    ``auto`` and ``fused``, the counts set to 0 before and read after, each
    window's launches exact; every probability within ``PROB_TOL`` of the
    plain path's (``jnp``) on the same requests."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build_early import (
        build_mm_early_setup)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        seed_everything)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
        save_params)

    http_text = "an http request about the #weather @user"
    result = {}
    for model, size in (("vilt", 384), ("mmbt", 224)):
        path = os.path.join(tmp, f"{model}_random_weights.pth")
        args = early_service_args(serve, model, path, "auto")
        save_params(path, build_mm_early_setup(
            args, C.serving_config(args, model_name=model),
            generator=seed_everything(args.seed)).model)
        reqs = make_requests(size)
        every = reqs + [(http_text, None)]
        plain_predict, _ = serve.build_service(early_service_args(serve, model, path, "jnp"))
        A.launches.reset()
        AB.launches.reset()
        plain = [r for i in range(0, len(every), BATCH) for r in plain_predict(every[i:i + BATCH])]
        if A.launches.count or AB.launches.count:
            raise AssertionError(f"serve[{model} jnp]: the plain path launched a kernel")
        del plain_predict
        torch.cuda.empty_cache()
        plain_probs = np.array([p["probs"] for p in plain])
        per_window = {"auto": {"sdpa_fwd": 12, "attn_block_fwd": 0},
                      "fused": {"sdpa_fwd": 0, "attn_block_fwd": 12}}
        for impl, expect in per_window.items():
            tag = f"serve[{model} {impl}]"
            answers, health, counts, seconds = run_service(
                torch, serve, A, AB, early_service_args(serve, model, path, impl), reqs,
                http_text)
            windows = health["windows"]
            if health["errors"] or health["requests"] != len(reqs) + 1:
                raise AssertionError(f"{tag}: {health}")
            probs = np.array([a["probs"] for a in answers])
            if probs.shape != plain_probs.shape or not np.isfinite(probs).all():
                raise AssertionError(f"{tag}: bad probabilities {probs.shape}")
            err = np.abs(probs - plain_probs).max()
            log(f"{tag}: {health['requests']} requests in {windows} windows, "
                f"{len(reqs) / seconds:.1f} requests/s from {N_CLIENTS} clients, mean window "
                f"{health['mean_dispatch_ms']} ms; max |p - p_plain| {err:.3e} (tol {PROB_TOL})")
            if not err <= PROB_TOL:
                raise AssertionError(f"{tag}: disagrees with the plain path")
            for kernel, n in expect.items():
                total = sum(counts[kernel].values())
                if total != n * windows:
                    raise AssertionError(f"{tag}: {kernel} launched {total} times, expected "
                                         f"{n} x {windows}")
            count_launches(launches, counts)
            result[f"{model}/{impl}"] = dict(requests_per_s=len(reqs) / seconds,
                                             mean_window_ms=health["mean_dispatch_ms"],
                                             max_abs_prob_err=float(err))
        os.remove(path)
    return result


# ---- the Faster R-CNN detector, the cacher and serve --model lxmert ----------------

DETECTOR_PHOTOS = ((480, 640), (640, 480), (720, 1280), (1280, 720), (500, 500), (375, 500),
                   (600, 400), (768, 1024), (1080, 1920), (24, 32), (300, 800), (800, 300),
                   (427, 640), (640, 427), (960, 720), (333, 333))
DETECTOR_POSTS = (24, 12, 12)  # the detector phase's posts: each of the photos three times
FRCNN_CKPT_SEED = 14
LXMERT_STEM = "lxmert_task3_seed30_itc0.1itm0.1_"


def detector_photos():
    """16 generated RGB photos of mixed orientation and size (numpy only): a
    shaded background with 3-9 rectangles of solid colour, and noise. The
    1080 x 1920 one is large enough to take the PIL path under
    ``ingest="device"``; the 24 x 32 one is tiny."""
    import numpy as np

    rng = np.random.RandomState(21)
    photos = []
    for h, w in DETECTOR_PHOTOS:
        xx = np.linspace(0.4, 1.0, w)[None, :, None]
        yy = np.linspace(1.0, 0.6, h)[:, None, None]
        img = rng.rand(3)[None, None, :] * 200 * xx * yy
        for _ in range(rng.randint(3, 10)):
            y0, x0 = rng.randint(0, h), rng.randint(0, w)
            y1 = min(h, y0 + max(2, int(rng.rand() * h * 0.6)))
            x1 = min(w, x0 + max(2, int(rng.rand() * w * 0.6)))
            img[y0:y1, x0:x1] = rng.rand(3) * 255
        img = img + rng.randn(h, w, 3) * 8
        photos.append(np.clip(img, 0, 255).astype(np.uint8))
    return photos


def orientation_groups(FR, cfg, photos):
    """The photos' PIL canvases by orientation: [(indices, (B, H, W, 3)
    uint8, (B, 2) sizes)]."""
    import numpy as np

    pre = [FR.preprocess_image(p, cfg) for p in photos]
    groups = {}
    for i, (canvas, _, _) in enumerate(pre):
        groups.setdefault(canvas.shape, []).append(i)
    return [(idxs, np.stack([pre[i][0] for i in idxs]),
             np.asarray([pre[i][1] for i in idxs], np.float32)) for idxs in groups.values()]


def photo_heads(torch, det, groups):
    """Per photo, what the final selection starts from: its proposals'
    res5 features (N, 2048), the proposals (N, 4) and its size, from stage 1,
    the device RPN and stage 2's pooling (the fused path's calls on the
    fused path's batches)."""
    out = {}
    with torch.inference_mode():
        for idxs, canv, sizes in groups:
            sizes_d = torch.from_numpy(sizes).to(DEVICE)
            fmap, logits, deltas = det.stage1(torch.from_numpy(canv).to(DEVICE), sizes_d)
            props, cnt = det._rpn_device(logits, deltas, sizes_d)
            for j, i in enumerate(idxs):
                boxes = props[j, :int(cnt[j])]
                out[i] = (det.stage2.pooled_features(fmap[j], boxes), boxes, sizes_d[j])
    return [out[i] for i in sorted(out)]


def kept_counts(torch, FR, det, heads):
    """Per photo, (proposals whose best class reaches ``box_score_thresh``,
    regions the per-class greedy NMS keeps of them) under ``det``'s box
    predictor: the staged path's selection before its backfill."""
    import numpy as np

    cfg = det.cfg
    counts = []
    with torch.inference_mode():
        for feats, boxes, size in heads:
            scores, deltas = det.stage2.roi_heads.box_predictor(feats)
            best, cls = torch.softmax(scores, -1)[:, :-1].max(-1)
            rows = torch.nonzero(best >= cfg.box_score_thresh).flatten()
            if not len(rows):
                counts.append((0, 0))
                continue
            dsel = deltas[rows].reshape(len(rows), cfg.num_classes, 4)[
                torch.arange(len(rows), device=rows.device), cls[rows]]
            det_boxes = FR.clip_boxes(FR.decode_boxes(boxes[rows], dsel, cfg.box_bbox_weights),
                                      float(size[0]), float(size[1])).cpu().numpy()
            b, c = best[rows].cpu().numpy(), cls[rows].cpu().numpy()
            kept = sum(len(FR.greedy_nms(det_boxes[c == k], b[c == k], cfg.box_nms_thresh))
                       for k in np.unique(c))
            counts.append((len(rows), kept))
    return counts


def damp_class_scores(torch, heads, pred, most):
    """Scale the class scores down (bisection) until no proposal's best
    class reaches probability ``most``: res5 features of some proposals
    have norms far above the rest, and at std 0.01 those alone would pass
    ``box_score_thresh`` in a class of their own. Returns the factor."""
    x = torch.cat([f for f, _, _ in heads])
    with torch.no_grad():
        w = pred.cls_score.weight.clone()
        lo, hi = 0.0, 1.0

        def peak(scale):
            return float(torch.softmax(x @ (w * scale).T, -1)[:, :-1].max())

        if peak(hi) >= most:
            for _ in range(30):
                mid = (lo + hi) / 2
                lo, hi = (mid, hi) if peak(mid) < most else (lo, mid)
            pred.cls_score.weight.copy_(w * lo)
            return lo
    return 1.0


def lift_template_classes(torch, heads, pred, classes):
    """Give each of ``classes`` (one a photo) the score row of a template:
    the photo's proposal whose res5 feature, centred, has the fewest
    proposals anywhere at or above its own score along it (the widest gap
    below it breaking ties), the class's logit 1.5 over probability 0.2 at
    that proposal and 1.5 under at the next lower one (each proposal's other
    logits as they are at the template). Every photo then has its template
    and the few proposals scoring above it at ``box_score_thresh``, none of
    them near saturation (distinct scores). Returns, per class, how many
    proposals reach its template's score."""
    feats = [f.double() for f, _, _ in heads]
    x = torch.cat(feats)
    mu = x.mean(0)
    xc = x - mu
    starts = [0] + torch.tensor([len(f) for f in feats]).cumsum(0).tolist()
    low = math.log(0.25)  # p = 0.2: the class's logit this far over the others' log-sum-exp
    reach = []
    with torch.no_grad():
        for p, cls in enumerate(classes):
            lo, hi = starts[p], starts[p + 1]
            s = xc[lo:hi] @ xc.T                                  # (n_p, N)
            own = s[torch.arange(hi - lo), torch.arange(lo, hi)]
            above = (s >= own[:, None]).sum(1)
            below = torch.where(s < own[:, None], s, float("-inf")).max(1).values
            gap = (own - below) / xc[lo:hi].norm(dim=1)
            r = int(torch.argmin(above.double() * 1e6 - gap))
            d, t = xc[lo + r], float(own[r] + below[r]) / 2
            alpha = 3.0 / float(own[r] - below[r])
            others = pred.cls_score(x[lo + r:lo + r + 1].float()).double()
            others[:, cls] = float("-inf")
            rest = float(torch.logsumexp(others, -1))
            pred.cls_score.weight[cls] = (alpha * d).float()
            pred.cls_score.bias[cls] = low + rest - alpha * (t + float(d @ mu))
            reach.append(int(above[r]))
    return reach


def seeded_frcnn_checkpoint(torch, FR, cfg, photos, path):
    """A full-geometry detector checkpoint that makes the checks mean
    something, written in the published key layout as ``{"model": state}``
    to ``path``. A random detector at full geometry is degenerate (activations
    grow through 33 blocks, every RPN box decodes off the canvas, no class of
    1,601 near-uniform ones reaches 0.2), so from seed ``FRCNN_CKPT_SEED``:
    flax's initializers, then every frozen batch norm's statistics set from
    its input on the photos (in one pass, layer by layer: res2-res4 over four
    canvases, res5 over the pooled proposals of two photos), the heads
    Detectron2's small inits (RPN std 0.01, ``cls_score`` 0.01 scaled down
    until no proposal reaches probability 0.05, ``bbox_pred`` 0.001, zero
    biases) and one class a photo lifted to a template of one of
    its proposals (``lift_template_classes``), under which every photo's
    per-class NMS keeps 1 to 35 regions and the backfill adds the rest.
    Returns the per-photo (confident proposals, NMS-kept regions)."""
    det = FR.FrcnnDetector(cfg, generator=torch.Generator().manual_seed(FRCNN_CKPT_SEED),
                           device=DEVICE)
    g = torch.Generator().manual_seed(FRCNN_CKPT_SEED + 1)
    rpn = det.stage1.proposal_generator.rpn_head
    pred = det.stage2.roi_heads.box_predictor
    with torch.no_grad():
        for layer, std in ((rpn.conv, 0.01), (rpn.objectness_logits, 0.01),
                           (rpn.anchor_deltas, 0.01), (pred.cls_score, 0.01),
                           (pred.bbox_pred, 0.001)):
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=g) * std)
            layer.bias.zero_()

    def calibrate(module, run):
        def set_stats(m, args):
            x = args[0].float()
            m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
            m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

        hooks = [m.register_forward_pre_hook(set_stats) for m in module.modules()
                 if isinstance(m, FR.FrozenBN)]
        try:
            with torch.no_grad():
                run()
        finally:
            for h in hooks:
                h.remove()

    groups = orientation_groups(FR, cfg, photos)
    _, canv, sizes = groups[0]
    canv_d, sizes_d = torch.from_numpy(canv[:4]).to(DEVICE), torch.from_numpy(sizes[:4]).to(DEVICE)
    calibrate(det.stage1.backbone, lambda: det.stage1(canv_d, sizes_d))
    with torch.inference_mode():
        fmap, logits, deltas = det.stage1(canv_d, sizes_d)
        props, _ = det._rpn_device(logits, deltas, sizes_d)
    calibrate(det.stage2.roi_heads.res5, lambda: torch.cat(
        [det.stage2.pooled_features(fmap[i], props[i, :256]) for i in range(2)]))
    heads = photo_heads(torch, det, groups)
    damp = damp_class_scores(torch, heads, pred, cfg.box_score_thresh / 4)
    lifted = [(7 + 97 * p) % cfg.num_classes for p in range(len(photos))]
    reach = lift_template_classes(torch, heads, pred, lifted)
    counts = kept_counts(torch, FR, det, heads)
    if not all(1 <= kept < cfg.max_detections for _, kept in counts):
        raise AssertionError(f"detector checkpoint: the template classes leave (confident, "
                             f"NMS-kept) per photo {counts}, not 1-{cfg.max_detections - 1} "
                             f"kept on every one (proposals at each template {reach})")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in det.state_dict().items()}
    torch.save({"model": state}, path)
    log(f"detector checkpoint: R101-C4, {len(state)} tensors in the published layout "
        f"({sum(v.numel() for v in state.values())} values), batch-norm statistics from the "
        f"photos, class scores x{damp:.4f} (none at {cfg.box_score_thresh / 4}), one "
        f"template class a photo ({lifted[:3]}..., proposals at each template {reach}): "
        f"(confident proposals, NMS-kept regions) per photo {counts}")
    del det, heads
    torch.cuda.empty_cache()
    return counts


def scale_err(torch, got, want):
    """max |got - want| over max |want| (float64)."""
    want = want.double().cpu()
    return ((got.double().cpu() - want).abs().max() / want.abs().max().clamp_min(1e-12)).item()


def card_against_cpu(torch, FR, cfg, path, photo, tol=1e-3):
    """The card against the port's CPU path stage by stage on one photo,
    each stage fed the same inputs on both: stage 1 (map, logits, deltas),
    stage 2 over the card's first 64 proposals from the card's map
    (features, best score, class, box), each within ``tol`` of its scale in
    float32 (TF32 off). Decisions are discrete and 1,600 classes near-tie,
    so a class may differ only where the CPU's two best probabilities are
    within ``tol`` of each other."""
    card = FR.load_frcnn(path, cfg, device=DEVICE)
    cpu = FR.load_frcnn(path, cfg, device="cpu")
    canvas, size_hw, _ = FR.preprocess_image(photo, cfg)
    canv, sizes = torch.from_numpy(canvas[None]), torch.tensor([size_hw], dtype=torch.float32)
    errs, failed = {}, []
    with torch.inference_mode():
        t0 = time.perf_counter()
        c1 = card.stage1(canv.to(DEVICE), sizes.to(DEVICE))
        props, cnt = card._rpn_device(c1[1], c1[2], sizes.to(DEVICE))
        h1 = cpu.stage1(canv, sizes)
        for name, a, b in zip(("fmap", "logits", "deltas"), c1, h1):
            errs[f"stage1 {name}"] = scale_err(torch, a, b)
        boxes = props[:, :64]
        c2 = card.stage2(c1[0], boxes, sizes.to(DEVICE))
        h2 = cpu.stage2(c1[0].cpu(), boxes.cpu(), sizes)
        cpu_seconds = time.perf_counter() - t0
        for name, a, b in zip(("features", "best", "box"), (c2[0], c2[1], c2[3]),
                              (h2[0], h2[1], h2[3])):
            errs[f"stage2 {name}"] = scale_err(torch, a, b)
        probs = torch.softmax(cpu.stage2.roi_heads.box_predictor(h2[0])[0], -1)[..., :-1]
        top2 = probs.topk(2, dim=-1).values
        flipped = (c2[2].cpu() != h2[2]) & ((top2[..., 0] - top2[..., 1]) > tol)
    for k, e in errs.items():
        if not e <= tol:
            failed.append(f"{k} {e:.3e}")
    if int(cnt[0]) < 64:
        failed.append(f"only {int(cnt[0])} proposals")
    if flipped.any():
        failed.append(f"{int(flipped.sum())} classes differ away from a near tie")
    log(f"detector card vs CPU (one {photo.shape[0]}x{photo.shape[1]} photo, canvas "
        f"{canvas.shape[0]}x{canvas.shape[1]}, 64 proposals; the CPU side {cpu_seconds:.1f} s): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" of each scale (tol {tol}); classes equal on "
        f"{int((c2[2].cpu() == h2[2]).sum())}/64")
    if failed:
        raise AssertionError(f"detector card vs CPU: {failed}")
    del card, cpu
    torch.cuda.empty_cache()
    return errs


def detector_nms_check(torch, FR, det, photos):
    """The device RPN NMS against ``greedy_nms`` on every photo's real
    candidates: the surfaced prefix identical, 1,000 kept, and candidates
    suppressed on the way (the 1,000th kept row sits past row 1,000)."""
    import numpy as np

    cfg = det.cfg
    report, failed = [], []
    for idxs, canv, sizes in orientation_groups(FR, cfg, photos):
        sizes_d = torch.from_numpy(sizes).to(DEVICE)
        with torch.inference_mode():
            _, logits, deltas = det.stage1(torch.from_numpy(canv).to(DEVICE), sizes_d)
            bx, alive = det._rpn_candidates(logits, deltas, sizes_d)
            keep, cnt = FR.nms_keep_device(bx, alive, cfg.rpn_nms_thresh, cfg.rpn_post_nms_topk)
        bx, alive, keep = bx.cpu().numpy(), alive.cpu().numpy(), keep.cpu().numpy()
        for j, i in enumerate(idxs):
            live = int(alive[j].sum())
            want = FR.greedy_nms(bx[j, :live], -np.arange(live, dtype=np.float32),
                                 cfg.rpn_nms_thresh, max_out=cfg.rpn_post_nms_topk)
            got = np.nonzero(keep[j])[0][:int(cnt[j])]
            last = int(got[-1]) if len(got) else -1
            report.append((i, live, int(cnt[j]), last + 1 - int(cnt[j])))
            if not np.array_equal(got, want):
                failed.append(f"photo {i}: the device keeps {len(got)}, greedy {len(want)}, "
                              f"first difference at {np.argmax(got[:len(want)] != want[:len(got)])}")
            elif int(cnt[j]) != cfg.rpn_post_nms_topk or last + 1 <= int(cnt[j]):
                failed.append(f"photo {i}: {int(cnt[j])} kept, {last + 1 - int(cnt[j])} "
                              "suppressed before the cut")
    log("detector RPN NMS, device against greedy_nms (photo, live candidates, kept, "
        f"suppressed before the 1,000th): {sorted(report)}; the surfaced prefixes "
        f"{'identical' if not failed else 'DIFFER'}")
    if failed:
        raise AssertionError(f"detector NMS: {failed}")
    return report


def detector_selection_check(torch, FR, det, photos, counts):
    """Fused against staged ``detect_batch`` on the card (classes exact,
    boxes within 1e-5, features within 1e-4 of their scale, scores within
    1e-5), and the seeded checkpoint's outcome on every photo: 36 live,
    distinct regions and both branches of the final selection: from the
    loaded detector (``kept_counts``; ``counts`` are the calibration's) 1 to
    35 regions kept by the per-class NMS, ranked first (at or above the
    threshold, in score order), and the backfill after them."""
    import numpy as np

    cfg = det.cfg
    fused = det.detect_batch(photos, fused=True)
    staged = det.detect_batch(photos, fused=False)
    loaded = kept_counts(torch, FR, det, photo_heads(torch, det, orientation_groups(
        FR, cfg, photos)))
    failed, branches = [], []
    for i, (a, b) in enumerate(zip(fused, staged)):
        if not np.array_equal(a["classes"], b["classes"]):
            failed.append(f"photo {i}: classes {a['classes'][:6]} vs {b['classes'][:6]}")
        for k, tol in (("normalized_boxes", 1e-5), ("scores", 1e-5)):
            if not np.abs(a[k] - b[k]).max() <= tol:
                failed.append(f"photo {i}: {k} {np.abs(a[k] - b[k]).max():.2e}")
        e = np.abs(a["roi_features"] - b["roi_features"]).max() / np.abs(b["roi_features"]).max()
        if not e <= 1e-4:
            failed.append(f"photo {i}: features {e:.2e} of their scale")
        live = int((a["classes"] >= 0).sum())
        distinct = len({tuple(r) for r in a["normalized_boxes"].round(6).tolist()})
        kept = loaded[i][1]
        branches.append((i, live, distinct) + tuple(loaded[i]))
        if live != cfg.max_detections or distinct != cfg.max_detections:
            failed.append(f"photo {i}: {live} live, {distinct} distinct regions")
        head = a["scores"][:kept]
        if (not 1 <= kept < cfg.max_detections or not (head >= cfg.box_score_thresh).all()
                or (np.diff(head) > 0).any()):
            failed.append(f"photo {i}: (confident, kept) {loaded[i]}, calibrated {counts[i]}, "
                          f"the first {kept} scores {head}")
    log("detector fused vs staged on the card: classes, boxes, scores and features "
        f"{'agree' if not failed else 'DIFFER'}; (photo, live, distinct, confident, kept by "
        f"the NMS) {branches}: the kept regions first, the backfill after them")
    if failed:
        raise AssertionError(f"detector selection: {failed}")
    return branches


def cacher_run(torch, obj_features, argv, n_posts):
    """One ``obj_features.main`` run: wall seconds, images/s of the whole
    command and peak memory, with the cacher's own timing
    (``extract_frcnn_features``'s last record): its set-up (the checkpoint's
    load), its first batch (the kernels' first use, its decode not
    overlapped) and the images/s of the batches after it."""
    import logging

    class Timing(logging.Handler):
        def emit(self, record):
            if hasattr(record, "frcnn_timing"):
                self.timing = record.frcnn_timing

    handler = Timing()
    obj_features.logger.addHandler(handler)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        obj_features.main(argv)
        torch.cuda.synchronize()
    finally:
        obj_features.logger.removeHandler(handler)
    seconds = time.perf_counter() - t0
    timing = handler.timing
    after = timing["batch_s"][1:]
    return dict(seconds=seconds, images_per_s=n_posts / seconds,
                setup_s=timing["setup_s"], first_batch_s=timing["batch_s"][0],
                steady_images_per_s=timing["images_per_s_after_first"],
                steady_ms_per_batch=1e3 * sum(after) / len(after),
                host_ms_per_batch=1e3 * sum(timing["host_s"]) / len(timing["host_s"]),
                wait_ms_after_first=1e3 * sum(timing["wait_s"][1:]),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def stage_ms(torch, det, photos, ingest):
    """The device ms of each detector stage and of all kernels in one batch
    of the photos, the cacher's calls (after a cacher run: warm). A stage's
    ms: the span between CUDA events recorded where each of its
    ``record_function`` ranges opens and closes, summed over its ranges;
    the kernels' busy ms: the profiler, tracing only the card (the host's op
    events of a batch took it about ten seconds to read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    real, marks = torch.profiler.record_function, []

    @contextlib.contextmanager
    def record_function(name):
        opened, closed = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        opened.record()
        try:
            with real(name):
                yield
        finally:
            closed.record()
            marks.append((name, opened, closed))

    torch.cuda.synchronize()
    torch.profiler.record_function = record_function
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            det.detect_batch(photos, ingest=ingest)
            torch.cuda.synchronize()
    finally:
        torch.profiler.record_function = real
    spans = {}
    for name, opened, closed in marks:
        if name.startswith("frcnn."):
            spans[name[6:]] = spans.get(name[6:], 0.0) + opened.elapsed_time(closed)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return spans, busy


def write_detector_posts(data, ids, photos):
    """Each post's photo as a JPEG where the data key's image format finds
    it (post i takes photo i mod 16)."""
    from PIL import Image

    d = os.path.join(data, "MVSA-Single", "data")
    os.makedirs(d, exist_ok=True)
    for i, data_id in enumerate(ids):
        Image.fromarray(photos[i % len(photos)]).save(os.path.join(d, f"{data_id}.jpg"),
                                                      quality=95)
    return os.path.join(d, "{}.jpg")


def detector_cacher(torch, C, FR, obj_features, build_early, ckpt, ids, photos):
    """``obj_features.main(["--mode", "obj", "--obj_source", "frcnn", ...])``
    over the posts in float32 and ``--frcnn_dtype bfloat16``, each run with
    ``pil``, ``device``, ``device`` and ``pil`` ingest (so the order cannot
    decide the comparison): the set-up (the checkpoint's load), the first
    batch and the images/s of the batches after it apart (``cacher_run``),
    peak memory, and the device ms a batch of each stage from one profiled
    batch of the 16 photos per dtype and ingest (``stage_ms``), whose busy
    ms against a steady batch's wall ms give the card's idle share in the
    cacher. Every post gets a non-zero row; ``ensure_roi_cache`` then
    returns the built cache untouched."""
    import dataclasses
    from types import SimpleNamespace

    import numpy as np

    base = ["--task", "3", "--mode", "obj", "--obj_source", "frcnn", "--frcnn_ckpt", ckpt]
    results, reference = {}, None
    for dtype in ("float32", "bfloat16"):
        det = FR.load_frcnn(ckpt, dataclasses.replace(FR.FrcnnConfig(), dtype=dtype),
                            device=DEVICE)
        for turn, ingest in enumerate(("pil", "device", "device", "pil")):
            tag = f"{dtype}/{ingest}"
            res = cacher_run(torch, obj_features, base + ["--frcnn_dtype", dtype,
                                                          "--frcnn_ingest", ingest], len(ids))
            cache = obj_features.RoiFeatureCache(os.path.join(C.DATA_PATH, "cache", "mvsa_roi"))
            feats, boxes = cache.gather(ids)
            empty = [i for i, f, b in zip(ids, feats, boxes) if not f.any() or not b.any()]
            if empty or not np.isfinite(feats).all():
                raise AssertionError(f"cacher[{tag}]: zero rows for {empty}, or non-finite")
            if reference is None:
                reference = feats
            res["mean_abs_vs_first_f32_pil"] = float(
                np.abs(feats - reference).mean() / np.abs(reference).max())
            entry = results.setdefault(tag, {"runs": []})
            entry["runs"].append(res)
            if turn < 2:
                spans, busy = stage_ms(torch, det, photos, ingest)
                entry.update(device_ms_per_batch=spans, kernels_busy_ms_per_batch=busy)
            busy = entry["kernels_busy_ms_per_batch"]
            log(f"cacher[{tag}, run {len(entry['runs'])}]: {len(ids)} posts in "
                f"{res['seconds']:.2f} s ({res['images_per_s']:.1f} images/s, the command): "
                f"set-up {res['setup_s']:.2f} s, first batch {res['first_batch_s']:.2f} s, then "
                f"{res['steady_images_per_s']:.2f} images/s ({res['steady_ms_per_batch']:.1f} ms "
                f"a batch of 16; decode and resize {res['host_ms_per_batch']:.1f} ms a batch in "
                f"the thread, waited for {res['wait_ms_after_first']:.1f} ms after the first; "
                + (f"kernels busy {busy:.1f} ms a batch, so the card "
                   f"{100 * max(0.0, 1 - busy / res['steady_ms_per_batch']):.0f}% idle), peak "
                   if busy else "the card's idle share not measured), peak ")
                + f"{res['peak_gb']:.2f} GB")
        for ingest in ("pil", "device"):
            entry = results[f"{dtype}/{ingest}"]
            entry["steady_images_per_s"] = [r["steady_images_per_s"] for r in entry["runs"]]
            spans = entry["device_ms_per_batch"]
            stages = (", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items()))
                      if spans else "not measured (the profiler saw no device spans)")
            log(f"cacher[{dtype}/{ingest}]: device ms of a batch of the {len(photos)} photos: "
                f"{stages}; kernels busy {entry['kernels_busy_ms_per_batch']:.1f} ms; images/s "
                f"after the first batch, runs in order: {entry['steady_images_per_s']}")
        del det
        torch.cuda.empty_cache()
    # the LXMERT builder finds every id in the cache and reads it as built
    path = os.path.join(C.DATA_PATH, "cache", "mvsa_roi", "features.npy")
    stamp = os.path.getmtime(path)
    cache = build_early.ensure_roi_cache(SimpleNamespace(arch="base"),
                                         SimpleNamespace(task_name="mvsa"),
                                         [SimpleNamespace(ids=np.asarray(ids))],
                                         torch.device(DEVICE))
    got = cache.gather(ids)[0]
    want = obj_features.RoiFeatureCache(os.path.dirname(path)).gather(ids)[0]
    if os.path.getmtime(path) != stamp or not np.array_equal(got, want):
        raise AssertionError("cacher: ensure_roi_cache did not return the built cache untouched")
    log(f"cacher: ensure_roi_cache returned the built cache untouched ({len(ids)} posts x "
        f"{cache.num_boxes} x {cache.feat_dim})")
    return results


def lxmert_service_argv(model_path, ckpt, attn_impl):
    return ["--task", "3", "--model", "lxmert", "--arch", "base", "--dtype", "bfloat16",
            "--max_batch", str(BATCH), "--batch_window_ms", "20", "--seed", "30",
            "--attn_impl", attn_impl, "--model_path", model_path, "--frcnn_ckpt", ckpt,
            "--port", "0"]


def lxmert_service_args(serve, model_path, ckpt, attn_impl):
    return serve.parse_args(lxmert_service_argv(model_path, ckpt, attn_impl))


def lxmert_serve(torch, serve, A, AB, launches, model_path, ckpt, photos):
    """``serve --model lxmert`` at full width (9 / 5 / 5 layers, bfloat16)
    with the seeded detector checkpoint, ``N_REQUESTS`` requests (every other
    with a photo) from ``N_CLIENTS`` clients and one HTTP request, under
    ``auto`` and ``fused``: each window's launches exact (``auto``: 34 SDPA
    forwards, the cross layers included; ``fused``: 24 blocks, the 10 cross
    attentions on the plain SDPA), every probability within ``PROB_TOL`` of
    the plain path's (``jnp``) on the same requests, requests/s and the mean
    window printed."""
    import numpy as np

    http_text = "an http request about the #weather @user"
    reqs = [(text, None if image is None else photos[i % len(photos)])
            for i, (text, image) in enumerate(make_requests(8))]
    every = reqs + [(http_text, None)]
    plain_predict, _ = serve.build_service(lxmert_service_args(serve, model_path, ckpt, "jnp"))
    A.launches.reset()
    AB.launches.reset()
    plain = [r for i in range(0, len(every), BATCH) for r in plain_predict(every[i:i + BATCH])]
    if A.launches.count or AB.launches.count:
        raise AssertionError("serve[lxmert jnp]: the plain path launched a kernel")
    del plain_predict
    torch.cuda.empty_cache()
    plain_probs = np.array([p["probs"] for p in plain])
    result = {}
    for impl, expect in (("auto", {"sdpa_fwd": 34, "attn_block_fwd": 0}),
                         ("fused", {"sdpa_fwd": 0, "attn_block_fwd": 24})):
        tag = f"serve[lxmert {impl}]"
        # no window profile: the detector's stages are profiled in the cacher, and reading
        # a window's trace takes the profiler seconds
        answers, health, counts, seconds = run_service(
            torch, serve, A, AB, lxmert_service_args(serve, model_path, ckpt, impl), reqs,
            http_text, profile=False)
        windows = health["windows"]
        if health["errors"] or health["requests"] != len(reqs) + 1:
            raise AssertionError(f"{tag}: {health}")
        probs = np.array([a["probs"] for a in answers])
        if probs.shape != plain_probs.shape or not np.isfinite(probs).all():
            raise AssertionError(f"{tag}: bad probabilities {probs.shape}")
        err = np.abs(probs - plain_probs).max()
        log(f"{tag}: {health['requests']} requests in {windows} windows, "
            f"{len(reqs) / seconds:.1f} requests/s from {N_CLIENTS} clients (half with a "
            f"photo), mean window {health['mean_dispatch_ms']} ms; max |p - p_plain| "
            f"{err:.3e} (tol {PROB_TOL}); launches {dict(counts['sdpa_fwd'])} "
            f"{dict(counts['attn_block_fwd'])}")
        if not err <= PROB_TOL:
            raise AssertionError(f"{tag}: disagrees with the plain path")
        for kernel, n in expect.items():
            total = sum(counts[kernel].values())
            if total != n * windows:
                raise AssertionError(f"{tag}: {kernel} launched {total} times, expected "
                                     f"{n} x {windows}")
        count_launches(launches, counts)
        result[impl] = dict(requests_per_s=len(reqs) / seconds,
                            mean_window_ms=health["mean_dispatch_ms"],
                            max_abs_prob_err=float(err), windows=windows)
    return result


def detector_phase(torch, C, serve, build_early, A, AB, launches, tmp, lxmert_path):
    """The Faster R-CNN at its published geometry (R101-C4, 6,000 / 1,000 RPN
    candidates, 1,600 classes, the 800 x 1,333 canvas): a seeded checkpoint
    (``seeded_frcnn_checkpoint``) read through ``load_frcnn``, the card
    against the CPU stage by stage, device NMS against ``greedy_nms``, fused
    against staged with the checkpoint's outcome, the cacher over 48 posts
    in float32 and bfloat16 with ``pil`` and ``device`` ingest, and ``serve
    --model lxmert`` with the LXMERT artifact at ``lxmert_path``. The data
    key, image format and data path are the phase's own, restored after."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import obj_features
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as FR

    t0 = time.monotonic()
    cfg = FR.FrcnnConfig()
    photos = detector_photos()
    ckpt = os.path.join(tmp, "hub_frcnn", "pytorch_model.bin")
    result = {"confident_and_kept": seeded_frcnn_checkpoint(torch, FR, cfg, photos, ckpt)}
    result["card_vs_cpu"] = card_against_cpu(torch, FR, cfg, ckpt, photos[0])
    det = FR.load_frcnn(ckpt, cfg, device=DEVICE)
    result["nms"] = detector_nms_check(torch, FR, det, photos)
    result["selection"] = detector_selection_check(torch, FR, det, photos,
                                                   result["confident_and_kept"])
    del det
    torch.cuda.empty_cache()
    saved = (C.DATA_PATH, C.PATH[3], C.IMG_FMT[3])
    try:
        data = make_dataset(tmp, name="detector_data", posts=DETECTOR_POSTS)
        with open(data + "data_key_mvsa.csv", newline="") as f:
            import csv

            ids = [row["tweet_id"] for row in csv.DictReader(f)]
        C.DATA_PATH, C.PATH[3] = data, data + "data_key_mvsa.csv"
        C.IMG_FMT[3] = write_detector_posts(data, ids, photos)
        result["cacher"] = detector_cacher(torch, C, FR, obj_features, build_early, ckpt, ids,
                                           photos)
    finally:
        C.DATA_PATH, C.PATH[3], C.IMG_FMT[3] = saved
    result["serve"] = lxmert_serve(torch, serve, A, AB, launches, lxmert_path, ckpt, photos)
    result["checkpoint"] = ckpt
    result["seconds"] = time.monotonic() - t0
    log(f"detector phase: {result['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return result


def random_lxmert_artifact(torch, C, serve, path, feat_dim=2048):
    """A full-width LXMERT (9 / 5 / 5 layers over 36 x 2,048 regions) from
    seed 30, saved at ``path``: ``--detector``'s stand-in for the artifact
    that the early phase trains."""
    from types import SimpleNamespace

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build_early import (
        build_mm_early_setup)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        seed_everything)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
        save_params)

    args = lxmert_service_args(serve, path, "unused", "auto")
    save_params(path, build_mm_early_setup(
        args, C.serving_config(args, model_name="lxmert"), generator=seed_everything(30),
        roi_cache=SimpleNamespace(num_boxes=LXMERT_BOXES, feat_dim=feat_dim)).model)


def detector_only():
    """``python3 chip_smoke.py --detector``: the kernels built, then the
    detector phase alone over a random LXMERT artifact, every (kernel, shape)
    that its services launched held against its plain version, without the
    last line: a quick run of this phase while it changes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        _build_early as build_early)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    set_precision_policy()
    init_memo = memoize_init(torch)
    log(card_line())
    log(f"build: per source {_cuda.build()}")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        lxmert_path = os.path.join(tmp, "lxmert_random_net.pth")
        random_lxmert_artifact(torch, C, serve, lxmert_path)
        out = detector_phase(torch, C, serve, build_early, A, AB, launches, tmp, lxmert_path)
    log(json.dumps({"detector": out}, default=str))
    rows = rows_for_every_launch(torch, AB, [], launches)
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "key"} for r in rows]}))
    log(f"init memo: {init_memo['hits']} builds copied, {init_memo['misses']} drawn, "
        f"{init_memo['bytes'] / 2 ** 30:.2f} GiB held")
    return 0


# ---- --scan_layers and export --export_detector ----------------------------------------


def state_diff(torch, a_path, b_path):
    """Two saved state dicts: (the largest |a - b| over every tensor, the
    names of the tensors that differ)."""
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (a_path, b_path))
    if list(a) != list(b):
        raise AssertionError(f"state dicts hold other names: {sorted(set(a) ^ set(b))[:4]}")
    worst, differ = 0.0, []
    for k in a:
        if not torch.equal(a[k], b[k]):
            differ.append(k)
            worst = max(worst, float((a[k].float() - b[k].float()).abs().max()))
    return worst, differ


def loss_diff(a, b):
    if len(a) != len(b):
        raise AssertionError(f"runs of {len(a)} and {len(b)} steps")
    return max(abs(x - y) for x, y in zip(a, b))


def scan_layers_run(torch, C, run_mm_late, counters, per_step, training, launches, tmp,
                    unrolled_net):
    """``run_mm_late --scan_layers`` of the headline run under ``fused``,
    K = 1 (its init through ``memoize_init``, its launches counted), against
    the unrolled ``train[fused]`` run of the same seed (``training["fused"]``,
    its ``net.pth`` kept at ``unrolled_net``): the losses and the saved state
    equal bit for bit. Where they are not, a second unrolled run says how
    far two unrolled runs of one seed lie apart on the card, and the
    scanned run is held to the larger of its differences (losses, state)
    from the two. The caller restores the model directories of the
    unrolled run (``same_model_dirs``). Returns (the result, the scanned
    ``net.pth``)."""
    saved = C.results_dir_mm_late
    C.results_dir_mm_late = os.path.join(tmp, "results", "mm_late_scan") + os.sep
    late_stem = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
    tag = "train[fused, scan_layers]"
    try:
        result, by_key, _ = train_run(
            torch, run_mm_late.main, train_args("fused", ["--scan_layers"]), tag, counters,
            C.results_dir_mm_late, late_stem, per_step["fused"], late_grads_check(torch, tag))
        count_launches(launches, by_key)
        scan_net = os.path.join(C.results_dir_mm_late, late_stem + "net.pth")
        d_loss = loss_diff(result["losses"], training["fused"]["losses"])
        d_state, differ = state_diff(torch, scan_net, unrolled_net)
        out = dict(run_seconds=result["run_seconds"], steady_ms=result["steady_ms_per_step"],
                   loss_diff=d_loss, state_diff=d_state, tensors_differing=len(differ))
        if d_loss == 0 and not differ:
            log(f"{tag}: losses and saved state equal the unrolled run's bit for bit "
                f"({len(result['losses'])} steps)")
            return out, scan_net
        # a second unrolled run: how far two unrolled runs of one seed lie apart here
        C.results_dir_mm_late = os.path.join(tmp, "results", "mm_late_again") + os.sep
        again, by_key, _ = train_run(
            torch, run_mm_late.main, train_args("fused"), "train[fused, again]", counters,
            C.results_dir_mm_late, late_stem, per_step["fused"],
            late_grads_check(torch, "train[fused, again]"))
        count_launches(launches, by_key)
        again_net = os.path.join(C.results_dir_mm_late, late_stem + "net.pth")
        uu_loss = loss_diff(again["losses"], training["fused"]["losses"])
        uu_state, uu_differ = state_diff(torch, again_net, unrolled_net)
        su_loss = max(d_loss, loss_diff(result["losses"], again["losses"]))
        su_state = max(d_state, state_diff(torch, scan_net, again_net)[0])
        out.update(unrolled_pair_loss_diff=uu_loss, unrolled_pair_state_diff=uu_state)
        log(f"{tag}: differs from the unrolled run (losses {d_loss:.3e}, state {d_state:.3e} "
            f"over {len(differ)} tensors); two unrolled runs differ by losses {uu_loss:.3e}, "
            f"state {uu_state:.3e} over {len(uu_differ)} tensors; the scanned run against "
            f"either: losses {su_loss:.3e}, state {su_state:.3e}")
        if su_loss > uu_loss or su_state > uu_state:
            raise AssertionError(f"{tag}: farther from the unrolled runs than they are from "
                                 "each other")
        return out, scan_net
    finally:
        C.results_dir_mm_late = saved


def scan_layers_serve(torch, serve, counters, per_window, launches, paths, same_state):
    """``serve --scan_layers`` of the scanned run's artifact beside the
    unrolled run's ``serve`` under ``auto``: two windows of requests each,
    the counts set to 0 before and read after each, the probabilities equal
    (within ``PROB_TOL`` where the two artifacts' states differ)."""
    import numpy as np

    reqs = make_requests()[:2 * BATCH]
    probs = {}
    for name, extra in (("unrolled", []), ("scan_layers", ["--scan_layers"])):
        args = service_args(serve, paths[name], "auto",
                            ["--use_clip_loss", "--use_tim_loss", *extra])
        predict, _ = serve.build_service(args)
        for c in counters.values():
            c.reset()
        answers = [r for i in range(0, len(reqs), BATCH) for r in predict(reqs[i:i + BATCH])]
        torch.cuda.synchronize()
        for kernel, n in per_window.items():
            if counters[kernel].count != 2 * n:
                raise AssertionError(f"serve[{name}]: {counters[kernel].count} {kernel} "
                                     f"launches in 2 windows, expected {n} each")
        count_launches(launches, {n: dict(c.by_key) for n, c in counters.items()})
        probs[name] = np.array([r["probs"] for r in answers])
        if not np.isfinite(probs[name]).all():
            raise AssertionError(f"serve[{name}]: probabilities not finite")
        del predict
        torch.cuda.empty_cache()
    err = float(np.abs(probs["scan_layers"] - probs["unrolled"]).max())
    log(f"serve[scan_layers]: {len(reqs)} requests; max |p - p_unrolled| {err:.3e} "
        f"(bit-equal: {np.array_equal(probs['scan_layers'], probs['unrolled'])})")
    if same_state and err != 0:
        raise AssertionError("serve --scan_layers: the same state served other probabilities")
    if not err <= PROB_TOL:
        raise AssertionError("serve --scan_layers: disagrees with the unrolled artifact")
    return dict(max_abs_prob_diff=err)


def timed_call(torch, fn, *args):
    """(fn(*args), its wall ms between two synchronisations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def detector_export_check(torch, tmp, ckpt, lxmert_path):
    """``cli/export.py --model lxmert --export_detector --platforms cuda`` at
    ``--detector_batch`` 16 with the seeded full-geometry checkpoint: the two
    orientations' programs written, each loaded and run on the photos of its
    orientation (``orientation_groups``, padded to 16 with zero canvases of
    size 1 x 1, as the JAX dispatch pads) and held to the live detector on the
    same batch: boxes, classes and counts equal, features and scores within
    rtol 1e-5, atol 1e-4. Logs the export seconds, the bytes, the load
    seconds, the program's ms (its second call) beside the live detector's
    and its ``smtc::nms_keep`` nodes."""
    import io

    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import export
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as FR

    out = os.path.join(tmp, "export_detector", "lxmert.pt2")
    kept, seconds = {}, {}
    real_service, real_detector = export.export_service, export.export_detector

    def service(args, platforms=None):
        t0 = time.monotonic()
        kept.update(real_service(args, platforms))
        seconds["service"] = time.monotonic() - t0
        return kept

    def detector(det, batch, platform):
        t0 = time.monotonic()
        programs = real_detector(det, batch, platform)
        seconds["detector_export"] = time.monotonic() - t0
        return programs

    argv = (["--out", out, "--platforms", "cuda", "--export_detector", "--detector_batch",
             str(BATCH)] + lxmert_service_argv(lxmert_path, ckpt, "auto"))
    printed = io.StringIO()
    t0 = time.monotonic()
    export.export_service, export.export_detector = service, detector
    try:
        with contextlib.redirect_stdout(printed):
            export.main(argv)
    finally:
        export.export_service, export.export_detector = real_service, real_detector
    seconds["main"] = time.monotonic() - t0
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    det = kept["cuda"][3]["detector"]
    live_program = FR.FusedDetectProgram(det)
    result = dict(seconds=seconds, orientations={})
    for idxs, canv, sizes in orientation_groups(FR, det.cfg, detector_photos()):
        ph, pw = canv.shape[1:3]
        orient = "landscape" if ph < pw else "portrait"
        canvases = np.zeros((BATCH, ph, pw, 3), np.uint8)
        size_hw = np.ones((BATCH, 2), np.float32)
        canvases[:len(idxs)], size_hw[:len(idxs)] = canv, sizes
        batch = (torch.from_numpy(canvases).to(DEVICE), torch.from_numpy(size_hw).to(DEVICE))
        path = f"{line['out']}.detector.{orient}.pt2"
        if path not in line["detectors"]:
            raise AssertionError(f"export: no {orient} program in {line}")
        sidecar = json.load(open(path + ".json"))
        if sidecar["canvas"] != [BATCH, ph, pw, 3] or sidecar["platforms"] != ["cuda"]:
            raise AssertionError(f"export[{orient}]: sidecar {sidecar}")
        t1 = time.monotonic()
        exported = torch.export.load(path)
        program = exported.module()
        load_s = time.monotonic() - t1
        nms_nodes = sum(1 for n in exported.graph.nodes if n.op == "call_function"
                        and str(n.target) == "smtc.nms_keep.default")
        with torch.no_grad():  # the live detector is warm: the program's second call is timed
            got = program(*batch)
            want, live_ms = timed_call(torch, live_program, *batch)
            _, program_ms = timed_call(torch, program, *batch)
        got, want = ([t.cpu().numpy() for t in outs] for outs in (got, want))
        failed = [name for name, i in (("boxes", 1), ("classes", 3), ("counts", 4))
                  if not np.array_equal(got[i], want[i])]
        errs = {name: float(np.abs(got[i] - want[i]).max()) for name, i in
                (("features", 0), ("boxes", 1), ("scores", 2))}
        for name, i in (("features", 0), ("scores", 2)):
            if not np.allclose(got[i], want[i], rtol=1e-5, atol=1e-4):
                failed.append(name)
        size = os.path.getsize(path)
        log(f"export[detector {orient}]: {len(idxs)} photos padded to {BATCH} at {ph}x{pw}; "
            f"{size} bytes, loaded in {load_s:.1f} s; {nms_nodes} smtc::nms_keep nodes; "
            f"program {program_ms:.1f} ms, live detector {live_ms:.1f} ms a batch; counts "
            f"{got[4][:len(idxs)].tolist()}; max |diff| {errs}")
        if nms_nodes != 2 or failed:
            raise AssertionError(f"export[detector {orient}]: {nms_nodes} NMS nodes; "
                                 f"disagrees with the live detector in {failed}")
        result["orientations"][orient] = dict(
            photos=len(idxs), bytes=size, load_s=load_s, nms_nodes=nms_nodes,
            program_ms=program_ms, live_ms=live_ms, max_abs_diff=errs)
        del exported, program
    log(f"export --export_detector: main {seconds['main']:.1f} s (the LXMERT service's "
        f"export {seconds['service']:.1f} s, both detector programs "
        f"{seconds['detector_export']:.1f} s)")
    if sorted(result["orientations"]) != ["landscape", "portrait"]:
        raise AssertionError(f"export: the photos cover {sorted(result['orientations'])}")
    del kept, det, live_program
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def same_model_dirs(C, model_dirs):
    """``C.MODEL_DIR_DICT`` set to ``model_dirs`` (what a run of an earlier
    phase saw: later phases point the towers at directories of their own),
    restored on exit."""
    saved = dict(C.MODEL_DIR_DICT)
    C.MODEL_DIR_DICT.clear()
    C.MODEL_DIR_DICT.update(model_dirs)
    try:
        yield
    finally:
        C.MODEL_DIR_DICT.clear()
        C.MODEL_DIR_DICT.update(saved)


def scan_export_phase(torch, C, serve, run_mm_late, counters, per_step, per_window, training,
                      launches, tmp, unrolled, ckpt, lxmert_path):
    """The headline run with ``--scan_layers`` against the unrolled one
    (``unrolled``: its ``net.pth`` and the model directories it saw),
    ``serve --scan_layers`` of its artifact, and ``export --export_detector``
    of the seeded full-geometry detector, each logging its seconds."""
    unrolled_net, model_dirs = unrolled
    t0 = time.monotonic()
    result = {}
    with same_model_dirs(C, model_dirs):
        result["train"], scan_net = scan_layers_run(torch, C, run_mm_late, counters, per_step,
                                                    training, launches, tmp, unrolled_net)
        t1 = time.monotonic()
        result["serve"] = scan_layers_serve(
            torch, serve, counters, per_window, launches,
            {"unrolled": unrolled_net, "scan_layers": scan_net},
            same_state=result["train"]["tensors_differing"] == 0)
    t2 = time.monotonic()
    result["export"] = detector_export_check(torch, tmp, ckpt, lxmert_path)
    t3 = time.monotonic()
    result["seconds"] = dict(train=t1 - t0, serve=t2 - t1, export=t3 - t2, total=t3 - t0)
    log(f"scan_layers and detector export phase: {t3 - t0:.1f} s (training {t1 - t0:.1f}, "
        f"serving {t2 - t1:.1f}, export {t3 - t2:.1f})")
    return result


def scan_export_only():
    """``python3 chip_smoke.py --scan_export``: the kernels built, the
    headline run's unrolled ``fused`` run, a seeded detector checkpoint and
    a random LXMERT artifact, then the ``--scan_layers`` and detector export
    phase, without the last line: a quick run of this phase while it
    changes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late, serve
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as FR
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    set_precision_policy()
    memoize_init(torch)
    log(card_line())
    log(f"build: per source {_cuda.build()}")
    counters, none, per_step, _ = training_counts(A, AB)
    per_window = {**none, **SERVE_PER_WINDOW["auto"]}
    launches, training = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_dataset(tmp)
        C.DATA_PATH, C.PATH[3] = data, data + "data_key_mvsa.csv"
        C.IMG_FMT[3] = data + "MVSA-Single/data/{}.jpg"
        C.results_dir_mm_late = os.path.join(tmp, "results", "mm_late") + os.sep
        late_stem = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
        training["fused"], by_key, _ = train_run(
            torch, run_mm_late.main, train_args("fused"), "train[fused]", counters,
            C.results_dir_mm_late, late_stem, per_step["fused"],
            late_grads_check(torch, "train[fused]"))
        unrolled = (os.path.join(tmp, "unrolled_fused_net.pth"), dict(C.MODEL_DIR_DICT))
        shutil.copyfile(os.path.join(C.results_dir_mm_late, late_stem + "net.pth"), unrolled[0])
        ckpt = os.path.join(tmp, "hub_frcnn", "pytorch_model.bin")
        seeded_frcnn_checkpoint(torch, FR, FR.FrcnnConfig(), detector_photos(), ckpt)
        lxmert_path = os.path.join(tmp, "lxmert_random_net.pth")
        random_lxmert_artifact(torch, C, serve, lxmert_path)
        out = scan_export_phase(torch, C, serve, run_mm_late, counters, per_step, per_window,
                                training, launches, tmp, unrolled, ckpt, lxmert_path)
    log(json.dumps({"scan_export": out}, default=str))
    return 0


def make_requests(size=224):
    import numpy as np

    rng = np.random.RandomState(30)
    words = ("rain sun happy sad team win lose #news @user https://t.co/x "
             "love hate coffee city \U0001F60D \U0001F389 tonight again never "
             "best worst").split()
    reqs = []
    for i in range(N_REQUESTS):
        text = " ".join(rng.choice(words, size=rng.randint(1, 40)))
        image = rng.randint(0, 256, (size, size, 3), np.uint8) if i % 2 else None
        reqs.append((text, image))
    return reqs


def service_argv(model_path, attn_impl, extra=()):
    return ["--task", "3", "--txt_model_name", "bernice", "--img_model_name", "vit",
            "--fusion_name", "attention", "--arch", "base", "--dtype", "bfloat16",
            "--max_batch", str(BATCH), "--batch_window_ms", "20", "--seed", "30",
            "--attn_impl", attn_impl, "--model_path", model_path, "--port", "0", *extra]


def service_args(serve, model_path, attn_impl, extra=()):
    return serve.parse_args(service_argv(model_path, attn_impl, extra))


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


def run_service(torch, serve, A, AB, args, reqs, http_text, profile=True, info=None):
    """Serve ``reqs`` from several client threads plus one HTTP request;
    returns (answers, batcher stats with the ``/metrics`` text under
    ``metrics`` and the device memory under ``memory``, launch counts,
    seconds). The memory, in GiB: what was allocated before the build
    (after a collection: an earlier server's handler class holds its model
    in a reference cycle until one), the build's peak, what stays
    allocated after it, and the peak of the windows (the warm-up's and the
    requests'). ``profile``: ``profile_window`` after; ``info``: the
    service's ``export_info``."""
    gib = 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory = {"before": torch.cuda.memory_allocated() / gib}
    predict, meta = serve.build_service(args, export_info=info)
    torch.cuda.synchronize()
    memory.update(build_peak=torch.cuda.max_memory_allocated() / gib,
                  after_build=torch.cuda.memory_allocated() / gib)
    torch.cuda.reset_peak_memory_stats()
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
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            health["metrics"] = r.read().decode()
        health["memory"] = dict(memory, windows_peak=torch.cuda.max_memory_allocated() / gib)
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    counts = {"sdpa_fwd": dict(A.launches.by_key), "attn_block_fwd": dict(AB.launches.by_key)}
    if profile:
        profile_window(torch, predict, reqs[:BATCH], args.attn_impl)
    del predict
    torch.cuda.empty_cache()
    return answers + [http_answer], health, counts, seconds


# the serving model's launches a window: text 12 + vision 12 + the fusion head's SDPA
SERVE_PER_WINDOW = {"auto": {"sdpa_fwd": 25, "attn_block_fwd": 0},
                    "fused": {"sdpa_fwd": 1, "attn_block_fwd": 24}}


def serving_phase(torch, serve, A, AB, tmp, reqs, http_text):
    """The serving path at full width: random weights from a seed saved
    under ``tmp``, the plain path's answers, then ``serve[auto]`` and
    ``serve[fused]`` held against them with exact launches a window.
    Returns (the weights' path, the launches by (kernel, key), each run's
    probabilities and stats by impl, the launches expected a window)."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
        build_mm_late_setup)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        seed_everything)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
        save_params)

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

    per_window = SERVE_PER_WINDOW
    launches, served = {}, {}
    for impl, expect in per_window.items():
        answers, health, counts, seconds = run_service(
            torch, serve, A, AB, service_args(serve, model_path, impl), reqs, http_text)
        windows = health["windows"]
        log(f"serve[{impl}]: {health['requests']} requests in {windows} windows, "
            f"{len(reqs) / seconds:.1f} requests/s from {N_CLIENTS} clients, "
            f"mean window {health['mean_dispatch_ms']} ms, errors {health['errors']}, "
            f"{memory_text(health['memory'])}")
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
        count_launches(launches, counts)
        served[impl] = {"probs": probs, "health": health, "metrics": health["metrics"]}
    return model_path, launches, served, per_window


# ---- the serving extras: /metrics, --quantize w8, --extra_model, --workers,
# ---- --img_decoder native, cli/export.py ------------------------------------------

WORKER_REQUESTS = 48  # HTTP requests of the --workers comparison, from N_CLIENTS clients
# (h, w) of the JPEG photos: libjpeg decodes at 1/2^k while both sides stay >= 2^k x 224,
# so the first is decoded at full size and the others DCT-scaled (the last >= 2,000 px)
NATIVE_PHOTOS = ((300, 400), (480, 640), (720, 1280), (1800, 2400))


def metrics_check(health, body, tag):
    """The Prometheus exposition of a finished run against its /healthz:
    cumulative buckets, +Inf = count = windows, requests = /healthz's."""
    m = {}
    for line in body.splitlines():
        if line.strip() and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            m[key] = float(value)
    buckets = [v for k, v in m.items() if k.startswith("smtc_serving_dispatch_seconds_bucket")]
    if any(b > a for a, b in zip(buckets[1:], buckets)) or not buckets:
        raise AssertionError(f"{tag}: buckets not cumulative {buckets}")
    inf = m['smtc_serving_dispatch_seconds_bucket{le="+Inf"}']
    if not inf == m["smtc_serving_dispatch_seconds_count"] == m["smtc_serving_windows_total"] \
            == health["windows"]:
        raise AssertionError(f"{tag}: +Inf {inf}, count, windows and /healthz disagree: {m}")
    if m["smtc_serving_requests_total"] != health["requests"] or m["smtc_serving_errors_total"]:
        raise AssertionError(f"{tag}: requests {m['smtc_serving_requests_total']} vs /healthz "
                             f"{health['requests']}, errors {m['smtc_serving_errors_total']}")
    log(f"{tag}: /metrics: {int(inf)} windows in the histogram {[int(b) for b in buckets]}, "
        f"sum {m['smtc_serving_dispatch_seconds_sum']:.3f} s, {int(m['smtc_serving_requests_total'])}"
        " requests, as /healthz")


def check_window_counts(counts, windows, expect, tag):
    for kernel, n in expect.items():
        total = sum(counts[kernel].values())
        if total != n * windows:
            raise AssertionError(f"{tag}: {kernel} launched {total} times, expected "
                                 f"{n} x {windows}")


def window_allocations(torch, predict, window, tag, top=8):
    """The device allocations live at the peak of one ``predict(window)``,
    from the allocator's own trace (``torch.cuda.memory._record_memory_history``,
    Python frames): the window's peak above what was allocated before it and
    the largest live blocks, each with the port's innermost frame that made
    it. Informational: it checks nothing, and says so when the trace is
    unavailable. Returns {"peak_bytes": ..., "top": [(bytes, frame), ...]}."""
    mem = torch.cuda.memory
    predict(window)
    torch.cuda.synchronize()
    try:
        mem._record_memory_history(enabled="all", context="alloc", stacks="python",
                                   max_entries=200000)
        predict(window)
        torch.cuda.synchronize()
        snap = mem._snapshot()
    except Exception as e:  # noqa: BLE001 - an API of the allocator that may differ by version
        log(f"alloc[{tag}]: not measured ({type(e).__name__}: {e})")
        return None
    finally:
        try:
            mem._record_memory_history(enabled=None)
        except Exception:  # noqa: BLE001
            pass
    try:
        return _peak_allocations(snap, tag, top)
    except (KeyError, TypeError, ValueError) as e:
        log(f"alloc[{tag}]: not measured (the trace reads {type(e).__name__}: {e})")
        return None


def _peak_allocations(snap, tag, top):
    events = [e for trace in snap.get("device_traces", []) for e in trace]

    def where(frames):
        for f in frames or []:
            if "socialmedia_textimage" in f.get("filename", ""):
                name = f["filename"].split("socialmedia_textimage_classification_auxlosses_tpu_torch/")[-1]
                return f"{name}:{f.get('line')} {f.get('name')}"
        return "(outside the port)"

    live, cur, peak, at = {}, 0, 0, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            cur -= live.pop(e["addr"])
    blocks = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            blocks[e["addr"]] = (e["size"], where(e.get("frames")))
        elif e["action"] in ("free_requested", "free_completed"):
            blocks.pop(e["addr"], None)
    by_frame = {}
    for size, frame in blocks.values():
        by_frame[frame] = by_frame.get(frame, 0) + size
    ranked = sorted(by_frame.items(), key=lambda kv: -kv[1])[:top]
    log(f"alloc[{tag}]: a window's peak {peak / 2 ** 20:.1f} MiB above what was allocated "
        f"before it, {len(blocks)} blocks live there; largest by the port's frame: "
        + "; ".join(f"{b / 2 ** 20:.1f} MiB {f}" for f, b in ranked))
    return {"peak_bytes": peak, "top": [(b, f) for f, b in ranked]}


def memory_text(memory) -> str:
    over = {k: memory[k] - memory["before"] for k in ("build_peak", "after_build",
                                                        "windows_peak")}
    return (f"over the {memory['before']:.3f} GiB allocated before it: build peak "
            f"+{over['build_peak']:.3f} GiB, +{over['after_build']:.3f} GiB after it, windows "
            f"peak +{over['windows_peak']:.3f} GiB")


def resident_bytes(module) -> dict:
    """Bytes of ``module``'s parameters and buffers by dtype name."""
    out = {}
    for t in list(module.parameters()) + list(module.buffers()):
        key = str(t.dtype).removeprefix("torch.")
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def w8_phase(torch, serve, A, AB, launches, model_path, reqs, http_text, served, per_window):
    """``--quantize w8`` under ``auto`` and ``fused``: probabilities within
    ``W8_TOL`` of the plain path under w8 (``jnp`` + w8), max |dp| from the
    unquantized service, each timed service's quantized weights int8 and its
    resident weight bytes by dtype, the window ms and the device memory
    (``run_service``) beside the bfloat16 service's, the allocations live at
    one window's peak (``window_allocations``), and the launches per window
    those of the unquantized service."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import quant

    w8 = ("--quantize", "w8")
    every = reqs + [(http_text, None)]
    info = {}
    plain_predict, _ = serve.build_service(service_args(serve, model_path, "jnp", w8),
                                           export_info=info)
    A.launches.reset()
    AB.launches.reset()
    plain = [r for i in range(0, len(every), BATCH) for r in plain_predict(every[i:i + BATCH])]
    if A.launches.count or AB.launches.count:
        raise AssertionError("serve[jnp, w8]: the plain path launched a kernel")
    resident = resident_bytes(info["model"])
    qbytes, f32bytes = quant.quantized_bytes(info["w8"])
    n_quant = len(info["w8"].names)
    del plain_predict, info
    torch.cuda.empty_cache()
    plain_probs = np.array([p["probs"] for p in plain])
    log(f"serve[w8]: {n_quant} Dense kernels int8 ({qbytes} bytes; {f32bytes} in float32); "
        f"resident weight bytes by dtype {resident} (the other leaves stay float32, not cast)")
    out = {"quantized_kernels": n_quant, "int8_bytes": qbytes, "their_float32_bytes": f32bytes,
           "resident_bytes_by_dtype": resident}
    for impl, expect in per_window.items():
        tag = f"serve[{impl}, w8]"
        info = {}
        answers, health, counts, seconds = run_service(
            torch, serve, A, AB, service_args(serve, model_path, impl, w8), reqs, http_text,
            profile=False, info=info)
        w8_now, params = info["w8"], dict(info["model"].named_parameters())
        if (w8_now is None or len(w8_now.names) != n_quant
                or any(q.dtype != torch.int8 for q in w8_now.qs())
                or any(n in params for n in w8_now.names)):
            raise AssertionError(f"{tag}: the service's Dense kernels are not int8")
        resident_now = resident_bytes(info["model"])
        window = info["make_batch"](reqs[:BATCH])
        device_batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in window.items()}
        with torch.inference_mode():
            allocations = window_allocations(torch, info["predict"], device_batch, tag)
        del info, w8_now, params, device_batch
        torch.cuda.empty_cache()
        log(f"{tag}: {n_quant} Dense kernels int8; resident weight bytes by dtype "
            f"{resident_now}")
        windows = health["windows"]
        if health["errors"] or health["requests"] != len(reqs) + 1:
            raise AssertionError(f"{tag}: {health}")
        probs = np.array([a["probs"] for a in answers])
        if probs.shape != plain_probs.shape or not np.isfinite(probs).all():
            raise AssertionError(f"{tag}: bad probabilities {probs.shape}")
        err = float(np.abs(probs - plain_probs).max())
        drift = float(np.abs(probs - served[impl]["probs"]).max())
        log(f"{tag}: {health['requests']} requests in {windows} windows, "
            f"{len(reqs) / seconds:.1f} requests/s, mean window {health['mean_dispatch_ms']} ms "
            f"(bf16 service {served[impl]['health']['mean_dispatch_ms']} ms); "
            f"{memory_text(health['memory'])} (bf16 service "
            f"{memory_text(served[impl]['health']['memory'])}); max |p - "
            f"p_plain(w8)| {err:.3e} (tol {W8_TOL}), max |p - "
            f"p_unquantized| {drift:.3e}")
        if not err <= W8_TOL:
            raise AssertionError(f"{tag}: disagrees with the plain path under w8")
        check_window_counts(counts, windows, expect, tag)
        count_launches(launches, counts)
        out[impl] = dict(requests_per_s=len(reqs) / seconds,
                         mean_window_ms=health["mean_dispatch_ms"],
                         bf16_mean_window_ms=served[impl]["health"]["mean_dispatch_ms"],
                         memory_gib=health["memory"],
                         bf16_memory_gib=served[impl]["health"]["memory"],
                         resident_bytes_by_dtype=resident_now,
                         window_allocations=allocations, max_abs_prob_err=err,
                         max_abs_dp_vs_unquantized=drift)
    return out


def extra_model_phase(torch, serve, A, AB, launches, model_path, reqs, served, per_window):
    """One server, ``default`` (``auto``) and ``--extra_model e:attn_impl=fused``
    over the same weights: ``N_CLIENTS`` clients split across the two
    batchers and one HTTP request a route; each route's answers equal that
    model's single-model service's, ``/metrics`` carries both labels, and
    each model's windows launch its kernels."""
    import numpy as np

    args = service_args(serve, model_path, "auto", ("--extra_model", "e:attn_impl=fused"))
    predict, meta = serve.build_service(args)
    serve.warm_service(args, predict)
    name, margs = serve.parse_model_spec(args, args.extra_model[0])
    predict_e, meta_e = serve.build_service(margs)
    serve.warm_service(margs, predict_e)
    torch.cuda.synchronize()
    A.launches.reset()
    AB.launches.reset()
    batchers = {"auto": serve.MicroBatcher(predict, args.max_batch, args.batch_window_ms),
                "fused": serve.MicroBatcher(predict_e, margs.max_batch, margs.batch_window_ms)}
    server = serve.make_server(args, batchers["auto"], meta, {name: (batchers["fused"], meta_e)})
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * len(reqs)
    try:
        def client(c):
            for i in range(c, len(reqs), N_CLIENTS):
                answers[i] = batchers["auto" if c % 2 else "fused"].submit(*reqs[i])

        t0 = time.monotonic()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
            if c.is_alive():
                raise AssertionError("extra_model: a client thread did not finish")
        seconds = time.monotonic() - t0
        http = {route: http_post(port, route, {"text": "a route request #weather"})
                for route in ("/classify", f"/classify/{name}")}
        health = http_get(port, "/healthz")
        body = http_get(port, "/metrics", raw=True)
    finally:
        server.shutdown()
        for b in batchers.values():
            b.close()
        server.server_close()
        thread.join(timeout=30)
    counts = {"sdpa_fwd": dict(A.launches.by_key), "attn_block_fwd": dict(AB.launches.by_key)}
    routes = {"auto": health, "fused": health["models"][name]}
    for impl, h in routes.items():
        if h["errors"] or h["requests"] != len(reqs) // 2 + 1:
            raise AssertionError(f"extra_model[{impl}]: {h}")
    windows = {impl: h["windows"] for impl, h in routes.items()}
    for kernel in ("sdpa_fwd", "attn_block_fwd"):
        want = sum(per_window[impl][kernel] * w for impl, w in windows.items())
        if sum(counts[kernel].values()) != want:
            raise AssertionError(f"extra_model: {kernel} launched {sum(counts[kernel].values())}"
                                 f" times, expected {want} over windows {windows}")
    count_launches(launches, counts)
    err = 0.0
    for i, ans in enumerate(answers):
        impl = "auto" if (i % N_CLIENTS) % 2 else "fused"
        err = max(err, float(np.abs(np.array(ans["probs"]) - served[impl]["probs"][i]).max()))
    for label in ("default", name):
        if f'smtc_serving_requests_total{{model="{label}"}} {len(reqs) // 2 + 1}' not in body:
            raise AssertionError(f"extra_model: /metrics lacks model={label!r}:\n{body}")
    log(f"extra_model: {len(reqs)} requests split over /classify (auto) and /classify/{name} "
        f"(fused) in {seconds:.2f} s, windows {windows}; max |p - p_single-model service| "
        f"{err:.3e}; /metrics labels default and {name}; HTTP answers "
        f"{[len(a['probs']) for a in http.values()]} classes")
    if not err <= 1e-5:
        raise AssertionError("extra_model: a route disagrees with its single-model service")
    del predict, predict_e
    torch.cuda.empty_cache()
    return dict(windows=windows, max_abs_dp_vs_single=err, seconds=seconds)


def http_post(port, path, payload, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_get(port, path, raw=False, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        body = r.read()
    return body.decode() if raw else json.loads(body)


def png_payloads(reqs):
    """Requests as HTTP bodies: text, and the uint8 image as a base64 PNG
    (lossless, so the server decodes the same pixels)."""
    import base64
    import io

    from PIL import Image

    out = []
    for text, img in reqs:
        body = {"text": text}
        if img is not None:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            body["image_b64"] = base64.b64encode(buf.getvalue()).decode()
        out.append(body)
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_load(port, payloads):
    """``payloads`` from ``N_CLIENTS`` HTTP clients -> (requests/s, answers)."""
    answers = [None] * len(payloads)

    def client(c):
        for i in range(c, len(payloads), N_CLIENTS):
            answers[i] = http_post(port, "/classify", payloads[i])

    t0 = time.monotonic()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
        if c.is_alive():
            raise AssertionError("a client did not finish")
    return len(payloads) / (time.monotonic() - t0), answers


def healthz_pids(port, want, tries=200):
    """The pids that answer ``/healthz`` over fresh connections (the kernel
    spreads them over the workers), until they are ``want``."""
    pids = set()
    for _ in range(tries):
        pids.add(http_get(port, "/healthz")["pid"])
        if pids == want:
            break
    return pids


def start_workers(model_path):
    """``serve --workers 2`` as a subprocess (its own process group) on an
    explicit port over the saved weights -> (process, its stderr lines as
    they come, port)."""
    port = free_port()
    argv = [sys.executable, "-m", f"{PKG}.cli.serve",
            *service_argv(model_path, "auto", ("--port", str(port), "--workers", "2"))]
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                     daemon=True).start()
    return proc, lines, port


def stop_group(proc):
    """Kill ``proc``'s process group if it still runs."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def workers_phase(proc, lines, port, reqs, served, deadline_s=600):
    """``start_workers``' supervisor: wait until both workers log that they
    serve, send the requests (PNG images) from ``N_CLIENTS`` HTTP clients
    and see both pids answer; then SIGTERM the first worker alone (it drains
    and exits 0, the supervisor reaps it), send the same load to the one left
    (requests/s of one worker, the same process and port), and SIGTERM the
    supervisor: rc 0 within the bound, every worker reaped. The answers
    match the in-process ``auto`` service."""
    import re
    import signal

    import numpy as np

    payloads = png_payloads(reqs)
    want = served["auto"]["probs"][:len(reqs)]
    serving = re.compile(r" - serving .* on 127\.0\.0\.1:\d+ \(pid (\d+),")
    deadline = time.monotonic() + deadline_s
    out = {}
    while len(serving.findall("".join(lines))) < 2:
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"workers: not serving (rc {proc.poll()}):\n"
                                 + "".join(lines)[-3000:])
        time.sleep(0.5)
    started = {int(p) for p in serving.findall("".join(lines))}
    spawned = [int(p) for p in re.findall(r"worker \d+/2 pid=(\d+)", "".join(lines))]
    for n, alive in ((2, started), (1, started - {spawned[0]})):
        if n == 1:  # the first worker drains and exits; the supervisor reaps it
            os.kill(spawned[0], signal.SIGTERM)
            while os.path.exists(f"/proc/{spawned[0]}"):
                if time.monotonic() > deadline:
                    raise AssertionError(f"workers: worker {spawned[0]} not reaped")
                time.sleep(0.1)
        else:  # each worker's first requests (decoders, lazy imports) out of the timing
            http_load(port, payloads[:2 * N_CLIENTS])
        rate, answers = http_load(port, payloads)
        pids = healthz_pids(port, alive)
        err = float(np.abs(np.array([a["probs"] for a in answers]) - want).max())
        log(f"workers[{n}]: {len(payloads)} HTTP requests from {N_CLIENTS} clients at "
            f"{rate:.1f} requests/s; pids answering /healthz {sorted(pids)} of serving "
            f"{sorted(alive)}; max |p - p_in-process| {err:.3e}")
        if pids != alive or set(spawned) != started:
            raise AssertionError(f"workers[{n}]: spawned {spawned}, serving {started}, "
                                 f"answered {pids}")
        if not err <= PROB_TOL:
            raise AssertionError(f"workers[{n}]: answers disagree with the in-process service")
        out[n] = dict(requests_per_s=rate, max_abs_dp=err)
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    stop_s = time.monotonic() - t0
    alive = [p for p in spawned if os.path.exists(f"/proc/{p}")]
    log(f"workers: 2 workers {out[2]['requests_per_s']:.1f} requests/s against 1 worker "
        f"{out[1]['requests_per_s']:.1f} (x{out[2]['requests_per_s'] / out[1]['requests_per_s']:.2f}"
        f"); SIGTERM to the supervisor -> rc {rc} in {stop_s:.2f} s; workers not reaped {alive}")
    if rc != 0 or stop_s > 60 or alive:
        raise AssertionError(f"workers: rc {rc} after {stop_s:.1f} s, alive {alive}")
    out["stop_s"] = stop_s
    return out


def photo_bytes(h, w, seed, fmt):
    """A photo-like image (a smooth field upscaled from a coarse grid) as
    encoded bytes."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (max(2, h // 60), max(2, w // 60), 3), np.uint8)
    img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def native_phase(torch, serve, model_path, tmp):
    """``--img_decoder native``: whether ``imgdec.cpp`` built here (the
    compiler's message if not). Built: PNG and JPEG (one 2400 x 1800, the
    DCT-scaled path) against PIL at the JAX package's bounds, decode ms an
    image native against PIL, and photo requests served with the native
    decoder within ``PROB_TOL`` of the same service fed PIL's pixels. Not
    built: the JAX warning is logged and PIL's answer is served."""
    import base64
    import io
    import logging

    import numpy as np
    from PIL import Image

    from socialmedia_textimage_classification_auxlosses_tpu_torch.data import images, native

    built = native.imgdec_available()
    log(f"native: imgdec.cpp built: {built}"
        + ("" if built else f"; the compiler said: {native.build_error()}"))
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep()
    logging.getLogger(f"{PKG}.cli.serve").addHandler(keep)
    try:
        args = service_args(serve, model_path, "auto", ("--img_decoder", "native"))
        predict, meta = serve.build_service(args)
    finally:
        logging.getLogger(f"{PKG}.cli.serve").removeHandler(keep)
    size = 224
    photos = [(h, w, "JPEG") for h, w in NATIVE_PHOTOS] + [(300, 400, "PNG")]
    encoded = [photo_bytes(h, w, i, fmt) for i, (h, w, fmt) in enumerate(photos)]
    payloads = [{"image_b64": base64.b64encode(e).decode()} for e in encoded]
    pil_px = [images.resize_to_u8(serve._decode_image(p), size) for p in payloads]
    out = {"built": built}
    if not built:
        if meta["native_size"] is not None or not any(
                "imgdec build unavailable; serving with PIL decode" in r for r in records):
            raise AssertionError("native: no PIL fallback warning")
        got = serve._decode_image(payloads[0], None, meta["native_size"])
        if isinstance(got, np.ndarray):
            raise AssertionError("native: a decoder that did not build decoded")
        log("native: the PIL fallback and its warning (as the JAX service)")
        out["error"] = native.build_error()
        del predict
        return out
    if meta["native_size"] != size:
        raise AssertionError(f"native: native_size {meta['native_size']}")
    nat_px = [serve._decode_image(p, None, size) for p in payloads]
    for (h, w, fmt), e, nat, pil in zip(photos, encoded, nat_px, pil_px):
        path = os.path.join(tmp, f"photo_{h}x{w}.{fmt.lower()}")
        with open(path, "wb") as f:
            f.write(e)
        diff = np.abs(nat.astype(int) - pil.astype(int))
        if fmt == "JPEG" and min(h, w) // 2 >= size:  # the DCT-scaled decode: PSNR
            mse = float((diff.astype(float) ** 2).mean())
            psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-9))
            if psnr < 45.0:
                raise AssertionError(f"native: {h}x{w} PSNR {psnr:.1f} dB < 45")
            log(f"native: {w}x{h} JPEG (DCT-scaled) PSNR {psnr:.1f} dB against PIL")
        else:
            if diff.max() > 2:
                raise AssertionError(f"native: {h}x{w} {fmt} resize {diff.max()} LSB from PIL")
            full = native.native_decode_full(path)
            pil_full = np.asarray(Image.open(io.BytesIO(e)).convert("RGB"))
            if not np.array_equal(full, pil_full):
                raise AssertionError(f"native: {h}x{w} {fmt} full decode differs from PIL")
    t_nat, t_pil = [], []
    for e in encoded:
        t0 = time.perf_counter()
        native.native_decode_resize_mem(e, size)
        t_nat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        images.resize_to_u8(Image.open(io.BytesIO(e)).convert("RGB"), size)
        t_pil.append((time.perf_counter() - t0) * 1e3)
    texts = [f"a photo {i} #weather" for i in range(len(photos))]
    a = predict(list(zip(texts, nat_px)))
    b = predict(list(zip(texts, pil_px)))
    err = float(np.abs(np.array([x["probs"] for x in a]) - np.array([x["probs"] for x in b])).max())
    log("native: decode + resize ms an image, native / PIL: " + ", ".join(
        f"{w}x{h} {fmt} {n:.2f} / {p:.2f}" for (h, w, fmt), n, p in zip(photos, t_nat, t_pil))
        + f"; served photos max |p_native - p_PIL| {err:.3e} (tol {PROB_TOL})")
    if not err <= PROB_TOL:
        raise AssertionError("native: the native decoder's answers are not PIL's")
    del predict
    torch.cuda.empty_cache()
    out.update(decode_ms_native=t_nat, decode_ms_pil=t_pil, max_abs_dp_vs_pil=err)
    return out


def export_phase(torch, serve, A, AB, launches, model_path, per_window, tmp):
    """``cli/export.py`` of the ``auto`` service for ``cuda`` at full width:
    the program holds the ``torch.library`` op nodes, is saved, loaded and
    run; its probabilities within 1e-5 of the live predict, and its run
    launches the hand-written kernels as many times as one live window."""
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import export

    args = service_args(serve, model_path, "auto")
    t0 = time.monotonic()
    exported, sidecar, _, info, sample = export.export_service(args, ["cuda"])["cuda"]
    export_s = time.monotonic() - t0
    ops = {}
    for node in exported.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("smtc."):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    path = os.path.join(tmp, "serving.cuda.pt2")
    torch.export.save(exported, path)
    size = os.path.getsize(path)
    t0 = time.monotonic()
    program = torch.export.load(path).module()
    load_s = time.monotonic() - t0
    with torch.no_grad():
        live = info["predict"](dict(sample)).float().cpu().numpy()
        program(*sample.values())  # first run out of the count
        torch.cuda.synchronize()
        A.launches.reset()
        AB.launches.reset()
        back = program(*sample.values()).float().cpu().numpy()
    counts = {"sdpa_fwd": dict(A.launches.by_key), "attn_block_fwd": dict(AB.launches.by_key)}
    err = float(np.abs(live - back).max())
    log(f"export[cuda]: {export_s:.1f} s to export, {size} bytes, loaded in {load_s:.1f} s; "
        f"op nodes {ops}; launches of one run {counts}; max |p - p_live| {err:.3e} "
        f"(bit-equal: {np.array_equal(live, back)})")
    if ops.get("smtc.sdpa_fwd.default", 0) != per_window["auto"]["sdpa_fwd"]:
        raise AssertionError(f"export: the program holds op nodes {ops}")
    check_window_counts(counts, 1, per_window["auto"], "export[cuda]")
    if not err <= 1e-5:
        raise AssertionError("export: the loaded program disagrees with the live predict")
    count_launches(launches, counts)
    if sidecar["platforms"] != ["cuda"] or "smtc::sdpa_fwd" not in sidecar["format"]:
        raise AssertionError(f"export: sidecar {sidecar}")
    del exported, program, info
    torch.cuda.empty_cache()
    return dict(export_s=export_s, bytes=size, load_s=load_s, op_nodes=ops,
                max_abs_dp=err, bit_equal=bool(np.array_equal(live, back)))


def serve_extras_phase(torch, serve, A, AB, launches, model_path, reqs, http_text, served,
                       per_window, tmp):
    """The serving extras over the serving phase's weights and runs, in
    order: ``/metrics`` of ``serve[auto]``, w8, ``--extra_model``,
    ``--img_decoder native``, ``cli/export.py`` (these three while the
    ``--workers 2`` subprocess starts), ``--workers 2``."""
    t0 = time.monotonic()
    metrics_check(served["auto"]["health"], served["auto"]["metrics"], "serve[auto]")
    out = {"w8": w8_phase(torch, serve, A, AB, launches, model_path, reqs, http_text, served,
                          per_window)}
    # the two workers come up (load, cast, warm-up) beside the next three checks, whose
    # timings are informational
    proc, lines, port = start_workers(model_path)
    try:
        out["extra_model"] = extra_model_phase(torch, serve, A, AB, launches, model_path, reqs,
                                               served, per_window)
        out["native"] = native_phase(torch, serve, model_path, tmp)
        out["export"] = export_phase(torch, serve, A, AB, launches, model_path, per_window, tmp)
        out["workers"] = workers_phase(proc, lines, port, reqs, served)
    finally:
        stop_group(proc)
    out["seconds"] = time.monotonic() - t0
    log(f"serve_extras: every check passed in {out['seconds']:.1f} s")
    return out


def training_counts(A, AB):
    """The launch counters by kernel, the zero counts, and the expected
    launches per train and eval step of late fusion (``auto``, ``fused``)
    and of the text-only runner (``fused``)."""
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
    txt_step = {"train": {**none, "attn_block_fwd": 12, "attn_block_bwd": 12,
                          "gemm_tn_bf16": 12},
                "eval": {**none, "attn_block_fwd": 12}}
    return counters, none, per_step, txt_step


def bucket_only():
    """``python3 chip_smoke.py --bucket``: the kernels built, then the
    bucketing phase and the BEiT sweep alone on the generated posts, every
    (kernel, shape) they launched held against its plain version, without
    the last line: a quick run of these phases while they change."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as build
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        run_mm_late, run_seed_sweep, run_txt)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    set_precision_policy()
    init_memo = memoize_init(torch)
    log(card_line())
    log(f"build: per source {_cuda.build()}")
    counters, _, per_step, txt_step = training_counts(A, AB)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_dataset(tmp)
        C.DATA_PATH, C.PATH[3] = data, data + "data_key_mvsa.csv"
        C.results_dir_mm_late = os.path.join(tmp, "results", "mm_late") + os.sep
        C.results_dir_txt = os.path.join(tmp, "results", "txt") + os.sep
        out = {"beit_sweep": beit_sweep(torch, C, run_mm_late, run_seed_sweep, counters,
                                        per_step, launches),
               "bucket": bucket_phase(torch, C, run_mm_late, run_txt, build, counters,
                                      per_step, txt_step, launches,
                                      {"fused": None}, tmp)}
    log(json.dumps({"training": out}))
    rows = rows_for_every_launch(torch, AB, [], launches)
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "key"} for r in rows]}))
    log(f"init memo: {init_memo['hits']} builds copied, {init_memo['misses']} drawn, "
        f"{init_memo['bytes'] / 2 ** 30:.2f} GiB held")
    return 0


def serve_extras_only():
    """``python3 chip_smoke.py --serve_extras``: the kernels built, the
    serving phase and the serving extras alone at full width, every
    (kernel, shape) they launched held against its plain version, without
    the last line: a quick run of these phases while they change."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    set_precision_policy()
    init_memo = memoize_init(torch)
    log(card_line())
    log(f"build: per source {_cuda.build()}")
    reqs = make_requests()
    http_text = "an http request about the #weather @user"
    with tempfile.TemporaryDirectory() as tmp:
        model_path, launches, served, per_window = serving_phase(torch, serve, A, AB, tmp, reqs,
                                                                 http_text)
        extras = serve_extras_phase(torch, serve, A, AB, launches, model_path, reqs, http_text,
                                    served, per_window, tmp)
    log(json.dumps({"serve_extras": extras}, default=str))
    rows = rows_for_every_launch(torch, AB, [], launches)
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "key"} for r in rows]}))
    log(f"init memo: {init_memo['hits']} builds copied, {init_memo['misses']} drawn, "
        f"{init_memo['bytes'] / 2 ** 30:.2f} GiB held")
    return 0


def main():
    import torch

    started = time.monotonic()
    clock = [started]

    def lap(name):
        """Log the seconds since the last lap: where the script's time goes."""
        now = time.monotonic()
        log(f"phase {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    if any(m == JAX_PKG or m.startswith(JAX_PKG + ".") or m.split(".")[0] in ("jax", "flax")
           for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    # the port's float32 policy (TF32 off) for the kernel comparisons; every
    # runner sets it again when it resolves its device (train_run checks)
    set_precision_policy()
    init_memo = memoize_init(torch)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.monotonic()
    secs = _cuda.build()
    log(f"build: {time.monotonic() - t0:.1f} s wall; per source {secs}")
    lap("kernels: imports and build")
    for name in _cuda.SOURCES:
        log_ptxas(name, _cuda.build_log(name))
    log_occupancy(A, AB)
    log_sass(_cuda)
    lap("kernels: ptxas, occupancy and SASS")
    gemm_rows, tn_rows = time_gemm(torch, AB)
    enqueue = time_enqueue(torch, AB)
    lap("kernels: GEMM and enqueue timings")
    rows = check_kernels(torch)
    lap("kernels: forward checks")
    rows += check_bwd_kernels(torch) + tn_rows
    lap("kernels: backward checks")
    perhead_rows, perhead_launches, perhead_vs_packed = check_perhead_kernels(torch)
    rows += perhead_rows

    lap("kernels")
    reqs = make_requests()
    http_text = "an http request about the #weather @user"
    with tempfile.TemporaryDirectory() as tmp:
        model_path, launches, served, per_window = serving_phase(torch, serve, A, AB, tmp, reqs,
                                                                 http_text)
        lap("serving")
        # /metrics, --quantize w8, --extra_model, --workers 2, --img_decoder
        # native and cli/export.py over the same weights
        extras = serve_extras_phase(torch, serve, A, AB, launches, model_path, reqs, http_text,
                                    served, per_window, tmp)

    lap("serve extras")
    # the training paths: one-epoch runs of run_mm_late and of run_mm_early
    # (ViLT) under auto and fused, and their first-step checks
    import csv

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as build
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        _build_early as build_early)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import (
        run_grid, run_img, run_mm_early, run_mm_late, run_seed_sweep, run_txt)

    counters, none, per_step, txt_step = training_counts(A, AB)
    training = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_dataset(tmp)
        C.DATA_PATH = data
        C.PATH[3] = data + "data_key_mvsa.csv"
        C.IMG_FMT[3] = data + "MVSA-Single/data/{}.jpg"  # never read: the cache holds every id
        C.results_dir_mm_late = os.path.join(tmp, "results", "mm_late") + os.sep
        late_stem = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
        eager_kernels = {}
        for impl, expect in per_step.items():
            tag = f"train[{impl}]"
            training[impl], by_key, eager_kernels[impl] = train_run(
                torch, run_mm_late.main, train_args(impl), tag, counters,
                C.results_dir_mm_late, late_stem, expect, late_grads_check(torch, tag),
                after=optimizer_reading(torch, tag) if impl == "auto" else None)
            count_launches(launches, by_key)
            if impl == "fused":  # the unrolled run the --scan_layers run is held to
                unrolled = (os.path.join(tmp, "unrolled_fused_net.pth"),
                            dict(C.MODEL_DIR_DICT))
                shutil.copyfile(os.path.join(C.results_dir_mm_late, late_stem + "net.pth"),
                                unrolled[0])
        no_added_f32_gemm(training["fused"], training["auto"], "train")
        # the same run at --steps_per_dispatch 3: every step a CUDA graph replay
        tag = "train[fused, K=3]"
        training["fused/k3"], by_key, _ = train_run(
            torch, run_mm_late.main, train_args("fused"), tag, counters, C.results_dir_mm_late,
            late_stem, per_step["fused"], late_grads_check(torch, tag), k=3,
            eager_kernels=eager_kernels["fused"])
        training["fused/k3"]["loss_rel_vs_k1"] = same_losses(training["fused/k3"],
                                                             training["fused"], tag)
        count_launches(launches, by_key)
        lap("train late")
        # --opt_impl lazy_emb, --cache_vision and --tim_reuse_text on the same run
        training["lazy"] = lazy_phase(torch, C, run_mm_late, counters, per_step, training,
                                      launches, eager_kernels)
        lap("lazy")
        # the seed sweep: the same model under three seeds in one seed-stacked run
        training["sweep"] = sweep_phase(torch, C, run_mm_late, build, run_seed_sweep, counters,
                                        per_step, training, launches,
                                        os.path.join(tmp, "hub_sweep"))
        lap("sweep")
        # the text-only runner (Bernice-base, CLS head) under fused, K = 1 and 3
        C.results_dir_txt = os.path.join(tmp, "results", "txt") + os.sep
        for k in (1, 3):
            tag = f"txt[fused, K={k}]"
            training[f"txt/fused/k{k}"], by_key, kernels = train_run(
                torch, run_txt.main, txt_args("fused"), tag, counters, C.results_dir_txt,
                "bernice_task3_seed30_", txt_step, txt_grads_check(torch, tag), k=k,
                eager_kernels=eager_kernels.get("txt/fused"))
            eager_kernels.setdefault("txt/fused", kernels)
            count_launches(launches, by_key)
        training["txt/fused/k3"]["loss_rel_vs_k1"] = same_losses(
            training["txt/fused/k3"], training["txt/fused/k1"], "txt[fused, K=3]")
        lap("txt")
        # sequence bucketing on tweet-like posts: one CUDA graph per width
        training["bucket"] = bucket_phase(torch, C, run_mm_late, run_txt, build, counters,
                                          per_step, txt_step, launches, eager_kernels, tmp)
        lap("bucket")
        # the image-only runner and the BEiT / ResNet late-fusion paths
        training["image"] = image_phase(torch, C, run_img, run_mm_late, build, counters, none,
                                        launches, tmp)
        lap("image")
        training["first_step"] = late_first_step(torch, C, run_mm_late, build,
                                                 os.path.join(tmp, "hub"))

        lap("late first step")
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
        for impl, k in (("auto", 1), ("fused", 1), ("fused", 3)):
            expect = vilt_step[impl]
            tag = f"vilt[{impl}]" if k == 1 else f"vilt[{impl}, K={k}]"
            seen.clear()
            run = f"vilt/{impl}" if k == 1 else f"vilt/{impl}/k{k}"
            training[run], by_key, kernels = train_run(
                torch, run_mm_early.main, vilt_args(impl), tag, counters,
                C.results_dir_mm_early, "vilt_task3_seed30_itc0.1itm0.1_", expect,
                vilt_grads_check(torch, tag), k=k,
                eager_kernels=eager_kernels[f"vilt/{impl}"] if k > 1 else None)
            if k == 1:
                eager_kernels[f"vilt/{impl}"] = kernels
            else:
                training[run]["loss_rel_vs_k1"] = same_losses(
                    training[run], training[f"vilt/{impl}"], tag)
            check_vilt_extents(memo, seen, tag)
            lengths = {key[3] if kernel.startswith("sdpa") else key[2]
                       for kernel, keys in by_key.items() for key in keys
                       if kernel != "gemm_tn_bf16"}
            # the weight gradients' K: the 2B x 402 token rows
            lengths |= {key[0] // (2 * BATCH) for key in by_key["gemm_tn_bf16"]}
            if lengths != {VILT_LEN}:
                raise AssertionError(f"{tag}: attention at lengths {sorted(lengths)}, "
                                     f"expected only {VILT_LEN}")
            count_launches(launches, by_key)
        no_added_f32_gemm(training["vilt/fused"], training["vilt/auto"], "vilt")
        training["vilt/resume"] = vilt_resume_check(torch, C, run_mm_early)
        training["vilt/remat"] = vilt_remat_check(torch, C, run_mm_early, build_early,
                                                  os.path.join(tmp, "hub_remat"))
        training["vilt/first_step"] = vilt_first_step(torch, C, run_mm_early, build_early,
                                                      os.path.join(tmp, "hub"))
        lap("vilt")
        # LXMERT and MMBT early fusion, the grid ROI fallback, and the
        # services of ViLT and MMBT
        training["early"] = early_phase(torch, C, run_mm_early, build_early, counters, none,
                                        launches, tmp, data, ids, eager_kernels)
        lap("early")
        training["early_serve"] = early_serve_phase(torch, C, serve, A, AB, launches, tmp)
        lap("early serve")
        # the Faster R-CNN, the cacher and serve --model lxmert over the
        # LXMERT artifact the early phase left
        training["detector"] = detector_phase(
            torch, C, serve, build_early, A, AB, launches, tmp,
            os.path.join(C.results_dir_mm_early, LXMERT_STEM + "net.pth"))

        lap("detector")
        # --scan_layers: the headline run against the unrolled one, and its service;
        # export --export_detector of the detector phase's checkpoint
        training["scan_export"] = scan_export_phase(
            torch, C, serve, run_mm_late, counters, per_step, {**none, **per_window["auto"]},
            training, launches, tmp, unrolled, training["detector"]["checkpoint"],
            os.path.join(C.results_dir_mm_early, LXMERT_STEM + "net.pth"))
        lap("scan layers and detector export")
        # a JAX-layout artifact served, and the paper's grid under both backends
        training["jax_artifact"] = jax_artifact_phase(
            torch, C, serve, counters, {**none, **per_window["auto"]}, launches, tmp)
        lap("jax artifact")
        training["grid"] = grid_phase(torch, C, run_grid, counters, launches, tmp)
        lap("grid")
        # the late-fusion towers from checkpoints, and --import_reference_ckpt
        training["pretrained"] = pretrained_start(torch, C, run_mm_late, counters)
        lap("pretrained")
        # RoBERTa-base from its vocab.json + merges.txt and model.safetensors, the
        # tokenizer layouts on the host, the native encoders
        training["roberta"] = roberta_phase(torch, C, run_txt, build, counters, none, launches,
                                            tmp)
    lap("roberta")
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder, vilt
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim

    training["optimizer"] = optimizer_launches(torch, optim, vilt, encoder)
    log(json.dumps({"serve_extras": extras}, default=str))
    log(json.dumps({"training": training}))
    log(json.dumps({"perhead_vs_packed": perhead_vs_packed}))
    log(json.dumps(gemm_rows))
    log(json.dumps({"enqueue": enqueue}))
    launches.update(perhead_launches)
    lap("optimizer")
    # every shape a main path launched, held against its plain version
    rows += rows_for_every_launch(torch, AB, rows, launches)

    lap("rows")
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
    log(f"init memo: {init_memo['hits']} builds copied, {init_memo['misses']} drawn, "
        f"{init_memo['bytes'] / 2 ** 30:.2f} GiB held")
    precision_check(torch, "the end of the run")
    log(f"chip_smoke: every phase passed in {time.monotonic() - started:.1f} s")
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
        if sys.argv[1:2] == ["--optimizer"] and len(sys.argv) == 3:
            sys.exit(optimizer_only(sys.argv[2]))
        if sys.argv[1:2] == ["--sweep_profile"] and len(sys.argv) == 3:
            sys.exit(sweep_profile(sys.argv[2]))
        if sys.argv[1:] == ["--bucket"]:
            sys.exit(bucket_only())
        if sys.argv[1:] == ["--detector"]:
            sys.exit(detector_only())
        if sys.argv[1:] == ["--scan_export"]:
            sys.exit(scan_export_only())
        if sys.argv[1:] == ["--serve_extras"]:
            sys.exit(serve_extras_only())
        if sys.argv[1:] == ["--roberta"]:
            sys.exit(roberta_only())
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
