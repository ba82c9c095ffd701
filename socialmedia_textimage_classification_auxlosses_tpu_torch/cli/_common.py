"""Shared CLI plumbing: the trainers' flags, architecture presets, artifact
names, seeding, the CSV writers.

Counterpart of the JAX package's ``cli/_common.py``. ``add_common_args``
declares the JAX package's whole flag surface plus ``--device``, so a command
line for one package parses for the other; ``check_training_supported``
refuses, with ``SystemExit``, every value that selects something the port
does not have yet. ``--prng_impl`` is accepted and logged only: the port's
draws come from ``torch.Generator``.

``--scan_layers`` is accepted by every trainer. In the JAX package it changes
only the parameter layout: ``nn.scan`` over one stacked ``layers/layer``
tree computes what the unrolled stack computes. The port always trains its
unrolled modules, so a run with the flag is the run without it, bit for bit,
and writes the same ``net.pth`` (the port's torch state dict); it still reads
a JAX artifact in either layout (``train/checkpoint.py::load_params``), and
under ``--load_saved_model --quantize w8`` the flag keeps the stacked layer
kernels out of the quantization, as in JAX (``ops/quant.py``). Two JAX
quirks are not copied: JAX's scanned branch ignores ``--remat`` (its
``nn.remat`` wraps the unrolled branch only), where the port recomputes each
layer under ``--remat`` with or without the flag, which gives the same
numbers; and JAX's scanned random init and dropout draw other streams
(``split_rngs``) than its unrolled ones, which the port never matched
(it draws from ``torch.Generator``).
"""

from __future__ import annotations

import argparse
import csv
import os
import random

import numpy as np
import torch

ARCH_PRESETS = {
    "base": {},
    "small": dict(hidden=256, layers=4, heads=4, mlp_dim=512),
    "tiny": dict(hidden=64, layers=2, heads=2, mlp_dim=128),
}


def add_common_args(parser: argparse.ArgumentParser, multimodal: bool = False):
    """The JAX package's common trainer flags, plus ``--device``."""
    parser.add_argument("--task", type=int, choices=[0, 1, 2, 3, 4, 5, 6],
                        help="task to run")
    parser.add_argument("--epochs", type=int, default=2, help="number of epochs")
    parser.add_argument("--weight_decay", type=float, default=0.00025,
                        help="weight decay param")
    parser.add_argument("--lr", type=float, default=1e-5, help="learning rate param")
    parser.add_argument("--dropout", type=float, default=0.05,
                        help="dropout of the classification head")
    parser.add_argument("--seed", type=int, default=30, help="manual seed")
    parser.add_argument("--testing", action="store_true", help="testing sample")
    parser.add_argument("--save_model", action="store_true", help="save model")
    parser.add_argument("--save_preds", action="store_true", help="eval test")
    parser.add_argument("--use_loss_correction", action="store_true",
                        help="use Loss correction (only for binary cases)")
    if multimodal:
        parser.add_argument("--use_clip_loss", action="store_true",
                            help="use contrastive Loss")
        parser.add_argument("--use_tim_loss", action="store_true", help="use TIM Loss")
        parser.add_argument("--beta_itc", type=float, default=0.1,
                            help="hyperparameter for itc loss")
        parser.add_argument("--beta_itm", type=float, default=0.1,
                            help="hyperparameter for itm loss")
        parser.add_argument("--use_saved_features", action="store_true",
                            help="use the uint8 pixel cache")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="activation compute dtype; float32 is float32 "
                             "everywhere (no TF32 in matrix products or "
                             "convolutions, cli/_common.py::set_precision_policy; "
                             "the float32 attention kernels run each product as "
                             "a three-pass TF32 split that keeps float32's "
                             "accuracy, single-pass TF32 is off everywhere)")
    parser.add_argument("--attn_impl", type=str, default="auto",
                        choices=["auto", "pallas", "pallas_interpret", "jnp",
                                 "fused", "fused_interpret"],
                        help="auto/pallas: the SDPA kernels; fused: the "
                             "whole-block kernels for self-attention; jnp: "
                             "the plain PyTorch version")
    parser.add_argument("--opt_moments", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="AdamW first-moment storage dtype")
    parser.add_argument("--opt_kernel", type=str, default="fused",
                        choices=["fused", "optax"],
                        help="AdamW emission in the JAX package; both names "
                             "are the same AdamW here")
    parser.add_argument("--tim_reuse_text", action="store_true",
                        help="reuse the primary pass's text-tower "
                             "activations for the TIM rows (a row gather: "
                             "the swap is an in-batch permutation) instead "
                             "of re-encoding them. Exact in eval; during "
                             "training the reused rows share the primary "
                             "pass's dropout masks where the reference "
                             "draws fresh ones (mm_late.py:168-182). Late "
                             "fusion only")
    parser.add_argument("--prng_impl", type=str, default="rbg",
                        choices=["rbg", "threefry"],
                        help="JAX PRNG; logged only: the port draws from "
                             "torch.Generator")
    parser.add_argument("--mesh_pipe", type=int, default=1,
                        help="(not ported) pipeline-parallel stages")
    parser.add_argument("--pp_microbatches", type=int, default=0,
                        help="(not ported) microbatches per pipeline step")
    parser.add_argument("--pp_interleave", type=int, default=1,
                        help="(not ported) interleaved pipeline levels")
    parser.add_argument("--bucket_seq", type=str, nargs="?", const="32,64,96",
                        default=None, metavar="L1,L2,..",
                        help="sequence-length bucketing: slice each batch's "
                             "text arrays to the smallest listed bucket "
                             "covering its longest real sequence (default "
                             "buckets 32,64,96; full max_length stays the "
                             "fallback). Exact under masked attention: the "
                             "same logits, less padded compute; on a CUDA "
                             "device each width replays its own CUDA graph "
                             "under --steps_per_dispatch > 1")
    parser.add_argument("--bucket_group", action="store_true",
                        help="with --bucket_seq and --steps_per_dispatch > 1: "
                             "stably regroup each training epoch's shuffled "
                             "batches by bucket width so every chunk is "
                             "pure-width and slices to the per-batch bucket "
                             "(chunk-level bucketing degenerates to the full "
                             "pad at realistic tweet-length mixes). "
                             "Per-example math stays exact; only the batch "
                             "visit order within an epoch deviates")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="(not ported beyond 1) data-parallel mesh axis size")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="(not ported beyond 1) tensor-parallel mesh axis size")
    parser.add_argument("--arch", type=str, default="base",
                        choices=list(ARCH_PRESETS),
                        help="architecture size preset (tiny/small for smoke runs)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialise encoder layers (recompute each in "
                             "the backward)")
    parser.add_argument("--scan_layers", action="store_true",
                        help="the JAX package's scanned layer layout; the port "
                             "trains its unrolled layers either way (the same "
                             "run, bit for bit) and keeps the stacked kernels "
                             "out of --quantize w8, as JAX does")
    parser.add_argument("--opt_impl", type=str, default="exact",
                        choices=["exact", "lazy_emb"],
                        help="exact: dense AdamW; lazy_emb: the word "
                             "table's rows in the batch get AdamW, the "
                             "others keep their moments and skip decay "
                             "(row-sparse, train/lazy_emb.py); a model "
                             "without one word table keeps exact AdamW")
    if multimodal:
        parser.add_argument("--cache_vision", action="store_true",
                            help="cache the frozen vision tower's activations "
                                 "per image (the first touch computes them in "
                                 "eval mode, later steps skip the tower; "
                                 "late-fusion transformer towers only)")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="optimizer steps per dispatch: chunks of K batches "
                             "staged together, each step a CUDA graph replay on "
                             "a CUDA device")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint")
    parser.add_argument("--ckpt_every", type=int, default=0,
                        help="checkpoint every N steps (0: none)")
    parser.add_argument("--profile", type=str, default=None,
                        help="torch.profiler trace directory")
    parser.add_argument("--log_every", type=int, default=10,
                        help="log training metrics every N steps")
    parser.add_argument("--image_size", type=int, default=None,
                        help="(CNN towers) input image size")
    parser.add_argument("--log_jsonl", type=str, default=None,
                        help="append structured per-step/epoch records to this JSONL file")
    parser.add_argument("--img_decoder", type=str, default="pil",
                        choices=["pil", "native"],
                        help="image ingest path: pil (the reference's decode, "
                             "default) or native (C++ libjpeg/libpng with "
                             "DCT-scaled JPEG decode, data/native.py; faster "
                             "cache builds, ~1 LSB resize deviation)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the run happens; cuda unless cpu is asked "
                             "for (no quiet fallback)")
    return parser


def check_training_supported(args) -> None:
    """Raise ``SystemExit`` for every flag value that selects something the
    port's trainers do not have yet, rather than ignoring it; then publish
    ``--img_decoder`` (``publish_img_decoder``)."""
    refused = [
        ("--mesh_pipe > 1", args.mesh_pipe > 1),
        ("--mesh_data > 1", (args.mesh_data or 1) > 1),
        ("--mesh_model > 1", args.mesh_model > 1),
    ]
    for flag, asked in refused:
        if asked:
            raise SystemExit(f"{flag} is not ported to PyTorch yet")
    seq_buckets_from(args)  # a bad --bucket_seq / --bucket_group exits before any build
    publish_img_decoder(args)


def publish_img_decoder(args) -> None:
    """Publish ``--img_decoder`` to the ingest layer as ``SMTC_IMG_DECODER``
    (``data/images.py::load_pixels_u8`` runs deep inside cache builds and
    pipelines), as the JAX package does. Every entry point calls it, always:
    the ``pil`` default resets the variable, so a ``native`` run cannot leak
    into a later ``main()`` in the same process."""
    os.environ["SMTC_IMG_DECODER"] = getattr(args, "img_decoder", None) or "pil"


def seq_buckets_from(args):
    """``--bucket_seq`` string -> sorted tuple of bucket lengths (or None),
    with the JAX package's ``SystemExit`` texts for a bad value and for
    ``--bucket_group`` without ``--bucket_seq``."""
    raw = getattr(args, "bucket_seq", None)
    if not raw:
        if getattr(args, "bucket_group", False):
            raise SystemExit("--bucket_group requires --bucket_seq")
        return None
    try:
        buckets = tuple(sorted({int(x) for x in str(raw).split(",") if x}))
    except ValueError:
        raise SystemExit(f"--bucket_seq {raw!r}: expected comma-separated ints")
    if not buckets or min(buckets) < 2:
        raise SystemExit(f"--bucket_seq {raw!r}: buckets must be >= 2")
    return buckets


def run_control(args, setup, ckpt_dir: str) -> dict:
    """The ``Trainer``'s run-control arguments from the common flags:
    ``--ckpt_every`` checkpoints under ``ckpt_dir`` (the JAX runners'
    directory name), ``--resume``, ``--profile`` and ``--steps_per_dispatch``
    with the chunked train and eval steps of ``setup``."""
    from ..train.checkpoint import TrainCheckpointer
    from ..train.steps import make_eval_many, make_train_many

    return dict(
        checkpointer=(TrainCheckpointer(ckpt_dir, args.ckpt_every)
                      if args.ckpt_every else None),
        profile_dir=args.profile, resume=args.resume,
        train_many=make_train_many(setup.train_step),
        eval_many=make_eval_many(setup.eval_step),
        steps_per_dispatch=args.steps_per_dispatch)


def save_predictions_csv(res: dict, path: str) -> None:
    """``data_id,label,prediction``, as the JAX package writes it."""
    def cell(x):
        return x.tolist() if hasattr(x, "tolist") else x

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["data_id", "label", "prediction"])
        for row in zip(res["data_id"], res["labels"], res["predictions"]):
            w.writerow([cell(x) for x in row])


def save_metrics_csv(metrics: dict, path: str) -> None:
    """``compute_metrics``' ``{"metric": [...], "result": [...]}`` table."""
    from ..train.loop import write_table_csv

    write_table_csv(metrics, path)


def arch_overrides(args) -> dict:
    return dict(ARCH_PRESETS[args.arch])


def artifact_stem(args, cfg, family: str = "mm_late") -> str:
    """The artifact naming contract, shared with the JAX package's trainers:
    late fusion ``{txt}-{img}-{fusion}_task{t}_seed{s}_{loss_str}_{N}``,
    early fusion ``{model}_task{t}_seed{s}_{loss_str}_`` (``family`` = the
    early model's name, e.g. ``vilt_task3_seed30_itc0.1itm0.1_``)."""
    if family != "mm_late":
        return f"{family}_task{args.task}_seed{args.seed}_{cfg.loss_str}_"
    nsamples = getattr(args, "nsamples", -1)
    nsamples_str = "" if nsamples == -1 else f"N{nsamples}_"
    return "{}-{}-{}_task{}_seed{}_{}_{}".format(
        args.txt_model_name, args.img_model_name, args.fusion_name,
        args.task, args.seed, cfg.loss_str, nsamples_str)


def results_dir_for(base: str, testing: bool) -> str:
    out = base + ("testing/" if testing else "")
    os.makedirs(out, exist_ok=True)
    return out


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a CPU
    ``torch.Generator`` seeded the same, for explicit random init."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def set_precision_policy() -> None:
    """The port's one float32 policy: float32 means float32 everywhere, so
    neither cuBLAS's matrix products nor cuDNN's convolutions may round
    their float32 inputs to TF32 (PyTorch's default leaves cuDNN on TF32).
    ``--dtype bfloat16`` is unaffected; the float32 parts of a bfloat16 run
    (a CNN late-fusion trunk, the heads) stay float32. The port's own float32
    attention kernels (``csrc/sdpa_core.cuh``, ``sdpa_bwd_core.cuh``) run on
    the tensor cores as a three-pass TF32 split: each operand is split into a
    TF32 part and a TF32 remainder and the three products that matter are
    summed in float32, which keeps float32's accuracy (held against float64
    on the card by ``chip_smoke.py``); single-pass TF32 stays off
    everywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default of every entry point) or ``cpu``. Asking for
    CUDA where there is none raises: nothing falls back to the CPU. Every
    entry point passes here, so here the precision policy is set
    (``set_precision_policy``)."""
    set_precision_policy()
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass --device cpu "
            "(device='cpu') to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device
