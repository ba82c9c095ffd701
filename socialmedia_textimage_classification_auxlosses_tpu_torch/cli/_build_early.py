"""Builds the ViLT early-fusion model and what its trainer needs.

Counterpart of the ViLT branch of the JAX package's ``cli/_build_early.py``:
ViLT-B/32 (12 pre-LN layers, hidden 768, 12 heads, MLP 3072, vocab 30,522,
40 text positions, patch 32, a 12 x 12 position grid from ``image_size``
384), sized by a ``config.json`` in the model directory when there is one
and by ``--arch``; the hashing tokenizer of the ``bert`` family (token types,
pad id 0); the image source (``--vilt_exact_resize``: the per-sample
aspect-preserving resize onto the 608-px canvas with ``grid_hw``; else the
fixed square, with ``--use_saved_features`` the uint8 cache under
``<data>/cache/{task}_vilt_u8_{size}``); AdamW over every parameter (nothing
is frozen in early fusion); the loss configuration and the train and eval
steps. In training and in eval the TIM rows run through the joint pass with
their own texts (they cannot be taken from the first pass's rows: each joint
row mixes its text with the image). The backbone starts from the HF ViLT
checkpoint in ``MODEL_DIR_DICT["vilt"]`` (``SMTC_VILT_DIR``) when that holds
one, else from random weights, as in the JAX builder;
``import_reference_checkpoint`` loads a reference-trained ``ViLT`` state
dict (``--import_reference_ckpt``). LXMERT and MMBT are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as C
from ..data.images import normalize_on_device, vilt_canvas
from ..data.pipeline import ExactViltImageSource, PipelineConfig, SplitPipeline, make_image_source
from ..data.prep import prepare_data
from ..data.tokenizers import build_tokenizer
from ..models import hf_import as H
from ..models.encoder import EncoderConfig
from ..models.vilt import ViltClassifier, init_vilt_weights
from ..models.vision import IMAGE_NORM, _load_hf_config
from ..train.optim import AdamW
from ..train.steps import EvalStep, TrainStep
from ..utils.logging import get_logger
from ._build import TrainSetup, loss_cfg_from
from ._common import arch_overrides

logger = get_logger(__name__)

VILT_VOCAB = 30522


def check_mm_early_supported(args) -> None:
    """Raise ``SystemExit`` for what the port's early-fusion trainer lacks."""
    if args.model != "vilt":
        raise SystemExit(f"--model {args.model} is not ported to PyTorch yet "
                         "(only vilt is)")


def import_reference_checkpoint(model: ViltClassifier, path: str) -> None:
    """``--import_reference_ckpt``: a reference-trained ``ViLT`` wrapper
    state dict (``model.*`` = HF ViltModel, ``linear``, ``linear_tim``,
    ``logit_scale``) into ``model``, every tensor checked by name and
    shape."""
    state = H.load_torch_file(path)
    if state is None:
        raise SystemExit(f"--import_reference_ckpt {path!r}: no such file")
    keys = H.merge_into(model, H.import_reference_vilt(state, model.cfg.layers))
    logger.info("imported reference checkpoint %s (%d tensors)", path, len(keys))


def build_mm_early_train_setup(args, cfg: C.Config, device: torch.device,
                               generator: torch.Generator,
                               keep_grads: bool = False) -> TrainSetup:
    """ViLT on ``device``, initialised from ``generator``, with the splits of
    ``cfg.data`` (subsampled with ``np.random.RandomState(args.seed)``, as
    the JAX builder does), the pipelines, AdamW and the steps."""
    check_mm_early_supported(args)
    model_dir = C.MODEL_DIR_DICT.get("vilt")
    hf = _load_hf_config(model_dir)
    overrides = arch_overrides(args)
    vocab = hf.get("vocab_size", VILT_VOCAB)
    tokenizer = build_tokenizer("bert", model_dir, cfg.max_length, vocab)

    exact = args.vilt_exact_resize
    geo = {"patch": hf.get("patch_size", 32), "image_size": hf.get("image_size", 384)}
    if args.arch != "base" and not exact:
        geo = {"patch": 32, "image_size": 64}
    enc_cfg = EncoderConfig(
        vocab_size=vocab,
        hidden=overrides.get("hidden", hf.get("hidden_size", 768)),
        layers=overrides.get("layers", hf.get("num_hidden_layers", 12)),
        heads=overrides.get("heads", hf.get("num_attention_heads", 12)),
        mlp_dim=overrides.get("mlp_dim", hf.get("intermediate_size", 3072)),
        max_positions=max(cfg.max_length, hf.get("max_position_embeddings", 40)),
        type_vocab=2, ln_style="pre",
        # the backbone's dropout follows the checkpoint's config, as in the
        # JAX builder; --dropout is the head's
        dropout=hf.get("hidden_dropout_prob", 0.1),
        dtype=args.dtype, attn_impl=args.attn_impl, remat=args.remat)
    canvas = vilt_canvas(geo["image_size"]) if exact else None
    with torch.device("meta"):  # no default init: it is replaced anyway
        model = ViltClassifier(enc_cfg, cfg.num_labels, patch=geo["patch"],
                               image_size=geo["image_size"], dropout=cfg.dropout,
                               tim_batched=not args.tim_two_pass, canvas_size=canvas)
    model = model.to_empty(device="cpu")
    init_vilt_weights(model, generator)
    keys = H.maybe_import_vilt(model, model_dir, enc_cfg.layers, prefix="backbone.")
    if keys:
        logger.info("ViLT backbone: %d pretrained tensors from %s", len(keys), model_dir)
    model = model.to(device)

    train, val, test, weights = prepare_data(
        cfg.data, cfg.num_labels, testing=args.testing, multilabel=cfg.multilabel,
        rng=np.random.RandomState(args.seed))
    pipe_cfg = PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length,
                              image_size=canvas or geo["image_size"])
    if exact and args.use_saved_features:
        logger.warning("--vilt_exact_resize decodes per sample (memoised); the "
                       "fixed-square uint8 cache of --use_saved_features does not apply")
    pipes = {}
    for name, split in (("train", train), ("val", val), ("test", test)):
        if exact:
            src = ExactViltImageSource(cfg.img_fmt, shortest=geo["image_size"])
        else:
            src = make_image_source(
                cfg.img_fmt, ids=split.ids, size=geo["image_size"],
                use_cache=args.use_saved_features,
                cache_dir=f"{C.DATA_PATH}cache/{cfg.task_name}_vilt_u8_{geo['image_size']}")
        pipes[name] = SplitPipeline(split, pipe_cfg, tokenizer=tokenizer, image_source=src)

    mean, std = IMAGE_NORM["vilt"]
    dtype = getattr(torch, args.dtype)

    def forward_fn(batch, tim_inputs, gen, deterministic):
        """The model's output dict; the TIM rows through the joint pass."""
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        tim = tim_inputs or {}
        return model(batch["ids"], batch["mask"], batch.get("token_type_ids"), pixels,
                     grid_hw=batch.get("grid_hw"), tim_ids=tim.get("ids"),
                     tim_mask=tim.get("mask"), tim_token_type_ids=tim.get("token_type_ids"),
                     gen=gen)

    mu_dtype = torch.bfloat16 if args.opt_moments == "bf16" else None
    optimizer = AdamW(model.named_parameters(), cfg.lr, cfg.weight_decay, mu_dtype=mu_dtype)
    loss_cfg = loss_cfg_from(cfg)
    cw = None if weights is None else torch.tensor(weights, device=device)
    logger.info("ViLT parameters %d (all trainable); joint length %d",
                sum(p.numel() for p in model.parameters()),
                cfg.max_length + 1 + ((canvas or geo["image_size"]) // geo["patch"]) ** 2)
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads),
        eval_step=EvalStep(model, forward_fn, loss_cfg, cw))
