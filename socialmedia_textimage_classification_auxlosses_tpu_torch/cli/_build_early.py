"""Builds the early-fusion models (ViLT, MMBT, LXMERT) and what their
trainer and their service need.

Counterpart of the JAX package's ``cli/_build_early.py``:

* ViLT-B/32 (12 pre-LN layers, hidden 768, 12 heads, MLP 3072, vocab 30,522,
  40 text positions, patch 32, a 12 x 12 position grid from ``image_size``
  384), its images either the per-sample aspect-preserving resize onto the
  608-px canvas with ``grid_hw`` (``--vilt_exact_resize``) or the fixed
  square (with ``--use_saved_features`` the uint8 cache under
  ``<data>/cache/{task}_vilt_u8_{size}``); the backbone from the HF ViLT
  checkpoint in ``MODEL_DIR_DICT["vilt"]`` when that holds one;
* MMBT: BERT (post-LN, 12 layers at base) over ``[CLS] img_1..img_3 [SEP]
  sentence`` with a ResNet-152 trunk at base (ResNet-50 below it) in
  ``--dtype``, 224 px at base, 64 below it, or ``--image_size``; the images
  a fixed square in the ``mm_cnn`` normalisation (with
  ``--use_saved_features`` the cache ``<data>/cache/{task}_mmbt_u8_{size}``);
  BERT from ``MODEL_DIR_DICT["mmbt"]`` (its word table into the backbone's)
  and a torchvision ResNet from ``MODEL_DIR_DICT[resnet]`` when they hold
  checkpoints; its BatchNorm statistics train with it (buffers, outside
  AdamW);
* LXMERT: 9 / 5 / 5 layers at base (``l_layers`` / ``r_layers`` /
  ``x_layers`` of the checkpoint's ``config.json``), 2 / 1 / 1 below it,
  over the ROI features of ``ensure_roi_cache`` (no pixels); the backbone
  from ``MODEL_DIR_DICT["lxmert"]`` when that holds a checkpoint.

The backbone's dropout follows the checkpoint's ``hidden_dropout_prob``
(0.1 without one), as in the JAX builder; ``--dropout`` is the head's. The
tokenizer is the ``bert`` family's (token types, pad id 0; hashing without a
vocabulary). AdamW takes every parameter (nothing is frozen in early
fusion); under ``--opt_impl lazy_emb`` the one word table takes the
row-sparse update from its dense gradient (the forwards take no
``word_embeds``, as in the JAX package). In training and in eval the TIM
rows run through the joint pass with their own texts. ``import_reference_checkpoint`` loads a
reference-trained ``ViLT`` or ``Lxmert`` state dict
(``--import_reference_ckpt``); the reference has no MMBT.
``build_mm_early_setup`` builds the model alone, for serving (LXMERT's sized
to the service's detector).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import config as C
from ..data.cache import RoiFeatureCache
from ..data.images import normalize_on_device, vilt_canvas
from ..data.pipeline import ExactViltImageSource, PipelineConfig, SplitPipeline, make_image_source
from ..data.prep import prepare_data
from ..data.tokenizers import build_tokenizer
from ..models import hf_import as H
from ..models.encoder import EncoderConfig
from ..models.lxmert import LxmertClassifier, LxmertConfig, init_lxmert_weights
from ..models.mmbt import MmbtClassifier, init_mmbt_weights
from ..models.vilt import ViltClassifier, init_vilt_weights
from ..models.vision import IMAGE_NORM, _load_hf_config
from ..train.steps import EvalStep, TrainStep
from ..utils.logging import get_logger
from ._build import Setup, TrainSetup, build_optimizer, loss_cfg_from
from ._common import arch_overrides, seq_buckets_from

logger = get_logger(__name__)

VILT_VOCAB = 30522


def check_mm_early_supported(args) -> None:
    """Raise ``SystemExit`` for what the port's early-fusion trainer lacks."""
    if args.model == "lxmert" and getattr(args, "remat", False):
        raise SystemExit("--remat is not ported for LXMERT (its layers are not "
                         "rematerialised in the JAX package either)")
    if args.model == "mmbt" and getattr(args, "import_reference_ckpt", None):
        raise SystemExit("--import_reference_ckpt: the reference ships no MMBT model, "
                         "so no reference checkpoint format exists for it")
    # the JAX early runner accepts these two and ignores them
    if args.tim_reuse_text:
        raise SystemExit("--tim_reuse_text is not ported to early fusion: its TIM rows run "
                         "through the joint pass with their images, so no text-only rows "
                         "can be reused (a late-fusion flag)")
    if getattr(args, "cache_vision", False):
        raise SystemExit("--cache_vision is not ported to early fusion: it caches a frozen "
                         "late-fusion vision tower, and early fusion trains every part")


def import_reference_checkpoint(model, args) -> None:
    """``--import_reference_ckpt``: a reference-trained ``ViLT`` wrapper
    (``model.*`` = HF ViltModel, ``linear``, ``linear_tim``,
    ``logit_scale``) or ``Lxmert`` wrapper (``model.*`` = HF LxmertModel,
    ``linear_fusion`` too) state dict into ``model``, every tensor checked
    by name and shape (``check_mm_early_supported`` refuses MMBT: the
    reference has none)."""
    path = args.import_reference_ckpt
    state = H.load_torch_file(path)
    if state is None:
        raise SystemExit(f"--import_reference_ckpt {path!r}: no such file")
    if args.model == "vilt":
        tree = H.import_reference_vilt(state, model.cfg.layers)
    else:
        lx = model.cfg
        tree = H.import_reference_lxmert(state, lx.l_layers, lx.r_layers, lx.x_layers)
    keys = H.merge_into(model, tree)
    logger.info("imported reference checkpoint %s (%d tensors)", path, len(keys))


@dataclasses.dataclass
class EarlyModel:
    """One early-fusion model on the CPU with what drives it."""
    model: torch.nn.Module
    tokenizer: object
    # (batch of device tensors, tim_inputs, gen, deterministic) -> output dict
    forward_fn: Callable
    # pixels: the (canvas or square) side, None for LXMERT (ROI features)
    image_size: Optional[int]
    image_norm: Optional[tuple]
    # the square pixel cache under --use_saved_features, the ViLT canvas flag
    cache_dir: Optional[str] = None
    exact: bool = False
    shortest: Optional[int] = None


def _vilt(args, cfg, hf, vocab, overrides, generator) -> EarlyModel:
    model_dir = C.MODEL_DIR_DICT.get("vilt")
    exact = getattr(args, "vilt_exact_resize", False)
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
        type_vocab=2, ln_style="pre", dropout=hf.get("hidden_dropout_prob", 0.1),
        dtype=args.dtype, attn_impl=args.attn_impl, remat=getattr(args, "remat", False))
    canvas = vilt_canvas(geo["image_size"]) if exact else None
    with torch.device("meta"):  # no default init: it is replaced anyway
        model = ViltClassifier(enc_cfg, cfg.num_labels, patch=geo["patch"],
                               image_size=geo["image_size"], dropout=cfg.dropout,
                               tim_batched=not getattr(args, "tim_two_pass", False),
                               canvas_size=canvas)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_vilt_weights(model, generator)
    keys = H.maybe_import_vilt(model, model_dir, enc_cfg.layers, prefix="backbone.")
    if keys:
        logger.info("ViLT backbone: %d pretrained tensors from %s", len(keys), model_dir)
    mean, std = IMAGE_NORM["vilt"]
    dtype = getattr(torch, args.dtype)

    def forward_fn(batch, tim_inputs, gen, deterministic):
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        tim = tim_inputs or {}
        return model(batch["ids"], batch["mask"], batch.get("token_type_ids"), pixels,
                     grid_hw=batch.get("grid_hw"), tim_ids=tim.get("ids"),
                     tim_mask=tim.get("mask"), tim_token_type_ids=tim.get("token_type_ids"),
                     gen=gen)

    size = canvas or geo["image_size"]
    logger.info("ViLT parameters %d (all trainable); joint length %d",
                sum(p.numel() for p in model.parameters()),
                cfg.max_length + 1 + (size // geo["patch"]) ** 2)
    return EarlyModel(
        model=model, tokenizer=None, forward_fn=forward_fn, image_size=size,
        image_norm=(mean, std), exact=exact, shortest=geo["image_size"],
        cache_dir=f"{C.DATA_PATH}cache/{cfg.task_name}_vilt_u8_{geo['image_size']}")


def _mmbt(args, cfg, hf, vocab, overrides, generator) -> EarlyModel:
    enc_cfg = EncoderConfig(
        vocab_size=vocab,
        hidden=overrides.get("hidden", hf.get("hidden_size", 768)),
        layers=overrides.get("layers", hf.get("num_hidden_layers", 12)),
        heads=overrides.get("heads", hf.get("num_attention_heads", 12)),
        mlp_dim=overrides.get("mlp_dim", hf.get("intermediate_size", 3072)),
        max_positions=hf.get("max_position_embeddings", 512),
        type_vocab=hf.get("type_vocab_size", 2), ln_style="post",
        dropout=hf.get("hidden_dropout_prob", 0.1), dtype=args.dtype,
        attn_impl=args.attn_impl, remat=getattr(args, "remat", False))
    cnn_name = "resnet50" if args.arch != "base" else "resnet152"
    size = getattr(args, "image_size", None) or (64 if args.arch != "base" else 224)
    with torch.device("meta"):
        model = MmbtClassifier(enc_cfg, cfg.num_labels, cnn_name=cnn_name,
                               dropout=cfg.dropout,
                               tim_batched=not getattr(args, "tim_two_pass", False))
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_mmbt_weights(model, generator)
    model_dir = C.MODEL_DIR_DICT.get("mmbt")
    keys = H.maybe_import_mmbt(model, model_dir, enc_cfg.layers,
                               cnn_weight_path=C.MODEL_DIR_DICT.get(cnn_name),
                               cnn_name=cnn_name)
    if keys:
        logger.info("MMBT: %d pretrained tensors (BERT from %s, %s)", len(keys), model_dir,
                    cnn_name)
    mean, std = IMAGE_NORM["mm_cnn"]
    dtype = getattr(torch, args.dtype)

    def forward_fn(batch, tim_inputs, gen, deterministic):
        """The BatchNorm statistics train when not ``deterministic``."""
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        tim = tim_inputs or {}
        return model(batch["ids"], batch["mask"], pixels, tim.get("ids"), tim.get("mask"),
                     train=not deterministic, gen=gen)

    logger.info("MMBT parameters %d (all trainable); %s at %d px; joint length %d",
                sum(p.numel() for p in model.parameters()), cnn_name, size,
                cfg.max_length + 1 + model.backbone.num_image_embeds)
    return EarlyModel(model=model, tokenizer=None, forward_fn=forward_fn, image_size=size,
                      image_norm=(mean, std),
                      cache_dir=f"{C.DATA_PATH}cache/{cfg.task_name}_mmbt_u8_{size}")


def _lxmert(args, cfg, hf, vocab, overrides, generator, roi_cache) -> EarlyModel:
    base = args.arch == "base"
    lx_cfg = LxmertConfig(
        vocab_size=vocab,
        hidden=overrides.get("hidden", hf.get("hidden_size", 768)),
        heads=overrides.get("heads", hf.get("num_attention_heads", 12)),
        mlp_dim=overrides.get("mlp_dim", hf.get("intermediate_size", 3072)),
        l_layers=hf.get("l_layers", 9) if base else 2,
        r_layers=hf.get("r_layers", 5) if base else 1,
        x_layers=hf.get("x_layers", 5) if base else 1,
        visual_feat_dim=roi_cache.feat_dim,
        dropout=hf.get("hidden_dropout_prob", 0.1), dtype=args.dtype,
        attn_impl=args.attn_impl)
    with torch.device("meta"):
        model = LxmertClassifier(lx_cfg, cfg.num_labels, dropout=cfg.dropout,
                                 tim_batched=not getattr(args, "tim_two_pass", False))
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_lxmert_weights(model, generator)
    model_dir = C.MODEL_DIR_DICT.get("lxmert")
    keys = H.maybe_import_lxmert(model, model_dir, lx_cfg.l_layers, lx_cfg.r_layers,
                                 lx_cfg.x_layers)
    if keys:
        logger.info("LXMERT backbone: %d pretrained tensors from %s", len(keys), model_dir)

    def forward_fn(batch, tim_inputs, gen, deterministic):
        tim = tim_inputs or {}
        return model(batch["ids"], batch["mask"], batch.get("token_type_ids"),
                     batch["roi_features"], batch["roi_boxes"], tim_ids=tim.get("ids"),
                     tim_mask=tim.get("mask"), tim_token_type_ids=tim.get("token_type_ids"),
                     gen=gen)

    logger.info("LXMERT parameters %d (all trainable); %d/%d/%d layers over %d regions of "
                "%d features", sum(p.numel() for p in model.parameters()), lx_cfg.l_layers,
                lx_cfg.r_layers, lx_cfg.x_layers, roi_cache.num_boxes, roi_cache.feat_dim)
    return EarlyModel(model=model, tokenizer=None, forward_fn=forward_fn, image_size=None,
                      image_norm=None)


def build_early_model(args, cfg, generator: Optional[torch.Generator],
                      roi_cache: Optional[RoiFeatureCache] = None) -> EarlyModel:
    """The ``--model`` early-fusion model on the CPU (random init from
    ``generator``, else uninitialised storage for a checkpoint to fill; then
    the pretrained parts of ``MODEL_DIR_DICT``), its tokenizer and forward.
    LXMERT takes its ROI cache's feature width."""
    model_dir = C.MODEL_DIR_DICT.get(args.model)
    hf = _load_hf_config(model_dir)
    vocab = hf.get("vocab_size", VILT_VOCAB)
    overrides = arch_overrides(args)
    if args.model == "vilt":
        em = _vilt(args, cfg, hf, vocab, overrides, generator)
    elif args.model == "mmbt":
        em = _mmbt(args, cfg, hf, vocab, overrides, generator)
    else:
        em = _lxmert(args, cfg, hf, vocab, overrides, generator, roi_cache)
    em.tokenizer = build_tokenizer("bert", model_dir, cfg.max_length, vocab,
                                   seed=getattr(args, "seed", None))
    return em


def build_mm_early_setup(args, cfg: C.ServingConfig,
                         generator: Optional[torch.Generator] = None,
                         roi_cache=None) -> Setup:
    """The serving setup of ViLT (the fixed square), MMBT or LXMERT: the
    model on the CPU in eval mode and ``forward_fn(batch) -> outputs``.
    LXMERT's visual projection takes ``roi_cache``'s feature width (the
    service's detector's, ``cli/serve.py::_serving_roi_cache``)."""
    if args.model == "lxmert" and roi_cache is None:
        raise ValueError("--model lxmert serves with a roi_cache that sizes its visual "
                         "projection")
    em = build_early_model(args, cfg, generator, roi_cache)
    forward = em.forward_fn

    def forward_fn(batch):
        return forward(batch, None, None, True)

    return Setup(model=em.model.eval(), tokenizer=em.tokenizer, image_size=em.image_size,
                 image_norm=em.image_norm, forward_fn=forward_fn)


def ensure_roi_cache(args, cfg, splits, device) -> RoiFeatureCache:
    """LXMERT's ROI features for every id of ``splits``, the first of these
    that works: the cache ``<data>/cache/{task}_roi`` when it holds every id,
    the reference's per-sample dumps under ``<data>/{task}_img_feats/``
    imported into it, else grid features of a ResNet-50 trunk
    (``cli/obj_features.py``) written into it, on ``device``. The grid's
    pixels come from the uint8 cache ``<data>/cache/{task}_u8_{size}`` at the
    extractor's size under ``--use_saved_features`` (ids it lacks are
    decoded into it), else each image is decoded."""
    cache = RoiFeatureCache(f"{C.DATA_PATH}cache/{cfg.task_name}_roi")
    all_ids = np.concatenate([np.asarray(s.ids) for s in splits])
    if cache.holds(all_ids):
        return cache
    if cache.import_reference_dumps(C.DATA_PATH, cfg.task_name, all_ids):
        return cache
    from .obj_features import extract_grid_features, grid_image_size

    tiny = args.arch != "base"
    pixels = None
    if getattr(args, "use_saved_features", False):
        size = grid_image_size(tiny)
        pixels = make_image_source(cfg.img_fmt, ids=all_ids, size=size, use_cache=True,
                                   cache_dir=f"{C.DATA_PATH}cache/{cfg.task_name}_u8_{size}")
    logger.info("building grid ROI features for %d images", len(all_ids))
    return extract_grid_features(all_ids, cfg.img_fmt, cache, tiny=tiny, device=device,
                                 pixel_source=pixels)


def build_mm_early_train_setup(args, cfg: C.Config, device: torch.device,
                               generator: torch.Generator,
                               keep_grads: bool = False) -> TrainSetup:
    """The ``--model`` early-fusion model on ``device``, initialised from
    ``generator``, with the splits of ``cfg.data`` (subsampled with
    ``np.random.RandomState(args.seed)``, as the JAX builder does), the
    pipelines, AdamW and the steps."""
    check_mm_early_supported(args)
    train, val, test, weights = prepare_data(
        cfg.data, cfg.num_labels, testing=args.testing, multilabel=cfg.multilabel,
        rng=np.random.RandomState(args.seed))
    splits = (train, val, test)
    roi_cache = ensure_roi_cache(args, cfg, splits, device) if args.model == "lxmert" else None
    em = build_early_model(args, cfg, generator, roi_cache)
    model = em.model.to(device)

    pipe_cfg = PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length,
                              image_size=em.image_size or 0,
                              with_images=em.image_size is not None,
                              seq_buckets=seq_buckets_from(args),
                              bucket_group=getattr(args, "bucket_group", False))
    if em.exact and args.use_saved_features:
        logger.warning("--vilt_exact_resize decodes per sample (memoised); the "
                       "fixed-square uint8 cache of --use_saved_features does not apply")
    pipes = {}
    for name, split in zip(("train", "val", "test"), splits):
        src = None
        if em.exact:
            src = ExactViltImageSource(cfg.img_fmt, shortest=em.shortest)
        elif em.image_size is not None:
            src = make_image_source(cfg.img_fmt, ids=split.ids, size=em.image_size,
                                    use_cache=args.use_saved_features,
                                    cache_dir=em.cache_dir)
        pipes[name] = SplitPipeline(split, pipe_cfg, tokenizer=em.tokenizer, image_source=src,
                                    roi_cache=roi_cache)

    optimizer, lazy = build_optimizer(model, args, cfg)
    loss_cfg = loss_cfg_from(cfg)
    cw = None if weights is None else torch.tensor(weights, device=device)
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, em.forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads, lazy=lazy),
        eval_step=EvalStep(model, em.forward_fn, loss_cfg, cw), tokenizer=em.tokenizer)
