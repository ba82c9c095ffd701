"""Builds the late-fusion and image-only models, for serving and for training.

Counterpart of ``build_mm_late_setup`` and ``build_image_setup`` in the JAX
package's ``cli/_build.py``: ``build_mm_late_setup`` makes the late-fusion
model (``MMLateModel`` over ViT / DeiT / BEiT, or ``MMCnnModel`` over
ResNet-50/152 with ``concat_cnn`` / ``xatt``), the tokenizer and the
serving forward, and imports each pretrained tower whose ``MODEL_DIR_DICT``
entry holds a checkpoint (the text tower into ``dual.text`` or ``text``,
ViT / DeiT / BEiT into ``dual.vision``, a torchvision ResNet into ``cnn``;
an entry without one leaves the tower random), as the JAX ``_build.py`` does;
``build_mm_late_train_setup`` adds what a trainer needs on its device: a
transformer vision tower frozen (``requires_grad`` off, outside AdamW, as
the reference freezes it; the CNN path trains everything, its BatchNorm
statistics in train mode), the data splits and pipelines (the CNN path's
images resized to 256 and centre-cropped), AdamW, the loss configuration
and the train and eval steps, from the parts a seed sweep builds once per
seed (``build_mm_late_parts``: the CPU model, pipelines and class weights;
``mm_late_forward``, ``mm_late_optimizer``); ``import_reference_checkpoint``
loads a reference-trained ``MM_Model`` state dict (``--import_reference_ckpt``);
``build_text_setup`` builds the text-only classifier of ``cli/run_txt.py``
and ``build_image_setup`` the image-only classifier of ``cli/run_img.py``
with their trainers' parts (the JAX ``build_text_setup`` /
``build_image_setup``). No mesh is built: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core import config as C
from ..data.images import normalize_on_device
from ..data.pipeline import PipelineConfig, SplitPipeline, make_image_source
from ..data.prep import prepare_data
from ..data.tokenizers import TweetTokenizerFrontend, build_tokenizer
from ..models import hf_import as H
from ..models.encoder import init_weights
from ..models.fusion import FUSION_NAMES, MMCnnModel, MMLateModel
from ..models.text import NO_TOKEN_TYPES, build_text_classifier, text_encoder_config
from ..models.vision import (CNN_MODELS, IMAGE_NORM, build_vision_classifier,
                             vision_encoder_config, vit_geometry)
from ..train.optim import AdamW, feature_extract_frozen, vision_frozen
from ..train.steps import EvalStep, LossConfig, TrainStep, make_feature_step
from ..utils.logging import get_logger
from ._common import arch_overrides

logger = get_logger(__name__)


CNN_FUSIONS = ("concat_cnn", "xatt")
CENTER_CROP_FROM = 256  # the CNN recipe: shorter side to 256, centre crop


@dataclasses.dataclass
class Setup:
    model: torch.nn.Module  # MMLateModel, or MMCnnModel over a ResNet
    tokenizer: TweetTokenizerFrontend
    image_size: int
    image_norm: tuple
    # batch of device tensors (ids, mask, [token_type_ids], pixel_values as
    # uint8 NHWC) -> the model's output dict
    forward_fn: Callable
    # the CNN recipe's shorter side before the centre crop (None: a square resize)
    center_crop_from: Optional[int] = None


def check_mm_late_supported(args) -> None:
    """Raise ``SystemExit`` for a fusion head that does not fit the image
    tower: ``concat_cnn`` / ``xatt`` take a ResNet, the four others a
    transformer tower."""
    if args.img_model_name in CNN_MODELS:
        if args.fusion_name not in CNN_FUSIONS:
            raise SystemExit(f"--img_model_name {args.img_model_name} takes --fusion_name "
                             f"{' or '.join(CNN_FUSIONS)}, not {args.fusion_name}")
    elif args.fusion_name not in FUSION_NAMES:
        raise SystemExit(f"--fusion_name {args.fusion_name} takes a ResNet image tower "
                         "(--img_model_name resnet50 or resnet152)")


def build_mm_late_setup(args, cfg: C.ServingConfig,
                        generator: Optional[torch.Generator] = None) -> Setup:
    """The late-fusion model on the CPU in float32: random init from
    ``generator`` when one is given, else uninitialised storage for a
    checkpoint to fill; then the pretrained towers of ``MODEL_DIR_DICT``."""
    check_mm_late_supported(args)
    txt_name, img_name = args.txt_model_name, args.img_model_name
    txt_dir = C.MODEL_DIR_DICT.get(txt_name)
    img_dir = C.MODEL_DIR_DICT.get(img_name)
    overrides = dict(arch_overrides(args), remat=getattr(args, "remat", False))
    text_cfg = text_encoder_config(txt_name, txt_dir, dtype=args.dtype,
                                   attn_impl=args.attn_impl, **overrides)
    tokenizer = build_tokenizer(txt_name, txt_dir, cfg.max_length, text_cfg.vocab_size)
    is_cnn = img_name in CNN_MODELS
    with torch.device("meta"):  # no default init: it is replaced anyway
        if is_cnn:
            model = MMCnnModel(text_cfg, img_name, cfg.num_labels,
                               fusion_name=args.fusion_name, dropout=cfg.dropout)
        else:
            vis_cfg = vision_encoder_config(img_name, img_dir, dtype=args.dtype,
                                            attn_impl=args.attn_impl, **overrides)
            geo = vit_geometry(img_name, img_dir)
            model = MMLateModel(text_cfg, vis_cfg, cfg.num_labels,
                                fusion_name=args.fusion_name, dropout=cfg.dropout,
                                patch=geo["patch"], image_size=geo["image_size"],
                                num_prefix_tokens=geo["num_prefix_tokens"],
                                vision_pooling=geo["pooling"],
                                vision_arch="beit" if img_name == "beit" else "vit")
    model = model.to_empty(device="cpu").eval()
    if generator is not None:
        init_weights(model, generator)
        if not is_cnn:
            with torch.no_grad():
                model.dual.logit_scale.fill_(2.6592)  # DualEncoder's init value
    if is_cnn:
        towers = (("text", txt_dir, H.maybe_import_text_tower(
                      model, txt_dir, text_cfg.layers, prefix="text.")),
                  ("cnn", img_dir, H.maybe_import_resnet(model, img_dir, img_name,
                                                        prefix="cnn.")))
    else:
        vision_keys = (H.maybe_import_beit_tower(model, img_dir, vis_cfg.layers)
                       if img_name == "beit" else
                       H.maybe_import_vision_tower(model, img_dir, vis_cfg.layers,
                                                   distilled=img_name == "deit",
                                                   pooling=geo["pooling"]))
        towers = (("text", txt_dir, H.maybe_import_text_tower(
                      model, txt_dir, text_cfg.layers, prefix="dual.text.")),
                  ("vision", img_dir, vision_keys))
    for what, model_dir, keys in towers:
        if keys:
            logger.info("%s tower: %d pretrained tensors from %s", what, len(keys), model_dir)

    mean, std = IMAGE_NORM["mm_cnn" if is_cnn else img_name]
    dtype = getattr(torch, args.dtype)
    use_tt = txt_name not in NO_TOKEN_TYPES

    def forward_fn(batch):
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        tt = batch.get("token_type_ids") if use_tt else None
        if is_cnn:
            return model(batch["ids"], batch["mask"], pixels, tt)
        return model(batch["ids"], batch["mask"], pixels, tt, iadds_task=cfg.use_iadds_loss)

    size = (getattr(args, "image_size", None) or 224) if is_cnn else geo["image_size"]
    return Setup(model=model, tokenizer=tokenizer, image_size=size,
                 image_norm=(mean, std), forward_fn=forward_fn,
                 center_crop_from=CENTER_CROP_FROM if is_cnn else None)


def import_reference_checkpoint(model: MMLateModel, args) -> None:
    """``--import_reference_ckpt``: a reference-trained ``MM_Model`` state
    dict (``dual_encoder.*``, the fusion head's and the heads' names) into
    ``model``, every tensor checked by name and shape."""
    state = H.load_torch_file(args.import_reference_ckpt)
    if state is None:
        raise SystemExit(f"--import_reference_ckpt {args.import_reference_ckpt!r}: no such file")
    tree = H.import_reference_mm_late(state, model.text_cfg.layers, model.vision_cfg.layers,
                                      args.fusion_name, distilled=args.img_model_name == "deit",
                                      vision_pooling=vit_geometry(args.img_model_name)["pooling"])
    keys = H.merge_into(model, tree)
    logger.info("imported reference checkpoint %s (%d tensors)", args.import_reference_ckpt,
                len(keys))


@dataclasses.dataclass
class TrainSetup:
    model: torch.nn.Module
    device: torch.device
    optimizer: AdamW
    pipes: Dict[str, SplitPipeline]
    train_step: TrainStep
    eval_step: EvalStep
    tokenizer: Optional[TweetTokenizerFrontend] = None
    # batch -> (features, label ids), for --extract_features
    feature_step: Optional[Callable] = None


def loss_cfg_from(cfg) -> LossConfig:
    return LossConfig(
        num_labels=cfg.num_labels, multilabel=cfg.multilabel,
        use_clip_loss=cfg.use_clip_loss, use_tim_loss=cfg.use_tim_loss,
        use_iadds_loss=cfg.use_iadds_loss,
        use_loss_correction=cfg.use_loss_correction, beta_itc=cfg.beta_itc,
        beta_itm=cfg.beta_itm, beta_iadds=cfg.beta_iadds,
        T=tuple(map(tuple, C.T)))


@dataclasses.dataclass
class RunParts:
    """What one late-fusion run builds before its device: the model on the
    CPU, its pipelines and its class weights."""
    base: Setup
    pipes: Dict[str, SplitPipeline]
    class_weights: Optional[np.ndarray]


def build_mm_late_parts(args, cfg: C.Config, generator: torch.Generator) -> RunParts:
    """The model initialised from ``generator`` (then the pretrained towers),
    the splits of ``cfg.data`` (subsampled with
    ``np.random.RandomState(args.seed)``, as the JAX package's
    ``build_mm_late_setup`` does) and the pipelines (the uint8 cache under
    ``<data>/cache/{task}_u8_{size}`` with ``--use_saved_features``)."""
    base = build_mm_late_setup(args, cfg, generator=generator)
    rng = np.random.RandomState(args.seed)
    train, val, test, weights = prepare_data(
        cfg.data, cfg.num_labels, testing=args.testing,
        nsamples=getattr(args, "nsamples", -1),
        load_image_adds=cfg.use_iadds_loss, multilabel=cfg.multilabel, rng=rng)
    pipe_cfg = PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length,
                              image_size=base.image_size)
    pipes = image_pipes(args, cfg, (train, val, test), pipe_cfg, base.image_size,
                        base.center_crop_from, base.tokenizer)
    return RunParts(base=base, pipes=pipes, class_weights=weights)


def image_pipes(args, cfg, splits, pipe_cfg, size, center_crop_from=None,
                tokenizer=None) -> Dict[str, SplitPipeline]:
    """The train, val and test pipelines of ``splits``, their images from
    the uint8 cache ``<data>/cache/{task}_u8_{size}`` under
    ``--use_saved_features`` (the JAX package's directory, which names no
    recipe: a cache that holds every id serves either), else decoded
    lazily."""
    pipes = {}
    for name, split in zip(("train", "val", "test"), splits):
        src = make_image_source(
            cfg.img_fmt, ids=split.ids, size=size, center_crop_from=center_crop_from,
            use_cache=getattr(args, "use_saved_features", False),
            cache_dir=f"{C.DATA_PATH}cache/{cfg.task_name}_u8_{size}")
        pipes[name] = SplitPipeline(split, pipe_cfg, tokenizer=tokenizer, image_source=src)
    return pipes


def freeze_vision(model: torch.nn.Module) -> None:
    """The vision tower frozen, as the reference freezes it."""
    for name, p in model.named_parameters():
        p.requires_grad_(not vision_frozen(name))


def mm_late_forward(model, args, cfg, image_norm) -> Callable:
    """The trainers' ``forward_fn(batch, tim_inputs, gen, deterministic)``
    over ``model`` (plain or seed-stacked; ``MMCnnModel``: its BatchNorm
    statistics trained when not ``deterministic``)."""
    mean, std = image_norm
    dtype = getattr(torch, args.dtype)
    use_tt = args.txt_model_name not in NO_TOKEN_TYPES

    if isinstance(model, MMCnnModel):
        def cnn_forward_fn(batch, tim_inputs, gen, deterministic):
            pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
            return model(batch["ids"], batch["mask"], pixels,
                         batch.get("token_type_ids") if use_tt else None,
                         train=not deterministic, gen=gen)

        return cnn_forward_fn

    def forward_fn(batch, tim_inputs, gen, deterministic):
        """The model's output dict; the TIM rows re-encoded in training, taken
        from the first pass's rows in eval (exact there)."""
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        tim_kw = {}
        if tim_inputs is not None:
            if deterministic:  # eval: the TIM rows are rows of the first pass
                tim_kw = {"tim_src": tim_inputs["src"]}
            else:
                tim_kw = {"tim_ids": tim_inputs["ids"], "tim_mask": tim_inputs["mask"],
                          "tim_token_type_ids": tim_inputs["token_type_ids"]}
        return model(batch["ids"], batch["mask"], pixels,
                     batch.get("token_type_ids") if use_tt else None,
                     iadds_task=cfg.use_iadds_loss, gen=gen, **tim_kw)

    return forward_fn


def mm_late_optimizer(model, args, cfg) -> AdamW:
    """AdamW over the trainable parameters (a transformer vision tower
    frozen; the CNN path's BatchNorm statistics are buffers, outside it)."""
    mu_dtype = torch.bfloat16 if args.opt_moments == "bf16" else None
    return AdamW(model.named_parameters(), cfg.lr, cfg.weight_decay,
                 mu_dtype=mu_dtype, frozen=vision_frozen)


def build_mm_late_train_setup(args, cfg: C.Config, device: torch.device,
                              generator: torch.Generator,
                              keep_grads: bool = False) -> TrainSetup:
    """Everything a late-fusion training run needs, on ``device``: the parts
    of ``build_mm_late_parts``, AdamW and the steps."""
    parts = build_mm_late_parts(args, cfg, generator)
    base, pipes, weights = parts.base, parts.pipes, parts.class_weights
    model = base.model.to(device)
    freeze_vision(model)
    forward_fn = mm_late_forward(model, args, cfg, base.image_norm)
    optimizer = mm_late_optimizer(model, args, cfg)
    loss_cfg = loss_cfg_from(cfg)
    cw = None if weights is None else torch.tensor(weights, device=device)
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for _, p in optimizer.params)
    logger.info("model parameters %d (trainable %d)", n_all, n_train)
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads),
        eval_step=EvalStep(model, forward_fn, loss_cfg, cw), tokenizer=base.tokenizer,
        feature_step=make_feature_step(model, forward_fn))


def build_text_setup(args, cfg: C.Config, device: torch.device,
                     generator: torch.Generator, freeze: bool = False,
                     keep_grads: bool = False) -> TrainSetup:
    """The text-only classifier (``TextClassifier``: the tower of
    ``--model_name`` and a linear head) on ``device``, initialised from
    ``generator``, then the pretrained tower of its ``MODEL_DIR_DICT``
    directory when that holds one; the splits (subsampled with
    ``np.random.RandomState(args.seed)``), text-only pipelines, AdamW
    (with ``freeze``, the tower frozen) and the steps."""
    model_name = args.model_name
    model_dir = C.MODEL_DIR_DICT.get(model_name)
    with torch.device("meta"):  # no default init: it is replaced anyway
        model = build_text_classifier(model_name, cfg.num_labels, model_dir,
                                      dropout=cfg.dropout, dtype=args.dtype,
                                      attn_impl=args.attn_impl, remat=args.remat,
                                      **arch_overrides(args))
    model = model.to_empty(device="cpu")
    init_weights(model, generator)
    keys = H.maybe_import_text_tower(model, model_dir, model.cfg.layers, prefix="tower.")
    if keys:
        logger.info("text tower: %d pretrained tensors from %s", len(keys), model_dir)
    model = model.to(device)

    def frozen(name):
        return freeze and name.split(".")[0] == "tower"

    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name))
    tokenizer = build_tokenizer(model_name, model_dir, cfg.max_length, model.cfg.vocab_size)
    train, val, test, weights = prepare_data(
        cfg.data, cfg.num_labels, testing=args.testing, multilabel=cfg.multilabel,
        rng=np.random.RandomState(args.seed))
    pipe_cfg = PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length)
    pipes = {name: SplitPipeline(split, pipe_cfg, tokenizer=tokenizer)
             for name, split in (("train", train), ("val", val), ("test", test))}
    use_tt = model_name not in NO_TOKEN_TYPES

    def forward_fn(batch, tim_inputs, gen, deterministic):
        return {"out_cls": model(batch["ids"], batch["mask"],
                                 batch.get("token_type_ids") if use_tt else None, gen=gen)}

    mu_dtype = torch.bfloat16 if args.opt_moments == "bf16" else None
    optimizer = AdamW(model.named_parameters(), cfg.lr, cfg.weight_decay, mu_dtype=mu_dtype,
                      frozen=frozen)
    loss_cfg = loss_cfg_from(cfg)
    cw = None if weights is None else torch.tensor(weights, device=device)
    logger.info("text classifier parameters %d (trainable %d)",
                sum(p.numel() for p in model.parameters()),
                sum(p.numel() for _, p in optimizer.params))
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads),
        eval_step=EvalStep(model, forward_fn, loss_cfg, cw), tokenizer=tokenizer)


def build_image_setup(args, cfg: C.Config, device: torch.device,
                      generator: torch.Generator, keep_grads: bool = False) -> TrainSetup:
    """The image-only classifier of ``--model_name`` (``models/vision.py``:
    ViT's CLS head, DeiT's and BEiT's pooled heads, ResNet-50/152 with
    ``--conv_att`` the attention-CNN) on ``device``, initialised from
    ``generator``, then the pretrained tower of its ``MODEL_DIR_DICT`` entry
    when that holds one (a torchvision ResNet into the trunk); the splits
    (subsampled with ``np.random.RandomState(args.seed)``), image-only
    pipelines (ImageNet pixel norm for the CNNs, each transformer's own),
    AdamW and the steps. Everything trains; ``--feature_extract`` keeps a
    CNN's trunk out of AdamW and its BatchNorm statistics frozen, as the
    JAX ``build_image_setup`` does; otherwise a CNN's statistics train with it."""
    model_name = args.model_name
    model_dir = C.MODEL_DIR_DICT.get(model_name)
    is_cnn = model_name in CNN_MODELS
    conv_att = getattr(args, "conv_att", False)
    with torch.device("meta"):  # no default init: it is replaced anyway
        model = build_vision_classifier(model_name, cfg.num_labels, model_dir,
                                        dtype=args.dtype, attn_impl=args.attn_impl,
                                        conv_att=conv_att, remat=args.remat,
                                        **arch_overrides(args))
    model = model.to_empty(device="cpu")
    init_weights(model, generator)
    if is_cnn:
        # under --conv_att the ResNet is the classifier's trunk
        keys = H.maybe_import_resnet(model, model_dir, model_name,
                                     prefix="trunk." if conv_att else "")
        size, norm = getattr(args, "image_size", None) or 224, IMAGE_NORM["imagenet"]
    else:
        geo = vit_geometry(model_name, model_dir)
        keys = (H.maybe_import_beit_tower(model, model_dir, model.cfg.layers, prefix="tower.")
                if model_name == "beit" else
                H.maybe_import_vision_tower(model, model_dir, model.cfg.layers,
                                            distilled=model_name == "deit",
                                            pooling=geo["pooling"], prefix="tower."))
        size, norm = geo["image_size"], IMAGE_NORM[model_name]
    if keys:
        logger.info("%s: %d pretrained tensors from %s", model_name, len(keys), model_dir)
    model = model.to(device)
    feature_extract = is_cnn and getattr(args, "feature_extract", False)
    frozen = feature_extract_frozen if feature_extract else None
    for name, p in model.named_parameters():
        p.requires_grad_(frozen is None or not frozen(name))
    train_bn = is_cnn and not feature_extract

    train, val, test, weights = prepare_data(
        cfg.data, cfg.num_labels, testing=args.testing, multilabel=cfg.multilabel,
        rng=np.random.RandomState(args.seed))
    pipe_cfg = PipelineConfig(batch_size=cfg.batch_size, image_size=size)
    pipes = image_pipes(args, cfg, (train, val, test), pipe_cfg, size)
    mean, std = norm
    dtype = getattr(torch, args.dtype)

    def forward_fn(batch, tim_inputs, gen, deterministic):
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        if is_cnn:
            return {"out_cls": model(pixels, train=train_bn and not deterministic)}
        return {"out_cls": model(pixels, gen)}

    mu_dtype = torch.bfloat16 if args.opt_moments == "bf16" else None
    optimizer = AdamW(model.named_parameters(), cfg.lr, cfg.weight_decay, mu_dtype=mu_dtype,
                      frozen=frozen)
    loss_cfg = loss_cfg_from(cfg)
    cw = None if weights is None else torch.tensor(weights, device=device)
    logger.info("image classifier parameters %d (trainable %d)",
                sum(p.numel() for p in model.parameters()),
                sum(p.numel() for _, p in optimizer.params))
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads),
        eval_step=EvalStep(model, forward_fn, loss_cfg, cw))
