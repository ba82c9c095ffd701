"""Builds the late-fusion model, for serving and for training.

Counterpart of ``build_mm_late_setup`` in the JAX package's ``cli/_build.py``:
``build_mm_late_setup`` makes the model for the transformer towers, the
tokenizer and the serving forward, and imports each pretrained tower whose
``MODEL_DIR_DICT`` directory holds a checkpoint (the text tower into
``dual.text``, ViT / DeiT into ``dual.vision``; a directory without one
leaves the tower random), as the JAX builder does; ``build_mm_late_train_setup``
adds what a trainer needs on its device: the vision tower frozen
(``requires_grad`` off, outside AdamW, as the reference freezes it), the data
splits and pipelines, AdamW, the loss configuration and the train and eval
steps; ``import_reference_checkpoint`` loads a reference-trained ``MM_Model``
state dict (``--import_reference_ckpt``). No mesh is built: the port runs on
one device.
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
from ..models.fusion import FUSION_NAMES, MMLateModel
from ..models.text import NO_TOKEN_TYPES, text_encoder_config
from ..models.vision import CNN_MODELS, IMAGE_NORM, vision_encoder_config, vit_geometry
from ..train.optim import AdamW, vision_frozen
from ..train.steps import EvalStep, LossConfig, TrainStep
from ..utils.logging import get_logger
from ._common import arch_overrides

logger = get_logger(__name__)


@dataclasses.dataclass
class Setup:
    model: MMLateModel
    tokenizer: TweetTokenizerFrontend
    image_size: int
    image_norm: tuple
    # batch of device tensors (ids, mask, [token_type_ids], pixel_values as
    # uint8 NHWC) -> the model's output dict
    forward_fn: Callable


def check_mm_late_supported(args) -> None:
    """Raise ``SystemExit`` for a tower or fusion head this port lacks."""
    if args.img_model_name in CNN_MODELS or args.fusion_name in ("xatt", "concat_cnn"):
        raise SystemExit(
            f"--img_model_name {args.img_model_name} / --fusion_name "
            f"{args.fusion_name}: the CNN fusion path (MMCnnModel) is not "
            "ported to PyTorch yet")
    if args.img_model_name == "beit":
        raise SystemExit("--img_model_name beit: the BEiT tower is not ported "
                         "to PyTorch yet")
    if args.fusion_name not in FUSION_NAMES:
        raise SystemExit(f"--fusion_name {args.fusion_name}: unknown")


def build_mm_late_setup(args, cfg: C.ServingConfig,
                        generator: Optional[torch.Generator] = None) -> Setup:
    """The late-fusion model on the CPU in float32: random init from
    ``generator`` when one is given, else uninitialised storage for a
    checkpoint to fill; then the pretrained towers of ``MODEL_DIR_DICT``."""
    check_mm_late_supported(args)
    txt_name, img_name = args.txt_model_name, args.img_model_name
    txt_dir = C.MODEL_DIR_DICT.get(txt_name)
    img_dir = C.MODEL_DIR_DICT.get(img_name)
    overrides = arch_overrides(args)
    text_cfg = text_encoder_config(txt_name, txt_dir, dtype=args.dtype,
                                   attn_impl=args.attn_impl, **overrides)
    vis_cfg = vision_encoder_config(img_name, img_dir, dtype=args.dtype,
                                    attn_impl=args.attn_impl, **overrides)
    geo = vit_geometry(img_name, img_dir)
    tokenizer = build_tokenizer(txt_name, txt_dir, cfg.max_length, text_cfg.vocab_size)
    with torch.device("meta"):  # no default init: it is replaced anyway
        model = MMLateModel(text_cfg, vis_cfg, cfg.num_labels,
                            fusion_name=args.fusion_name, dropout=cfg.dropout,
                            patch=geo["patch"], image_size=geo["image_size"],
                            num_prefix_tokens=geo["num_prefix_tokens"],
                            vision_pooling=geo["pooling"])
    model = model.to_empty(device="cpu").eval()
    if generator is not None:
        init_weights(model, generator)
        with torch.no_grad():
            model.dual.logit_scale.fill_(2.6592)  # DualEncoder's init value
    towers = (("text", txt_dir, H.maybe_import_text_tower(
                  model, txt_dir, text_cfg.layers, prefix="dual.text.")),
              ("vision", img_dir, H.maybe_import_vision_tower(
                  model, img_dir, vis_cfg.layers, distilled=img_name == "deit",
                  pooling=geo["pooling"], prefix="dual.vision.")))
    for what, model_dir, keys in towers:
        if keys:
            logger.info("%s tower: %d pretrained tensors from %s", what, len(keys), model_dir)

    mean, std = IMAGE_NORM[img_name]
    dtype = getattr(torch, args.dtype)
    use_tt = txt_name not in NO_TOKEN_TYPES

    def forward_fn(batch):
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        return model(batch["ids"], batch["mask"], pixels,
                     batch.get("token_type_ids") if use_tt else None,
                     iadds_task=cfg.use_iadds_loss)

    return Setup(model=model, tokenizer=tokenizer, image_size=geo["image_size"],
                 image_norm=(mean, std), forward_fn=forward_fn)


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
    model: MMLateModel
    device: torch.device
    optimizer: AdamW
    pipes: Dict[str, SplitPipeline]
    train_step: TrainStep
    eval_step: EvalStep


def _loss_cfg_from(cfg) -> LossConfig:
    return LossConfig(
        num_labels=cfg.num_labels, multilabel=cfg.multilabel,
        use_clip_loss=cfg.use_clip_loss, use_tim_loss=cfg.use_tim_loss,
        use_iadds_loss=cfg.use_iadds_loss,
        use_loss_correction=cfg.use_loss_correction, beta_itc=cfg.beta_itc,
        beta_itm=cfg.beta_itm, beta_iadds=cfg.beta_iadds,
        T=tuple(map(tuple, C.T)))


def build_mm_late_train_setup(args, cfg: C.Config, device: torch.device,
                              generator: torch.Generator,
                              keep_grads: bool = False) -> TrainSetup:
    """Everything a late-fusion training run needs, on ``device``: the model
    initialised from ``generator``, the splits of ``cfg.data`` (subsampled
    with ``np.random.RandomState(args.seed)``, as the JAX package's
    ``build_mm_late_setup`` does),
    the pipelines (the uint8 cache under ``<data>/cache/{task}_u8_{size}``
    with ``--use_saved_features``), AdamW and the steps."""
    base = build_mm_late_setup(args, cfg, generator=generator)
    model = base.model.to(device)
    for name, p in model.named_parameters():
        p.requires_grad_(not vision_frozen(name))

    rng = np.random.RandomState(args.seed)
    train, val, test, weights = prepare_data(
        cfg.data, cfg.num_labels, testing=args.testing,
        nsamples=getattr(args, "nsamples", -1),
        load_image_adds=cfg.use_iadds_loss, multilabel=cfg.multilabel, rng=rng)
    size = base.image_size
    pipe_cfg = PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length,
                              image_size=size)
    pipes = {}
    for name, split in (("train", train), ("val", val), ("test", test)):
        src = make_image_source(
            cfg.img_fmt, ids=split.ids, size=size,
            use_cache=getattr(args, "use_saved_features", False),
            cache_dir=f"{C.DATA_PATH}cache/{cfg.task_name}_u8_{size}")
        pipes[name] = SplitPipeline(split, pipe_cfg, tokenizer=base.tokenizer,
                                    image_source=src)

    mean, std = base.image_norm
    dtype = getattr(torch, args.dtype)
    use_tt = args.txt_model_name not in NO_TOKEN_TYPES

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

    mu_dtype = torch.bfloat16 if args.opt_moments == "bf16" else None
    optimizer = AdamW(model.named_parameters(), cfg.lr, cfg.weight_decay,
                      mu_dtype=mu_dtype, frozen=vision_frozen)
    loss_cfg = _loss_cfg_from(cfg)
    cw = None if weights is None else torch.tensor(weights, device=device)
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for _, p in optimizer.params)
    logger.info("model parameters %d (trainable %d)", n_all, n_train)
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads),
        eval_step=EvalStep(model, forward_fn, loss_cfg, cw))
